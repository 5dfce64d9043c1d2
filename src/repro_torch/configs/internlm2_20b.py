"""internlm2-20b [dense] — GQA (kv=8).  [arXiv:2403.17297]"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internlm2-20b",
    arch_type="dense",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92544,
    long_context_mode="swa",
    citation="arXiv:2403.17297",
))
