"""deepseek-7b [dense] — llama-arch, MHA (kv=32).  [arXiv:2401.02954]"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-7b",
    arch_type="dense",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=102400,
    long_context_mode="swa",
    citation="arXiv:2401.02954",
))
