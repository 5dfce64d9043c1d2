"""qwen3-32b [dense] — qk-norm, GQA (kv=8).  [hf:Qwen/Qwen3-8B]"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-32b",
    arch_type="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=80,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    long_context_mode="swa",
    citation="hf:Qwen/Qwen3-8B",
))
