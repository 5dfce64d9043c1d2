"""command-r-35b [dense] — GQA (kv=8), no biases.
[hf:CohereForAI/c4ai-command-r-v01]
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="command-r-35b",
    arch_type="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
    attn_bias=False,
    rope_theta=8_000_000.0,
    long_context_mode="swa",
    citation="hf:CohereForAI/c4ai-command-r-v01",
))
