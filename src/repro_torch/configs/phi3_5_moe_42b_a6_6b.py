"""phi3.5-moe-42b-a6.6b [moe] — 16 experts, top-2 routing.
[hf:microsoft/Phi-3.5-MoE-instruct]
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    arch_type="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    block_pattern=(("attn", "moe"),),
    num_experts=16,
    experts_per_token=2,
    moe_d_ff=6400,
    long_context_mode="swa",
    citation="hf:microsoft/Phi-3.5-MoE-instruct",
))
