"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE every
other layer, 16 experts top-2.  [arXiv:2403.19887]

Superblock of 8 layers: attention at position 4, Mamba elsewhere;
MoE FFN at odd positions, dense MLP at even ones (Jamba's 1:7 attn
ratio and every-other-layer MoE).
"""

from repro_torch.configs.base import ModelConfig, register

_PATTERN = tuple(
    (("attn" if i == 4 else "mamba"), ("moe" if i % 2 == 1 else "mlp"))
    for i in range(8)
)

CONFIG = register(ModelConfig(
    name="jamba-v0.1-52b",
    arch_type="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    block_pattern=_PATTERN,
    num_experts=16,
    experts_per_token=2,
    moe_d_ff=14336,
    ssm_state_dim=16,
    ssm_conv_width=4,
    ssm_expand=2,
    long_context_mode="native",      # Mamba states + sparse attention layers
    citation="arXiv:2403.19887",
))
