"""granite-moe-3b-a800m [moe] — 40 experts, top-8 routing, per-expert
d_ff=512.  [hf:ibm-granite/granite-3.0-1b-a400m-base]

Note: 40 experts do not divide the 16-way model axis, so expert
parameters are sharded over the per-expert hidden dim instead
(tensor-parallel within experts) — see models/moe.py.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-moe-3b-a800m",
    arch_type="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    block_pattern=(("attn", "moe"),),
    num_experts=40,
    experts_per_token=8,
    moe_d_ff=512,
    attn_layout_constraint=True,   # §Perf G-P3 (measured win)
    long_context_mode="swa",
    citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
))
