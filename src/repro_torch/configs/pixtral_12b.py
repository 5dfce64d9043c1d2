"""pixtral-12b [vlm] — Pixtral-ViT frontend (STUB) + Mistral-Nemo-style
decoder backbone.  [hf:mistralai/Pixtral-12B-2409]

Backbone only per the assignment carve-out: the vision encoder +
projector are stubbed; ``input_specs`` provides precomputed patch
embeddings at d_model.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="pixtral-12b",
    arch_type="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=160,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1_000_000.0,
    frontend="vit_stub",
    frontend_tokens=1024,            # patch positions per example
    long_context_mode="swa",         # Mistral-style sliding window
    citation="hf:mistralai/Pixtral-12B-2409",
))
