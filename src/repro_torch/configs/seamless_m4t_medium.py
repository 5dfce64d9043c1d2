"""seamless-m4t-medium [audio] — encoder-decoder, multimodal.
[arXiv:2308.11596]

Backbone only: the mel-spectrogram + conv feature extractor is a STUB;
``input_specs`` provides precomputed frame embeddings at d_model.
Decode over a long source is O(L_enc) per token (cross-attention reads
the cached encoder output), i.e. sub-quadratic per decoded token.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-medium",
    arch_type="audio",
    num_layers=12,                  # decoder layers
    encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    frontend="audio_stub",
    long_context_mode="cross",
    citation="arXiv:2308.11596",
))
