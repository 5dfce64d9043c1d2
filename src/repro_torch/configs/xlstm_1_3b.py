"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks (7:1 per superblock of 8,
matching the paper's sparse sLSTM placement).  [arXiv:2405.04517]

d_ff=0 per assignment: xLSTM blocks carry their own up/down projections
(mLSTM pre-up-projection ×2, sLSTM gated FFN), no separate MLP.
"""

from repro_torch.configs.base import ModelConfig, register

_PATTERN = tuple(
    (("slstm" if i == 7 else "mlstm"), "none") for i in range(8)
)

CONFIG = register(ModelConfig(
    name="xlstm-1.3b",
    arch_type="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab_size=50304,
    block_pattern=_PATTERN,
    long_context_mode="native",      # constant-size recurrent state
    citation="arXiv:2405.04517",
))
