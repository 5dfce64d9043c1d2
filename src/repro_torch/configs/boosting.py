"""The paper's own 'architecture': the resilient boosting protocol
itself, as a distributed program (k players) — the port's copy of
``repro.configs.boosting``."""

from repro_torch.core.types import BoostConfig

PRODUCTION_BOOST = BoostConfig(
    k=16,                       # one player per data-axis group
    coreset_size=512,
    domain_size=1 << 20,
    opt_budget=256,
    deterministic_coreset=True,
)
