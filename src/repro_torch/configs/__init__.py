"""Per-architecture configs (the assigned pool), copied from
``repro.configs``."""

from repro_torch.configs.base import (ASSIGNED_ARCHS, DEFAULT_SWA_WINDOW,
                                      INPUT_SHAPES, MeshConfig, ModelConfig,
                                      ShapeConfig, all_configs, get_config,
                                      load_all, reduced)

__all__ = ["ModelConfig", "ShapeConfig", "MeshConfig", "INPUT_SHAPES",
           "DEFAULT_SWA_WINDOW", "ASSIGNED_ARCHS", "get_config",
           "all_configs", "load_all", "reduced"]
