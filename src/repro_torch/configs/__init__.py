from repro_torch.configs.base import (AutotuneConfig, CascadeConfig,
                                      EscalationConfig, InputShape,
                                      INPUT_SHAPES, KernelTuneConfig,
                                      ModelConfig, ObsConfig,
                                      PagedCacheConfig,
                                      default_exit_boundaries, get_config,
                                      list_configs, reduced, register)

__all__ = [
    "AutotuneConfig", "CascadeConfig", "EscalationConfig", "InputShape",
    "INPUT_SHAPES", "KernelTuneConfig", "ModelConfig", "ObsConfig",
    "PagedCacheConfig", "default_exit_boundaries", "get_config",
    "list_configs", "reduced", "register",
]
