from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, MoEConfig, SSMConfig, ShapeConfig, SHAPES, reduced_config)
from repro_torch.configs.registry import (  # noqa: F401
    ARCH_IDS, get_config, resolve_arch)
