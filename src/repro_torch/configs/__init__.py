"""Architecture configs (framework-free copies of ``repro.configs``)."""

from repro_torch.configs.base import (  # noqa: F401
    ARCH_IDS,
    ArchConfig,
    get_config,
    get_smoke,
    list_archs,
)
