"""Config registry: importing this package registers the archs the port
serves (the dense transformer family of the first slice)."""
from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    MoEConfig,
    available_archs,
    get_config,
)

# registration side-effects
from repro_torch.configs import gemma_7b, starcoder2_7b  # noqa: F401,E402
