"""Config registry: importing this package registers the archs the port
serves (the dense transformer family, zamba2 and xLSTM), and exports the
configs of the paper's own edge models."""
from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    MoEConfig,
    available_archs,
    get_config,
)
from repro_torch.configs.paper_models import (  # noqa: F401
    BraggNNConfig,
    CookieNetAEConfig,
)

# registration side-effects
from repro_torch.configs import (  # noqa: F401,E402
    gemma_7b, starcoder2_7b, xlstm_1p3b, zamba2_2p7b)
