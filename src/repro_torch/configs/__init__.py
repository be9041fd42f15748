"""Config registry: importing this package registers the archs the port
serves (the dense transformer family, the MoE family, the VLM backbone,
zamba2, xLSTM and the audio encoder-decoder), exports the shape registry
and ``ASSIGNED_ARCHS`` (the dry-run's sweep, in the reference's order)
and the configs of the paper's own edge models."""
from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    FrontendStub,
    MoEConfig,
    available_archs,
    get_config,
)
from repro_torch.configs.paper_models import (  # noqa: F401
    BraggNNConfig,
    CookieNetAEConfig,
)
from repro_torch.configs.shapes import (  # noqa: F401
    SHAPES,
    InputShape,
    all_shapes,
    get_shape,
    smoke_shape,
)

# registration side-effects
from repro_torch.configs import (  # noqa: F401,E402
    command_r_35b, deepseek_moe_16b, gemma_7b, llava_next_mistral_7b,
    moonshot_v1_16b_a3b, qwen3_moe_235b_a22b, starcoder2_7b, whisper_base,
    xlstm_1p3b, zamba2_2p7b)

ASSIGNED_ARCHS = (
    "zamba2-2.7b",
    "moonshot-v1-16b-a3b",
    "qwen3-moe-235b-a22b",
    "starcoder2-7b",
    "deepseek-moe-16b",
    "xlstm-1.3b",
    "whisper-base",
    "command-r-35b",
    "gemma-7b",
    "llava-next-mistral-7b",
)
