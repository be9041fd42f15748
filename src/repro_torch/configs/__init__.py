"""Config registry: importing this package registers the archs the port
serves (the dense transformer family, the MoE family, the VLM backbone,
zamba2, xLSTM and the audio encoder-decoder), and exports the configs of
the paper's own edge models."""
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

# registration side-effects
from repro_torch.configs import (  # noqa: F401,E402
    command_r_35b, deepseek_moe_16b, gemma_7b, llava_next_mistral_7b,
    moonshot_v1_16b_a3b, qwen3_moe_235b_a22b, starcoder2_7b, whisper_base,
    xlstm_1p3b, zamba2_2p7b)
