"""xlstm-1.3b — sLSTM + mLSTM blocks, xLSTM[7:1] [arXiv:2405.04517].

d_ff=0: xLSTM blocks carry their own up/down projections (proj factor 2 for
mLSTM pre-up-projection blocks, ~4/3 gated FFN for sLSTM post-FFN blocks).
"""
from repro_torch.configs.base import ArchConfig, XLSTMConfig, register


@register("xlstm-1.3b")
def xlstm_1p3b() -> ArchConfig:
    return ArchConfig(
        name="xlstm-1.3b",
        family="ssm",
        source="arXiv:2405.04517",
        n_layers=48,
        d_model=2048,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        xlstm=XLSTMConfig(slstm_every=8, mlstm_proj_factor=2.0,
                          slstm_proj_factor=1.3334, conv1d_kernel=4),
        norm_type="layernorm",
        supports_long_context=True,   # recurrent, natively sub-quadratic
    )
