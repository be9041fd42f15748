"""starcoder2-7b — GQA, RoPE, native sliding-window 4096 [arXiv:2402.19173]."""
from repro_torch.configs.base import ArchConfig, register


@register("starcoder2-7b")
def starcoder2_7b() -> ArchConfig:
    return ArchConfig(
        name="starcoder2-7b",
        family="dense",
        source="arXiv:2402.19173",
        n_layers=32,
        d_model=4608,
        n_heads=36,
        n_kv_heads=4,
        d_ff=18432,
        vocab_size=49152,
        rope_theta=1_000_000.0,
        sliding_window=4096,       # native SWA -> long_500k runs as-is
        mlp_type="gelu",           # non-gated c_fc/c_proj MLP
        norm_type="layernorm",
        use_bias=True,
    )
