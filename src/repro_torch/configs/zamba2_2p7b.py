"""zamba2-2.7b — Mamba2 backbone + shared attention blocks [arXiv:2411.15242]."""
from repro_torch.configs.base import ArchConfig, SSMConfig, register


@register("zamba2-2.7b")
def zamba2_2p7b() -> ArchConfig:
    return ArchConfig(
        name="zamba2-2.7b",
        family="hybrid",
        source="arXiv:2411.15242",
        n_layers=54,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_ff=10240,
        vocab_size=32000,
        # 128-token chunks for the SSD scan (the reference's choice)
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, n_groups=1,
                      chunk_size=128),
        hybrid_attn_every=6,          # shared-weight attn block every 6 mamba layers
        long_context_window=4096,     # shared attn runs SWA at 500k
        mlp_type="geglu",
        norm_type="rmsnorm",
        supports_long_context=True,   # SSM backbone is sub-quadratic
    )
