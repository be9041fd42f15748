"""deepseek-moe-16b — 2 shared + 64 routed top-6, fine-grained [arXiv:2401.06066]."""
from repro_torch.configs.base import ArchConfig, MoEConfig, register


@register("deepseek-moe-16b")
def deepseek_moe_16b() -> ArchConfig:
    return ArchConfig(
        name="deepseek-moe-16b",
        family="moe",
        source="arXiv:2401.06066",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab_size=102400,
        moe=MoEConfig(
            n_experts=64,
            experts_per_token=6,
            d_expert=1408,
            n_shared_experts=2,
            first_dense_layers=1,
            dense_d_ff=10944,      # paper's first dense layer width
        ),
        long_context_window=4096,
        mlp_type="swiglu",
        norm_type="rmsnorm",
    )
