"""qwen3-moe-235b-a22b — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B family].

94L d_model=4096 64H (GQA kv=4) expert d_ff=1536 vocab=151936, head_dim=128,
qk-norm, no shared experts.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register


@register("qwen3-moe-235b-a22b")
def qwen3_moe_235b_a22b() -> ArchConfig:
    return ArchConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        source="hf:Qwen/Qwen3-30B-A3B (scaled per assignment)",
        n_layers=94,
        d_model=4096,
        n_heads=64,
        n_kv_heads=4,
        head_dim=128,
        d_ff=1536,
        vocab_size=151936,
        rope_theta=1_000_000.0,
        qk_norm=True,
        moe=MoEConfig(
            n_experts=128,
            experts_per_token=8,
            d_expert=1536,
            n_shared_experts=0,
            router_aux_weight=0.001,
        ),
        long_context_window=4096,
        mlp_type="swiglu",
        norm_type="rmsnorm",
    )
