"""moonshot-v1-16b-a3b (Moonlight-16B-A3B) — DeepSeek-style fine-grained MoE.

[hf:moonshotai/Moonlight-16B-A3B] 48L d_model=2048 16H (kv=16) expert d_ff=1408
vocab=163840, 64 routed experts top-6 + 2 shared, first layer dense.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register


@register("moonshot-v1-16b-a3b")
def moonshot_v1_16b_a3b() -> ArchConfig:
    return ArchConfig(
        name="moonshot-v1-16b-a3b",
        family="moe",
        source="hf:moonshotai/Moonlight-16B-A3B",
        n_layers=48,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab_size=163840,
        moe=MoEConfig(
            n_experts=64,
            experts_per_token=6,
            d_expert=1408,
            n_shared_experts=2,
            first_dense_layers=1,
            dense_d_ff=11264,  # 8 * 1408, DeepSeek-style wide first dense layer
        ),
        long_context_window=4096,  # SWA long-context variant (beyond paper card)
        mlp_type="swiglu",
        norm_type="rmsnorm",
    )
