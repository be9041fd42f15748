"""gemma-7b — GeGLU, head_dim=256 (16H x 256 = 4096 != d_model) [arXiv:2403.08295]."""
from repro_torch.configs.base import ArchConfig, register


@register("gemma-7b")
def gemma_7b() -> ArchConfig:
    return ArchConfig(
        name="gemma-7b",
        family="dense",
        source="arXiv:2403.08295",
        n_layers=28,
        d_model=3072,
        n_heads=16,
        n_kv_heads=16,
        head_dim=256,
        d_ff=24576,
        vocab_size=256000,
        tie_embeddings=True,
        scale_embeddings=True,
        long_context_window=4096,   # beyond-card SWA variant for long_500k
        mlp_type="geglu",
        norm_type="rmsnorm",
    )
