"""llava-next-mistral-7b — anyres tiling VLM [hf:llava-hf/llava-v1.6-mistral-7b-hf].

Mistral-7B language backbone (native sliding-window 4096).  The vision tower
(CLIP ViT-L/14-336) + projector is a STUB per the assignment carve-out:
``input_specs()`` supplies precomputed patch embeddings.  anyres tiling: up to
4 tiles + 1 base image, 576 patches each = 2880 image tokens, d_embed=1024
(CLIP hidden), projected to d_model by a real learned 2-layer MLP projector.
"""
from repro_torch.configs.base import ArchConfig, FrontendStub, register


@register("llava-next-mistral-7b")
def llava_next_mistral_7b() -> ArchConfig:
    return ArchConfig(
        name="llava-next-mistral-7b",
        family="vlm",
        source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=32000,
        rope_theta=1_000_000.0,
        sliding_window=4096,        # mistral native SWA -> long_500k runs
        frontend=FrontendStub(kind="image_patches", n_tokens=2880, d_embed=1024),
        mlp_type="swiglu",
        norm_type="rmsnorm",
    )
