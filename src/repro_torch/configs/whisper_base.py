"""whisper-base — encoder-decoder audio backbone [arXiv:2212.04356].

6L enc + 6L dec, d_model=512 8H d_ff=2048 vocab=51865.  The mel-spectrogram +
conv frontend is a STUB: the model consumes precomputed frame embeddings
(1500 x 512 after the conv stride-2).

Shape policy: the decoder's learned positions cap at 448; decode shapes are
lowered structurally with the assigned cache length.  ``long_500k`` is
skipped (out of family for a 448-position decoder).
"""
from repro_torch.configs.base import ArchConfig, FrontendStub, register


@register("whisper-base")
def whisper_base() -> ArchConfig:
    return ArchConfig(
        name="whisper-base",
        family="audio",
        source="arXiv:2212.04356",
        n_layers=6,                 # decoder layers
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        d_ff=2048,
        vocab_size=51865,
        is_encoder_decoder=True,
        n_encoder_layers=6,
        encoder_positions=1500,
        max_decoder_positions=448,
        frontend=FrontendStub(kind="audio_frames", n_tokens=1500, d_embed=512),
        mlp_type="gelu",
        norm_type="layernorm",
        use_bias=True,
        tie_embeddings=True,
        supports_long_context=False,
        long_context_skip_reason=(
            "whisper decoder has 448 learned positions and a fixed 1500-frame "
            "encoder; a 524288-token decode context is out of family"
        ),
    )
