"""command-r-35b — GQA, no-bias, parallel block [hf:CohereForAI/c4ai-command-r-v01]."""
from repro_torch.configs.base import ArchConfig, register


@register("command-r-35b")
def command_r_35b() -> ArchConfig:
    return ArchConfig(
        name="command-r-35b",
        family="dense",
        source="hf:CohereForAI/c4ai-command-r-v01",
        n_layers=40,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22528,
        vocab_size=256000,
        rope_theta=8_000_000.0,
        parallel_block=True,        # cohere parallel attn+mlp residual block
        tie_embeddings=True,
        long_context_window=4096,   # SWA long-context variant for long_500k
        mlp_type="swiglu",
        norm_type="layernorm",
        use_bias=False,
    )
