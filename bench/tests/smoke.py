"""Smoke-size copies of the benchmark's configurations and mixes, and a
throw-away benchmark root that holds them, for the CPU tests."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent

DENSE = {
    "name": "starcoder2-smoke", "program_arch": "starcoder2-7b",
    "model_type": "starcoder2", "num_hidden_layers": 2, "hidden_size": 256,
    "num_attention_heads": 4, "num_key_value_heads": 1, "head_dim": 64,
    "intermediate_size": 512, "hidden_act": "gelu_pytorch_tanh",
    "norm_type": "layer_norm", "norm_epsilon": 1e-6, "use_bias": True,
    "rope_theta": 1000000.0, "sliding_window": 64, "vocab_size": 512,
    "tie_word_embeddings": False,
}
MOE = {
    "name": "deepseek-smoke", "program_arch": "deepseek-moe-16b",
    "model_type": "deepseek", "num_hidden_layers": 3, "hidden_size": 256,
    "num_attention_heads": 4, "num_key_value_heads": 4, "head_dim": 64,
    "intermediate_size": 384, "moe_intermediate_size": 128,
    "n_routed_experts": 8, "num_experts_per_tok": 2, "n_shared_experts": 1,
    "first_k_dense_replace": 1, "norm_topk_prob": True,
    "capacity_factor": 1.25, "hidden_act": "silu", "norm_type": "rms_norm",
    "rms_norm_eps": 1e-6, "use_bias": False, "rope_theta": 10000.0,
    "vocab_size": 512, "tie_word_embeddings": False,
}
ENGINE = {"n_slots": 4, "cache_len": 256, "chunk_tokens": 32,
          "token_budget": 64}
OPEN = {"loop": "open", "engine": ENGINE, "warm_s": 0.5, "rate_rps": 4.0,
        "contexts": {"count": 3, "tokens": {"low": 32, "high": 96,
                                            "block": 16}, "zipf_s": 1.1},
        "suffix_tokens": {"low": 16, "high": 64, "dist": "loguniform",
                          "block": 16},
        "max_new": {"low": 4, "high": 12},
        "check": {"served_tokens": 48, "max_requests": 8}}
CLOSED = {"loop": "closed", "engine": ENGINE, "warm_s": 0.5, "clients": 3,
          "prompt_tokens": {"low": 16, "high": 100},
          "max_new": {"low": 4, "high": 12},
          "check": {"served_tokens": 48, "max_requests": 8}}


def make_root(tmp: Path, *, limit: float = 0.05, kv_limit: float = 0.05,
              min_tokens: int = 8):
    """A benchmark root under ``tmp`` with the smoke cells
    ``dense.open``, ``dense.closed``, ``moe.open`` and ``moe.closed``;
    returns (root, the BENCHMARK.json dict)."""
    root = tmp / "bench"
    for d in ("configs", "mixes", "limits"):
        (root / d).mkdir(parents=True, exist_ok=True)
    shutil.copytree(BENCH / "metrics", root / "metrics")
    (root / "configs" / "dense.json").write_text(json.dumps(DENSE))
    (root / "configs" / "moe.json").write_text(json.dumps(MOE))
    (root / "mixes" / "open.json").write_text(json.dumps(OPEN))
    (root / "mixes" / "closed.json").write_text(json.dumps(CLOSED))
    cells = []
    for c in ("dense", "moe"):
        for t in ("open", "closed"):
            name = f"{c}.{t}"
            cells.append({"name": name, "config": c, "traffic": t,
                          "chips": 1, "why": "smoke"})
            lim = {"max_gap": limit, "min_checked_tokens": min_tokens}
            if c == "moe":       # an MoE step is followed from its cache
                lim = {"method": "replay", "mean_gap": limit,
                       "max_kv_row_err": kv_limit,
                       "min_checked_tokens": min_tokens}
            (root / "limits" / f"{name}.json").write_text(json.dumps(lim))
    real = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    names = [c["name"] for c in cells]
    bench = {"workloads": cells,
             "end_to_end": [dict(m, workloads=names)
                            for m in real["end_to_end"]],
             "per_layer": [dict(m, workloads=names)
                           for m in real["per_layer"]]}
    return root, bench
