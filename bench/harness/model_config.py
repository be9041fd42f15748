"""A configuration file of ``bench/configs/`` and the program's view of it.

A configuration file keeps the published model's keys (as its
``config.json`` names them) with the values the benchmark runs.  The
harness hands the program ``repro_torch``'s registered architecture of
the same name, and refuses to run when that architecture and the file
disagree on any size: the file, not the program, states what is run.
The plain reference (``bench/reference/``) reads the file alone.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict

BENCH = Path(__file__).resolve().parent.parent


def load(name: str, root: Path = BENCH) -> Dict:
    """The configuration file ``configs/<name>.json`` under ``root``."""
    path = root / "configs" / f"{name}.json"
    if not path.exists():
        raise FileNotFoundError(f"no configuration file {path}")
    return json.loads(path.read_text())


def is_moe(cfg: Dict) -> bool:
    return bool(cfg.get("n_routed_experts"))


def head_dim(cfg: Dict) -> int:
    return cfg.get("head_dim") or (cfg["hidden_size"]
                                   // cfg["num_attention_heads"])


def window(cfg: Dict) -> int:
    """The attention window the configuration serves with (0 = full)."""
    return int(cfg.get("sliding_window") or 0)


def program_fields(cfg: Dict) -> Dict:
    """The fields of the program's ``ArchConfig`` that the file fixes."""
    act = cfg["hidden_act"]
    out = dict(
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        vocab_size=cfg["vocab_size"], rope_theta=float(cfg["rope_theta"]),
        sliding_window=window(cfg),
        norm_type="layernorm" if cfg["norm_type"] == "layer_norm"
        else "rmsnorm",
        use_bias=bool(cfg.get("use_bias", False)),
        tie_embeddings=bool(cfg.get("tie_word_embeddings", False)),
        mlp_type=("swiglu" if act == "silu" else "gelu"),
    )
    if is_moe(cfg):
        out["d_ff"] = cfg["moe_intermediate_size"]
        out["moe"] = dict(
            n_experts=cfg["n_routed_experts"],
            experts_per_token=cfg["num_experts_per_tok"],
            d_expert=cfg["moe_intermediate_size"],
            n_shared_experts=cfg["n_shared_experts"],
            first_dense_layers=cfg["first_k_dense_replace"],
            dense_d_ff=cfg["intermediate_size"],
            capacity_factor=float(cfg["capacity_factor"]))
    else:
        out["d_ff"] = cfg["intermediate_size"]
    return out


def program_arch(cfg: Dict, *, strict: bool = True):
    """The program's ``ArchConfig`` for the file.  With ``strict`` (every
    run of a cell) the registered architecture must already equal the
    file; without it (the CPU tests' smoke sizes) the file's sizes are
    written over it."""
    from repro_torch.configs import get_config
    base = get_config(cfg["program_arch"])
    fields = program_fields(cfg)
    moe = fields.pop("moe", None)
    arch = dataclasses.replace(base, **fields)
    if moe is not None:
        arch = dataclasses.replace(arch, moe=dataclasses.replace(base.moe,
                                                                 **moe))
    if arch.resolved_head_dim != head_dim(cfg):
        arch = dataclasses.replace(arch, head_dim=head_dim(cfg))
    if strict and arch != base:
        diff = {f.name: (getattr(base, f.name), getattr(arch, f.name))
                for f in dataclasses.fields(base)
                if getattr(base, f.name) != getattr(arch, f.name)}
        raise ValueError(f"the program's {cfg['program_arch']} differs from "
                         f"the configuration file: {diff}")
    if cfg["norm_type"] == "layer_norm" and not arch.use_bias:
        raise ValueError("a layer norm without bias is not a configuration "
                         "the program has")
    return arch
