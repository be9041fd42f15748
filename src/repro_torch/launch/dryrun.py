"""Shape-only dry-run of every (arch x shape) combo on the ``meta`` device:
the counterpart of ``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b \\
        --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun      # the sweep

The reference lowers and compiles each combo's step for a 16 x 16 TPU
pod and reads XLA's ``cost_analysis``, ``memory_analysis`` and HLO.  The
port runs the same step builders (``launch/specs.py``) on parameters,
optimizer state, batches and caches on the ``meta`` device (shapes and
dtypes, no storage, no card, no kernel: every wrapper takes its plain
path off CUDA), under ``torch.utils.flop_counter.FlopCounterMode``.  Each
combo writes one JSON artifact with the reference's keys, where

* ``counted`` (the counted FLOPs, whole and by op) stands in for
  ``cost_analysis``;
* ``memory`` (the parameter, optimizer-state and decode-cache bytes one
  position holds under the specs the step places its parameters by,
  ``specs.train_specs`` on a mesh) for ``memory_analysis``;
* ``meta_pass_s`` (the meta pass's wall) for ``lower_s``/``compile_s``;
* ``collectives`` and ``collective_bytes_total`` are the sharded train
  step's own counts for one position a step, in place of the HLO parse:
  the tensor-parallel plan's reduces and gathers with their duals
  (``TPPlan``) and the parameters' gathers, reduce-scatters and gradient
  sums (``specs.ParamCollectives``);
* ``analytic`` is ``roofline/analytic.py``'s account, which
  ``roofline/analysis.from_artifact`` prefers.

The default mesh is one card ("1x1").  ``--mesh-shape d,m`` runs the
``train`` combos' sharded step (``make_train_step_fn(mesh=)``) over d x m
meta positions; a ``prefill`` or ``decode`` combo on more than one
position raises ``ValueError`` (the port's sharded serving is
``PagedDecodeEngine(mesh=)``, not a step function).  The reference's
production mesh (``make_production_mesh``), HLO dump and XLA flags have
no counterpart.

The meta device costs a pass its op count, not its FLOPs (most
elementwise ops run PyTorch's Python decompositions there): chunked
attention at 32,768 tokens and xlstm-1.3b's sLSTM, which loops over every
token, take minutes to tens of minutes a combo, hence ``--jobs``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import os
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, get_config, get_shape
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import sharding as shard_lib
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.mesh import make_host_mesh, mesh_axis_sizes
from repro_torch.models.api import ModelAPI, build_model
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.roofline import analytic
from repro_torch.roofline.analysis import from_artifact, model_flops_estimate

META = torch.device("meta")


def count_params(tree) -> int:
    return sum(int(t.numel()) for t in tree_leaves(tree))


def moe_active_params(cfg: ArchConfig, tree) -> int:
    """Parameters a token reads: the routed experts' leaves
    (``experts_w_*``) scaled by top-k / E."""
    def active(path, leaf) -> int:
        n = int(leaf.numel())
        if "experts_w" in path and cfg.moe is not None:
            n = n * cfg.moe.experts_per_token // cfg.moe.n_experts
        return n

    return sum(tree_leaves(shard_lib._map_with_path(active, tree)))


def tokens_per_step(cfg: ArchConfig, shape: InputShape) -> int:
    B, S = shape.global_batch, shape.seq_len
    if shape.is_decode:
        return B
    if cfg.family == "audio":
        return B * (cfg.encoder_positions + specs_lib._decoder_len(cfg, S))
    return B * S


def _tree_bytes(tree, specs=None, sizes: Optional[Dict[str, int]] = None,
                dtype: Optional[torch.dtype] = None) -> int:
    """Bytes one position holds of ``tree`` cut by ``specs`` over a mesh of
    axis ``sizes`` (whole without ``specs``; each leaf in ``dtype`` if
    given)."""
    size = torch.empty((), dtype=dtype).element_size() if dtype else None
    if specs is None:
        return sum(t.numel() * (size or t.element_size())
                   for t in tree_leaves(tree))
    return sum(tree_leaves(shard_lib._zip_map(
        lambda leaf, spec: shard_lib.piece_numel(leaf, spec, sizes)
        * (size or leaf.element_size()), tree, specs)))


def meta_pass(api: ModelAPI, shape: InputShape, *,
              mesh_shape: Tuple[int, int] = (1, 1), attn_chunk: int = 512,
              remat: bool = True, sharding_policy: str = "baseline"
              ) -> Dict[str, Any]:
    """One step of ``shape``'s kind on the ``meta`` device under
    ``FlopCounterMode``: ``make_train_step_fn`` with ``opt.init``
    (float32 masters; over ``mesh_shape`` meta positions when it is not
    1 x 1), ``make_prefill_step_fn`` or ``make_serve_step_fn`` over
    :func:`cache_abstract <repro_torch.launch.specs.cache_abstract>`
    (bf16 parameters).  Returns the counted FLOPs, the per-position
    memory, the collectives a position takes part in and the wall.
    Raises ``ValueError`` for a prefill or decode step on more than one
    position."""
    cfg = api.cfg
    n_dev = mesh_shape[0] * mesh_shape[1]
    if shape.kind != "train" and n_dev > 1:
        raise ValueError(
            f"a {shape.kind} step has no sharded step function (the port's "
            "sharded serving is PagedDecodeEngine(mesh=)); run it on one "
            "position (--mesh-shape 1,1)")
    mesh = make_host_mesh(mesh_shape[1], devices=[META] * n_dev)
    sizes = mesh_axis_sizes(mesh)
    params = specs_lib.abstract_params(api, torch.float32)
    if shape.kind != "train":
        params = specs_lib.cast_params_bf16(params)
    specs = (specs_lib.train_specs(api, params, mesh, sharding_policy)
             if n_dev > 1 else None)
    memory = {"params_bytes": _tree_bytes(params, specs, sizes)}
    collectives: Dict[str, Dict[str, float]] = {}
    coll_bytes = 0.0
    counter = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    if shape.kind == "train":
        batch = specs_lib.batch_abstract(cfg, shape)
        pre_gather = sharding_policy == "fsdp_flat"
        if n_dev == 1:
            step, opt = specs_lib.make_train_step_fn(
                api, shape, attn_chunk=attn_chunk, remat=remat,
                pre_gather=pre_gather)
            state = params
        else:
            step, opt = specs_lib.make_train_step_fn(
                api, shape, attn_chunk=attn_chunk, remat=remat,
                pre_gather=pre_gather, mesh=mesh, specs=specs)
            state = shard_lib.place(params, specs, mesh)
        opt_state = opt.init(state)
        memory["opt_state_bytes"] = 2 * _tree_bytes(
            params, specs, sizes, torch.float32) + 4
        with counter:
            step(state, opt_state, batch)
        if n_dev > 1:
            if hasattr(step, "plans"):
                plan = step.plans[0]
                collectives["tensor-parallel"] = {
                    "count": plan.collectives,
                    "bytes": float(plan.collective_bytes)}
            pc = step.param_collectives
            collectives["all-gather"] = {"count": pc.gathers,
                                         "bytes": float(pc.gather_bytes)}
            collectives["reduce-scatter"] = {
                "count": pc.gathers, "bytes": float(pc.scatter_bytes)}
            collectives["all-reduce"] = {"count": pc.reduces,
                                         "bytes": float(pc.reduce_bytes)}
            coll_bytes = sum(c["bytes"] for c in collectives.values())
    elif shape.kind == "prefill":
        batch = specs_lib.batch_abstract(cfg, shape)
        batch.pop("labels")
        step = specs_lib.make_prefill_step_fn(api, shape,
                                              attn_chunk=attn_chunk)
        with torch.no_grad(), counter:
            step(params, batch)
    else:
        cache = specs_lib.cache_abstract(api, shape)
        memory["cache_bytes"] = sum(t.numel() * t.element_size()
                                    for t in tree_leaves(cache)
                                    if torch.is_tensor(t))
        step = specs_lib.make_serve_step_fn(api, shape)
        with torch.no_grad(), counter:
            step(params, cache, specs_lib.decode_tokens_abstract(shape))
    wall = time.perf_counter() - t0
    by_op = {str(k): float(v)
             for k, v in counter.get_flop_counts().get("Global", {}).items()}
    return {
        "n_devices": n_dev,
        "mesh_axes": sizes,
        "meta_pass_s": wall,
        "counted": {"flops": float(counter.get_total_flops()),
                    "by_op": by_op},
        "memory": memory,
        "bytes_per_device": float(sum(memory.values())),
        "collectives": collectives,
        "collective_bytes_total": coll_bytes,
    }


# ---------------------------------------------------------------------------
def run_combo(arch: str, shape_name: str, *, mesh_shape=(1, 1),
              out_dir: Optional[str] = None, attn_chunk: int = 512,
              remat: bool = True, moe_impl: Optional[str] = None,
              sharding_policy: str = "baseline", tag: str = "",
              verbose: bool = True) -> Dict[str, Any]:
    """The artifact of ``arch`` x ``shape_name``: SKIPPED where
    ``combo_supported`` says so, else OK with the meta pass's counts.
    Written to ``out_dir`` when given."""
    cfg = get_config(arch)
    if moe_impl and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, impl=moe_impl))
    shape = get_shape(shape_name)
    mesh_shape = tuple(mesh_shape)
    mesh_tag = f"{mesh_shape[0]}x{mesh_shape[1]}"
    ok, reason = specs_lib.combo_supported(cfg, shape)
    result: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_tag,
        "status": "OK" if ok else "SKIPPED", "skip_reason": reason,
    }
    if not ok:
        if verbose:
            print(f"[dryrun] SKIP {arch} x {shape_name}: {reason}")
        _maybe_save(result, out_dir)
        return result

    api = build_model(cfg)
    result.update(meta_pass(api, shape, mesh_shape=mesh_shape,
                            attn_chunk=attn_chunk, remat=remat,
                            sharding_policy=sharding_policy))

    tree = specs_lib.abstract_params(api, torch.float32)
    n_total = count_params(tree)
    n_active = moe_active_params(cfg, tree)
    toks = tokens_per_step(cfg, shape)
    kind = "train" if shape.kind == "train" else "forward"
    window = api.effective_window(shape.seq_len)
    acct = analytic.step_account(cfg, shape, window=window,
                                 n_params_total=n_total,
                                 n_params_active=n_active, remat=remat)
    acct_out = {k: v for k, v in acct.items() if k != "parts"}
    acct_out["parts"] = {k: float(v) for k, v in acct["parts"].items()}
    result.update({
        "params_total": n_total,
        "params_active": n_active,
        "tokens_per_step": toks,
        "model_flops": model_flops_estimate(n_active, toks, kind),
        "analytic": acct_out,
        "window": window,
        "attn_chunk": attn_chunk,
        "remat": remat,
        "moe_impl": (cfg.moe.impl if cfg.moe else None),
        "sharding_policy": sharding_policy,
        "tag": tag,
    })
    terms = from_artifact(result)
    result["roofline"] = terms.row()
    if verbose:
        counted = result["counted"]["flops"]
        print(f"[dryrun] {result['status']} {arch} x {shape_name} x "
              f"{mesh_tag}: analytic flops={acct['flops']:.3e} "
              f"bytes={acct['bytes']:.3e} counted flops="
              f"{counted:.3e} (x{counted / acct['flops']:.4f}) "
              f"coll={result['collective_bytes_total']:.3e}B "
              f"bound={terms.step_time_lower_bound * 1e3:.3f} ms "
              f"({terms.dominant}) meta_pass={result['meta_pass_s']:.1f}s")
        print(f"  memory: {result['memory']}")
    _maybe_save(result, out_dir)
    return result


def _maybe_save(result: Dict, out_dir: Optional[str]) -> None:
    if not out_dir:
        return
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"_{result['tag']}" if result.get("tag") else ""
    name = f"{result['arch']}_{result['shape']}_{result['mesh']}{suffix}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(result, f, indent=1)


def _try_combo(combo: Tuple[str, str], kw: Dict) -> Tuple[str, str]:
    """(status, error text) of one combo of the sweep."""
    try:
        return run_combo(*combo, **kw)["status"], ""
    except Exception as e:
        traceback.print_exc()
        return "FAILED", f"{type(e).__name__}: {e}"


# ---------------------------------------------------------------------------
def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None,
                    help="architecture id (default: all assigned)")
    ap.add_argument("--shape", default=None,
                    help="input shape (default: all four)")
    ap.add_argument("--mesh-shape", default="1,1",
                    help="d,m meta positions of a train combo's sharded "
                         "step (default 1,1: one card; a prefill or decode "
                         "combo on more positions raises)")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--attn-chunk", type=int, default=512)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--moe-impl", default=None,
                    help="override MoE dispatch impl (gshard|gather)")
    ap.add_argument("--sharding-policy", default="baseline",
                    help="param sharding policy (see "
                         "sharding.POLICY_OVERRIDES)")
    ap.add_argument("--tag", default="", help="artifact filename suffix")
    ap.add_argument("--jobs", type=int, default=1,
                    help="combos run at once, each in its own process")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ASSIGNED_ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    kw = dict(mesh_shape=tuple(int(x) for x in args.mesh_shape.split(",")),
              out_dir=args.out, attn_chunk=args.attn_chunk,
              remat=not args.no_remat, moe_impl=args.moe_impl,
              sharding_policy=args.sharding_policy, tag=args.tag)
    combos = [(arch, shape) for arch in archs for shape in shapes]
    t0 = time.perf_counter()
    if args.jobs > 1:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(args.jobs, mp_context=ctx) as pool:
            outs = list(pool.map(_try_combo, combos, [kw] * len(combos)))
    else:
        outs = [_try_combo(c, kw) for c in combos]
    status: Dict[str, int] = {}
    failures = []
    for (arch, shape), (st, err) in zip(combos, outs):
        status[st] = status.get(st, 0) + 1
        if err:
            failures.append((arch, shape, err))
    print(f"\n{len(combos)} combos in {time.perf_counter() - t0:.1f} s "
          f"({args.jobs} jobs): "
          + ", ".join(f"{k} {v}" for k, v in sorted(status.items())))
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nall dry-runs OK")


if __name__ == "__main__":
    main()
