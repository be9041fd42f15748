"""Train a (reduced) assigned-architecture LLM end to end, sharded:
``python -m repro_torch.launch.train_llm [--arch gemma-7b] [--device cpu]``.

The twin of ``examples/train_llm.py``: a sharded data pipeline
(``data/pipeline.py::ShardedLoader`` over ``lm_token_batch``, a
prefetch thread) -> the sharded train step with the reference's sharding
rules (``launch/specs.py::make_train_step_fn(mesh=)`` on
``sharding.place``'s pieces) -> a checkpoint save and restore round trip
(the whole tree in the reference's format, re-placed) -> the loss falls.
The smoke variant of the dense or MoE arch by default, its published
width with ``--full``.  The mesh is every visible card as the reference
builds it (``--model-parallel``) or ``--mesh-shape dp,tp``; with
``--device cpu`` four CPU positions, 2 data slices x 2-way tensor
parallelism, unless ``--mesh-shape`` says otherwise:

    python -m repro_torch.launch.train_llm --device cpu
"""
from __future__ import annotations

import argparse
import tempfile
import time

import torch

from repro_torch.configs import get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.data.pipeline import ShardedLoader
from repro_torch.data.synthetic import lm_token_batch
from repro_torch.launch import sharding as shard_lib
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.mesh import build_mesh
from repro_torch.models.api import build_model
from repro_torch.train import checkpoint as ckpt_lib


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-7b")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--mesh-shape", default="")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.smoke_variant()
    api = build_model(cfg)
    mesh_shape = args.mesh_shape or ("2,2" if args.device == "cpu" else "")
    mesh = build_mesh(mesh_shape, args.model_parallel, args.device)
    shape = InputShape("example", args.seq, args.batch, "train")
    dev = mesh.devices.reshape(-1)[0]
    params = api.init(seed=0, device=dev, dtype=torch.float32)
    n = sum(x.numel() for x in shard_lib.leaves(params))
    print(f"{cfg.name} ({cfg.family}): {n / 1e6:.2f}M params, "
          f"mesh {mesh.shape}")
    specs = specs_lib.train_specs(api, params, mesh)
    placed = shard_lib.place(params, specs, mesh)
    del params
    step_fn, opt = specs_lib.make_train_step_fn(api, shape, lr=args.lr,
                                                mesh=mesh, specs=specs)
    opt_state = opt.init(placed)

    def make_batch(gen, batch):
        return lm_token_batch(gen, batch, args.seq, cfg.vocab_size,
                              device=gen.device)

    loader = iter(ShardedLoader(make_batch, args.batch, seed=0,
                                device=dev))
    losses = []
    t0 = time.perf_counter()
    for step in range(1, args.steps + 1):
        placed, opt_state, m = step_fn(placed, opt_state, next(loader))
        if step % 10 == 0 or step in (1, args.steps):
            losses.append(float(m["loss"]))
            print(f"  step {step:4d}  loss {losses[-1]:.4f}")
    assert losses[-1] < losses[0], "loss did not decrease"
    dt = time.perf_counter() - t0
    print(f"{args.steps} steps in {dt:.1f}s "
          f"({args.steps * args.batch * args.seq / dt:.0f} tok/s), "
          f"collectives a step per slice "
          f"{[p.collectives // args.steps for p in step_fn.plans]}")

    with tempfile.TemporaryDirectory() as d:
        ckpt_lib.save_placed(d, args.steps, placed, specs, mesh)
        restored, _ = ckpt_lib.restore_placed(d, placed, specs, mesh)
        same = all(torch.equal(a, b) for a, b in zip(
            shard_lib.leaves(restored), shard_lib.leaves(placed)))
        assert same, "the restored pieces differ from the saved ones"
        print(f"checkpoint roundtrip OK "
              f"({ckpt_lib.tree_nbytes(restored) / 1e6:.1f} MB)")
    print("train_llm OK")


if __name__ == "__main__":
    main()
