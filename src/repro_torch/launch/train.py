"""Training launcher of the port:
``python -m repro_torch.launch.train --arch <id> [--full] [--device cuda|cpu]``.

Runs real training steps of any registered arch (``gemma-7b``,
``llava-next-mistral-7b``, ``zamba2-2.7b``, ``xlstm-1.3b``,
``whisper-base``, ...): float32 master weights from seed 0, a bfloat16
forward, AdamW with global-norm clipping
(``launch/specs.py::make_train_step_fn``), on synthetic bigram batches
(``data/synthetic.py::lm_token_batch``, one seed per step); the VLM's
patch embeddings and the audio family's frame embeddings are drawn from
a normal distribution with the step's generator, as the reference's
launcher draws them.  The smoke variant of the arch by default, its
published width with ``--full``.  It runs on the CUDA card, where
attention goes through the flash-attention kernels forward and backward
(the recurrent families' scans through their plain chunkwise forms: the
scan kernels have no backward), unless ``--device cpu`` is given.

``--model-parallel N`` trains sharded over the reference's host mesh
(every visible card, (cards / N) data slices x N-way tensor parallelism;
``launch/mesh.py::build_mesh``), ``--mesh-shape dp,tp`` over the first
dp x tp cards; with ``--device cpu`` the positions are CPU positions
(``--model-parallel N``: N of them), which run every shard's layers and
reduces on the CPU.  The float32 masters are placed once by the
reference's ``param_specs`` under its ``baseline`` policy
(``launch/specs.py::train_specs``, ``sharding.place``), each step's
``lm_token_batch`` is drawn whole and cut by rows, and a checkpoint
holds the whole tree (``sharding.unshard``) in the reference's format.
Every family trains sharded: the dense, MoE and VLM families
tensor-parallel over each data slice's positions, the audio, hybrid and
ssm families in the gathered regime (each position gathers the whole
tree and runs the one-device loss on its share of the rows, which the
positions must divide), with per-layer remat on one card or several:

    python -m repro_torch.launch.train --arch gemma-7b --device cpu \\
        --mesh-shape 2,2
    python -m repro_torch.launch.train --arch xlstm-1.3b --device cpu \\
        --mesh-shape 2,2
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.data.synthetic import lm_token_batch
from repro_torch.device import resolve_device
from repro_torch.launch import sharding as shard_lib
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.mesh import build_mesh
from repro_torch.models.api import build_model
from repro_torch.train import checkpoint as ckpt_lib


def frontend_inputs(cfg, batch: int, gen: torch.Generator, device) -> dict:
    """The stubbed frontend's embeddings a batch needs, drawn N(0, 1) from
    ``gen`` in bfloat16: ``frames`` (batch, encoder_positions, d_embed) for
    the audio family, ``patches`` (batch, n_tokens, d_embed) for the VLM;
    nothing for the other families."""
    if cfg.family == "audio":
        shape = (batch, cfg.encoder_positions, cfg.frontend.d_embed)
        name = "frames"
    elif cfg.family == "vlm":
        shape = (batch, cfg.frontend.n_tokens, cfg.frontend.d_embed)
        name = "patches"
    else:
        return {}
    x = torch.randn(shape, generator=gen, device=gen.device)
    return {name: x.to(device=device, dtype=torch.bfloat16)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--full", action="store_true",
                    help="use the full (non-smoke) config")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="tensor-parallel degree over every visible card "
                         "(N CPU positions with --device cpu)")
    ap.add_argument("--mesh-shape", default="",
                    help='"dp,tp" mesh: dp data-parallel slices x tp-way '
                         "tensor-parallel shards each")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.smoke_variant()
    api = build_model(cfg)
    mesh = build_mesh(args.mesh_shape, args.model_parallel, args.device)
    if mesh is not None and mesh.devices.size == 1:
        mesh = None
    dev = (resolve_device(args.device) if mesh is None
           else mesh.devices.reshape(-1)[0])
    shape = InputShape("cli_train", args.seq, args.batch, "train")
    print(f"device {dev}; mesh "
          f"{mesh.shape if mesh is not None else None}; arch {cfg.name} "
          f"({cfg.family}); L={cfg.n_layers} d={cfg.d_model}")

    params = api.init(seed=0, device=dev, dtype=torch.float32)
    specs = None
    if mesh is not None:
        specs = specs_lib.train_specs(api, params, mesh)
        params = shard_lib.place(params, specs, mesh)
    step_fn, opt = specs_lib.make_train_step_fn(api, shape, lr=args.lr,
                                                mesh=mesh, specs=specs)
    opt_state = opt.init(params)
    gen = torch.Generator()

    t0 = time.perf_counter()
    losses = []
    for step in range(1, args.steps + 1):
        gen.manual_seed(step)
        batch = lm_token_batch(gen, args.batch, args.seq, cfg.vocab_size,
                               device=dev)
        batch.update(frontend_inputs(cfg, args.batch, gen, dev))
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % args.log_every == 0 or step == 1:
            loss = float(metrics["loss"])
            losses.append(loss)
            print(f"step {step:5d}  loss {loss:.4f}  "
                  f"grad_norm {float(metrics['grad_norm']):.3f}  "
                  f"({(time.perf_counter() - t0) / step:.3f}s/step)")
    assert np.isfinite(losses[-1]), "training diverged"
    if mesh is not None and hasattr(step_fn, "plans"):
        print(f"collectives a step per slice: "
              f"{[p.collectives // args.steps for p in step_fn.plans]}")
    elif mesh is not None:
        print(f"gathered on {len(step_fn.gather.devices)} positions: "
              f"collectives a step {step_fn.gather.collectives} (gathers "
              "and their duals)")
    if mesh is not None:
        params = shard_lib.unshard(params, specs, mesh)
    if args.ckpt_dir:
        ckpt_lib.save_checkpoint(args.ckpt_dir, args.steps,
                                 {"params": params})
        print(f"checkpoint saved to {args.ckpt_dir}")
    print("done")


if __name__ == "__main__":
    main()
