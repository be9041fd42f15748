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
``--model-parallel`` above 1 needs sharded training (ROADMAP A9b).
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
from repro_torch.launch import specs as specs_lib
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
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.model_parallel > 1:
        raise NotImplementedError(
            "--model-parallel > 1 needs sharded training, not ported "
            "yet (ROADMAP A9b)")

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.smoke_variant()
    api = build_model(cfg)
    dev = resolve_device(args.device)
    shape = InputShape("cli_train", args.seq, args.batch, "train")
    print(f"device {dev}; arch {cfg.name} ({cfg.family}); "
          f"L={cfg.n_layers} d={cfg.d_model}")

    params = api.init(seed=0, device=dev, dtype=torch.float32)
    step_fn, opt = specs_lib.make_train_step_fn(api, shape, lr=args.lr)
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
    if args.ckpt_dir:
        ckpt_lib.save_checkpoint(args.ckpt_dir, args.steps,
                                 {"params": params})
        print(f"checkpoint saved to {args.ckpt_dir}")
    print("done")


if __name__ == "__main__":
    main()
