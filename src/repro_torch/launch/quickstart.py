"""Quickstart of the port: the paper's full loop on one device,
``python -m repro_torch.launch.quickstart [--device cuda|cpu] [--steps N]``.

The counterpart of ``examples/quickstart.py``:

1. SIMULATE Bragg-peak data (the paper's S op),
2. LABEL it with the conventional pseudo-Voigt analysis (the A op -- on
   the card through the port's Hopper kernel, on the CPU through its plain
   version),
3. TRAIN BraggNN on the labeled data (the T op),
4. ESTIMATE peak centers with the trained surrogate (the E op) and compare
   against both the labels and the ground truth.

It runs on the CUDA card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.analysis import label_for_braggnn
from repro_torch.configs import BraggNNConfig
from repro_torch.data.pipeline import ShardedLoader
from repro_torch.data.synthetic import bragg_patches
from repro_torch.device import resolve_device
from repro_torch.models import braggnn
from repro_torch.optim import adam
from repro_torch.train import TrainerConfig, fit


def main(argv=None) -> None:
    """Run S, A, T and E once; raise if the surrogate misses the truth by
    0.5 px or more on average."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--steps", type=int, default=150)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = BraggNNConfig()
    params = braggnn.init_params(cfg, seed=0, device=dev)
    n_params = sum(t.numel() for t in params.values())
    print(f"BraggNN: {n_params:,} params on {dev}")

    # S + A: simulate patches, label with the conventional analysis
    def make_batch(g, bs):
        d = bragg_patches(g, bs, device=dev)
        labels = label_for_braggnn(d["patches"])   # pseudo-Voigt fit
        return {"patches": d["patches"], "centers": labels,
                "truth": d["centers"]}

    loader = ShardedLoader(make_batch, global_batch=64, prefetch=0,
                           device=dev)

    # T: train
    state, _ = fit(lambda p, b: braggnn.loss_fn(p, b, cfg), adam(1e-3),
                   params, iter(loader),
                   TrainerConfig(steps=args.steps, log_every=25),
                   callbacks=[lambda s, m: print(
                       f"  step {s:4d} loss {float(m['loss']):.5f}")])

    # E: estimate on fresh data; compare vs labels and ground truth
    g = torch.Generator(device=dev)
    g.manual_seed(999)
    test = make_batch(g, 256)
    with torch.no_grad():
        pred = braggnn.forward(state.params, test["patches"], cfg)
    patch_px = cfg.patch - 1
    err_vs_label = float((pred - test["centers"]).abs().mean()) * patch_px
    err_vs_truth = float((pred - test["truth"]).abs().mean()) * patch_px
    print(f"E: mean |err| vs pseudo-Voigt labels: {err_vs_label:.3f} px")
    print(f"E: mean |err| vs ground truth:        {err_vs_truth:.3f} px")
    if not err_vs_truth < 0.5:
        raise AssertionError("surrogate failed to learn peak localization")
    print("quickstart OK")


if __name__ == "__main__":
    main()
