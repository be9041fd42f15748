"""The paper's geographically distributed (re)training workflow on the port,
``python -m repro_torch.launch.remote_retrain_flow [--device cuda|cpu]
[--steps N] [--peaks N]``.

The counterpart of ``examples/remote_retrain_flow.py``, on
``repro_torch.core``.  An experiment at SLAC collects Bragg-peak patches;
the DNNTrainerFlow ships them to the data center, labels them there with
the pseudo-Voigt fit (LabelData: on the card through the port's Hopper
kernel), trains BraggNN on the DCAI endpoint (the port's ``h100``), ships
the model back and registers it in the edge model repository:

1. run 1 trains from scratch (v1);
2. run 2 collects new data and warm-starts from the repository's best
   foundation (v2, the paper's future-work item 1);
3. a third flow ships a further dataset and runs the
   ``overlap_label_train`` action: labeling and training pipelined over
   8 shards (A||T, future-work item 3), from the best foundation;
4. the edge serves the latest registered model through ``BatchEngine``
   on held-out patches (the E op).

Training functions end with a host read of the loss, as the reference's
do, so each state is charged the time its work ran.  It runs on the CUDA
card unless ``--device cpu`` is given, and fails unless every flow
succeeds and the surrogate's mean error at the edge is under 0.5 px.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.analysis import label_for_braggnn
from repro_torch.configs import BraggNNConfig
from repro_torch.core import build_system, dnn_trainer_flow
from repro_torch.core.transfer import FileRef
from repro_torch.data.synthetic import bragg_patches
from repro_torch.device import resolve_device
from repro_torch.models import braggnn
from repro_torch.optim import adam
from repro_torch.serving.batch import BatchEngine
from repro_torch.train import make_train_step

DC_DEVICE = "h100"           # the port's target DCAI in the topology
BATCH = 64
MODEL_BYTES = 3_000_000      # the paper's BraggNN artifact size
N_SHARDS = 8                 # A||T's pipeline stages
MAX_ERR_PX = 0.5             # the edge surrogate's mean error limit


def _collect(sys_, name: str, n: int, g: torch.Generator, dev) -> None:
    """The experiment's S/C op: ``n`` patches (and their ground truth,
    kept only to check the labels) stored at the edge facility."""
    d = bragg_patches(g, n, device=dev)
    sys_.store.put("slac", FileRef(
        name, d["patches"].numel() * 4,
        payload={"patches": d["patches"], "truth": d["centers"]}))


def _label(sys_, dataset_name: str) -> Dict[str, float]:
    """LabelData at the DC: the conventional fit labels the transferred
    patches in place; returns the labels' mean distance from the truth."""
    ref = sys_.store.get("alcf", dataset_name)
    raw = ref.payload
    labels = label_for_braggnn(raw["patches"])
    err = float((labels - raw["truth"]).abs().mean())
    sys_.store.put("alcf", FileRef(dataset_name, ref.nbytes,
                                   payload={**raw, "labels": labels}))
    return {"n": int(labels.shape[0]), "label_err": err}


def _trainer(cfg: BraggNNConfig):
    return make_train_step(lambda p, b: braggnn.loss_fn(p, b, cfg),
                           adam(1e-3))


def _train_steps(step, params, opt_state, patches, labels, steps: int):
    """``steps`` Adam steps on consecutive batches (wrapping), as the
    reference example takes them; returns (params, opt_state, loss)."""
    n = patches.shape[0]
    loss = None
    for i in range(steps):
        lo = (i * BATCH) % (n - BATCH)
        params, opt_state, m = step(params, opt_state, {
            "patches": patches[lo:lo + BATCH],
            "centers": labels[lo:lo + BATCH]})
        loss = m["loss"]
    return params, opt_state, float(loss)


def _make_train_function(sys_, cfg, steps: int, artifact_name: str, dev,
                         warm_start_from=None) -> Callable:
    """TrainModel's function: BraggNN trained on the labelled dataset at
    the DC, the model stored there as ``artifact_name``."""

    def train(dataset_name: str):
        raw = sys_.store.get("alcf", dataset_name).payload
        params = warm_start_from if warm_start_from is not None else \
            braggnn.init_params(cfg, seed=0, device=dev)
        opt_state = adam(1e-3).init(params)
        params, _, loss = _train_steps(_trainer(cfg), params, opt_state,
                                       raw["patches"], raw["labels"], steps)
        sys_.store.put("alcf", FileRef(artifact_name, MODEL_BYTES,
                                       payload=params))
        return {"final_loss": loss, "steps": steps}

    return train


def run_flow(sys_, cfg, *, version_tag: str, steps: int, peaks: int,
             seed: int, dev, warm_start=None, log=print):
    """One DNNTrainerFlow run with labeling: collect at SLAC, then
    TransferData, LabelData, TrainModel, TransferModel and RegisterModel;
    the registered entry's ``val_loss`` is the final training loss."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    dataset = f"scan_{version_tag}.h5"
    artifact = f"braggnn_{version_tag}.pt"
    _collect(sys_, dataset, peaks, g, dev)
    fx = sys_.funcx
    label_fid = fx.register_function(lambda name: _label(sys_, name),
                                     "label_braggnn")
    train_fid = fx.register_function(_make_train_function(
        sys_, cfg, steps, artifact, dev, warm_start), "train_braggnn")
    eid = fx.register_endpoint(DC_DEVICE, mode="real")
    flow_id = sys_.flows.deploy(dnn_trainer_flow(with_labeling=True))

    t_wall = time.perf_counter()
    run = sys_.flows.run(flow_id, {
        "src": "slac", "dc": "alcf", "dataset": [dataset],
        "label_endpoint": eid, "label_function": label_fid,
        "label_args": [dataset], "label_kwargs": {},
        "train_endpoint": eid, "train_function": train_fid,
        "train_args": [dataset], "train_kwargs": {},
        "modeled_duration": None,
        "model_artifacts": [artifact], "model_name": artifact,
        "register_as": "braggnn", "version_tag": version_tag,
        "metrics": {"val_loss": 0.0},   # set from the train result below
    }, sys_.user_token())
    wall = time.perf_counter() - t_wall
    if run.status != "SUCCEEDED":
        raise RuntimeError(f"flow {version_tag} {run.status}: "
                           f"{[e.error for e in run.log]}")
    train_res = run.output["TrainModel"]["result"]
    label_res = run.output["LabelData"]["result"]
    log(f"flow {version_tag}: status={run.status} "
        f"turnaround={run.turnaround:.4f}s (wall {wall:.4f}s)")
    for e in run.log:
        log(f"  {e.state:14s} {e.duration:9.4f}s")
    log(f"  labels: {label_res['n']} peaks, mean |label - truth| "
        f"{label_res['label_err']:.5f}; train final_loss="
        f"{train_res['final_loss']:.6f} ({train_res['steps']} steps)")
    sys_.repo.latest("braggnn").metrics["val_loss"] = train_res["final_loss"]
    return run


def run_overlap(sys_, cfg, *, steps: int, peaks: int, seed: int, dev,
                log=print) -> Dict:
    """A||T as a flow: TransferData, then the ``overlap_label_train``
    action labelling and training shard by shard from the repository's
    best foundation (``steps`` spread over the shards)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    dataset = "scan_overlap.h5"
    _collect(sys_, dataset, peaks, g, dev)
    best = sys_.repo.best_foundation("braggnn", "val_loss")
    per_shard = max(steps // N_SHARDS, 1)
    step = _trainer(cfg)

    def init():
        params = best.artifact.payload
        return params, adam(1e-3).init(params)

    def train_shard(state, shard, labels):
        params, opt_state, loss = _train_steps(step, *state,
                                               shard["patches"], labels,
                                               per_shard)
        return (params, opt_state), {"loss": loss}

    fx = sys_.funcx
    fns = {"label_function": fx.register_function(
               lambda shard: label_for_braggnn(shard["patches"]), "label"),
           "train_init_function": fx.register_function(init, "init"),
           "train_shard_function": fx.register_function(train_shard,
                                                        "train_shard")}
    flow_id = sys_.flows.deploy({"StartAt": "TransferData", "States": {
        "TransferData": {
            "Provider": "transfer",
            "Parameters": {"src": "slac", "dst": "alcf", "names": [dataset],
                           "label": "dataset ex->dc"},
            "Next": "LabelTrain"},
        "LabelTrain": {
            "Provider": "overlap_label_train",
            "Parameters": {"facility": "alcf", "dataset_name": dataset,
                           "n_shards": N_SHARDS,
                           "artifact_name": "braggnn_overlap.pt", **fns},
            "End": True}}})
    run = sys_.flows.run(flow_id, {}, sys_.user_token())
    if run.status != "SUCCEEDED":
        raise RuntimeError(f"A||T flow {run.status}: "
                           f"{[e.error for e in run.log]}")
    res = run.output["LabelTrain"]
    log(f"A||T over {N_SHARDS} shards ({per_shard} steps each): "
        f"serial={res['serial_s']:.4f}s pipelined={res['pipelined_s']:.4f}s "
        f"saving={res['saving_s']:.4f}s final loss "
        f"{res['metrics']['loss']:.6f}")
    for e in run.log:
        log(f"  {e.state:14s} {e.duration:9.4f}s")
    return {"run": run, **res}


def serve_at_edge(sys_, cfg, *, peaks: int, seed: int, dev,
                  log=print) -> Dict:
    """E: the latest registered model estimates held-out peak centers
    through the edge ``BatchEngine``; returns its mean error in px."""
    entry = sys_.repo.latest("braggnn")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    held = bragg_patches(g, peaks, device=dev)
    x = held["patches"].cpu().numpy()
    truth = held["centers"].cpu().numpy()
    eng = BatchEngine(lambda p, xb: braggnn.forward(p, xb, cfg),
                      entry.artifact.payload, max_batch=1024, device=dev)
    t0 = time.perf_counter()
    pred = eng.infer(x)
    sec = time.perf_counter() - t0
    err_px = float(np.abs(pred - truth).mean()) * (cfg.patch - 1)
    log(f"edge serving ({entry.name} version {entry.version}, "
        f"{entry.version_tag}): {peaks} "
        f"held-out peaks in {sec:.4f}s {eng.stats.summary()} mean |err| "
        f"{err_px:.4f} px")
    if pred.shape != (peaks, 2) or not np.isfinite(pred).all():
        raise AssertionError(f"estimates {pred.shape} not finite (n, 2)")
    return {"err_px": err_px, "seconds": sec, "entry": entry}


def run(*, steps: int = 300, peaks: int = 4096, device="cuda",
        log=print) -> Dict:
    """The whole scenario; returns the system, the three flow runs, the
    edge result and the cost model's strategy totals at ``peaks``."""
    dev = resolve_device(device)
    cfg = BraggNNConfig()
    sys_ = build_system()
    v1 = run_flow(sys_, cfg, version_tag="v1", steps=steps, peaks=peaks,
                  seed=42, dev=dev, log=log)
    best = sys_.repo.best_foundation("braggnn", "val_loss")
    log(f"best foundation: {best.version_tag} val_loss="
        f"{best.metrics['val_loss']:.6f}")
    v2 = run_flow(sys_, cfg, version_tag="v2", steps=max(steps // 3, 1),
                  peaks=peaks, seed=43, dev=dev,
                  warm_start=best.artifact.payload, log=log)
    overlap = run_overlap(sys_, cfg, steps=steps, peaks=peaks,
                          seed=44, dev=dev, log=log)
    br = sys_.clock.breakdown()
    log(f"clock: real={br['real']:.4f}s modeled={br['modeled']:.4f}s "
        f"sim(WAN+svc)={br['sim']:.4f}s total={br['total']:.4f}s")
    cm = sys_.costmodel
    strategies = {
        "conventional_dc": cm.f_conventional_dc(peaks).total,
        "conventional_ex": cm.f_conventional_ex(peaks).total,
        "ml_surrogate": cm.f_ml(peaks).total,
        "ml_pipelined": cm.f_ml_pipelined(peaks).total,
    }
    log(f"cost model at {peaks} peaks: " + " ".join(
        f"{k}={v:.4f}s" for k, v in strategies.items())
        + f" advise={cm.advise(peaks)}; measured flow v1 turnaround "
        f"{v1.turnaround:.4f}s")
    edge = serve_at_edge(sys_, cfg, peaks=peaks, seed=7, dev=dev,
                         log=log)
    versions = [e.version_tag for e in sys_.repo.versions("braggnn")]
    if versions != ["v1", "v2"]:
        raise AssertionError(f"repository holds {versions}, not v1 and v2")
    if not edge["err_px"] < MAX_ERR_PX:
        raise AssertionError(f"surrogate error {edge['err_px']:.4f} px >= "
                             f"{MAX_ERR_PX}")
    return {"system": sys_, "v1": v1, "v2": v2, "overlap": overlap,
            "edge": edge, "clock": br, "strategies": strategies}


def main(argv=None) -> None:
    """Run the scenario once; raise on a failed flow or a surrogate that
    misses the truth by MAX_ERR_PX or more on average."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--peaks", type=int, default=4096)
    args = ap.parse_args(argv)
    run(steps=args.steps, peaks=args.peaks, device=args.device)
    print("remote_retrain_flow OK")


if __name__ == "__main__":
    main()
