"""Training loop: train step with gradient accumulation, metrics, history.

The counterpart of ``repro/train/trainer.py``.  PyTorch runs eagerly, so
the step is a plain function: gradients come from ``torch.autograd.grad``
over the parameter leaves, and the optimizer's functional ``update``
returns the new parameters.  The leaves are those ``tree_leaves`` walks,
lists included, so a sharded step's state (``sharding.place``: each leaf
a list of its pieces) takes its gradients, norm and update per piece,
every element once.  ``fit`` checkpoints parameters and
optimizer state through ``train/checkpoint.py``, in the reference's
on-disk format.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.optim.optimizers import (Optimizer, global_norm, tree_leaves,
                                          tree_map)
from repro_torch.train import checkpoint as ckpt_lib

Tree = Any


@dataclasses.dataclass
class TrainState:
    """Parameters and optimizer state after ``step`` steps."""

    params: Tree
    opt_state: Tree
    step: int = 0


def _unflatten(tree: Tree, leaves: list) -> Tree:
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def make_train_step(loss_fn: Callable, optimizer: Optimizer, *,
                    grad_accum: int = 1) -> Callable:
    """loss_fn(params, batch) -> (loss, metrics dict).

    Returns step(params, opt_state, batch) -> (params, opt_state, metrics),
    metrics holding detached tensors: the loss, ``loss_fn``'s metrics and
    ``grad_norm``.  With grad_accum > 1, the batch's leading axis must be
    (grad_accum * local_batch); it is split into microbatches whose
    gradients and metrics are averaged.
    """

    def grads_of(params, batch):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        loss, metrics = loss_fn(_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return list(grads), metrics

    def step_fn(params, opt_state, batch):
        if grad_accum == 1:
            grads, metrics = grads_of(params, batch)
        else:
            grads = metrics = None
            for i in range(grad_accum):
                mb = tree_map(lambda x: x.reshape(
                    (grad_accum, x.shape[0] // grad_accum)
                    + tuple(x.shape[1:]))[i], batch)
                g, m = grads_of(params, mb)
                if grads is None:
                    grads, metrics = g, m
                else:
                    grads = [a + b for a, b in zip(grads, g)]
                    metrics = {k: metrics[k] + m[k] for k in metrics}
            grads = [g / grad_accum for g in grads]
            metrics = {k: v / grad_accum for k, v in metrics.items()}
        grads = _unflatten(params, grads)
        metrics["grad_norm"] = global_norm(grads)
        new_params, new_opt = optimizer.update(grads, opt_state, params)
        return new_params, new_opt, metrics

    return step_fn


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TrainerConfig:
    """Loop settings: with a ``ckpt_dir``, ``fit`` saves {"params",
    "opt_state"} every ``ckpt_every`` steps (0: only the final step) and
    at the end."""

    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 0            # 0 = only final
    ckpt_dir: Optional[str] = None
    grad_accum: int = 1


def fit(loss_fn: Callable, optimizer: Optimizer, params: Tree,
        data_iter, cfg: TrainerConfig,
        *, callbacks=()) -> Tuple[TrainState, Dict[str, list]]:
    """Run the loop; returns the final state and the metric history:
    ``loss`` and ``step_time`` as (step, value) pairs at step 1, every
    ``log_every`` steps and the last step, and the loop's ``wall_time``."""
    step_fn = make_train_step(loss_fn, optimizer, grad_accum=cfg.grad_accum)
    opt_state = optimizer.init(params)
    history: Dict[str, list] = {"loss": [], "step_time": []}
    t_wall = time.perf_counter()

    for step in range(1, cfg.steps + 1):
        batch = next(data_iter)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step == 1 or step % cfg.log_every == 0 or step == cfg.steps:
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            history["loss"].append((step, loss))
            history["step_time"].append((step, dt))
            for cb in callbacks:
                cb(step, metrics)
        if (cfg.ckpt_dir and cfg.ckpt_every
                and step % cfg.ckpt_every == 0):
            ckpt_lib.save_checkpoint(cfg.ckpt_dir, step,
                                     {"params": params,
                                      "opt_state": opt_state})

    if cfg.ckpt_dir:
        ckpt_lib.save_checkpoint(cfg.ckpt_dir, cfg.steps,
                                 {"params": params, "opt_state": opt_state})
    history["wall_time"] = time.perf_counter() - t_wall
    return TrainState(params, opt_state, cfg.steps), history
