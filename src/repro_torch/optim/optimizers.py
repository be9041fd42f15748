"""Optimizers (from scratch): Adam(W), SGD+momentum, Adafactor-lite.

The counterpart of ``repro/optim/optimizers.py``, with its functional API
over (nested) dicts of tensors:

    opt = adamw(lr=1e-3, ...)
    state = opt.init(params)
    new_params, new_state = opt.update(grads, state, params)

``update`` runs under ``torch.no_grad()`` and returns new tensors; nothing
is updated in place.  ``state["step"]`` is an int32 tensor, bias
corrections are ``1 - b ** step`` in float32 and gradient clipping uses
the global norm, as in the reference.  Optimizer state trees mirror the
parameter tree.  Leaves may sit on several devices (a sharded step's
pieces, ``launch/sharding.py::place``): the norm is summed on the first
leaf's device and each leaf's update reads the step's scalars on its
own.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

Tree = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """A pair of pure functions: ``init(params) -> state`` and
    ``update(grads, state, params) -> (params, state)``."""

    init: Callable[[Tree], Tree]
    update: Callable[[Tree, Tree, Tree], Tuple[Tree, Tree]]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of nested dicts and lists (an MoE config's
    ``head_blocks``), with the matching leaves of ``rest`` (which share
    ``tree``'s structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list:
    """The leaves of nested dicts and lists, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def _zeros_f32(params: Tree) -> Tree:
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def _step0(params: Tree) -> torch.Tensor:
    dev = tree_leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


def _clip(gf: Tree, grad_clip_norm: Optional[float]) -> Tree:
    if grad_clip_norm is None:
        return gf
    scale = torch.clamp(grad_clip_norm / (global_norm(gf) + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.device), gf)


def _lr_at(lr, step: torch.Tensor):
    return lr(step) if callable(lr) else lr


def _on(x, dev: torch.device):
    """A step scalar (a tensor or a float) for a leaf on ``dev``."""
    return x.to(dev) if torch.is_tensor(x) else x


# ---------------------------------------------------------------------------
def adamw(lr: float | Callable[[torch.Tensor], Any] = 1e-3,
          b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0,
          grad_clip_norm: Optional[float] = None) -> Optimizer:
    """Adam with decoupled weight decay; ``lr`` a float or a schedule of
    the step."""
    def init(params):
        return {"step": _step0(params), "m": _zeros_f32(params),
                "v": _zeros_f32(params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        gf = _clip(tree_map(lambda g: g.to(torch.float32), grads),
                   grad_clip_norm)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], gf)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, state["v"],
                     gf)
        lr_t = _lr_at(lr, step)
        t = step.to(torch.float32)
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t

        def upd(p, m_, v_):
            dev = p.device
            d = (m_ / _on(bc1, dev)) / (torch.sqrt(v_ / _on(bc2, dev)) + eps)
            if weight_decay:
                d = d + weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - _on(lr_t, dev) * d).to(p.dtype)

        return tree_map(upd, params, m, v), {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


def adam(lr=1e-3, **kw) -> Optimizer:
    """:func:`adamw` without weight decay."""
    return adamw(lr, weight_decay=0.0, **kw)


# ---------------------------------------------------------------------------
def sgd(lr: float | Callable = 1e-2, momentum: float = 0.9,
        nesterov: bool = False,
        grad_clip_norm: Optional[float] = None) -> Optimizer:
    """SGD with (optionally Nesterov) momentum."""
    def init(params):
        return {"step": _step0(params), "mu": _zeros_f32(params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        gf = _clip(tree_map(lambda g: g.to(torch.float32), grads),
                   grad_clip_norm)
        mu = tree_map(lambda mu_, g: momentum * mu_ + g, state["mu"], gf)
        lr_t = _lr_at(lr, step)

        def upd(p, mu_, g):
            d = momentum * mu_ + g if nesterov else mu_
            return (p.to(torch.float32) - lr_t * d).to(p.dtype)

        return tree_map(upd, params, mu, gf), {"step": step, "mu": mu}

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
def adafactor(lr: float | Callable = 1e-2, eps: float = 1e-30,
              clip_threshold: float = 1.0) -> Optimizer:
    """Factored second-moment optimizer: leaves of two or more dims keep
    row and column statistics over their last two axes."""

    def init(params):
        def per_leaf(p):
            if p.dim() >= 2:
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32,
                                          device=p.device)}
            return {"v": torch.zeros_like(p, dtype=torch.float32)}

        return {"step": _step0(params), "slots": tree_map(per_leaf, params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        beta2 = 1.0 - step.to(torch.float32) ** -0.8
        lr_t = _lr_at(lr, step)

        def per_leaf(g, slot, p):
            g = g.to(torch.float32)
            g2 = g * g + eps
            if "vr" in slot:
                vr = beta2 * slot["vr"] + (1 - beta2) * g2.mean(dim=-1)
                vc = beta2 * slot["vc"] + (1 - beta2) * g2.mean(dim=-2)
                rmean = vr.mean(dim=-1, keepdim=True)
                u = g / torch.sqrt(
                    (vr / torch.clamp(rmean, min=eps))[..., None]
                    * vc[..., None, :] + eps)
                new_slot = {"vr": vr, "vc": vc}
            else:
                v = beta2 * slot["v"] + (1 - beta2) * g2
                u = g / torch.sqrt(v + eps)
                new_slot = {"v": v}
            rms_u = torch.sqrt(torch.mean(u * u) + eps)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            return (p.to(torch.float32) - lr_t * u).to(p.dtype), new_slot

        outs = _map_pairs(per_leaf, grads, state["slots"], params)
        return outs[0], {"step": step, "slots": outs[1]}

    return Optimizer(init, update)


def _map_pairs(fn: Callable, grads: Tree, slots: Tree, params: Tree
               ) -> Tuple[Tree, Tree]:
    """``fn(g, slot, p) -> (new_p, new_slot)`` over the parameter leaves;
    returns the tree of new params and the tree of new slots."""
    if isinstance(params, dict):
        pairs = {k: _map_pairs(fn, grads[k], slots[k], v)
                 for k, v in params.items()}
        return ({k: a for k, (a, _) in pairs.items()},
                {k: b for k, (_, b) in pairs.items()})
    return fn(grads, slots, params)


# ---------------------------------------------------------------------------
def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, on the first
    leaf's device."""
    leaves = tree_leaves(tree)
    dev = leaves[0].device
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32))).to(dev)
                          for x in leaves))
