"""Step functions of the port's training, prefill and serving paths: the
counterpart of ``make_loss_for_shape``, ``make_train_step_fn``,
``make_prefill_step_fn`` and ``make_serve_step_fn`` in
``repro/launch/specs.py``.

``make_train_step_fn(..., mesh=, specs=)`` is the sharded train step of
every family, the counterpart of jitting the reference's step on
``device_put`` parameters: its state is ``sharding.place``'s tree of
pieces (each element stored once, float32) and ``opt.init(placed)``;
every step hands each mesh position its local tree
(``sharding.local_trees``, in bfloat16 first with ``pre_gather``), runs
the loss in one of two regimes and updates the pieces with ``adamw``:

* tensor parallel (the dense, MoE and VLM families under specs that cut
  over "model" alone, as ``baseline`` and ``local_recurrent`` do): the
  local trees gather the "data" cuts, and each data slice's rows run
  through the family's ``tp_loss`` (tensor-parallel over the slice's
  positions);
* gathered (the audio, hybrid and ssm families, and any family under
  ``fsdp_flat`` or ``replicated``; the reference's §Perf-2 regime):
  every position's local tree is the whole tree, gathered from the
  pieces over every axis, and the rows are cut over every position, each
  running the family's one-device loss forward (``loss_parts``) with no
  collective inside it.

Either way the positions' loss sums are added before dividing
(``transformer.parts_loss``).

:func:`abstract_params` is the parameter tree on the ``meta`` device
(shapes and dtypes, no storage), which the sharding rules read.  The
reference's abstract input specs and its AOT/HLO step builders read XLA's
ahead-of-time compilation and have no counterpart here yet (ROADMAP
A10).  Options that the reference does not have (``compute_dtype``,
``use_kernel``) pass through ``**model_kw`` to the model's loss.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.shapes import InputShape
from repro_torch.launch import sharding as shard_lib
from repro_torch.launch.mesh import (Mesh, data_axes_of, mesh_axis_sizes,
                                     mesh_slices)
from repro_torch.models import transformer
from repro_torch.models.api import ModelAPI
from repro_torch.models.common import cast_weights
from repro_torch.optim import Optimizer, adamw
from repro_torch.train.trainer import make_train_step

# the families with a tensor-parallel layer loop (``api.tp_loss``); the
# others train sharded in the gathered regime
TP_FAMILIES = ("dense", "moe", "vlm")


def abstract_params(api: ModelAPI, dtype: torch.dtype = torch.bfloat16):
    """The arch's parameter tree on the ``meta`` device: every leaf's
    shape and dtype, nothing allocated."""
    return api.init(seed=0, device="meta", dtype=dtype)


def _loss_kwargs(api: ModelAPI, shape: InputShape, **kw) -> Dict[str, Any]:
    """The loss's keywords: ``kw`` and the attention window that
    ``shape``'s sequence length gives the arch (none for the audio
    family, as the reference's)."""
    if api.cfg.family != "audio":
        kw["window"] = api.effective_window(shape.seq_len)
    return kw


def make_loss_for_shape(api: ModelAPI, shape: InputShape, *,
                        attn_chunk: int = 512, remat: bool = True,
                        **model_kw) -> Callable:
    """loss(params, batch) -> (loss, metrics) at the attention window
    that ``shape``'s sequence length gives the arch; the audio family's
    loss gets no window, as the reference's."""
    kwargs = _loss_kwargs(api, shape, attn_chunk=attn_chunk, remat=remat,
                          **model_kw)

    def loss(params, batch):
        return api.loss(params, batch, **kwargs)

    return loss


def _bf16(tree):
    """Every float leaf cast to bfloat16, differentiably: the reference's
    per-step bf16 gather of the master weights, without its sharding
    constraint (one card)."""
    return cast_weights(tree, torch.bfloat16, keep_norms=False)


def train_specs(api: ModelAPI, params, mesh: Mesh,
                policy: str = "baseline"):
    """The sharded train step's parameter specs, which :func:`place
    <repro_torch.launch.sharding.place>` takes too: the reference
    launcher's ``param_specs(params, axes, data_axes, policy)`` (its
    dry-run's for ``fsdp_flat`` and ``replicated``), with the
    tensor-parallel families' per-head q/k norm scales whole, as their
    layers read them (:func:`_whole_norms`)."""
    specs = shard_lib.param_specs(params, mesh_axis_sizes(mesh),
                                  data_axes_of(mesh), policy)
    return _whole_norms(api, specs)


def _whole_norms(api: ModelAPI, specs):
    """``transformer.tp_specs`` on the backbone of a tensor-parallel
    family (the VLM's ``lm``); the other families' specs as they are."""
    family = api.cfg.family
    if family == "vlm":
        return {**specs, "lm": transformer.tp_specs(specs["lm"])}
    return transformer.tp_specs(specs) if family in TP_FAMILIES else specs


def gathers_whole(api: ModelAPI, specs) -> bool:
    """Whether the sharded step runs in the gathered regime: the family
    has no tensor-parallel layer loop, or the specs cut no leaf over
    "model" alone (``replicated``) or cut a dim over "model" jointly with
    another axis (``fsdp_flat``)."""
    if api.cfg.family not in TP_FAMILIES:
        return True
    choices = [c for spec in shard_lib.leaves(specs) for c in spec]
    joint = any(isinstance(c, tuple) and "model" in c for c in choices)
    return joint or "model" not in choices


@dataclasses.dataclass(frozen=True)
class GatherPlan:
    """The gathered regime's layout: ``devices`` are the positions
    (row-major over the mesh), each computing the whole model's loss on
    its rows; ``gathers`` counts the leaves cut over some axis of the
    mesh, each gathered whole once a step.  ``collectives`` a step by
    design: those gathers and their backward duals (the reduce-scatters
    into the pieces); a replicated leaf is read as is."""
    devices: List[torch.device]
    gathers: int

    @property
    def collectives(self) -> int:
        return 2 * self.gathers


def _rows(batch: Dict, devices) -> list:
    """The batch's rows cut over ``devices`` in order, each share on its
    device; every row is computed once."""
    b, n = batch["tokens"].shape[0], len(devices)
    if b % n:
        raise ValueError(f"a batch of {b} rows does not divide over the "
                         f"mesh's {n} positions")
    k = b // n
    return [{key: v[i * k:(i + 1) * k].to(d) for key, v in batch.items()}
            for i, d in enumerate(devices)]


def _data_slices(batch: Dict, mesh: Mesh, dp: int) -> list:
    """The batch's rows cut over the data slices by ``batch_spec``; where
    they do not divide, every slice takes the whole batch."""
    spec = shard_lib.batch_spec(tuple(batch["tokens"].shape),
                                mesh_axis_sizes(mesh), data_axes_of(mesh))
    if spec[0] is None:
        return [batch] * dp
    n = batch["tokens"].shape[0] // dp
    return [{k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            for i in range(dp)]


def make_train_step_fn(api: ModelAPI, shape: InputShape, *,
                       lr: float = 1e-4, attn_chunk: int = 512,
                       remat: bool = True, pre_gather: bool = False,
                       mesh: Optional[Mesh] = None, specs=None,
                       **model_kw) -> Tuple[Callable, Optimizer]:
    """(train_step, opt): train_step(params, opt_state, batch) ->
    (params, opt_state, metrics) with ``adamw(lr, grad_clip_norm=1.0)``;
    metrics hold the loss's metrics, ``loss`` and ``grad_norm``.

    With a ``mesh`` the step is sharded: params is ``place(params, specs,
    mesh)`` (``specs`` default: :func:`train_specs` of the arch's tree),
    the optimizer state ``opt.init`` of it, and gradients, their norm and
    the update are the pieces', each element once.  Every position's
    local tree comes from the pieces (``sharding.local_trees``; bf16 first
    with ``pre_gather``).  In the tensor-parallel regime the batch's rows
    are cut over the data slices, each slice runs the family's
    ``tp_loss`` and ``train_step.plans`` are the slices' ``TPPlan``s
    (their ``collectives``); in the gathered regime
    (:func:`gathers_whole`) the rows are cut over every position (a batch
    that does not divide them raises ``ValueError``), each runs the
    family's ``loss_parts`` on the whole tree, and ``train_step.gather``
    is the :class:`GatherPlan`."""
    opt = adamw(lr, grad_clip_norm=1.0)
    if mesh is None:
        loss = make_loss_for_shape(api, shape, attn_chunk=attn_chunk,
                                   remat=remat, **model_kw)

        def loss_of(p, b):
            return loss(_bf16(p) if pre_gather else p, b)

        return make_train_step(loss_of, opt), opt
    cfg = api.cfg
    if specs is None:
        specs = train_specs(api, abstract_params(api, torch.float32), mesh)
    elif _whole_norms(api, specs) != specs:
        raise ValueError("place the parameters with train_specs: the q/k "
                         "norm scales must be whole")
    dtype = torch.bfloat16 if pre_gather else None
    kwargs = _loss_kwargs(api, shape, attn_chunk=attn_chunk, remat=remat,
                          **model_kw)

    if gathers_whole(api, specs):
        devices = list(mesh.devices.reshape(-1))
        dst = devices[0]

        def gathered_loss(placed, batch):
            trees = shard_lib.local_trees(placed, specs, mesh, dtype=dtype,
                                          whole=True)
            return transformer.parts_loss(
                [api.loss_parts(t, rows, **kwargs)
                 for t, rows in zip(trees, _rows(batch, devices))], cfg, dst)

        step = make_train_step(gathered_loss, opt)
        step.gather = GatherPlan(devices, sum(
            bool(shard_lib._cut_axes(spec, mesh.shape, mesh.axis_names))
            for spec in shard_lib.leaves(specs)))
        return step, opt

    plans = [api.tp_plan(specs, list(m.devices.reshape(-1)))
             for m in mesh_slices(mesh)]
    tp = plans[0].tp

    def sharded_loss(placed, batch):
        local = shard_lib.local_trees(placed, specs, mesh, dtype=dtype)
        shards = [local[i * tp:(i + 1) * tp] for i in range(len(plans))]
        return api.tp_loss(shards, _data_slices(batch, mesh, len(plans)),
                           plans, **kwargs)

    step = make_train_step(sharded_loss, opt)
    step.plans = plans
    return step, opt


def make_prefill_step_fn(api: ModelAPI, shape: InputShape, *,
                         attn_chunk: int = 512, **model_kw) -> Callable:
    """prefill_step(params, batch) -> the last position's logits (B, V) in
    bfloat16, from a no-remat forward over ``batch["tokens"]`` at the
    window ``shape``'s sequence length gives the arch: what serving
    admission needs for next-token sampling.  The VLM family's forward
    also takes ``batch["patches"]`` (prepended to the tokens), the audio
    family's ``batch["frames"]`` (the encoder's input; no window, as the
    reference)."""
    family = api.cfg.family
    kw: Dict[str, Any] = dict(attn_chunk=attn_chunk, remat=False, **model_kw)
    if family != "audio":
        kw["window"] = api.effective_window(shape.seq_len)
    extra = {"vlm": "patches", "audio": "frames"}.get(family)

    def prefill_step(params, batch):
        inputs = {extra: batch[extra]} if extra else {}
        logits, _ = api.forward(params, batch["tokens"], **inputs, **kw)
        return logits[:, -1].to(torch.bfloat16)

    return prefill_step


def make_serve_step_fn(api: ModelAPI, shape: InputShape) -> Callable:
    """serve_step(params, cache, tokens) -> (logits, cache): one
    ``decode_step`` at the window of ``shape``'s sequence length."""
    window = api.effective_window(shape.seq_len)

    def serve_step(params, cache, tokens):
        return api.decode_step(params, cache, tokens, window=window)

    return serve_step
