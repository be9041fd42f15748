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
reference's abstract input specs have their counterparts here as meta
tensors where the reference builds ``ShapeDtypeStruct`` stand-ins
(:func:`batch_abstract`, :func:`cache_abstract`,
:func:`decode_tokens_abstract`, :func:`cast_params_bf16`), with
:func:`combo_supported`; ``launch/dryrun.py`` runs the step builders on
them.  Options that the reference does not have (``compute_dtype``,
``use_kernel``) pass through ``**model_kw`` to the model's loss.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import sharding as shard_lib
from repro_torch.launch.mesh import (Mesh, data_axes_of, mesh_axis_sizes,
                                     mesh_slices)
from repro_torch.models import transformer
from repro_torch.models.api import ModelAPI
from repro_torch.models.common import cast_weights
from repro_torch.optim import Optimizer, adamw
from repro_torch.optim.optimizers import tree_map
from repro_torch.train.trainer import make_train_step

# the families with a tensor-parallel layer loop (``api.tp_loss``); the
# others train sharded in the gathered regime
TP_FAMILIES = ("dense", "moe", "vlm")


def abstract_params(api: ModelAPI, dtype: torch.dtype = torch.bfloat16):
    """The arch's parameter tree on the ``meta`` device: every leaf's
    shape and dtype, nothing allocated."""
    return api.init(seed=0, device="meta", dtype=dtype)


def _decoder_len(cfg: ArchConfig, seq: int) -> int:
    if cfg.is_encoder_decoder and cfg.max_decoder_positions:
        return min(seq, cfg.max_decoder_positions)
    return seq


def _meta(shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_abstract(cfg: ArchConfig, shape: InputShape
                   ) -> Dict[str, torch.Tensor]:
    """Training / prefill batch on the ``meta`` device: int32 tokens and
    labels, and the audio family's bf16 frames (its decoder cut to
    ``max_decoder_positions``) or the VLM's bf16 patches (its text the
    rest of the sequence, at least 16 tokens)."""
    B = shape.global_batch
    S = shape.seq_len
    if cfg.family == "audio":
        S_dec = _decoder_len(cfg, S)
        return {
            "frames": _meta((B, cfg.encoder_positions, cfg.frontend.d_embed),
                            torch.bfloat16),
            "tokens": _meta((B, S_dec), torch.int32),
            "labels": _meta((B, S_dec), torch.int32),
        }
    if cfg.family == "vlm":
        n_img = cfg.frontend.n_tokens
        S_text = max(S - n_img, 16)
        return {
            "patches": _meta((B, n_img, cfg.frontend.d_embed),
                             torch.bfloat16),
            "tokens": _meta((B, S_text), torch.int32),
            "labels": _meta((B, S_text), torch.int32),
        }
    return {
        "tokens": _meta((B, S), torch.int32),
        "labels": _meta((B, S), torch.int32),
    }


def cache_abstract(api: ModelAPI, shape: InputShape):
    """The decode cache of ``shape``'s batch and sequence on the ``meta``
    device, at the window that sequence gives the arch."""
    window = api.effective_window(shape.seq_len)
    return api.init_cache(shape.global_batch, shape.seq_len, window=window,
                          device="meta")


def decode_tokens_abstract(shape: InputShape) -> torch.Tensor:
    return _meta((shape.global_batch, 1), torch.int32)


def cast_params_bf16(tree):
    """Inference-time parameter dtype (serving uses bf16 checkpoints):
    every floating leaf in bfloat16."""
    return tree_map(lambda t: t.to(torch.bfloat16)
                    if t.is_floating_point() else t, tree)


def combo_supported(cfg: ArchConfig, shape: InputShape
                    ) -> Tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, cfg.long_context_skip_reason or "no long-context path"
    if shape.is_decode and not cfg.supports_decode:
        return False, "encoder-only architecture has no decode step"
    return True, ""


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
    into the pieces); a replicated leaf is read as is.  The bytes a
    position receives a step: ``gather_bytes``, every gathered leaf
    whole (in bfloat16 with ``pre_gather``), and ``scatter_bytes``, its
    own piece of each leaf's gradient (:class:`ParamCollectives` counts
    the gradient sums of the leaves read alike too)."""
    devices: List[torch.device]
    gathers: int
    gather_bytes: int = 0
    scatter_bytes: int = 0

    @property
    def collectives(self) -> int:
        return 2 * self.gathers

    @property
    def collective_bytes(self) -> int:
        return self.gather_bytes + self.scatter_bytes


@dataclasses.dataclass(frozen=True)
class ParamCollectives:
    """The collectives a sharded train step runs on its parameters, as
    ``sharding.local_trees`` builds them and autograd sums their
    gradients, once a step each, in either regime.  ``gathers`` counts
    the leaves whose pieces a position concatenates: in the gathered
    regime every leaf cut over some axis of the mesh, gathered whole; in
    the tensor-parallel regime every leaf cut over a data axis, gathered
    over those axes into the position's "model" piece (the FSDP
    all-gather).  Each has its backward dual, the reduce-scatter of the
    gradient into the pieces.  ``reduces`` counts the leaves that the
    positions along some axis larger than 1 read alike (the axis does not
    cut them): those positions' gradients are summed (an all-reduce).
    The bytes are each collective's output on one position, in the dtype
    the pieces travel in (bfloat16 under ``pre_gather``):
    ``gather_bytes`` the gathered leaves, ``scatter_bytes`` and
    ``reduce_bytes`` the position's own piece of each gradient.  The
    loss's few scalars a position are not counted."""
    gathers: int = 0
    reduces: int = 0
    gather_bytes: int = 0
    scatter_bytes: int = 0
    reduce_bytes: int = 0

    @property
    def collectives(self) -> int:
        return 2 * self.gathers + self.reduces

    @property
    def collective_bytes(self) -> int:
        return self.gather_bytes + self.scatter_bytes + self.reduce_bytes


def param_collectives(tree, specs, mesh: Mesh,
                      dtype: Optional[torch.dtype], whole: bool
                      ) -> ParamCollectives:
    """The :class:`ParamCollectives` of ``tree``'s leaves (the float32
    masters' shapes) placed by ``specs`` on ``mesh``, travelling in
    ``dtype`` (None: as stored), gathered whole (the gathered regime) or
    over the data axes only."""
    sizes = mesh.shape
    wide = [a for a in mesh.axis_names if sizes[a] > 1]
    n = dict.fromkeys(("gathers", "reduces", "gather_bytes",
                       "scatter_bytes", "reduce_bytes"), 0)
    pairs = shard_lib.leaves(shard_lib._zip_map(
        lambda leaf, spec: [(leaf, spec)], tree, specs))
    for leaf, spec in pairs:
        size = (torch.empty((), dtype=dtype).element_size()
                if dtype is not None and leaf.is_floating_point()
                else leaf.element_size())
        piece = shard_lib.piece_numel(leaf, spec, sizes) * size
        cut = shard_lib._cut_axes(spec, sizes, mesh.axis_names)
        gathered = [a for a in cut if whole or a != "model"]
        if gathered:
            n["gathers"] += 1
            n["gather_bytes"] += piece * math.prod(sizes[a] for a in gathered)
            n["scatter_bytes"] += piece
        if any(a not in cut for a in wide):
            n["reduces"] += 1
            n["reduce_bytes"] += piece
    return ParamCollectives(**n)


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
    that does not divide them raises ``ValueError``) and each runs the
    family's ``loss_parts`` on the whole tree, and ``train_step.gather``
    is the :class:`GatherPlan`.  In both regimes
    ``train_step.param_collectives`` counts the parameters' collectives
    (:func:`param_collectives`)."""
    opt = adamw(lr, grad_clip_norm=1.0)
    if mesh is None:
        loss = make_loss_for_shape(api, shape, attn_chunk=attn_chunk,
                                   remat=remat, **model_kw)

        def loss_of(p, b):
            return loss(_bf16(p) if pre_gather else p, b)

        return make_train_step(loss_of, opt), opt
    cfg = api.cfg
    tree = abstract_params(api, torch.float32)
    if specs is None:
        specs = train_specs(api, tree, mesh)
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
        pc = step.param_collectives = param_collectives(
            tree, specs, mesh, dtype, whole=True)
        step.gather = GatherPlan(devices, pc.gathers, pc.gather_bytes,
                                 pc.scatter_bytes)
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
    step.param_collectives = param_collectives(tree, specs, mesh, dtype,
                                               whole=False)
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
