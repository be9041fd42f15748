"""Sharding rules: parameter PartitionSpecs and batch/cache specs per arch.

The counterpart of ``repro/launch/sharding.py``, as pure functions of
leaf paths and shapes.  Logical roles on a mesh:
  * "data"  — batch / FSDP axis (with multi-pod, batch maps to
              ("pod", "data"));
  * "model" — tensor / expert / head axis.

Rules are (leaf-name regex, dims-from-end axis preferences).  Every
assignment is validated for divisibility against the leaf's shape and
degrades (axis dropped) when a dim does not divide, so one rule table
covers every architecture (kv heads that do not split over "model"
replicate, while the head size still FSDP-shards).  An axis preference
entry may list alternatives: the first axis (or axis tuple) that divides
the dim wins.

A spec is a :class:`PartitionSpec`, one axis choice per leaf dim: None,
an axis name or a tuple of axis names.  Trees are the port's nested dicts
and lists; a leaf's path joins dict keys and list indices with "/"
(``head_blocks/0/attn/wq``), as the reference's ``_path_str`` does.
:func:`shard_tree` cuts a tree into one local tree per mesh position.
The reference's ``maybe_shard`` and ``models.common.constrain`` are
sharding hints to XLA's partitioner, which an eager program has no use
for, so they have no counterpart.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

PyTree = Any
AxisChoice = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """One axis choice per dim of a leaf (a tuple, as jax's)."""

    def __new__(cls, *entries: AxisChoice) -> "PartitionSpec":
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec

# dims counted FROM THE END of the leaf shape; leading (layer-stack) dims
# are automatically unsharded.
#   entry = list of alternatives tried in order; each alternative is an axis
#   name or tuple of axis names (mapped jointly).
RULES: List[Tuple[str, Tuple[Sequence[AxisChoice], ...]]] = [
    # --- MoE ---------------------------------------------------------------
    (r"experts_w_(gate|up)$", (["model"], ["data"], [None])),   # (E, d, h)
    (r"experts_w_down$", (["model"], [None], ["data"])),        # (E, h, d)
    (r"router$", ([None], ["model"])),                          # (d, E)
    # --- attention -----------------------------------------------------------
    (r"\bwq$", (["data"], ["model"], [None])),                  # (d, H, D)
    # kv heads that don't divide the model axis REPLICATE (never D-shard:
    # a sharded contraction dim turns every score product into a reduce)
    (r"\bw(k|v)$", (["data"], ["model", None], [None])),        # (d,Hkv,D)
    (r"\bwo$", (["model"], [None], ["data"])),                  # (H, D, d)
    (r"b(q|k|v)$", (["model", None], [None])),                  # (H, D)
    # --- MLP ------------------------------------------------------------------
    (r"w_(gate|up|z)$", (["data"], ["model"])),                 # (d, ff)
    (r"(w_down|ffn_down)$", (["model"], ["data"])),             # (ff, d)
    (r"ffn_(gate|up)$", (["data"], ["model"])),
    (r"b_up$", (["model"],)),
    # --- embeddings / head ------------------------------------------------------
    (r"\bembedding$", (["model"], ["data"])),                   # (V, d)
    (r"head/w$|head.*\bw$", (["data"], ["model"])),             # (d, V)
    (r"dec_pos$", ([None], ["model", "data", None])),
    (r"frame_proj$|projector/w1$", ([None], ["model", "data", None])),
    (r"projector/w2$", (["model", "data", None], [None])),
    # --- mamba2 --------------------------------------------------------------
    (r"mamba/w_in$|\bw_in$", (["data"], ["model"])),            # (d, big)
    (r"conv_w$", ([None], ["model", "data", None])),            # (K, Cd)
    (r"conv_b$", (["model", "data", None],)),
    (r"mamba/w_out$", (["model"], ["data"])),                   # (d_in, d)
    (r"norm_scale$", (["model", "data", None],)),
    # --- xlstm ----------------------------------------------------------------
    (r"w_if$", (["data"], [None])),                             # (d_in, 2H)
    (r"r_gates$", ([None], ["model", None], [None])),           # (4,H,hd,hd)
    (r"w_gates$", (["data"], ["model", "data", None])),         # (d, 4d)
    (r"out_norm_scale$", (["model", "data", None],)),
]

_DEFAULT: Tuple[Sequence[AxisChoice], ...] = ((None,),)

# sharding-policy overrides, prepended to RULES (first match wins)
POLICY_OVERRIDES: Dict[str, List[Tuple[str, Tuple[Sequence[AxisChoice],
                                                  ...]]]] = {
    # the paper-faithful baseline
    "baseline": [],
    # small models: pure data parallelism, every parameter replicated
    "replicated": [(r".", ((None,), (None,), (None,), (None,), (None,)))],
    # recurrent stacks: FSDP for the big projections, but everything the
    # per-timestep sLSTM scan body touches replicated
    "local_recurrent": [
        (r"r_gates$", ((None,), (None,), (None,), (None,))),
        (r"w_gates$", (["data"], (None,))),
        (r"b_gates$", ((None,),)),
    ],
}


def _axis_size(mesh_axes: Dict[str, int], choice: AxisChoice) -> int:
    if choice is None:
        return 1
    if isinstance(choice, tuple):
        n = 1
        for a in choice:
            n *= mesh_axes[a]
        return n
    return mesh_axes[choice]


def has_axis(spec: Sequence[AxisChoice], axis: str = "model") -> bool:
    """Whether any dim of ``spec`` is cut over ``axis``."""
    return any(s == axis or (isinstance(s, tuple) and axis in s)
               for s in spec)


def spec_for_leaf(path: str, shape: Tuple[int, ...],
                  mesh_axes: Dict[str, int],
                  data_axes: Tuple[str, ...] = ("data",),
                  policy: str = "baseline") -> PartitionSpec:
    """A leaf's PartitionSpec by rule table and divisibility."""
    prefs: Optional[Tuple[Sequence[AxisChoice], ...]] = None
    for pattern, p in POLICY_OVERRIDES.get(policy, []) + RULES:
        if re.search(pattern, path):
            prefs = p
            break
    if prefs is None:
        prefs = _DEFAULT

    ndim = len(shape)
    spec: List[AxisChoice] = [None] * ndim
    used: set = set()
    for k, alternatives in enumerate(prefs):      # applied from the end
        dim = ndim - len(prefs) + k
        if dim < 0:
            continue
        for alt in alternatives:
            if alt is None:
                break
            # "data" expands to the full batch axes tuple (pod + data)
            cand: AxisChoice = alt
            if alt == "data" and len(data_axes) > 1:
                cand = tuple(data_axes)
            names = cand if isinstance(cand, tuple) else (cand,)
            if any(n in used for n in names):
                continue
            # an axis the mesh doesn't carry can't be assigned (a serving
            # mesh restricted to {"model": tp} skips every "data" choice)
            if any(n not in mesh_axes for n in names):
                continue
            if shape[dim] % _axis_size(mesh_axes, cand) == 0:
                spec[dim] = cand
                used.update(names)
                break

    # attention projections whose head dim cannot take the model axis
    # replicate outright (keeping the d dim FSDP-sharded would reduce the
    # replicated-batch activations instead of gathering the small weight)
    if re.search(r"\bw[qkvo]$", path) and not has_axis(spec):
        return P(*([None] * ndim))
    return P(*spec)


def _map_with_path(fn: Callable[[str, Any], Any], tree: PyTree,
                   prefix: str = "") -> PyTree:
    """``fn(path, leaf)`` over a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, f"{prefix}{i}/")
                for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


def _fsdp_flat_spec(shape: Tuple[int, ...],
                    mesh_axes: Dict[str, int]) -> PartitionSpec:
    """Weight storage sharded over the whole mesh (one dim over ("pod",
    "data", "model") combined), gathered at use, compute purely
    data-parallel: for models whose head structure does not divide the
    model axis."""
    all_axes = tuple(a for a in ("pod", "data", "model") if a in mesh_axes)
    # small leaves stay replicated
    n_elem = 1
    for s in shape:
        n_elem *= s
    if n_elem < (1 << 23):
        return P(*([None] * len(shape)))
    # combined suffixes, then single axes, largest dim first
    dims = sorted(range(len(shape)), key=lambda i: -shape[i])
    for k in range(len(all_axes), 0, -1):
        axes = all_axes[-k:]
        n = 1
        for a in axes:
            n *= mesh_axes[a]
        for dim in dims:
            if shape[dim] % n == 0 and shape[dim] >= n:
                spec: List[AxisChoice] = [None] * len(shape)
                spec[dim] = axes if len(axes) > 1 else axes[0]
                return P(*spec)
    return P(*([None] * len(shape)))


def param_specs(tree: PyTree, mesh_axes: Dict[str, int],
                data_axes: Tuple[str, ...] = ("data",),
                policy: str = "baseline") -> PyTree:
    """Specs for a whole parameter (or optimizer-state) tree."""
    def per_leaf(path, leaf):
        shape = tuple(leaf.shape)
        if policy == "fsdp_flat":
            return _fsdp_flat_spec(shape, mesh_axes)
        return spec_for_leaf(path, shape, mesh_axes, data_axes, policy)

    return _map_with_path(per_leaf, tree)


def serving_param_specs(tree: PyTree, mesh_axes: Dict[str, int]) -> PyTree:
    """Tensor-parallel-only parameter specs for the serving engines: the
    rule table with the visible mesh restricted to ``{"model": tp}``, so
    every data alternative is skipped while the GQA degradation (wk/wv
    replicated where the kv heads do not divide) stays."""
    tp_axes = {"model": mesh_axes.get("model", 1)}
    return param_specs(tree, tp_axes, data_axes=())


def paged_pool_specs(cache: PyTree, mesh_axes: Dict[str, int]) -> PyTree:
    """Specs for a paged-KV serving cache (``init_paged_cache``).

    The 5-D floating K/V pools ``(layers, num_blocks, block_size, Hkv,
    D)`` shard their kv-head dim over "model"; the block axis stays whole
    on every shard, so block tables, CoW copies and transfers address the
    same physical block ids everywhere.  When Hkv does not divide the
    axis the pool replicates.  Everything else (block tables, per-token
    metadata, int8 pools and their scales) replicates.
    """
    m = mesh_axes.get("model", 1)

    def per_leaf(_, leaf):
        shape = tuple(leaf.shape)
        spec: List[AxisChoice] = [None] * len(shape)
        if (len(shape) == 5 and leaf.dtype.is_floating_point
                and shape[-2] % m == 0 and shape[-2] >= m):
            spec[-2] = "model"
        return P(*spec)

    return _map_with_path(per_leaf, cache)


# ---------------------------------------------------------------------------
def batch_spec(shape: Tuple[int, ...], mesh_axes: Dict[str, int],
               data_axes: Tuple[str, ...] = ("data",)) -> PartitionSpec:
    """The leading (batch) dim over the batch axes where it divides,
    degrading to fewer axes, then to replication, for small batches."""
    b = shape[0]
    for k in range(len(data_axes), 0, -1):
        axes = tuple(data_axes[-k:])
        n = 1
        for a in axes:
            n *= mesh_axes[a]
        if b % n == 0:
            ax: AxisChoice = axes if len(axes) > 1 else axes[0]
            return P(ax, *([None] * (len(shape) - 1)))
    return P(*([None] * len(shape)))


def cache_specs(tree: PyTree, mesh_axes: Dict[str, int],
                data_axes: Tuple[str, ...] = ("data",)) -> PyTree:
    """Dense KV-cache and recurrent-state specs: the first dim that the
    data axes divide goes to them, then the slot dim (else the kv-head
    dim) of a KV cache, or the second-to-last dim of a smaller leaf, to
    "model" where it divides.  Integer bookkeeping replicates."""
    def per_leaf(_, leaf):
        shape = tuple(leaf.shape)
        ndim = len(shape)
        spec: List[AxisChoice] = [None] * ndim
        if ndim == 0:
            return P()
        if leaf.dtype in (torch.int32, torch.int64):
            return P(*spec)
        data_dim = -1
        for k in range(len(data_axes), 0, -1):
            axes = tuple(data_axes[-k:])
            n = 1
            for a in axes:
                n *= mesh_axes[a]
            for dim in range(ndim - 1):
                if shape[dim] % n == 0 and shape[dim] >= n:
                    spec[dim] = axes if len(axes) > 1 else axes[0]
                    data_dim = dim
                    break
            if data_dim >= 0:
                break
        # KV caches (..., B, S, Hkv, D) shard the slot dim S, never the
        # head dim D; heads only when they divide
        m = mesh_axes.get("model", 1)
        candidates = []
        if ndim >= 4:
            candidates = [ndim - 3, ndim - 2]      # slots, then kv heads
        elif ndim >= 2:
            candidates = [ndim - 2]
        for dim in candidates:
            if dim <= data_dim or dim < 0 or spec[dim] is not None:
                continue
            if shape[dim] % m == 0 and shape[dim] >= m:
                spec[dim] = "model"
                break
        return P(*spec)

    return _map_with_path(per_leaf, tree)


# ---------------------------------------------------------------------------
def _local(leaf: torch.Tensor, spec: PartitionSpec, coords: Dict[str, int],
           sizes: Dict[str, int]) -> torch.Tensor:
    """The block of ``leaf`` at mesh coordinates ``coords``: each dim cut
    into the product of its axes' sizes, the piece indexed row-major over
    those axes."""
    out = leaf
    for dim, choice in enumerate(spec):
        if choice is None:
            continue
        names = choice if isinstance(choice, tuple) else (choice,)
        n, idx = 1, 0
        for a in names:
            idx = idx * sizes[a] + coords[a]
            n *= sizes[a]
        size = leaf.shape[dim] // n
        out = out.narrow(dim, idx * size, size)
    return out


def shard_tree(tree: PyTree, specs: PyTree, mesh) -> List[PyTree]:
    """One local tree per mesh position (row-major over the mesh): each
    leaf cut by its spec into one contiguous tensor on that position's
    device.  A cut along the leaf's first cut dim with nothing cut before
    it is a contiguous view and costs no copy on the leaf's own device; a
    replicated leaf is shared, not copied, where the position sits on the
    leaf's device."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    out = []
    for flat, dev in enumerate(mesh.devices.reshape(-1)):
        coords = dict(zip(mesh.axis_names,
                          np.unravel_index(flat, mesh.devices.shape)))

        def per_leaf(leaf, spec, _c=coords, _d=dev):
            return _local(leaf, spec, _c, sizes).to(_d).contiguous()

        out.append(_zip_map(per_leaf, tree, specs))
    return out


def _zip_map(fn, tree: PyTree, specs: PyTree) -> PyTree:
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip_map(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, specs)


def leaves(tree: PyTree) -> List:
    """The leaves of a tree of dicts and lists, in key order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]
