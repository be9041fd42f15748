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
:func:`shard_tree` cuts a tree into one local tree per mesh position
(serving).  Sharded training stores each element once: :func:`place` is
the counterpart of ``jax.device_put(params, to_named(specs, mesh))``,
:func:`local_trees` hands every position its differentiable local tree
(the FSDP all-gather over "data", or over every axis for a step that
gathers whole weights; its backward is the reduce-scatter) and
:func:`unshard` rebuilds the whole tree.  The reference's
``maybe_shard`` and ``models.common.constrain`` are sharding hints to
XLA's partitioner, which an eager program has no use for, so they have
no counterpart.
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


# the fsdp_flat policy replicates leaves of fewer elements
FSDP_FLAT_MIN_ELEMENTS = 1 << 23


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
    if n_elem < FSDP_FLAT_MIN_ELEMENTS:
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
    """``fn(leaf, spec)`` down the structure of ``specs`` (so a placed
    leaf, a list of pieces, reaches ``fn`` whole)."""
    if isinstance(specs, dict):
        return {k: _zip_map(fn, tree[k], v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_zip_map(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, specs)


def leaves(tree: PyTree) -> List:
    """The leaves of a tree of dicts and lists, in key order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# Placement for sharded training: every element stored once
# ---------------------------------------------------------------------------
def _cut_axes(spec: PartitionSpec, sizes: Dict[str, int],
              axis_names: Sequence[str]) -> List[str]:
    """The mesh axes (in mesh order) that cut a leaf: named by its spec and
    larger than 1."""
    return [a for a in axis_names if sizes[a] > 1 and has_axis(spec, a)]


def _pieces(mesh, spec: PartitionSpec):
    """(coords, position index) of a leaf's distinct pieces, in row-major
    order over the axes that cut it: each piece sits on the first position
    that holds it (every other axis at 0)."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    cut = _cut_axes(spec, sizes, mesh.axis_names)
    out = []
    for idx in np.ndindex(*[sizes[a] for a in cut]):
        coords = dict.fromkeys(mesh.axis_names, 0)
        coords.update(zip(cut, idx))
        flat = int(np.ravel_multi_index(
            [coords[a] for a in mesh.axis_names], mesh.devices.shape))
        out.append((coords, flat))
    return out


def place(tree: PyTree, specs: PyTree, mesh) -> PyTree:
    """The tree with each leaf replaced by the list of its distinct pieces:
    one tensor per combination of the mesh axes its spec cuts (row-major
    over them, in mesh order), on the first position that holds it, so
    every element is stored once (a replicated leaf is one piece).  A
    piece cut along the leaf's first cut dim with nothing cut before it
    is a view of the leaf where the leaf already sits on its device."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    devices = mesh.devices.reshape(-1)

    def per_leaf(leaf, spec):
        return [_local(leaf, spec, coords, sizes).to(devices[flat])
                .contiguous() for coords, flat in _pieces(mesh, spec)]

    return _zip_map(per_leaf, tree, specs)


def _gather_dims(spec: PartitionSpec, sizes: Dict[str, int], whole: bool
                 ) -> List[Tuple[int, Tuple[str, ...]]]:
    """(dim, axes) of the dims a local tree concatenates, over their axes
    larger than 1: with ``whole`` every cut dim (a dim cut jointly over
    ("data", "model"), the ``fsdp_flat`` policy, over both, row-major in
    the spec's order), else the dims cut over data axes (every axis but
    "model").  A dim cut over "model" jointly with a data axis has no
    tensor-parallel piece, so it is gathered only whole."""
    out = []
    for dim, choice in enumerate(spec):
        if choice is None:
            continue
        names = tuple(a for a in (choice if isinstance(choice, tuple)
                                  else (choice,)) if sizes[a] > 1)
        if not whole and "model" in names and len(names) > 1:
            raise ValueError(
                f"a dim cut over {names} jointly (the fsdp_flat policy) "
                "is gathered only whole (whole=True)")
        if not whole:
            names = tuple(a for a in names if a != "model")
        if names:
            out.append((dim, names))
    return out


def local_trees(placed: PyTree, specs: PyTree, mesh, *,
                dtype: Optional[torch.dtype] = None,
                whole: bool = False) -> List[PyTree]:
    """One local tree per mesh position (row-major over the mesh), built
    differentiably from the pieces of :func:`place`: a leaf's cuts over
    "model" are that position's piece, its cuts over the data axes are
    the pieces concatenated along their dims (the FSDP all-gather; its
    backward sums the positions' gradients into each piece, the
    reduce-scatter).  With ``whole`` the cuts over "model" are
    concatenated too, so every position holds the whole tree (the
    gathered regime of sharded training).  With ``dtype`` every float
    piece is cast to it once, before the concatenation (the reference's
    ``pre_gather`` bf16 gather).  A piece that needs no cast, no move and
    no concatenation is handed over as is, and positions on one device
    that assemble the same leaf share it, so a replicated leaf's gradient
    sums over the positions that read it."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    flat_devices = mesh.devices.reshape(-1)
    memo: Dict[Tuple[int, torch.device], torch.Tensor] = {}
    built: Dict[Tuple, torch.Tensor] = {}

    def fetch(piece: torch.Tensor, dev: torch.device) -> torch.Tensor:
        key = (id(piece), dev)
        if key not in memo:
            t = piece
            if dtype is not None and t.is_floating_point():
                t = memo.setdefault((id(piece), None), t.to(dtype))
            memo[key] = t.to(dev)
        return memo[key]

    out = []
    for flat, dev in enumerate(flat_devices):
        here = dict(zip(mesh.axis_names,
                        np.unravel_index(flat, mesh.devices.shape)))

        def per_leaf(pieces, spec, _here=here, _dev=dev):
            cut = _cut_axes(spec, sizes, mesh.axis_names)
            dims = _gather_dims(spec, sizes, whole)
            gathered = {a for _, names in dims for a in names}
            key = (id(pieces), _dev, tuple(_here[a] for a in cut
                                           if a not in gathered))
            if key in built:
                return built[key]
            index = {tuple(c[a] for a in cut): i for i, (c, _) in
                     enumerate(_pieces(mesh, spec))}

            def assemble(coords, dims):
                if not dims:
                    return fetch(pieces[index[tuple(coords[a] for a in cut)]],
                                 _dev)
                dim, names = dims[0]
                parts = [assemble({**coords, **dict(zip(names, idx))},
                                  dims[1:])
                         for idx in np.ndindex(*[sizes[a] for a in names])]
                return torch.cat(parts, dim=dim)

            built[key] = assemble(dict(_here), dims)
            return built[key]

        out.append(_zip_map(per_leaf, placed, specs))
    return out


@torch.no_grad()
def unshard(placed: PyTree, specs: PyTree, mesh) -> PyTree:
    """The whole tree of :func:`place`'s pieces, each leaf on its first
    piece's device."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))

    def per_leaf(pieces, spec):
        first = pieces[0]
        shape = list(first.shape)
        for dim, choice in enumerate(spec):
            if choice is not None:
                for a in (choice if isinstance(choice, tuple) else (choice,)):
                    shape[dim] *= sizes[a]
        whole = torch.empty(shape, dtype=first.dtype, device=first.device)
        for piece, (coords, _) in zip(pieces, _pieces(mesh, spec)):
            _local(whole, spec, coords, sizes).copy_(piece)
        return whole

    return _zip_map(per_leaf, placed, specs)
