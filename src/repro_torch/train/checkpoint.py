"""Checkpointing: save and restore trees of tensors with a manifest and
integrity checks, in the reference's on-disk format.

The counterpart of ``repro/train/checkpoint.py``, and file-compatible
with it: one ``ckpt_<step>.npz`` per checkpoint beside a
``ckpt_<step>.json`` manifest mapping each leaf's tree path
("params/blocks/attn/wq") to its array, with dtype, shape and a crc32
over the stored bytes, checked on restore.  bfloat16 and float8_e4m3fn
leaves are stored as their uint16 / uint8 bit patterns (npz cannot hold
them) under their own dtype name, so either package restores what the
other wrote without ``ml_dtypes``.  Leaves are written in sorted path
order, as the reference flattens dicts.  A sharded step's state (each
leaf a list of its pieces, ``launch/sharding.py::place``) is saved whole
(:func:`save_placed`), as the reference saves its sharded arrays, and
restored into pieces (:func:`restore_placed`).
"""
from __future__ import annotations

import json
import os
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.launch import sharding as shard_lib

Tree = Any

# extension dtypes stored as bit-equivalent unsigned integers: name ->
# (torch dtype, its signed integer view in torch and numpy, the stored
# unsigned numpy type)
_EXT_DTYPES = {
    "bfloat16": (torch.bfloat16, torch.int16, np.int16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.int8, np.int8, np.uint8),
}


def _to_storable(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    t = t.detach().cpu()
    for name, (dt, signed, _, stored) in _EXT_DTYPES.items():
        if t.dtype == dt:
            return t.view(signed).numpy().view(stored), name
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_storable(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name in _EXT_DTYPES:
        dt, _, signed, _ = _EXT_DTYPES[dtype_name]
        return torch.from_numpy(arr.view(signed)).view(dt)
    return torch.from_numpy(arr)


def _flatten_with_paths(tree: Tree, prefix: str = ""
                        ) -> List[Tuple[str, Any]]:
    """(path, leaf) pairs of nested dicts (keys sorted at every level) and
    lists (an MoE config's ``head_blocks``; their indices in the path), as
    the reference's ``jax.tree_util`` paths."""
    if isinstance(tree, dict):
        flat = []
        for k in sorted(tree):
            flat += _flatten_with_paths(tree[k], f"{prefix}{k}/")
        return flat
    if isinstance(tree, list):
        flat = []
        for i, v in enumerate(tree):
            flat += _flatten_with_paths(v, f"{prefix}{i}/")
        return flat
    return [(prefix[:-1], tree)]


def save_checkpoint(directory: str, step: int, tree: Tree, *,
                    extra: Optional[Dict] = None, keep: int = 3) -> str:
    """Write ``tree`` (nested dicts and lists of tensors) as checkpoint
    ``step``,
    keeping the newest ``keep``.  Returns the path without suffix."""
    os.makedirs(directory, exist_ok=True)
    flat = [(k, *_to_storable(torch.as_tensor(a)))
            for k, a in _flatten_with_paths(tree)]
    arrays = {f"a{i}": arr for i, (_k, arr, _d) in enumerate(flat)}
    manifest = {
        "step": step,
        "entries": [
            {"path": k, "array": f"a{i}", "dtype": d,
             "shape": list(a.shape),
             "crc32": zlib.crc32(np.ascontiguousarray(a).tobytes())}
            for i, (k, a, d) in enumerate(flat)
        ],
        "extra": extra or {},
    }
    base = os.path.join(directory, f"ckpt_{step:08d}")
    np.savez(base + ".npz", **arrays)
    with open(base + ".json", "w") as f:
        json.dump(manifest, f)
    _retain(directory, keep)
    return base


def _retain(directory: str, keep: int) -> None:
    ckpts = sorted(f for f in os.listdir(directory)
                   if f.startswith("ckpt_") and f.endswith(".json"))
    for old in ckpts[:-keep]:
        step_tag = old[:-5]
        for suffix in (".json", ".npz"):
            p = os.path.join(directory, step_tag + suffix)
            if os.path.exists(p):
                os.remove(p)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(f[5:13]) for f in os.listdir(directory)
             if f.startswith("ckpt_") and f.endswith(".json")]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, template: Tree,
                       step: Optional[int] = None) -> Tuple[Tree, Dict]:
    """Restore into the structure of ``template``: each leaf's shape and
    crc32 are checked, and it comes back in the template leaf's dtype and
    on its device."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    base = os.path.join(directory, f"ckpt_{step:08d}")
    with open(base + ".json") as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["entries"]}

    def restore(node, prefix: str):
        if isinstance(node, dict):
            return {k: restore(v, f"{prefix}{k}/") for k, v in node.items()}
        if isinstance(node, list):
            return [restore(v, f"{prefix}{i}/") for i, v in enumerate(node)]
        key = prefix[:-1]
        if key not in by_path:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        e = by_path[key]
        arr = data[e["array"]]
        if list(arr.shape) != list(node.shape):
            raise ValueError(f"shape mismatch at {key}: ckpt {arr.shape} vs "
                             f"template {tuple(node.shape)}")
        if zlib.crc32(np.ascontiguousarray(arr).tobytes()) != e["crc32"]:
            raise IOError(f"crc mismatch at {key} (corrupt checkpoint)")
        return _from_storable(arr, e["dtype"]).to(device=node.device,
                                                  dtype=node.dtype)

    with np.load(base + ".npz") as data:
        return restore(template, ""), manifest


def save_placed(directory: str, step: int, placed: Tree, specs: Tree,
                mesh, **kw) -> str:
    """:func:`save_checkpoint` of ``{"params": the whole tree}`` of a
    sharded step's pieces (``sharding.unshard``), in the reference's
    format."""
    return save_checkpoint(directory, step, {
        "params": shard_lib.unshard(placed, specs, mesh)}, **kw)


def restore_placed(directory: str, placed: Tree, specs: Tree, mesh,
                   step: Optional[int] = None) -> Tuple[Tree, Dict]:
    """The ``params`` of a checkpoint (either package's, whole) placed
    into pieces by ``specs`` on ``mesh``, as ``placed``'s dtypes; and the
    manifest."""
    template = {"params": shard_lib.unshard(placed, specs, mesh)}
    tree, manifest = restore_checkpoint(directory, template, step)
    return shard_lib.place(tree["params"], specs, mesh), manifest


def tree_nbytes(tree: Tree) -> int:
    return sum(torch.as_tensor(x).nbytes
               for _, x in _flatten_with_paths(tree))
