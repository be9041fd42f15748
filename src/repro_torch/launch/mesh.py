"""Device meshes of the port's serving engines and sharded training.

The counterpart of ``repro/launch/mesh.py``.  A :class:`Mesh` is an
object array of ``torch.device`` positions with named axes: "data" (the
data-parallel slices of ``ShardedDecodeEngine``, or of a sharded train
step's batch and FSDP pieces) and "model" (the tensor-parallel shards of
one ``PagedDecodeEngine`` or of one slice's training forward).  Two
positions may name the same device: a mesh of four ``cpu`` positions
runs the sharded code on the CPU, and positions that share one card run
every shard's kernels at the sharded shapes on that card.  Building a
mesh touches no device state.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """Positions ``devices`` (any nesting, reshaped to ``shape``) under
    ``axis_names``.  ``.devices`` is the object array of ``torch.device``,
    ``.shape`` maps each axis name to its size, as ``jax.sharding.Mesh``
    does."""

    def __init__(self, devices, axis_names: Sequence[str],
                 shape: Optional[Tuple[int, ...]] = None) -> None:
        flat = [torch.device(d) for d in np.asarray(
            devices, dtype=object).reshape(-1)]
        arr = np.empty(len(flat), dtype=object)
        arr[:] = flat
        if shape is None:
            shape = np.asarray(devices, dtype=object).shape
        self.devices = arr.reshape(shape)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} needs "
                             f"{self.devices.ndim} axis names, got "
                             f"{self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def make_host_mesh(model_parallel: int = 1,
                   devices: Optional[Sequence] = None) -> Mesh:
    """A ``("data", "model")`` mesh of shape ``(n // model_parallel,
    model_parallel)`` over ``devices`` (default: every visible CUDA card;
    raises on a machine without one, never falling back to the CPU)."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("no CUDA device is visible; pass devices= "
                               "(e.g. [torch.device('cpu')] * 4) for a CPU "
                               "mesh")
        devices = [torch.device("cuda", i) for i in range(n)]
    devs = list(devices)
    n = len(devs)
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"model_parallel {model_parallel} does not divide "
                         f"the {n} devices")
    return Mesh(devs, ("data", "model"),
                shape=(n // model_parallel, model_parallel))


def build_mesh(mesh_shape: str, tp: int, device: str) -> Optional[Mesh]:
    """The launchers' mesh: ``mesh_shape`` "dp,tp" (the first dp x tp
    devices), else ``tp`` > 0 (every visible card, model_parallel tp; tp
    CPU positions with ``device="cpu"``); None when neither is given.
    Refuses a mesh larger than the devices present, and never falls back
    to the CPU."""
    if not (mesh_shape or tp):
        return None
    if mesh_shape:
        dp, tp = (int(x) for x in mesh_shape.split(","))
    else:
        dp = 0
    if device == "cpu":
        return Mesh([torch.device("cpu")] * (max(dp, 1) * tp),
                    ("data", "model"), shape=(max(dp, 1), tp))
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if dp == 0:
        if n == 0 or n % tp:
            raise SystemExit(f"--tp {tp} does not divide the {n} visible "
                             "CUDA devices")
        dp = n // tp
    if dp * tp > n:
        raise SystemExit(f"--mesh-shape {dp},{tp} needs {dp * tp} devices, "
                         f"found {n} CUDA devices (--device cpu lays the "
                         "positions on the CPU)")
    return Mesh([torch.device("cuda", i) for i in range(dp * tp)],
                ("data", "model"), shape=(dp, tp))


def mesh_axis_sizes(mesh: Mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def mesh_slices(mesh: Mesh) -> List[Mesh]:
    """Split a mesh into per-data-slice tensor-parallel sub-meshes.

    A ``(data..., model)`` mesh of dp * tp positions becomes ``dp`` meshes
    of shape ``("data", "model") = (1, tp)``, one per engine slice of a
    data-parallel serving front.  Each slice keeps the "data" axis (size
    1) so the sharding rules resolve identically on a slice and on the
    full mesh.  A mesh with no "model" axis yields pure data slices
    (tp = 1).
    """
    tp = mesh_axis_sizes(mesh).get("model", 1)
    devs = mesh.devices.reshape(-1, tp)
    return [Mesh(devs[i], ("data", "model"), shape=(1, tp))
            for i in range(devs.shape[0])]


def data_axes_of(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


# hardware constants for the roofline model (``roofline/analysis.py``):
# one NVIDIA H100 SXM (the data sheet's dense rates at the 700 W power
# limit).  The reference's ``make_production_mesh`` (a 16 x 16 TPU pod of
# placeholder devices for its XLA dry-run) has no counterpart: the port's
# dry-run runs on meta positions (``launch/dryrun.py``)
CHIP_PEAK_FLOPS_BF16 = 989e12      # FLOP/s per card, bf16 tensor cores
CHIP_HBM_BW = 3.35e12              # bytes/s per card, HBM3
NVLINK_BW = 450e9                  # bytes/s per card and direction (NVLink 4)
