"""Roofline terms of a step on the H100: the port's copy of
``repro/roofline/analysis.py``.

Per (arch x shape x mesh):
    compute_term    = flops / (chips * peak_FLOP/s)
    memory_term     = bytes / (chips * HBM_bw)
    collective_term = collective_bytes_per_dev / link_bw

The fields keep the reference's names.  ``hlo_flops`` and ``hlo_bytes``
hold the dry-run artifact's analytic account (``roofline/analytic.py``),
the FLOPs falling back to what ``FlopCounterMode`` counted on the
``meta`` device (``counted``), as the reference falls back to XLA's
``cost_analysis``;
``collective_bytes_per_dev`` is the bytes of every collective's output
that one position receives a step (``TPPlan.collective_bytes``,
``GatherPlan.collective_bytes``), as the reference sums per-device HLO
output shapes.  The chip constants are the port's (``launch/mesh.py``:
one H100 SXM, NVLink 4 in place of the TPU's ICI link).  MODEL_FLOPS =
6*N*D for training (3x forward for fwd+bwd), 2*N_active*D for a single
forward or decode step.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict

from repro_torch.launch.mesh import (CHIP_HBM_BW, CHIP_PEAK_FLOPS_BF16,
                                     NVLINK_BW)


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    hlo_flops: float
    hlo_bytes: float
    collective_bytes_per_dev: float
    model_flops: float
    peak_flops: float = CHIP_PEAK_FLOPS_BF16
    hbm_bw: float = CHIP_HBM_BW
    link_bw: float = NVLINK_BW

    @property
    def compute_term(self) -> float:
        return self.hlo_flops / (self.n_chips * self.peak_flops)

    @property
    def memory_term(self) -> float:
        return self.hlo_bytes / (self.n_chips * self.hbm_bw)

    @property
    def collective_term(self) -> float:
        # collective bytes are already per-device traffic
        return self.collective_bytes_per_dev / self.link_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_term, "memory": self.memory_term,
                 "collective": self.collective_term}
        return max(terms, key=terms.get)

    @property
    def step_time_lower_bound(self) -> float:
        return max(self.compute_term, self.memory_term, self.collective_term)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / flops: remat/redundancy waste indicator."""
        return self.model_flops / max(self.hlo_flops, 1.0)

    @property
    def mfu_upper_bound(self) -> float:
        """Model-FLOPs utilization if the dominant term were achieved."""
        t = self.step_time_lower_bound
        return self.model_flops / (self.n_chips * self.peak_flops * max(t, 1e-12))

    def row(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.n_chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "coll_bytes_dev": self.collective_bytes_per_dev,
            "model_flops": self.model_flops,
            "t_compute": self.compute_term,
            "t_memory": self.memory_term,
            "t_collective": self.collective_term,
            "dominant": self.dominant,
            "useful_ratio": self.useful_flops_ratio,
            "mfu_bound": self.mfu_upper_bound,
        }


# ---------------------------------------------------------------------------
def model_flops_estimate(n_params_active: int, tokens: int,
                         kind: str) -> float:
    """6*N*D for train, 2*N*D for forward-only (per step)."""
    per_tok = 6 if kind == "train" else 2
    return float(per_tok) * n_params_active * tokens


def from_artifact(art: Dict) -> RooflineTerms:
    """Prefer the analytic FLOPs/bytes (the reference's yardstick) with
    the meta pass's counted FLOPs kept in the artifact for reference and
    taken where the analytic account has none (the meta pass counts no
    bytes)."""
    acct = art.get("analytic", {})
    flops = acct.get("flops") or art["counted"].get("flops", 0.0)
    bytes_ = acct.get("bytes", 0.0)
    return RooflineTerms(
        arch=art["arch"], shape=art["shape"], mesh=art["mesh"],
        n_chips=art["n_devices"],
        hlo_flops=flops,
        hlo_bytes=bytes_,
        collective_bytes_per_dev=art["collective_bytes_total"],
        model_flops=art["model_flops"],
    )


def load_artifact(path: str) -> RooflineTerms:
    with open(path) as f:
        return from_artifact(json.load(f))
