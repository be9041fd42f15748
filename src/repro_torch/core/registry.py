"""Model repository — the paper's future-work item 1, implemented.

"we are building the model repository ... so as to pick up the right model as
foundation to fine-tune using new dataset instead of retraining from scratch"
(paper §7).  Versioned artifacts with metrics; ``best_foundation`` picks the
highest-scoring compatible model to warm-start a retrain.

The port's copy of ``repro/core/registry.py``, unchanged but for its imports.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from repro_torch.core.transfer import FileRef


@dataclasses.dataclass
class ModelEntry:
    name: str
    version: int
    version_tag: str
    artifact: FileRef
    metrics: Dict[str, float]


class ModelRepository:
    def __init__(self) -> None:
        self._models: Dict[str, List[ModelEntry]] = {}

    def register(self, name: str, version_tag: str, artifact: FileRef,
                 metrics: Optional[Dict[str, float]] = None) -> ModelEntry:
        versions = self._models.setdefault(name, [])
        entry = ModelEntry(name, len(versions) + 1, version_tag, artifact,
                           dict(metrics or {}))
        versions.append(entry)
        return entry

    def latest(self, name: str) -> ModelEntry:
        return self._models[name][-1]

    def get(self, name: str, version: int) -> ModelEntry:
        return self._models[name][version - 1]

    def versions(self, name: str) -> List[ModelEntry]:
        return list(self._models.get(name, []))

    def best_foundation(self, name: str, metric: str = "val_loss",
                        minimize: bool = True) -> Optional[ModelEntry]:
        """Pick the best prior model to fine-tune from (future-work #1)."""
        candidates = [e for e in self._models.get(name, [])
                      if metric in e.metrics]
        if not candidates:
            return None
        return (min if minimize else max)(
            candidates, key=lambda e: e.metrics[metric])


class DataRepository:
    """Data repository — the paper's future-work item 2, implemented.

    "we are also building a data repository to augment training dataset or
    substitute unlabelled dataset, because the labelling process is usually
    time consuming" (paper §7).  Labeled datasets are registered with
    instrument/sample metadata; ``augment_for`` returns prior labeled
    datasets matching the new experiment so (re)training can start from a
    larger corpus or skip labeling entirely.
    """

    def __init__(self) -> None:
        self._datasets: Dict[str, List] = {}

    def register(self, experiment_class: str, artifact: FileRef,
                 metadata: Optional[Dict[str, Any]] = None,
                 labeled: bool = True):
        entry = {
            "artifact": artifact,
            "metadata": dict(metadata or {}),
            "labeled": labeled,
            "version": len(self._datasets.get(experiment_class, [])) + 1,
        }
        self._datasets.setdefault(experiment_class, []).append(entry)
        return entry

    def augment_for(self, experiment_class: str, *,
                    labeled_only: bool = True,
                    match: Optional[Dict[str, Any]] = None) -> List:
        out = []
        for e in self._datasets.get(experiment_class, []):
            if labeled_only and not e["labeled"]:
                continue
            if match and any(e["metadata"].get(k) != v
                             for k, v in match.items()):
                continue
            out.append(e)
        return out

    def total_bytes(self, experiment_class: str) -> int:
        return sum(e["artifact"].nbytes
                   for e in self._datasets.get(experiment_class, []))
