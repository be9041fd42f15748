"""Paper future-work #3, implemented: overlap A (labeling) and T (training).

"As the training process is mini-batch based which can be started before
getting all training samples, we can try to partially overlap A and T in
the workflow to shorten end-to-end time." (paper §7)

``run_overlapped_label_train`` executes labeling and training as a software
pipeline over micro-shards: shard i is labeled while shard i-1 trains.
Compute is real (both stages actually run); the clock charges the pipeline's
critical path per stage — max(label_i, train_{i-1}) — rather than the sum,
which is exactly the paper's proposed saving.

The port's copy of ``repro/core/pipeline_flow.py``.  Each stage's time is
read after a synchronization of the CUDA card, so the labeling kernel and
the training step are charged what they ran, not what they took to launch.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List

from repro_torch.core.simclock import device_sync
from repro_torch.core.system import System
from repro_torch.core.transfer import FileRef


def run_overlapped_label_train(
        sys_: System, *, dataset_facility: str, dataset_name: str,
        label_fn: Callable, train_init_fn: Callable,
        train_shard_fn: Callable, n_shards: int = 8,
        artifact_name: str = "model.npz",
        artifact_bytes: int = 3_000_000) -> Dict:
    """Pipeline: [label s0][label s1 | train s0][label s2 | train s1]...

    label_fn(raw_shard) -> labels;  train_init_fn() -> state;
    train_shard_fn(state, shard, labels) -> (state, metrics).
    Returns {"state", "per_stage", "serial_s", "pipelined_s", "saving_s"}.
    """
    clock = sys_.clock
    raw = sys_.store.get(dataset_facility, dataset_name).payload
    n = raw["patches"].shape[0]
    per = n // n_shards
    shards = [
        {k: v[i * per:(i + 1) * per] for k, v in raw.items()}
        for i in range(n_shards)
    ]

    state = train_init_fn()
    label_times: List[float] = []
    train_times: List[float] = []
    labeled: List = []
    metrics = None

    serial = 0.0
    pipelined = 0.0
    for stage in range(n_shards + 1):
        t_label = 0.0
        t_train = 0.0
        if stage < n_shards:
            device_sync()
            t0 = time.perf_counter()
            labeled.append(label_fn(shards[stage]))
            device_sync()
            t_label = time.perf_counter() - t0
            label_times.append(t_label)
        if stage > 0:
            t0 = time.perf_counter()
            state, metrics = train_shard_fn(state, shards[stage - 1],
                                            labeled[stage - 1])
            device_sync()
            t_train = time.perf_counter() - t0
            train_times.append(t_train)
        # the two stages run on different resources (CPU labeling cluster vs
        # the DCAI accelerator): the pipeline's critical path is the max
        serial += t_label + t_train
        stage_t = max(t_label, t_train)
        pipelined += stage_t
        clock.advance(stage_t, f"A||T stage {stage}", "real")

    sys_.store.put("alcf", FileRef(artifact_name, artifact_bytes,
                                   payload=state))
    return {
        "state": state,
        "metrics": metrics,
        "serial_s": serial,
        "pipelined_s": pipelined,
        "saving_s": serial - pipelined,
        "label_times": label_times,
        "train_times": train_times,
    }
