"""Data pipeline: deterministic sharded batching with host-side prefetch.

The counterpart of ``repro/data/pipeline.py``.  Each host takes its
``host_id`` slice of a deterministic global stream, so the trainer code is
the same on 1 host and N hosts.  Step k's global batch comes from a
``torch.Generator`` seeded from (seed, k), the counterpart of the
reference's ``fold_in(PRNGKey(seed), k)``; with ``prefetch > 0`` a thread
makes step k+1 while step k trains.
"""
from __future__ import annotations

import queue as queue_mod
import threading
from typing import Callable, Dict, Iterator, List

import numpy as np
import torch

from repro_torch.device import resolve_device


def _step_generator(seed: int, step: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, step): distinct steps
    and seeds give unrelated streams."""
    state = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed((int(state[0]) << 31) ^ int(state[1]))
    return g


def _slice(tree, lo: int, hi: int):
    if isinstance(tree, dict):
        return {k: _slice(v, lo, hi) for k, v in tree.items()}
    return tree[lo:hi]


class ShardedLoader:
    """Wraps ``make_batch(generator, batch_size) -> dict`` into a sharded
    stream of this host's local batches."""

    def __init__(self, make_batch: Callable, global_batch: int, *,
                 seed: int = 0, host_id: int = 0, host_count: int = 1,
                 prefetch: int = 2, device="cuda") -> None:
        """``make_batch`` is called with a generator on ``device`` and the
        global batch size; each host keeps rows
        [host_id * local, (host_id + 1) * local)."""
        if global_batch % host_count:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"over {host_count} hosts")
        self.make_batch = make_batch
        self.global_batch = global_batch
        self.local_batch = global_batch // host_count
        self.host_id = host_id
        self.host_count = host_count
        self.seed = seed
        self.prefetch = prefetch
        self.device = resolve_device(device)

    def _gen(self, step: int) -> Dict:
        g = _step_generator(self.seed, step, self.device)
        global_batch = self.make_batch(g, self.global_batch)
        lo = self.host_id * self.local_batch
        return _slice(global_batch, lo, lo + self.local_batch)

    def __iter__(self) -> Iterator[Dict]:
        """Local batches of steps 0, 1, ...; with ``prefetch > 0`` made by
        a daemon thread up to ``prefetch`` steps ahead."""
        if self.prefetch <= 0:
            step = 0
            while True:
                yield self._gen(step)
                step += 1

        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue_mod.Full:
                    continue
            return False

        def worker():
            step = 0
            try:
                while put(self._gen(step)):
                    step += 1
            except Exception as e:      # handed to the consumer, raised there
                put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


def take(loader: ShardedLoader, n: int) -> List[Dict]:
    """The first ``n`` local batches of ``loader``."""
    it = iter(loader)
    return [next(it) for _ in range(n)]
