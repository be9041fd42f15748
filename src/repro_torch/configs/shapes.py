"""Input shapes of the port's training and prefill paths: the port's own
copy of ``InputShape``, ``TRAIN_4K``, ``PREFILL_32K``, ``DECODE_32K`` and
``smoke_shape`` from ``repro/configs/shapes.py``."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")


def smoke_shape(kind: str = "train") -> InputShape:
    """Tiny shape for CPU smoke tests."""
    if kind == "train":
        return InputShape("smoke_train", 32, 2, "train")
    if kind == "prefill":
        return InputShape("smoke_prefill", 32, 2, "prefill")
    return InputShape("smoke_decode", 32, 2, "decode")
