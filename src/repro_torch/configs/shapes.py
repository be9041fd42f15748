"""The four assigned input shapes and their step kinds: the port's own
copy of ``repro/configs/shapes.py`` (the shape registry the dry-run
sweeps, and the shapes of the training and prefill paths)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple


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
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

SHAPES: Dict[str, InputShape] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}


def get_shape(name: str) -> InputShape:
    try:
        return SHAPES[name]
    except KeyError:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}")


def all_shapes() -> Tuple[InputShape, ...]:
    return tuple(SHAPES.values())


def smoke_shape(kind: str = "train") -> InputShape:
    """Tiny shape for CPU smoke tests."""
    if kind == "train":
        return InputShape("smoke_train", 32, 2, "train")
    if kind == "prefill":
        return InputShape("smoke_prefill", 32, 2, "prefill")
    return InputShape("smoke_decode", 32, 2, "decode")
