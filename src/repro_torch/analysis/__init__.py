"""The conventional analysis of the paper's workflow (the "A" op)."""
from repro_torch.analysis.pseudo_voigt import (  # noqa: F401
    analyze_patches,
    label_for_braggnn,
)
