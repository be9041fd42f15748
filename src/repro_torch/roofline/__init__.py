"""Roofline tooling of the port: the analytic step account
(:mod:`~repro_torch.roofline.analytic`) and the H100 roofline terms
(:mod:`~repro_torch.roofline.analysis`).  The reference's ``hlo_parse``
reads XLA's compiled HLO and has no counterpart: the port counts its
collectives where they run (``TPPlan``, ``GatherPlan``)."""
from repro_torch.roofline.analysis import (  # noqa: F401
    RooflineTerms, from_artifact, load_artifact)
from repro_torch.roofline import analytic  # noqa: F401
