"""The paper's primary contribution: the geographically distributed
workflow system (flows + funcX + transfer + cost model + sim clock).

The port's copy of ``repro/core``: the same services, providers and cost
model, with the measured steps synchronized with the CUDA card so that
work launched on it is charged when it runs, not when it is queued.
"""
from repro_torch.core.system import System, build_system, dnn_trainer_flow  # noqa: F401
from repro_torch.core.simclock import SimClock  # noqa: F401
from repro_torch.core.costmodel import CostModel, OperationCosts  # noqa: F401
