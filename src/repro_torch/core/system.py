"""One-call assembly of the paper's full distributed system (Figure 2).

``build_system()`` wires topology + clock + auth + data store + transfer +
funcX + model repository + flow engine, and ``dnn_trainer_flow()`` returns
the paper's DNNTrainerFlow definition:

    TransferData (ex->dc)  ->  LabelData (A at dc, optional)
      ->  TrainModel (T on the DCAI endpoint)
      ->  TransferModel (dc->ex)  ->  RegisterModel (edge repo)

which is exactly the Table-1 measured pipeline.

The port's copy of ``repro/core/system.py``, unchanged but for its imports.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from repro_torch.core.actions import (ComputeProvider, OverlapLabelTrainProvider,
                                RegisterModelProvider, TransferProvider)
from repro_torch.core.auth import (AuthService, SCOPE_COMPUTE, SCOPE_FLOWS,
                             SCOPE_TRANSFER)
from repro_torch.core.costmodel import CostModel, OperationCosts
from repro_torch.core.facility import Topology, paper_topology
from repro_torch.core.flows import FlowsService
from repro_torch.core.funcx import FuncXService
from repro_torch.core.registry import ModelRepository
from repro_torch.core.simclock import SimClock
from repro_torch.core.transfer import DataStore, TransferService


@dataclasses.dataclass
class System:
    topo: Topology
    clock: SimClock
    auth: AuthService
    store: DataStore
    transfer: TransferService
    funcx: FuncXService
    repo: ModelRepository
    flows: FlowsService
    costmodel: CostModel

    def user_token(self, subject: str = "scientist"):
        return self.auth.issue(
            subject, [SCOPE_FLOWS, SCOPE_TRANSFER, SCOPE_COMPUTE])


def build_system(*, fault_rate: float = 0.0, seed: int = 0,
                 topo: Optional[Topology] = None,
                 costs: Optional[OperationCosts] = None) -> System:
    topo = topo or paper_topology()
    clock = SimClock()
    auth = AuthService()
    store = DataStore()
    transfer = TransferService(topo, clock, store, fault_rate=fault_rate,
                               seed=seed)
    funcx = FuncXService(topo, clock)
    repo = ModelRepository()
    providers = {
        "transfer": TransferProvider(transfer),
        "compute": ComputeProvider(funcx),
        "register_model": RegisterModelProvider(repo, store),
        "overlap_label_train": OverlapLabelTrainProvider(funcx, store),
    }
    flows = FlowsService(clock, auth, providers,
                         services={"store": store, "repo": repo})
    cm = CostModel(topo, transfer, costs)
    system = System(topo, clock, auth, store, transfer, funcx, repo, flows,
                    cm)
    flows.services["system"] = system
    return system


# ---------------------------------------------------------------------------
def dnn_trainer_flow(*, with_labeling: bool = False) -> Dict[str, Any]:
    """The paper's DNNTrainerFlow definition (github.com/AISDC/DNNTrainerFlow).

    Run-time arguments (flow input):
      src, dc: facility names;  dataset: list of file names;
      train_endpoint, train_function: funcX ids;  train_args/kwargs;
      modeled_duration (optional);  model_name: artifact file name produced
      by the train function;  register_as: repository model name.
    """
    states: Dict[str, Any] = {
        "TransferData": {
            "Provider": "transfer",
            "Parameters": {
                "src": "$.input.src",
                "dst": "$.input.dc",
                "names": "$.input.dataset",
                "label": "dataset ex->dc",
            },
            "Retries": 2,
            "Next": "LabelData" if with_labeling else "TrainModel",
        },
        "TrainModel": {
            "Provider": "compute",
            "Parameters": {
                "endpoint_id": "$.input.train_endpoint",
                "function_id": "$.input.train_function",
                "args": "$.input.train_args",
                "kwargs": "$.input.train_kwargs",
                "modeled_duration": "$.input.modeled_duration",
                "label": "T: train on DCAI",
            },
            "Retries": 1,
            "Next": "TransferModel",
        },
        "TransferModel": {
            "Provider": "transfer",
            "Parameters": {
                "src": "$.input.dc",
                "dst": "$.input.src",
                "names": "$.input.model_artifacts",
                "label": "model dc->ex",
            },
            "Retries": 2,
            "Next": "RegisterModel",
        },
        "RegisterModel": {
            "Provider": "register_model",
            "Parameters": {
                "name": "$.input.register_as",
                "version_tag": "$.input.version_tag",
                "facility": "$.input.src",
                "artifact_name": "$.input.model_name",
                "metrics": "$.input.metrics",
            },
            "End": True,
        },
    }
    if with_labeling:
        states["LabelData"] = {
            "Provider": "compute",
            "Parameters": {
                "endpoint_id": "$.input.label_endpoint",
                "function_id": "$.input.label_function",
                "args": "$.input.label_args",
                "kwargs": "$.input.label_kwargs",
                "label": "A: conventional labeling",
            },
            "Retries": 1,
            "Next": "TrainModel",
        }
    return {"StartAt": "TransferData", "States": states}
