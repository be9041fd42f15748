"""Concrete action providers wiring the flow engine to the services.

These mirror the paper's Figure 2: every compute function (simulate, label,
train) is a funcX function wrapped as a Flows action; every data dependency
is a Globus transfer wrapped as an action; model delivery is a transfer +
model-repository registration (the paper's future-work item 1, implemented
here).

The port's copy of ``repro/core/actions.py``, unchanged but for its imports.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.core.auth import SCOPE_COMPUTE, SCOPE_TRANSFER
from repro_torch.core.flows import ActionFailure, ActionProvider, RunContext
from repro_torch.core.funcx import FuncXService
from repro_torch.core.registry import ModelRepository
from repro_torch.core.transfer import DataStore, TransferService


class TransferProvider(ActionProvider):
    """Parameters: src, dst, names[, concurrency, label]."""

    name = "transfer"
    required_scope = SCOPE_TRANSFER

    def __init__(self, transfer: TransferService) -> None:
        self.transfer = transfer

    def run(self, params: Dict[str, Any], ctx: RunContext) -> Any:
        try:
            rec = self.transfer.submit(
                params["src"], params["dst"], list(params["names"]),
                concurrency=params.get("concurrency"),
                label=params.get("label", ""))
        except KeyError as e:
            raise ActionFailure(f"missing file or parameter: {e}")
        return {
            "task_id": rec.task_id,
            "nbytes": rec.nbytes,
            "duration": rec.duration,
            "rate_Bps": rec.rate,
            "retries": rec.retries,
        }


class ComputeProvider(ActionProvider):
    """Parameters: endpoint_id, function_id, args (list), kwargs (dict)
    [, modeled_duration, label]."""

    name = "compute"
    required_scope = SCOPE_COMPUTE

    def __init__(self, funcx: FuncXService) -> None:
        self.funcx = funcx

    def run(self, params: Dict[str, Any], ctx: RunContext) -> Any:
        try:
            tr = self.funcx.run(
                params["endpoint_id"], params["function_id"],
                *params.get("args", []),
                modeled_duration=params.get("modeled_duration"),
                label=params.get("label", ""),
                **params.get("kwargs", {}))
        except KeyError as e:
            raise ActionFailure(f"unknown endpoint/function: {e}")
        except Exception as e:  # compute errors are action failures
            raise ActionFailure(f"compute raised {type(e).__name__}: {e}")
        return {
            "task_id": tr.task_id,
            "result": tr.result,
            "duration": tr.duration,
            "overhead": tr.overhead,
            "mode": tr.mode,
        }


class RegisterModelProvider(ActionProvider):
    """Registers a delivered model artifact in the model repository.

    Parameters: name, version_tag, facility, artifact_name[, metrics].
    """

    name = "register_model"
    required_scope = SCOPE_COMPUTE

    def __init__(self, repo: ModelRepository, store: DataStore) -> None:
        self.repo = repo
        self.store = store

    def run(self, params: Dict[str, Any], ctx: RunContext) -> Any:
        fac = params["facility"]
        art = params["artifact_name"]
        if not self.store.exists(fac, art):
            raise ActionFailure(f"artifact {art!r} not present at {fac!r}")
        ref = self.store.get(fac, art)
        entry = self.repo.register(
            params["name"], params.get("version_tag", ""), ref,
            metrics=params.get("metrics", {}))
        return {"name": entry.name, "version": entry.version,
                "nbytes": ref.nbytes}


class OverlapLabelTrainProvider(ActionProvider):
    """Future-work #3 as a flow action: pipelined A||T on the DC.

    Parameters: facility, dataset_name, label_function, train_init_function,
    train_shard_function (funcX function ids registered on the service),
    n_shards, artifact_name.
    """

    name = "overlap_label_train"
    required_scope = SCOPE_COMPUTE

    def __init__(self, funcx, store: DataStore) -> None:
        self.funcx = funcx
        self.store = store

    def run(self, params: Dict[str, Any], ctx: RunContext) -> Any:
        from repro_torch.core.pipeline_flow import run_overlapped_label_train

        fx = self.funcx
        try:
            label_fn = fx.functions[params["label_function"]]
            init_fn = fx.functions[params["train_init_function"]]
            shard_fn = fx.functions[params["train_shard_function"]]
            sys_like = ctx.services["system"]
            res = run_overlapped_label_train(
                sys_like,
                dataset_facility=params["facility"],
                dataset_name=params["dataset_name"],
                label_fn=label_fn, train_init_fn=init_fn,
                train_shard_fn=shard_fn,
                n_shards=int(params.get("n_shards", 8)),
                artifact_name=params.get("artifact_name", "model.npz"))
        except KeyError as e:
            raise ActionFailure(f"missing parameter/function: {e}")
        return {
            "serial_s": res["serial_s"],
            "pipelined_s": res["pipelined_s"],
            "saving_s": res["saving_s"],
            "metrics": res["metrics"],
        }
