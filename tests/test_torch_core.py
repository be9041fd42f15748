"""The port's workflow system (``repro_torch.core``: funcX, flows, transfer,
registry, cost model, sim clock) against the reference's ``repro.core``.

Both packages are pure Python here, so the same inputs must give the same
results exactly: transfer durations and retries (the fault injection's
seeded ``random.Random`` draws), the sim and modeled clock entries, the cost
model's strategies, the flow engine's states and failures, and the
registry's choices.  Only measured ("real") seconds differ between runs.
The port's one change to the reference's semantics, the CUDA
synchronization around measured steps, is checked with the card's calls
stubbed out.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from repro_torch.core import simclock as port_simclock

PACKAGES = ("repro.core", "repro_torch.core")
# the devices and links of the paper's deployment: every device but each
# package's own target DCAI (the reference's TPU pod, the port's H100)
SHARED_DEVICES = ("edge-tpu", "local-v100", "cerebras", "sambanova-1rdu",
                  "gpu-server-8xv100", "cpu-cluster-1024")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _both(name: str):
    return [_mod(pkg, name) for pkg in PACKAGES]


def _entries(clock, kinds=("sim", "modeled"), at=True):
    """The clock's entries of ``kinds``; with ``at``, their start stamps
    too (which measured seconds before them would move)."""
    return [(e.kind, e.label, e.seconds) + ((e.at,) if at else ())
            for e in clock.log if e.kind in kinds]


# ---------------------------------------------------------------------------
# topology
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", SHARED_DEVICES)
def test_paper_devices_match_reference(name):
    ref, port = (m.paper_topology() for m in _both("facility"))
    assert dataclasses.asdict(port.device(name)) \
        == dataclasses.asdict(ref.device(name))


def test_links_match_and_the_target_is_the_h100():
    ref, port = (m.paper_topology() for m in _both("facility"))
    assert {k: dataclasses.asdict(v) for k, v in port.links.items()} \
        == {k: dataclasses.asdict(v) for k, v in ref.links.items()}
    for src, dst in (("slac", "alcf"), ("slac", "slac")):
        assert dataclasses.asdict(port.link(src, dst)) \
            == dataclasses.asdict(ref.link(src, dst))
    names = {n for fac in port.facilities.values() for n in fac.devices}
    assert names == set(SHARED_DEVICES) | {"h100"}
    h100 = port.device("h100")
    assert (h100.facility, h100.kind, h100.peak_flops, h100.hbm_bw,
            h100.n_chips, h100.queue_wait, h100.service_overhead) \
        == ("alcf", "dcai", 989e12, 3.35e12, 1, 2.0, 1.0)
    target = ref.device("tpu-v5e-pod")
    assert (target.queue_wait, target.service_overhead) == (2.0, 1.0)
    with pytest.raises(KeyError):
        port.device("tpu-v5e-pod")


# ---------------------------------------------------------------------------
# transfer service
# ---------------------------------------------------------------------------
def _transfers(pkg: str, fault_rate: float):
    system = _mod(pkg, "system")
    FileRef = _mod(pkg, "transfer").FileRef
    sys_ = system.build_system(fault_rate=fault_rate, seed=0)
    for i in range(6):
        sys_.store.put("slac", FileRef(f"d{i}", (i + 1) * 7_000_000))
    recs = []
    for i in range(40):
        names = [f"d{j}" for j in range(i % 6 + 1)]
        recs.append(sys_.transfer.submit("slac", "alcf", names,
                                         concurrency=(None, 1, 4, 16)[i % 4],
                                         label=f"batch {i}"))
    recs.append(sys_.transfer.submit("alcf", "slac", ["d0"], n_files=9))
    recs.append(sys_.transfer.submit("slac", "slac", ["d5"]))
    curve = sys_.transfer.throughput_curve("slac", "alcf", 10**9,
                                           [1, 2, 4, 8, 32])
    return ([dataclasses.asdict(r) for r in recs], curve,
            _entries(sys_.clock), sys_.store.exists("alcf", "d3"))


@pytest.mark.parametrize("fault_rate", [0.0, 0.2])
def test_transfer_service_matches_reference(fault_rate):
    """Durations, retries and rates equal the reference's, the seeded
    fault injection included (fault rate 0.2, seed 0)."""
    ref, port = (_transfers(pkg, fault_rate) for pkg in PACKAGES)
    assert port == ref
    if fault_rate:
        assert sum(r["retries"] for r in port[0]) > 0


# ---------------------------------------------------------------------------
# funcX and the clock
# ---------------------------------------------------------------------------
def _funcx_runs(pkg: str):
    system = _mod(pkg, "system")
    sys_ = system.build_system()
    fx = sys_.funcx
    fid = fx.register_function(lambda x, scale=1: np.arange(x) * scale,
                               "ramp")
    real = fx.register_endpoint("local-v100", mode="real")
    modeled = fx.register_endpoint("cerebras", mode="modeled",
                                   speedup_vs_host=50.0)
    out = []
    for eid, kw in ((real, {}), (modeled, {"modeled_duration": 19.0}),
                    (modeled, {})):
        tr = fx.run(eid, fid, 4, scale=3, label=f"run on {eid[:12]}", **kw)
        out.append((tr.result.tolist(), tr.overhead, tr.mode,
                    tr.duration if "modeled_duration" in kw else None))
    with sys_.clock.measure("outer"):
        sys_.clock.advance(0.5, "inside")
    sys_.clock.charge(2.0, "model")
    return out, _entries(sys_.clock, ("sim",), at=False), \
        [(e.kind, e.label) for e in sys_.clock.log], \
        sorted(sys_.clock.breakdown())


def test_funcx_and_clock_match_reference():
    """The same results, overheads and modes; the sim entries equal; every
    entry in the same order with the same kind and label."""
    ref, port = (_funcx_runs(pkg) for pkg in PACKAGES)
    assert port == ref


def test_measure_synchronizes_the_card(monkeypatch):
    """Measured steps read the clock after draining the card's queue: the
    clock's ``measure``, funcX's real mode and each A||T stage
    synchronize (stubbed here: the CPU has no card)."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: calls.append("sync"))
    clock = port_simclock.SimClock()
    with clock.measure("step"):
        calls.append("work")
    assert calls == ["sync", "work", "sync"]

    from repro_torch.core import build_system
    sys_ = build_system()
    fid = sys_.funcx.register_function(lambda: calls.append("fn"), "fn")
    eid = sys_.funcx.register_endpoint("h100", mode="real")
    calls.clear()
    sys_.funcx.run(eid, fid)
    assert calls.index("fn") >= 2 and calls[-1] == "sync"
    mid = sys_.funcx.register_endpoint("h100", mode="modeled")
    calls.clear()
    sys_.funcx.run(mid, fid, modeled_duration=1.0)
    assert calls == ["fn"]

    from repro_torch.core.pipeline_flow import run_overlapped_label_train
    from repro_torch.core.transfer import FileRef
    sys_.store.put("alcf", FileRef("d", 1, payload={
        "patches": np.zeros((4, 2))}))

    def train_shard(state, shard, labels):
        calls.append("train")
        return state, {}

    calls.clear()
    run_overlapped_label_train(
        sys_, dataset_facility="alcf", dataset_name="d",
        label_fn=lambda s: calls.append("label"),
        train_init_fn=lambda: None, train_shard_fn=train_shard, n_shards=2)
    assert calls.count("label") == calls.count("train") == 2
    # every stage's label and train is followed by a sync before its stamp
    for i, c in enumerate(calls):
        if c in ("label", "train"):
            assert calls[i + 1] == "sync"


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("device", SHARED_DEVICES)
def test_costmodel_matches_reference(device):
    """Eq. (1)-(3), the pipelined Eq. (3'), the crossover and the advice
    equal the reference's, with T priced for each shared device (the
    paper's 19 s on Cerebras scaled by peak rate)."""
    out = []
    for pkg in PACKAGES:
        system, cm_mod = _mod(pkg, "system"), _mod(pkg, "costmodel")
        topo = _mod(pkg, "facility").paper_topology()
        train = 19.0 * topo.device("cerebras").peak_flops \
            / topo.device(device).peak_flops
        sys_ = system.build_system(costs=cm_mod.OperationCosts(train=train))
        cm = sys_.costmodel
        rows = []
        for n in (1, 1_000, 800_000, 10**8):
            for p in (0.05, 0.1, 0.5):
                rows.append((cm.f_conventional_dc(n), cm.f_conventional_ex(n),
                             cm.f_ml(n, p), cm.f_ml(n, p, train_seconds=3.0),
                             cm.f_ml_pipelined(n, p),
                             cm.f_ml_pipelined(n, p, n_microbatches=4),
                             cm.advise(n, p)))
        rows.append([cm.crossover(p) for p in (0.05, 0.1, 0.5)])
        out.append([[dataclasses.asdict(c) if dataclasses.is_dataclass(c)
                     else c for c in row] for row in rows])
    assert out[1] == out[0]
    assert dataclasses.asdict(_mod(PACKAGES[1], "costmodel").OperationCosts()) \
        == dataclasses.asdict(_mod(PACKAGES[0], "costmodel").OperationCosts())


# ---------------------------------------------------------------------------
# flows
# ---------------------------------------------------------------------------
def _trainer_flow(pkg: str, with_labeling: bool, *, scopes=None,
                  dataset=("d0", "d1")):
    system = _mod(pkg, "system")
    FileRef = _mod(pkg, "transfer").FileRef
    auth = _mod(pkg, "auth")
    sys_ = system.build_system(fault_rate=0.2, seed=3)
    for i in range(2):
        sys_.store.put("slac", FileRef(f"d{i}", 50_000_000))
    tok = sys_.user_token() if scopes is None else sys_.auth.issue(
        "limited", [getattr(auth, s) for s in scopes])

    def label(names):
        return {"labelled": list(names)}

    def train(names, steps=1):
        sys_.store.put("alcf", FileRef("m.pt", 3_000_000, {"w": steps}))
        return {"steps": steps}

    fx = sys_.funcx
    eid = fx.register_endpoint("cerebras", mode="modeled")
    flow_input = {
        "src": "slac", "dc": "alcf", "dataset": list(dataset),
        "train_endpoint": eid, "train_function": fx.register_function(train),
        "train_args": [list(dataset)], "train_kwargs": {"steps": 3},
        "modeled_duration": 19.0, "model_artifacts": ["m.pt"],
        "model_name": "m.pt", "register_as": "braggnn",
        "version_tag": "v1", "metrics": {"val_loss": 0.25}}
    if with_labeling:      # A measured on a CPU cluster: real seconds
        flow_input.update(label_endpoint=fx.register_endpoint(
                              "cpu-cluster-1024", mode="real"),
                          label_function=fx.register_function(label),
                          label_args=[list(dataset)], label_kwargs={})
    fid = sys_.flows.deploy(system.dnn_trainer_flow(
        with_labeling=with_labeling))
    run = sys_.flows.run(fid, flow_input, tok)
    # a measured state moves every later stamp: those are compared only
    # when every state is simulated or modeled
    exact = not with_labeling
    log = [(e.state, e.provider, e.status, e.attempts, e.error)
           + ((e.started_at, e.duration) if exact else ())
           for e in run.log]
    results = {k: (dict(v, task_id=None) if isinstance(v, dict) else v)
               for k, v in run.output.items()}
    if "LabelData" in results and results["LabelData"] is not None:
        results["LabelData"]["duration"] = None
    return (run.status, log, run.turnaround if exact else None, results,
            _entries(sys_.clock, at=exact),
            sys_.store.exists("slac", "m.pt"),
            [e.version for e in sys_.repo.versions("braggnn")])


@pytest.mark.parametrize("with_labeling", [False, True])
def test_dnn_trainer_flow_matches_reference(with_labeling):
    """The same status, states in the same order, attempts, charged
    seconds, results and sim/modeled clock entries, exactly (a modeled
    training endpoint, seeded transfer faults); with labeling, LabelData
    runs for real, so only the stamps after it may differ."""
    ref, port = (_trainer_flow(pkg, with_labeling) for pkg in PACKAGES)
    assert port == ref
    assert port[0] == "SUCCEEDED" and port[-1] == [1]
    states = [row[0] for row in port[1]]
    assert states == ["TransferData"] + ["LabelData"] * with_labeling + [
        "TrainModel", "TransferModel", "RegisterModel"]


@pytest.mark.parametrize("case", ["missing_scope", "missing_file"])
def test_flow_failures_match_reference(case):
    """A token without the compute scope fails TrainModel; a dataset that
    does not exist fails TransferData (after its retries); the same state,
    error and attempts in both packages."""
    kw = {"scopes": ["SCOPE_FLOWS", "SCOPE_TRANSFER"]} \
        if case == "missing_scope" else {"dataset": ("d0", "nope")}
    ref, port = (_trainer_flow(pkg, False, **kw) for pkg in PACKAGES)
    assert port == ref
    status, log = port[0], port[1]
    assert status == "FAILED"
    failed = log[-1]
    state, attempts, error = failed[0], failed[3], failed[4]
    if case == "missing_scope":
        assert state == "TrainModel" and "lacks scope" in error
    else:
        assert state == "TransferData" and attempts == 3
        assert "missing file" in error


def test_deploy_validation_matches_reference():
    bad = [{"StartAt": "Nope", "States": {}},
           {"StartAt": "A", "States": {"A": {"Provider": "transfer",
                                             "Next": "Missing"}}},
           {"StartAt": "A", "States": {"A": {"Provider": "nope",
                                             "End": True}}},
           {"States": {}}]
    msgs = []
    for pkg in PACKAGES:
        sys_ = _mod(pkg, "system").build_system()
        FlowError = _mod(pkg, "flows").FlowError
        row = []
        for d in bad:
            with pytest.raises(FlowError) as e:
                sys_.flows.deploy(d)
            row.append(str(e.value))
        msgs.append(row)
    assert msgs[1] == msgs[0]


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
def _registry(pkg: str):
    reg = _mod(pkg, "registry")
    FileRef = _mod(pkg, "transfer").FileRef
    models = reg.ModelRepository()
    for tag, m in (("v1", {"val_loss": 0.3, "acc": 0.7}),
                   ("v2", {"acc": 0.9}), ("v3", {"val_loss": 0.1}),
                   ("v4", {"val_loss": 0.2, "acc": 0.8})):
        models.register("braggnn", tag, FileRef(f"{tag}.pt", 10), m)
    pick = lambda e: None if e is None else (e.version, e.version_tag)
    data = reg.DataRepository()
    for i, (cls, meta, lab) in enumerate((
            ("hedm", {"sample": "Ni"}, True), ("hedm", {"sample": "Cu"},
                                               True),
            ("hedm", {"sample": "Ni"}, False), ("xpcs", {}, True))):
        data.register(cls, FileRef(f"d{i}", 100 * (i + 1)), meta, lab)
    return (pick(models.best_foundation("braggnn")),
            pick(models.best_foundation("braggnn", "acc", minimize=False)),
            pick(models.best_foundation("braggnn", "f1")),
            pick(models.best_foundation("cookienet")),
            pick(models.latest("braggnn")), pick(models.get("braggnn", 2)),
            [e.version_tag for e in models.versions("braggnn")],
            [e["artifact"].name for e in data.augment_for("hedm")],
            [e["artifact"].name for e in data.augment_for(
                "hedm", labeled_only=False, match={"sample": "Ni"})],
            data.total_bytes("hedm"))


def test_registry_matches_reference():
    """``best_foundation`` (minimizing, maximizing, a missing metric or
    model), the versions, and the data repository's augmentation."""
    ref, port = (_registry(pkg) for pkg in PACKAGES)
    assert port == ref
    assert port[0] == (3, "v3") and port[1] == (2, "v2")


# ---------------------------------------------------------------------------
# A||T
# ---------------------------------------------------------------------------
def _overlap(pkg: str, n_shards: int, as_action: bool):
    system = _mod(pkg, "system")
    FileRef = _mod(pkg, "transfer").FileRef
    pipeline = _mod(pkg, "pipeline_flow")
    sys_ = system.build_system()
    rng = np.random.default_rng(5)
    sys_.store.put("alcf", FileRef("scan", 1, payload={
        "patches": rng.standard_normal((37, 3, 3)),
        "centers": rng.standard_normal((37, 2))}))
    seen = []

    def label(shard):
        seen.append({k: v.copy() for k, v in shard.items()})
        return shard["patches"].sum(axis=(1, 2))

    def init():
        return np.zeros(2)

    def train_shard(state, shard, labels):
        state = state + labels.mean() + shard["centers"].sum(0)
        return state, {"loss": float(np.abs(state).sum())}

    if as_action:
        fx = sys_.funcx
        fid = sys_.flows.deploy({"StartAt": "AT", "States": {"AT": {
            "Provider": "overlap_label_train",
            "Parameters": {"facility": "alcf", "dataset_name": "scan",
                           "label_function": fx.register_function(label),
                           "train_init_function": fx.register_function(init),
                           "train_shard_function":
                               fx.register_function(train_shard),
                           "n_shards": n_shards, "artifact_name": "at.pt"},
            "End": True}}})
        run = sys_.flows.run(fid, {}, sys_.user_token())
        assert run.status == "SUCCEEDED", [e.error for e in run.log]
        metrics = run.output["AT"]["metrics"]
        state = sys_.store.get("alcf", "at.pt").payload
    else:
        res = pipeline.run_overlapped_label_train(
            sys_, dataset_facility="alcf", dataset_name="scan",
            label_fn=label, train_init_fn=init, train_shard_fn=train_shard,
            n_shards=n_shards)
        metrics, state = res["metrics"], res["state"]
        assert len(res["label_times"]) == len(res["train_times"]) \
            == n_shards
        assert res["saving_s"] == pytest.approx(
            res["serial_s"] - res["pipelined_s"])
    return (seen, metrics, state,
            [(e.kind, e.label) for e in sys_.clock.log],
            _entries(sys_.clock))


@pytest.mark.parametrize("as_action", [False, True])
@pytest.mark.parametrize("n_shards", [1, 4])
def test_overlapped_label_train_matches_reference(n_shards, as_action):
    """Cheap numpy stages: the same shards reach the labeler, in the same
    order, the same final state and metrics, the same clock entries (their
    measured seconds aside), directly and as the flow action."""
    ref, port = (_overlap(pkg, n_shards, as_action) for pkg in PACKAGES)
    assert len(port[0]) == len(ref[0]) == n_shards
    for a, b in zip(port[0], ref[0]):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert port[1] == ref[1]
    np.testing.assert_array_equal(port[2], ref[2])
    assert port[3:] == ref[3:]


# ---------------------------------------------------------------------------
# the crossover analysis (launch/crossover_analysis.py)
# ---------------------------------------------------------------------------
def test_crossover_analysis_prints_the_references_tables(capsys):
    """Stages 1 and 3 (§4.2's training crossover and the modeled 7B-class
    split, arithmetic on the cost and transfer models) print the
    reference example's tables character for character; stage 2 serves
    its fleet on the CPU through one engine and through the split with
    the same tokens, and prints a row for each bandwidth of the sweep."""
    import importlib.util
    from pathlib import Path
    from repro_torch.launch import crossover_analysis as ca
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "crossover_analysis.py"
    spec = importlib.util.spec_from_file_location("crossover_example", path)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    assert ca.BW_SWEEP == ref.BW_SWEEP
    for stage in ("training_crossover", "serving_crossover_modeled"):
        getattr(ref, stage)()
        want = capsys.readouterr().out
        getattr(ca, stage)()
        assert capsys.readouterr().out == want, stage
    lines = []
    res = ca.serving_crossover_measured("cpu", log=lines.append)
    assert res["split"] == res["local"] and len(res["local"]) == 6
    assert all(len(t) == 8 for t in res["local"])
    text = "\n".join(lines)
    assert "token-identical to one-engine" in text
    assert sum(line.strip().startswith(f"{bw:8.0e}".strip())
               for line in lines for bw in ca.BW_SWEEP) == len(ca.BW_SWEEP)
