"""The port's dry-run (``launch/dryrun.py``): steps on the ``meta`` device
counted by ``FlopCounterMode``, against the reference's analytic account.

* The counted FLOPs of a train step agree with ``analytic.step_account``
  on the reference's loop-free configs (1 layer, vocab 2048, 2 x 256
  tokens, remat off): starcoder2-7b and gemma-7b within a relative 0.10,
  qwen3-moe-235b-a22b within 0.25, the reference's own tolerances against
  XLA's count (``tests/test_roofline.py``).
* ``run_combo`` writes artifacts that ``load_artifact`` reads, and
  SKIPPED ones with the reference's reason.
* On a 1 x 2 mesh of CPU positions, a tensor-parallel train step's
  ``TPPlan.collective_bytes`` equals the bytes of the collectives'
  outputs that position 0 receives, summed by a wrapper here around
  ``_Reduce``/``_Gather``, and with the parameters' collectives it makes
  the dry-run's figure on meta positions (exact).
* The parameters' collectives (``ParamCollectives``, and the gathered
  regime's ``GatherPlan``) equal what the step's local trees show on
  CPU positions, in both regimes on 1 x 2 and 2 x 2 (exact): a leaf
  whose local tensor is larger than its piece was gathered (and its
  gradient reduce-scattered), and a leaf with fewer pieces than
  positions is read alike by some (its gradient summed).
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_shape as jax_get_shape
from repro.launch import specs as jspecs
from repro_torch.configs import get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import dryrun
from repro_torch.launch import sharding as sh
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer
from repro_torch.models.api import build_model
from repro_torch.roofline import analytic
from repro_torch.roofline.analysis import load_artifact

CPU = torch.device("cpu")
TINY = InputShape("tiny_train", 256, 2, "train")
SMOKE = InputShape("smoke_train", 32, 2, "train")
SMOKE4 = InputShape("smoke_train", 32, 4, "train")    # rows for 2 x 2


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test, beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch,tol", [
    ("starcoder2-7b", 0.10), ("gemma-7b", 0.10),
    ("qwen3-moe-235b-a22b", 0.25),
])
def test_counted_flops_match_analytic_loop_free(arch, tol):
    cfg = dataclasses.replace(get_config(arch), n_layers=1, vocab_size=2048)
    if cfg.moe:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, first_dense_layers=0))
    api = build_model(cfg)
    out = dryrun.meta_pass(api, TINY, remat=False)
    tree = sp.abstract_params(api, torch.float32)
    acct = analytic.step_account(
        cfg, TINY, window=0, n_params_total=dryrun.count_params(tree),
        n_params_active=dryrun.moe_active_params(cfg, tree), remat=False)
    counted = out["counted"]["flops"]
    assert abs(acct["flops"] - counted) / counted < tol, (
        arch, acct["flops"], counted)
    assert out["memory"]["opt_state_bytes"] == 8 * dryrun.count_params(
        tree) + 4


def test_run_combo_artifacts(tmp_path):
    arts = {}
    for arch, shape in (("whisper-base", "prefill_32k"),
                        ("gemma-7b", "decode_32k")):
        art = arts[arch] = dryrun.run_combo(arch, shape,
                                            out_dir=str(tmp_path),
                                            verbose=False)
        assert art["status"] == "OK"
        assert art["counted"]["flops"] > 0
        t = load_artifact(str(tmp_path / f"{arch}_{shape}_1x1.json"))
        assert (t.arch, t.shape, t.mesh, t.n_chips) == (arch, shape, "1x1",
                                                        1)
        assert t.hlo_flops == art["analytic"]["flops"]
        assert t.hlo_bytes == art["analytic"]["bytes"]
        assert t.step_time_lower_bound == pytest.approx(
            art["roofline"]["t_" + t.dominant])
    art = arts["gemma-7b"]
    # the whole 32k-slot cache: K and V in bf16, the slot positions and
    # the lanes' positions in int32
    assert art["memory"]["cache_bytes"] == (
        28 * 128 * 32768 * 16 * 256 * 2 * 2 + 128 * 32768 * 4 + 128 * 4)
    assert art["counted"]["flops"] == pytest.approx(
        art["analytic"]["flops"], rel=1e-3)

    skip = dryrun.run_combo("whisper-base", "long_500k",
                            out_dir=str(tmp_path), verbose=False)
    assert skip["status"] == "SKIPPED"
    assert skip["skip_reason"] == jspecs.combo_supported(
        jax_get_config("whisper-base"), jax_get_shape("long_500k"))[1]


def test_sharded_serving_steps_are_refused():
    api = build_model(get_config("gemma-7b").smoke_variant())
    for kind in ("prefill", "decode"):
        with pytest.raises(ValueError, match="PagedDecodeEngine"):
            dryrun.meta_pass(api, InputShape("s", 32, 2, kind),
                             mesh_shape=(1, 2))


def test_kernel_path_on_meta_raises():
    """The meta pass takes the plain paths because its tensors are off
    the card; asking for the kernels there raises, as on the CPU."""
    api = build_model(get_config("gemma-7b").smoke_variant())
    shape = InputShape("s", 32, 2, "prefill")
    params = sp.cast_params_bf16(sp.abstract_params(api))
    batch = sp.batch_abstract(api.cfg, shape)
    step = sp.make_prefill_step_fn(api, shape, use_kernel=True)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        step(params, batch)


def _batch(cfg, seed=1, shape=SMOKE):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (shape.global_batch,
                                              shape.seq_len + 1))
    batch = {"tokens": torch.from_numpy(tokens[:, :-1]),
             "labels": torch.from_numpy(tokens[:, 1:].copy())}
    if cfg.family == "audio":
        frames = (shape.global_batch, cfg.encoder_positions,
                  cfg.frontend.d_embed)
        batch["frames"] = torch.from_numpy(
            rng.standard_normal(frames, dtype=np.float32))
    return batch


def _nbytes(t) -> int:
    return 0 if t is None else t.numel() * t.element_size()


class _Tally:
    """Wraps ``_Reduce`` and ``_Gather``: the bytes of each collective's
    output that position 0 receives (a reduce's sum, a gather's whole,
    the backward's gradient of part 0)."""

    def __init__(self, monkeypatch):
        self.bytes = 0
        for fn in (transformer._Reduce, transformer._Gather):
            for name in ("forward", "backward"):
                monkeypatch.setattr(fn, name, staticmethod(
                    self._wrap(getattr(fn, name), name)))

    def _wrap(self, f, name):
        def run(ctx, *args):
            out = f(ctx, *args)
            self.bytes += _nbytes(out[0] if name == "forward" else out[1])
            return out
        return run


def test_collective_bytes_match_the_collectives(monkeypatch):
    api = build_model(get_config("gemma-7b").smoke_variant())
    params = api.init(seed=0, device="cpu", dtype=torch.float32)
    mesh = Mesh([CPU] * 2, ("data", "model"), shape=(1, 2))
    specs = sp.train_specs(api, params, mesh)
    placed = sh.place(params, specs, mesh)
    step, opt = sp.make_train_step_fn(api, SMOKE, mesh=mesh, specs=specs)
    tally = _Tally(monkeypatch)
    step(placed, opt.init(placed), _batch(api.cfg))
    plan = step.plans[0]
    assert plan.collectives > 0 and plan.collective_bytes > 0
    assert plan.collective_bytes == tally.bytes
    monkeypatch.undo()
    dry = dryrun.meta_pass(api, SMOKE, mesh_shape=(1, 2))
    assert dry["collectives"]["tensor-parallel"] == {
        "count": plan.collectives, "bytes": float(plan.collective_bytes)}
    pc = step.param_collectives
    assert pc.reduces > 0
    assert dry["collectives"]["all-reduce"] == {
        "count": pc.reduces, "bytes": float(pc.reduce_bytes)}
    assert dry["collective_bytes_total"] == (plan.collective_bytes
                                             + pc.collective_bytes)


def _observed(api, mesh, pre_gather, monkeypatch):
    """One sharded step of ``api`` on ``mesh``: (the step, the
    collectives its position 0's local tree shows)."""
    params = api.init(seed=0, device="cpu", dtype=torch.float32)
    specs = sp.train_specs(api, params, mesh)
    placed = sh.place(params, specs, mesh)
    step, opt = sp.make_train_step_fn(api, SMOKE4, mesh=mesh, specs=specs,
                                      pre_gather=pre_gather)
    seen = {}
    local_trees = sh.local_trees

    def spy(placed_, specs_, mesh_, **kw):
        seen["trees"] = local_trees(placed_, specs_, mesh_, **kw)
        return seen["trees"]

    monkeypatch.setattr(sh, "local_trees", spy)
    step(placed, opt.init(placed), _batch(api.cfg, shape=SMOKE4))
    n = dict.fromkeys(("gathers", "reduces", "gather_bytes",
                       "scatter_bytes", "reduce_bytes"), 0)
    held = sh.leaves(sh._zip_map(lambda p, s: (p,), placed, specs))
    for local, (pieces,) in zip(sh.leaves(seen["trees"][0]), held):
        own = pieces[0].numel() * local.element_size()
        if local.numel() > pieces[0].numel():
            n["gathers"] += 1
            n["gather_bytes"] += _nbytes(local)
            n["scatter_bytes"] += own
        if len(pieces) < mesh.devices.size:
            n["reduces"] += 1
            n["reduce_bytes"] += own
    return step, n


@pytest.mark.parametrize("pre_gather", [False, True])
@pytest.mark.parametrize("arch,mesh_shape", [
    ("whisper-base", (1, 2)), ("whisper-base", (2, 2)),
    ("gemma-7b", (2, 2))])
def test_gather_plan_bytes(monkeypatch, arch, mesh_shape, pre_gather):
    """The parameters' collectives of a smoke config's sharded step: the
    gathered regime (whisper-base) and the tensor-parallel one (gemma-7b,
    its "data" cuts gathered) on CPU positions."""
    api = build_model(get_config(arch).smoke_variant())
    mesh = Mesh([CPU] * math.prod(mesh_shape), ("data", "model"),
                shape=mesh_shape)
    step, n = _observed(api, mesh, pre_gather, monkeypatch)
    pc = step.param_collectives
    assert dataclasses.asdict(pc) == n
    assert n["gathers"] > 0 and n["reduces"] > 0
    assert pc.collectives == 2 * n["gathers"] + n["reduces"]
    assert pc.collective_bytes == (n["gather_bytes"] + n["scatter_bytes"]
                                   + n["reduce_bytes"])
    if arch == "whisper-base":
        g = step.gather
        assert g.gathers == n["gathers"] and g.collectives == 2 * g.gathers
        assert (g.gather_bytes, g.scatter_bytes) == (n["gather_bytes"],
                                                     n["scatter_bytes"])
    else:
        assert not hasattr(step, "gather")
