"""Sharded training of the VLM, audio, hybrid and ssm families on CPU
positions, in float32: the sharded step against the one-position step.

``launch/specs.py::make_train_step_fn(mesh=)`` trains llava's smoke
config tensor-parallel (the projector cut over "model", one reduce, b2
after it; each data slice through ``vlm.tp_loss_fn``) and whisper-base,
zamba2 and xLSTM gathered (every position gathers the whole tree from
the pieces and runs the family's one-device loss on its share of the
rows, which are cut over every position).  Positions are
``torch.device("cpu")`` repeated.

Tolerances are ``test_torch_train_sharded.py``'s: in float32 the sharded
step differs from the one-position step only by the order of sums, so
loss, metrics, gradient norm and every post-AdamW parameter are held to
``allclose(rtol=1e-5, atol=1e-6)`` at lr 1e-5; a ``pre_gather`` step
rounds every position's gradient to bfloat16, so it is held to the
one-position ``pre_gather`` step at bfloat16's rounding (loss 1e-5,
gradient norm 1e-4, each first-moment element within 2^-6 of its value
plus 2^-8 of its leaf's largest).
"""
import ast
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import sharding as sh
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import Mesh
from repro_torch.models.api import build_model
from repro_torch.optim.optimizers import tree_leaves

CPU = torch.device("cpu")
B, S = 4, 32
LR = 1e-5
SHAPE = InputShape("test_sharded_families", S, B, "train")
F32 = dict(lr=LR, compute_dtype=torch.float32)
ARCHS = ["llava-next-mistral-7b", "whisper-base", "zamba2-2.7b",
         "xlstm-1.3b"]
PRE_GATHER = {"llava-next-mistral-7b": "baseline", "xlstm-1.3b": "fsdp_flat"}
KERNELS = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels"


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test, beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(dp, tp):
    return Mesh([CPU] * (dp * tp), ("data", "model"), shape=(dp, tp))


def _batch(cfg, rows=B, seed=1):
    """Tokens, next-token labels (-1 over part of row 0) and the
    frontend's embeddings, made with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (rows, S + 1))
    batch = {"tokens": torch.from_numpy(tokens[:, :-1]),
             "labels": torch.from_numpy(tokens[:, 1:].copy())}
    batch["labels"][0, 3:9] = -1
    if cfg.family == "vlm":
        shape = (rows, cfg.frontend.n_tokens, cfg.frontend.d_embed)
        batch["patches"] = torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32))
    if cfg.family == "audio":
        shape = (rows, cfg.encoder_positions, cfg.frontend.d_embed)
        batch["frames"] = torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32))
    return batch


@pytest.fixture(scope="module")
def models():
    """arch -> the API, float32 params, a batch and the one-position
    float32 step's (params, opt_state, metrics), without and with
    pre_gather."""
    out = {}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    for arch in ARCHS:
        api = build_model(get_config(arch).smoke_variant())
        params = api.init(seed=0, device="cpu", dtype=torch.float32)
        batch = _batch(api.cfg)
        ref = {}
        for pg in (False, True) if arch in PRE_GATHER else (False,):
            step, opt = sp.make_train_step_fn(api, SHAPE, pre_gather=pg,
                                              **F32)
            ref[pg] = step(params, opt.init(params), batch)
        out[arch] = dict(api=api, params=params, batch=batch, ref=ref)
    torch.set_num_threads(n)
    return out


def _sharded(m, dp, tp, policy="baseline", batch=None, **kw):
    """The sharded step from ``m``'s params on a dp x tp mesh: (whole
    params after it, whole opt state, metrics, the step, the specs)."""
    mesh = _mesh(dp, tp)
    specs = sp.train_specs(m["api"], m["params"], mesh, policy)
    placed = sh.place(m["params"], specs, mesh)
    step, opt = sp.make_train_step_fn(m["api"], SHAPE, mesh=mesh,
                                      specs=specs, **{**F32, **kw})
    p, s, met = step(placed, opt.init(placed), m["batch"] if batch is None
                     else batch)
    state = {k: sh.unshard(s[k], specs, mesh) for k in ("m", "v")}
    return sh.unshard(p, specs, mesh), state, met, step, specs


def _check_f32(m, got_p, got_m):
    want_p, _, want_m = m["ref"][False]
    assert set(got_m) == set(want_m)
    for k in want_m:
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for a, b in zip(tree_leaves(got_p), tree_leaves(want_p)):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_equals_one_position(models, arch, mesh):
    """Loss, metrics, gradient norm and every post-AdamW parameter of the
    float32 sharded step against the one-position step, in the regime
    the family takes: the VLM tensor-parallel (its collectives a slice:
    the dense design's 6 L + 4 and the projector's reduce and dual), the
    others gathered (the gathers and their duals by design)."""
    m = models[arch]
    got_p, _, got_m, step, specs = _sharded(m, *mesh)
    _check_f32(m, got_p, got_m)
    cfg = m["api"].cfg
    if cfg.family == "vlm":
        assert not sp.gathers_whole(m["api"], specs)
        assert [p.collectives for p in step.plans] == \
            [6 * cfg.n_layers + 6] * mesh[0]
    else:
        assert sp.gathers_whole(m["api"], specs)
        sizes = dict(zip(("data", "model"), mesh))
        cut = [s for s in sh.leaves(specs) if any(
            sizes[a] > 1 for c in s if c is not None
            for a in (c if isinstance(c, tuple) else (c,)))]
        assert step.gather.collectives == 2 * len(cut) > 0
        assert len(step.gather.devices) == mesh[0] * mesh[1]


@pytest.mark.parametrize("policy", ["local_recurrent", "fsdp_flat"])
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-1.3b"])
def test_recurrent_policies_equal_one_position(models, arch, policy,
                                               monkeypatch):
    """The recurrent families under ``local_recurrent`` and ``fsdp_flat``
    on 2 x 2 positions; the smoke leaves are all below fsdp_flat's size
    floor, so it is lowered to cut every leaf it can jointly over
    ("data", "model")."""
    monkeypatch.setattr(sh, "FSDP_FLAT_MIN_ELEMENTS", 1 << 12)
    m = models[arch]
    got_p, _, got_m, _, specs = _sharded(m, 2, 2, policy)
    if policy == "fsdp_flat":
        assert ("data", "model") in [c for s in sh.leaves(specs) for c in s]
    _check_f32(m, got_p, got_m)


@pytest.mark.parametrize("arch,policy", PRE_GATHER.items())
def test_pre_gather_step_matches_one_position(models, arch, policy,
                                              monkeypatch):
    """2 x 2 with ``pre_gather`` against the one-position ``pre_gather``
    step, at bfloat16's rounding of the gradients: the VLM
    tensor-parallel, xLSTM gathered from joint cuts."""
    monkeypatch.setattr(sh, "FSDP_FLAT_MIN_ELEMENTS", 1 << 12)
    m = models[arch]
    _, want_s, want_m = m["ref"][True]
    _, got_s, got_m, _, _ = _sharded(m, 2, 2, policy, pre_gather=True)
    np.testing.assert_allclose(float(got_m["loss"]), float(want_m["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(got_m["grad_norm"]),
                               float(want_m["grad_norm"]), rtol=1e-4)
    for a, b in zip(tree_leaves(got_s["m"]), tree_leaves(want_s["m"])):
        scale = float(b.abs().max())
        assert bool(((a - b).abs() <= 2 ** -6 * b.abs()
                     + 2 ** -8 * scale).all())


def test_batch_that_does_not_divide_the_positions_raises(models):
    """The gathered regime cuts the rows over every position: 6 rows on 4
    positions raise, naming both numbers."""
    m = models["xlstm-1.3b"]
    with pytest.raises(ValueError, match="6 rows.*4 positions"):
        _sharded(m, 2, 2, batch=_batch(m["api"].cfg, rows=6))


def _in_device_guard(tree: ast.AST) -> set:
    """The ids of the nodes inside a ``with torch.cuda.device(...)``."""
    inside = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.With) and any(
                ast.unparse(item.context_expr).startswith(
                    "torch.cuda.device(") for item in node.items):
            inside.update(id(n) for n in ast.walk(node))
    return inside


def test_kernel_launches_run_under_their_inputs_device():
    """Several cards: no shared-memory opt-in of ``kernels/csrc`` is held
    once a process (each is a ``PerDevice`` record), and every call of
    ``kernels/*.py`` that hands a library a CUDA stream runs under
    ``torch.cuda.device`` of its input."""
    for src in sorted((KERNELS / "csrc").glob("*.cu*")):
        text = src.read_text()
        assert not re.search(r"static (bool|size_t)\b", text), src.name
        if "cudaFuncAttributeMaxDynamicSharedMemorySize" in text:
            assert "PerDevice" in text or src.name.endswith(".cuh"), src.name
    launches = 0
    for src in sorted(KERNELS.glob("*.py")):
        tree = ast.parse(src.read_text())
        inside = _in_device_guard(tree)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            args = [ast.unparse(a) for a in node.args]
            if any(a.endswith(".cuda_stream") or a in ("stream", "st")
                   or a.startswith("_stream(") for a in args):
                launches += 1
                assert id(node) in inside, (src.name, node.lineno)
    assert launches >= 8
