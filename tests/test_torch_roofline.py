"""The port's roofline tooling against the reference's.

The shape registry, ``ASSIGNED_ARCHS`` and ``combo_supported`` must equal
the reference's on every arch x shape; ``analytic.forward_flops`` and
``analytic.step_account`` must equal the reference's for every assigned
arch x shape, with both MoE dispatch impls and remat on and off, at the
same window and parameter counts (relative 1e-12); and
``RooflineTerms`` must do its arithmetic on the H100's constants as the
reference's test does on the TPU's.  (The dry-run's parameter and active
counts are held to the reference's ``jax.eval_shape`` counts in
``test_torch_sharding.py``, on the reference trees that file builds.)
"""
import dataclasses

import pytest
import torch

from repro.configs import ASSIGNED_ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import get_shape as jax_get_shape
from repro.launch import specs as jspecs
from repro.roofline import analytic as janalytic
from repro_torch.configs import (ASSIGNED_ARCHS, SHAPES, all_shapes,
                                 get_config, get_shape)
from repro_torch.launch import dryrun
from repro_torch.launch import specs
from repro_torch.launch.mesh import (CHIP_HBM_BW, CHIP_PEAK_FLOPS_BF16,
                                     NVLINK_BW)
from repro_torch.models.api import build_model
from repro_torch.roofline import analytic
from repro_torch.roofline.analysis import RooflineTerms, model_flops_estimate

REL = 1e-12


@pytest.fixture(scope="module")
def counts():
    """arch -> (total, active) parameters of the port's meta tree."""
    out = {}
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        tree = specs.abstract_params(build_model(cfg), torch.float32)
        out[arch] = (dryrun.count_params(tree),
                     dryrun.moe_active_params(cfg, tree))
    return out


def test_shape_registry_equals_reference():
    assert ASSIGNED_ARCHS == JAX_ARCHS
    assert list(SHAPES) == list(JAX_SHAPES)
    for name, shape in SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            JAX_SHAPES[name])
        assert get_shape(name) is shape
    assert [s.name for s in all_shapes()] == list(JAX_SHAPES)
    with pytest.raises(KeyError) as got:
        get_shape("train_8k")
    with pytest.raises(KeyError) as want:
        jax_get_shape("train_8k")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_combo_supported_and_abstract_inputs_equal_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name in SHAPES:
        assert specs.combo_supported(cfg, SHAPES[name]) == \
            jspecs.combo_supported(jcfg, JAX_SHAPES[name])
        if SHAPES[name].kind == "decode":
            continue
        got = specs.batch_abstract(cfg, SHAPES[name])
        want = jspecs.batch_abstract(jcfg, JAX_SHAPES[name])
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in got.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
        assert all(v.device.type == "meta" for v in got.values())


def _close(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            _close(got[k], v)
        else:
            assert got[k] == pytest.approx(v, rel=REL, abs=0.0), k


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_step_account_equals_reference(arch, counts):
    """Every shape, both MoE impls, remat on and off."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    api = build_model(cfg)
    impls = ("gshard", "gather") if cfg.moe is not None else (None,)
    n_total, n_active = counts[arch]
    for impl in impls:
        c, jc = cfg, jcfg
        if impl:
            c = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, impl=impl))
            jc = dataclasses.replace(jcfg, moe=dataclasses.replace(
                jcfg.moe, impl=impl))
        for name, shape in SHAPES.items():
            window = api.effective_window(shape.seq_len)
            tokens = dryrun.tokens_per_step(c, shape)
            _close(analytic.forward_flops(c, shape, window=window,
                                          tokens=tokens),
                   janalytic.forward_flops(jc, JAX_SHAPES[name],
                                           window=window, tokens=tokens))
            for remat in (True, False):
                _close(analytic.step_account(
                    c, shape, window=window, n_params_total=n_total,
                    n_params_active=n_active, remat=remat),
                    janalytic.step_account(
                        jc, JAX_SHAPES[name], window=window,
                        n_params_total=n_total, n_params_active=n_active,
                        remat=remat))


def test_roofline_term_arithmetic():
    """The reference's term test on the H100's constants (one card's
    second of compute, half a second of HBM, a quarter of NVLink)."""
    t = RooflineTerms(arch="a", shape="s", mesh="m", n_chips=4,
                      hlo_flops=4 * CHIP_PEAK_FLOPS_BF16,
                      hlo_bytes=4 * CHIP_HBM_BW * 0.5,
                      collective_bytes_per_dev=NVLINK_BW * 0.25,
                      model_flops=4 * CHIP_PEAK_FLOPS_BF16 * 0.6)
    assert t.compute_term == pytest.approx(1.0)
    assert t.memory_term == pytest.approx(0.5)
    assert t.collective_term == pytest.approx(0.25)
    assert t.dominant == "compute"
    assert t.step_time_lower_bound == pytest.approx(1.0)
    assert t.mfu_upper_bound == pytest.approx(0.6)
    assert t.useful_flops_ratio == pytest.approx(0.6)
    assert (t.peak_flops, t.hbm_bw, t.link_bw) == (989e12, 3.35e12, 450e9)
    row = t.row()
    assert row["dominant"] == "compute" and row["chips"] == 4
    assert row["t_memory"] == pytest.approx(0.5)
    assert model_flops_estimate(10, 7, "train") == 420.0
    assert model_flops_estimate(10, 7, "forward") == 140.0
