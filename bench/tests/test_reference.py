"""The plain reference against the program at smoke size on the CPU,
both in float32: the whole-sequence forward, and the replay of served
steps from the cache they ran on."""
import numpy as np
import pytest
import torch

from bench.harness import check, model_config as mc, weights
from bench.harness.drive import Driver
from bench.reference import model as ref
from bench.tests.smoke import DENSE, MOE


@pytest.mark.parametrize("cfg", [DENSE, MOE], ids=["starcoder2-like",
                                                   "deepseek-like"])
def test_forward_matches_the_program(cfg):
    from repro_torch.models.api import build_model
    p = weights.make(cfg, 11, device="cpu", dtype=torch.float32)
    api = build_model(mc.program_arch(cfg, strict=False))
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg["vocab_size"], (2, 150), generator=g)
    got, _ = api.forward(p, toks, compute_dtype=torch.float32, remat=False,
                         window=mc.window(cfg))
    want = ref.logits(cfg, lambda l: weights.layer(p, l), p,
                      list(toks), [torch.arange(150)] * 2, device="cpu")
    for i in range(2):
        assert torch.allclose(got[i], want[i], atol=2e-5, rtol=1e-5)


def test_fp8_control_departs_from_float32():
    p = weights.make(DENSE, 4, device="cpu", dtype=torch.float32)
    toks = torch.randint(0, 512, (100,), generator=torch.Generator()
                         .manual_seed(1))
    f32 = ref.logits(DENSE, lambda l: weights.layer(p, l), p, [toks],
                     [torch.arange(100)], device="cpu")[0]
    f8 = ref.logits(DENSE, lambda l: weights.layer(p, l), p, [toks],
                    [torch.arange(100)], quant="fp8", device="cpu")[0]
    rel = (f8 - f32).norm() / f32.norm()
    assert 0.01 < rel < 0.5


@pytest.mark.parametrize("cfg", [DENSE, MOE], ids=["starcoder2-like",
                                                   "deepseek-like"])
def test_replay_matches_served_steps(cfg):
    """A float32 engine's steps, replayed from its cache: every emitted
    token is the reference's best and the written keys and values agree
    to float32 rounding, prefix hits, speculation and the MoE's one
    capacity group included."""
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import PagedDecodeEngine
    p = weights.make(cfg, 12, device="cpu", dtype=torch.float32)
    api = build_model(mc.program_arch(cfg, strict=False))
    eng = PagedDecodeEngine(api, p, n_slots=4, cache_len=256,
                            chunk_tokens=32, token_budget=64,
                            window=mc.window(cfg), device="cpu")
    drv = Driver(eng)
    rng = np.random.default_rng(0)
    shared = rng.integers(0, 512, 48).astype(np.int32)
    for n in (20, 90, 33):
        drv.submit(np.concatenate([shared, rng.integers(0, 512, n)
                                   .astype(np.int32)]), 12, 0.0)
    def history(rid):
        r = drv.reqs[rid]
        return [int(t) for t in r.prompt] + r.tokens
    gaps, errs, rows, emitted = [], [], [], 0
    with torch.no_grad():
        while eng.has_work():
            st = drv.step(detail=True)
            got = check.replay(cfg, p, eng, st, device="cpu")
            gaps.append(got["gap"])
            errs.append(got["kv_err"])
            rows.append(got["kv_row_err"])
            rows.append(check.context_check(cfg, p, eng, history,
                                            device="cpu")["ctx_kv_row_err"])
            emitted += st.emitted
    assert emitted == 36
    assert np.concatenate(gaps).max() < 1e-4
    assert np.concatenate(errs).max() < 1e-5
    assert np.concatenate(rows).max() < 1e-4
    assert eng.stats()["prefix_tokens_reused"] > 0
