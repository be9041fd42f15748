"""Copy-on-write blocks under the check, at smoke size on the CPU: a
prompt sent again whole is served from the prefix cache, its shared
tail block is copied before the engine writes into it, and the tokens
served over the copy are those the reference reads."""
import numpy as np
import torch

from bench.harness import check, model_config as mc, weights
from bench.harness.drive import Driver
from bench.tests.smoke import DENSE, ENGINE


def test_prompt_sent_again_is_served_through_a_copied_block():
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import PagedDecodeEngine
    p = weights.make(DENSE, 21, device="cpu")
    engine = PagedDecodeEngine(build_model(mc.program_arch(DENSE,
                                                           strict=False)),
                               p, window=mc.window(DENSE), device="cpu",
                               **ENGINE)
    drv = Driver(engine)
    prompt = np.random.default_rng(3).integers(0, 512, 80).astype(np.int32)
    with torch.no_grad():
        first = drv.submit(prompt, 8, drv.clock())
        drv.drain()
        again = drv.submit(prompt, 8, drv.clock())
        drv.drain()
    stats = engine.stats()
    assert stats["prefix_tokens_reused"] >= 64
    assert stats["cow_copies"] >= 1
    assert again.tokens == first.tokens
    got = check.gaps_of(DENSE, p, [first, again], device="cpu")
    assert got["gap"].size == 16
    assert float(got["gap"].max()) < 0.05
