"""Every architecture the reference assigns (``repro.configs.ASSIGNED_ARCHS``)
builds, trains and serves in the port on the CPU: the counterpart of
``tests/test_models_smoke.py``, on the port's smoke configs.  Per arch,
one float32-master ``make_train_step_fn`` step from the port's own init
(a finite loss and gradient norm, every parameter finite and some moved),
a checkpoint round trip of the new parameters (an MoE config's
``head_blocks`` list included), the forward's logits shape, and one
decode step.  The frontend stubs' inputs (whisper's frames, llava's
patches) come from the training launcher's ``frontend_inputs``."""
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS
from repro_torch.configs import get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.data.synthetic import lm_token_batch
from repro_torch.launch import specs
from repro_torch.launch.train import frontend_inputs
from repro_torch.models.api import build_model
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.train import checkpoint as ckpt

B, S = 2, 32


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_builds_trains_and_decodes(arch, tmp_path):
    cfg = get_config(arch).smoke_variant()
    api = build_model(cfg)
    gen = torch.Generator()
    gen.manual_seed(0)
    batch = lm_token_batch(gen, B, S, cfg.vocab_size, device="cpu")
    extra = frontend_inputs(cfg, B, gen, "cpu")
    batch.update(extra)
    params = api.init(seed=0, device="cpu", dtype=torch.float32)
    step, opt = specs.make_train_step_fn(
        api, InputShape("t", S, B, "train"), lr=1e-3)
    new_params, _, metrics = step(params, opt.init(params), batch)
    assert bool(torch.isfinite(metrics["loss"])), arch
    assert bool(torch.isfinite(metrics["grad_norm"])), arch
    assert float(metrics["ce"]) > 0
    moved = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(params), tree_leaves(new_params)))
    assert moved > 0, arch
    assert all(bool(torch.isfinite(p).all())
               for p in tree_leaves(new_params)), arch
    ckpt.save_checkpoint(str(tmp_path), 1, new_params)
    back, _ = ckpt.restore_checkpoint(str(tmp_path), params)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back),
                                                 tree_leaves(new_params)))

    with torch.no_grad():
        logits, _ = api.forward(params, batch["tokens"], remat=False,
                                **extra)
    n_extra = extra["patches"].shape[1] if "patches" in extra else 0
    assert tuple(logits.shape) == (B, n_extra + S, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()), arch

    cache = api.init_cache(B, 64, dtype=torch.float32, device="cpu")
    tokens = batch["tokens"][:, :1]
    with torch.no_grad():
        logits, cache = api.decode_step(new_params, cache, tokens)
    assert tuple(logits.shape) == (B, 1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()), arch
    assert cache["pos"].tolist() == [1] * B
