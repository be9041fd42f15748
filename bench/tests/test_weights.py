"""The benchmark's weights have the tree the program's init returns."""
import pytest
import torch

from bench.harness import model_config as mc
from bench.harness import weights
from bench.tests.smoke import DENSE, MOE


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tuple(tree.shape), tree.dtype


@pytest.mark.parametrize("cfg", [DENSE, MOE], ids=["dense", "moe"])
def test_tree_matches_the_programs(cfg):
    from repro_torch.models.api import build_model
    api = build_model(mc.program_arch(cfg, strict=False))
    want = sorted(_leaves(api.init(seed=0, device="meta",
                                   dtype=torch.bfloat16)))
    got = sorted(_leaves(weights.make(cfg, 3, device="cpu")))
    assert got == want


def test_same_seed_same_weights():
    a = weights.make(DENSE, 2 ** 41 + 1, device="cpu")
    b = weights.make(DENSE, 2 ** 41 + 1, device="cpu")
    c = weights.make(DENSE, 5, device="cpu")
    assert torch.equal(a["blocks"]["attn"]["wq"], b["blocks"]["attn"]["wq"])
    assert not torch.equal(a["blocks"]["attn"]["wq"],
                           c["blocks"]["attn"]["wq"])
    assert a["blocks"]["attn"]["bq"].abs().max() > 0     # biases drawn


@pytest.mark.parametrize("name", ["starcoder2-7b", "deepseek-moe-16b"])
def test_the_program_runs_the_files_sizes(name):
    """The registered architecture equals the configuration file, so the
    strict check of every run passes."""
    cfg = mc.load(name)
    arch = mc.program_arch(cfg, strict=True)
    assert arch.name == name
    full = sum(t.numel() for _, t in _named(
        __import__("repro_torch.models.api", fromlist=["build_model"])
        .build_model(arch).init(seed=0, device="meta")))
    assert abs(full - {"starcoder2-7b": 7.40e9,
                       "deepseek-moe-16b": 16.38e9}[name]) < 0.01e9


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _named(v, f"{prefix}/{i}")
    else:
        yield prefix, tree
