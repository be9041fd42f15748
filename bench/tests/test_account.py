"""B1's least time and the useful FLOPs, on hand-worked steps."""
import json

import pytest

from bench.harness import account
from bench.tests.smoke import BENCH, DENSE


def _brute_span(start, rows, window):
    return sum(min(p + 1, window) if window else p + 1
               for p in range(start, start + rows))


@pytest.mark.parametrize("start,rows,window", [
    (0, 1, 0), (0, 10, 0), (5, 3, 0), (0, 10, 4), (2, 10, 4), (10, 5, 4),
    (3, 1, 4), (4095, 2, 4096), (100, 4000, 4096), (0, 1, 1)])
def test_span_sum(start, rows, window):
    assert account.span_sum(start, rows, window) == \
        _brute_span(start, rows, window)


def test_b1_on_a_hand_worked_step():
    cfg = dict(DENSE)            # 2 layers, H 4, Hkv 1, D 64, window 64
    # a decode token at position 99 (sees 64 keys, 64 distinct) and a
    # prefill chunk of 8 tokens at positions 0..7 (1 + .. + 8 = 36 keys)
    segs = [(99, 1, 1), (0, 8, 8)]
    H, Hkv, D, L = 4, 1, 64, 2
    flops = L * 4 * H * D * (64 + 36)
    kv = L * 2 * Hkv * D * 2 * (64 + 8)
    qo = L * 2 * H * D * 2 * (1 + 8)
    assert account.b1_counts(cfg, segs) == (flops, kv + qo)
    assert account.b1_least_s(cfg, segs) == max(
        flops / account.PEAK_FLOPS, (kv + qo) / account.PEAK_BYTES)


def test_useful_flops_count_kept_rows_only():
    cfg = dict(DENSE)
    d, ff, V, L, H, D = 256, 512, 512, 2, 4, 64
    n = L * (d * H * D * 2 + d * 1 * D * 2 + 2 * d * ff) + d * V
    assert account.active_params(cfg) == n
    # a draft segment: 1 fed token + 4 drafts at positions 10.., 2 kept
    segs = [(10, 5, 2)]
    assert account.useful_flops(cfg, segs) == \
        2 * n * 2 + L * 4 * H * D * (11 + 12)


def test_published_sizes():
    sc = json.loads((BENCH / "configs" / "starcoder2-7b.json").read_text())
    ds = json.loads((BENCH / "configs" / "deepseek-moe-16b.json")
                    .read_text())
    # 7.40 B parameters of which the embedding is 0.23 B
    assert abs(account.active_params(sc) - 7.17e9) < 0.01e9
    # 2.62 B active parameters a token (router, 6 routed, 2 shared)
    assert abs(account.active_params(ds) - 2.62e9) < 0.01e9


def test_moe_count_leaves_out_the_dispatch():
    """The MoE layer's useful FLOPs a token are the program's account's
    experts, shared experts and router, without its dispatch einsums."""
    import dataclasses
    from repro_torch.roofline.analytic import _moe_flops_per_token
    from bench.harness import model_config as mc
    ds = json.loads((BENCH / "configs" / "deepseek-moe-16b.json")
                    .read_text())
    arch = mc.program_arch(ds)
    mf = _moe_flops_per_token(arch, 4096)
    useful = mf["expert"] + mf["shared"] + mf["router"]
    cut = dict(ds, num_hidden_layers=2)      # the dense layer + one MoE
    dense_only = dict(ds, num_hidden_layers=1)
    per_moe_layer = 2 * (account.active_params(cut)
                         - account.active_params(dense_only))
    attn = 2 * (2 * 2048 * 16 * 128 * 2)
    assert per_moe_layer - attn == useful
    assert mf["dispatch"] > 0.5 * useful     # what the account would add
    assert dataclasses.replace(arch, moe=dataclasses.replace(
        arch.moe, impl="gather")) != arch
