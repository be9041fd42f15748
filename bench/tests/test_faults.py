"""The check on a whole run, at smoke size on the CPU with the program
in bfloat16 as served: a sound run is correct, the float8 control fails
a limit, and each fault a serving cell can have makes ``correct`` false.

Faults of training cells (half of a batch left out of a mean) and of
four-chip cells (the exchange between chips left out) do not arise in
these one-card serving cells."""
import pytest

from bench.harness import cell
from bench.tests.smoke import make_root

CELLS = ["dense.closed", "moe.closed"]
SEED = 2 ** 33 + 17


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("faults"))


def _run(bench, name, **kw):
    root, bj = bench
    return cell.run(name, SEED, 2.0, False, device="cpu", root=root,
                    strict=False, bench_json=bj, **kw)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(bench, name):
    res = _run(bench, name)
    assert res["correct"], res["check"]
    assert res["check"]["checked_tokens"]["value"] >= 8
    assert list(res)[-3:] == ["check", "_check", "_run"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_a_limit(bench, name):
    """The float8 reference in the program's place, judged as the
    program is, is not correct."""
    res = _run(bench, name, control=True)
    assert res["correct"], res["check"]
    assert not res["_check"]["control"]["correct"], \
        res["_check"]["control"]["numbers"]


@pytest.mark.parametrize("name", CELLS)
def test_altered_token_is_caught(bench, name, monkeypatch):
    from repro_torch.serving import engine as eng_mod
    real = eng_mod._emit_token

    def altered(engine, req, tok):
        if len(req.generated) == 2:
            tok = (tok + 1) % engine.api.cfg.vocab_size
        return real(engine, req, tok)

    monkeypatch.setattr(eng_mod, "_emit_token", altered)
    assert not _run(bench, name)["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_unchanged_cache_is_caught(bench, name, monkeypatch):
    """A step that leaves its state (the KV pools) as it found it."""
    from repro_torch.models import transformer
    monkeypatch.setattr(transformer, "_write_kv_pool",
                        lambda *a, **k: None)
    assert not _run(bench, name)["correct"]


def test_one_lane_fault_is_caught(bench):
    """One block of one lane holding another lane's keys and values, as
    a wrong block-table entry would make it read."""
    from bench.tools import readings
    undo = readings.plant("lane")
    try:
        res = _run(bench, "moe.closed")
    finally:
        undo()
    assert not res["correct"], res["check"]
    assert res["check"]["max_kv_row_err"]["value"] > 0.5


def test_single_altered_token_reads_a_far_rank(bench):
    """One token altered where it is produced lies far down the
    reference's ranking, where sound tokens do not (``max_rank``, read
    but not compared: see PERF.md)."""
    from bench.tools import readings
    sound = readings._numbers(_run(bench, "moe.closed")["_check"]
                              ["readings"])["max_rank"]
    undo = readings.plant("token")
    try:
        res = _run(bench, "moe.closed")
    finally:
        undo()
    bad = readings._numbers(res["_check"]["readings"])["max_rank"]
    assert bad > sound, (sound, bad)
