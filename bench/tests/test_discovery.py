"""A configuration, mix or metric is found by its name: adding files is
enough."""
import json

from bench.harness import cell
from bench.tests.smoke import CLOSED, make_root


def test_new_mix_and_metric_found_by_name(tmp_path):
    root, bj = make_root(tmp_path)
    mix = dict(CLOSED, clients=2, prompt_tokens={"low": 20, "high": 40})
    (root / "mixes" / "fresh-mix.json").write_text(json.dumps(mix))
    (root / "limits" / "dense.fresh-mix.json").write_text(json.dumps(
        {"max_gap": 0.05, "min_checked_tokens": 1}))
    (root / "metrics" / "requests_per_s.py").write_text(
        "def read(run):\n"
        "    t0, t1 = run.window\n"
        "    return sum(1 for r in run.requests if r.done is not None\n"
        "               and t0 <= r.done < t1) / (t1 - t0)\n")
    bj["workloads"].append({"name": "dense.fresh-mix", "config": "dense",
                            "traffic": "fresh-mix", "chips": 1,
                            "why": "a new cell"})
    bj["end_to_end"].append({"name": "requests_per_s", "unit": "1/s",
                             "better": "higher", "bound": 0.1,
                             "source": "host_clock",
                             "workloads": ["dense.fresh-mix"]})
    res = cell.run("dense.fresh-mix", 3, 1.5, False, device="cpu",
                   root=root, strict=False, bench_json=bj)
    assert res["metrics"]["requests_per_s"]["value"] > 0
    assert "tpot_p95_ms" not in res["metrics"]     # listed for others
    run = res["_run"]
    assert all(20 <= len(r.prompt) <= 40 for r in run.requests
               if r.max_new > 2)


def test_benchmark_json_names_existing_files():
    from bench.tests.smoke import BENCH
    bj = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for c in bj["configs"]:
        assert (BENCH.parent / c["file"]).exists()
    for w in bj["workloads"]:
        assert (BENCH / "mixes" / f"{w['traffic']}.json").exists()
        assert (BENCH / "limits" / f"{w['name']}.json").exists()
        assert w["config"] in {c["name"] for c in bj["configs"]}
    for m in bj["end_to_end"] + bj["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
