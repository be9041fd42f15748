"""What the command runs loads no module named ``jax``, ``jaxlib``,
``flax`` or ``repro`` (the JAX package; ``repro_torch`` is the port),
and the command refuses to run without a card or without the program."""
import json
import shutil
import subprocess
import sys
import textwrap

from bench.tests.smoke import BENCH

ROOT = BENCH.parent


def test_a_run_loads_no_jax_and_no_jax_package(tmp_path):
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
        from pathlib import Path
        from bench.tests.smoke import make_root
        from bench.harness import cell
        from bench import run as entry
        root, bj = make_root(Path({str(tmp_path)!r}))
        for name in ("dense.open", "moe.closed"):
            cell.run(name, 5, 1.0, True, device="cpu", root=root,
                     strict=False, bench_json=bj)
        for m in bj["per_layer"] + bj["end_to_end"]:
            cell.metric_reader(m["name"], root)
        print(entry.forbidden_modules())
        print(sorted(m for m in sys.modules if m.split(".")[0] == "repro_torch")[:3])
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-2] == "[]"
    assert "repro_torch" in lines[-1]


def test_forbidden_names_are_compared_whole(monkeypatch):
    import types
    from bench import run as entry
    assert entry.forbidden_modules() == []
    for name in ("repro_torchish", "jaxtyping", "flaxen.sub"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert entry.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("j"))
    assert entry.forbidden_modules() == ["jax"]


def test_refuses_without_a_card_or_without_the_program(tmp_path):
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    w = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"][0]
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", w["name"], "--seed",
         "3000000001", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
