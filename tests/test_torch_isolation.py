"""The port stands alone: it imports neither JAX nor the reference
package, and its entry points default to the card instead of quietly
running on the CPU."""
import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    import repro_torch
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_importing_every_port_module_loads_no_jax_and_no_repro():
    mods = _port_modules()
    for name in ("serving.engine", "serving.transfer", "core",
                 "core.actions", "core.auth", "core.costmodel",
                 "core.facility", "core.flows", "core.funcx",
                 "core.pipeline_flow", "core.registry", "core.simclock",
                 "core.system", "core.transfer",
                 "launch.remote_retrain_flow", "launch.edge_serving",
                 "serving.frontend", "models.cookienetae",
                 "launch.crossover_analysis", "launch.mesh",
                 "launch.sharding"):
        assert f"repro_torch.{name}" in mods, name
    code = ("import sys\n"
            f"for m in {mods!r}:\n"
            "    __import__(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
            "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_source_imports_no_jax_and_no_repro(path):
    """No ``import jax`` / ``from repro.`` / ``import repro`` anywhere in
    the port or in chip_smoke.py (``repro_torch`` is the port itself)."""
    for name in _imports(ROOT / path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_default_device_is_the_card():
    """Built with the default device on a machine without CUDA, the
    engines, the model inits and the caches (dense, zamba2, xLSTM and
    whisper's encoder-decoder),
    CookieNetAE and its shots, and the launchers of the paper's workflow,
    of edge serving and of the crossover analysis raise instead of running
    on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import PagedDecodeEngine
    api = build_model(get_config("gemma-7b").smoke_variant())
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init(seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init_paged_cache(2, num_blocks=5, block_size=4,
                             max_blocks_per_lane=2)
    params = api.init(seed=0, device="cpu", dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedDecodeEngine(api, params, n_slots=2, cache_len=16)
    # the recurrent and audio families: init, caches and their slot engine
    from repro_torch.serving.engine import DecodeEngine
    for arch in ("zamba2-2.7b", "xlstm-1.3b", "whisper-base"):
        api = build_model(get_config(arch).smoke_variant())
        with pytest.raises(RuntimeError, match="CUDA"):
            api.init(seed=0)
        with pytest.raises(RuntimeError, match="CUDA"):
            api.init_cache(2, 16)
        params = api.init(seed=0, device="cpu", dtype=torch.float32)
        with pytest.raises(RuntimeError, match="CUDA"):
            DecodeEngine(api, params, n_slots=2, cache_len=16)
    # the paper's second DNN and its data
    from repro_torch.data.synthetic import cookiebox_shots
    from repro_torch.models import cookienetae
    with pytest.raises(RuntimeError, match="CUDA"):
        cookienetae.init_params(seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        cookiebox_shots(torch.Generator(), 4)
    # the launchers of the workflow (repro_torch.core), of edge serving
    # (repro_torch.serving.transfer) and of the crossover analysis
    from repro_torch.launch import (crossover_analysis, edge_serving,
                                    remote_retrain_flow)
    with pytest.raises(RuntimeError, match="CUDA"):
        remote_retrain_flow.run(steps=1, peaks=128)
    with pytest.raises(RuntimeError, match="CUDA"):
        remote_retrain_flow.run_cookienetae(steps=1, shots=128)
    for launcher in (remote_retrain_flow, edge_serving, crossover_analysis):
        with pytest.raises(RuntimeError, match="CUDA"):
            launcher.main([])


def test_kernel_build_needs_nvcc_and_is_keyed_by_source(monkeypatch,
                                                       tmp_path):
    """A build without the CUDA toolkit fails with a clear error; the
    library is named by its source and flags, so an edit rebuilds."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mlstm_scan as ml
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import pseudo_voigt as pv
    from repro_torch.kernels import ssm_scan as ssd
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
    path = _build.library_path(pa.TILED)
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    assert path.name.startswith(pa.TILED + "-")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path(pa.TILED) != path
    assert set(_build.sources()) == {pa.TILED, pa.RAGGED, pa.ROWS,
                                     pa.TILED_TC, pa.RAGGED_TC, pa.ROWS_TC,
                                     pv.PV, fa.FWD, fa.BWD, fa.FWD_TC,
                                     fa.BWD_TC, ssd.SRC, ssd.SRC_TC,
                                     ml.MLSTM, ml.MLSTM_TC}


def test_kernel_build_key_covers_shared_headers(monkeypatch, tmp_path):
    """The paged-attention kernels include their shared headers (the FMA
    one, the split sweep of the bf16 ones), the float32 and the
    tensor-core flash-attention kernels theirs, the scans theirs, the bf16
    mLSTM and SSD scans the mma.sync ones (which the split sweep includes)
    and the bf16 mLSTM the Hopper building blocks: editing any changes every library path, so no stale
    library is reused."""
    import shutil
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mlstm_scan as ml
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ssm_scan as ssd
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    names = _build.sources()
    for header, users in (("paged_attention_common.cuh",
                           (pa.TILED, pa.RAGGED, pa.ROWS)),
                          ("paged_attention_split.cuh",
                           (pa.TILED_TC, pa.RAGGED_TC, pa.ROWS_TC)),
                          ("mma_common.cuh", (ml.MLSTM_TC, ssd.SRC_TC)),
                          ("flash_attention_common.cuh", (fa.FWD, fa.BWD)),
                          ("hopper_common.cuh", (fa.FWD_TC, fa.BWD_TC,
                                                 ml.MLSTM_TC)),
                          ("scan_common.cuh", (ssd.SRC, ssd.SRC_TC,
                                               ml.MLSTM, ml.MLSTM_TC))):
        assert all(f'#include "{header}"' in (csrc / f"{n}.cu").read_text()
                   for n in users)
        before = {n: _build.library_path(n) for n in names}
        (csrc / header).write_text((csrc / header).read_text()
                                   + "\n// edited\n")
        after = {n: _build.library_path(n) for n in names}
        assert all(after[n] != before[n] for n in names)
