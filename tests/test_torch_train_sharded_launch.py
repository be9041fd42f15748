"""The sharded training launchers on CPU positions: ``launch/train.py``
with ``--mesh-shape`` and ``--model-parallel`` (a falling loss, a
checkpoint in the reference's format), the ``train_llm`` twin of
``examples/train_llm.py`` on four positions, and the VLM, audio, hybrid
and ssm families on 2 x 2 positions (the VLM tensor-parallel, the others
gathered).  The launchers print their losses; a falling loss is the last
logged below the first.
"""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import specs as sp
from repro_torch.launch import train as train_launcher
from repro_torch.launch import train_llm
from repro_torch.launch.mesh import Mesh
from repro_torch.models.api import build_model
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.train import checkpoint as ck

CPU = torch.device("cpu")
SHAPE = InputShape("test_sharded", 32, 4, "train")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test, beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(dp, tp):
    return Mesh([CPU] * (dp * tp), ("data", "model"), shape=(dp, tp))


@pytest.mark.parametrize("argv", [
    ["--arch", "gemma-7b", "--mesh-shape", "2,2"],
    ["--arch", "deepseek-moe-16b", "--model-parallel", "2"]],
    ids=["gemma-2x2", "deepseek-tp2"])
def test_train_launcher_sharded_on_cpu(tmp_path, capsys, argv):
    """``launch/train.py --device cpu`` with a mesh trains with a falling
    loss and saves the whole tree in the reference's format."""
    train_launcher.main(argv + ["--device", "cpu", "--steps", "4",
                                "--log-every", "1", "--seq", "32",
                                "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 4 and losses[-1] < losses[0], out
    assert "collectives a step per slice" in out
    assert out.strip().endswith("done")
    cfg = get_config(argv[1]).smoke_variant()
    tree, _ = ck.restore_checkpoint(str(tmp_path), {"params": build_model(
        cfg).init(seed=0, device="cpu", dtype=torch.float32)})
    assert all(torch.isfinite(t).all() for t in tree_leaves(tree))


def test_train_llm_on_four_cpu_positions(capsys):
    """The twin of ``examples/train_llm.py`` on 2 x 2 CPU positions: the
    sharded loader, the sharded step, the loss falls, the checkpoint
    round trip."""
    train_llm.main(["--device", "cpu", "--steps", "10", "--batch", "4",
                    "--seq", "32", "--lr", "1e-2"])
    out = capsys.readouterr().out
    assert "mesh {'data': 2, 'model': 2}" in out
    assert "checkpoint roundtrip OK" in out
    assert out.strip().endswith("train_llm OK")


@pytest.mark.parametrize("arch", ["whisper-base", "llava-next-mistral-7b",
                                  "xlstm-1.3b", "zamba2-2.7b"])
def test_families_without_a_tp_layer_loop_are_refused(tmp_path, capsys,
                                                      arch):
    """The families once refused above a model axis of 1 (ROADMAP A9c)
    train: ``launch/train.py --device cpu --mesh-shape 2,2`` runs 2 steps
    of each, the VLM tensor-parallel and the others gathered, and its
    checkpoint holds the whole tree; ``make_train_step_fn`` takes each
    family in that regime."""
    train_launcher.main(["--arch", arch, "--device", "cpu", "--mesh-shape",
                         "2,2", "--steps", "2", "--log-every", "1", "--seq",
                         "16", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.strip().endswith("done"), out
    tp = arch == "llava-next-mistral-7b"
    assert ("collectives a step per slice" if tp
            else "gathered on 4 positions") in out
    api = build_model(get_config(arch).smoke_variant())
    whole = api.init(seed=0, device="cpu", dtype=torch.float32)
    tree, _ = ck.restore_checkpoint(str(tmp_path), {"params": whole})
    got, want = tree_leaves(tree), tree_leaves(whole)
    assert [t.shape for t in got] == [t.shape for t in want]
    assert all(torch.isfinite(t).all() for t in got)
    assert sum(not torch.equal(a, b) for a, b in zip(got, want)) > 0
    mesh = _mesh(1, 2)
    step, _ = sp.make_train_step_fn(api, SHAPE, mesh=mesh)
    assert hasattr(step, "plans") == tp and hasattr(step, "gather") != tp
