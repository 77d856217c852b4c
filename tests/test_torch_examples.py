"""The port's examples (``examples/torch_*.py``) on the CPU at their
smallest sizes: each ``main`` with ``--device cpu``.

``torch_quickstart.py`` trains and writes a record; ``torch_train.py
--tiny`` checkpoints, and a rerun over the same directory resumes from
the latest step; ``torch_serve_batch.py`` in each of its modes (paged,
``--dense``, ``--shared-prefix``, ``--traffic``, ``--chaos``) writes a
monitored record, and ``--spec`` gives the same tokens with speculation
on and off; ``torch_ci_workflow.py`` runs three pipelines of one- and
two-rank jobs and renders a site whose findings name the stalled commit.
Every record loads with JAX's ``RunRecord.load`` and passes JAX's
``validate_pop``. Without ``--device`` an example asks for the card and
raises where there is none. No JAX example runs here.
"""

import glob
import importlib.util
import os

import pytest

torch = pytest.importorskip("torch")

from repro.core.factors import validate_pop  # noqa: E402
from repro.core.records import RunRecord  # noqa: E402

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "examples")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the examples' small ops beside the suite's
    other workers (as ``tests/test_torch_recurrent.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example(name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _valid(path: str, regions) -> RunRecord:
    run = RunRecord.load(path)
    assert set(regions) <= set(run.regions), sorted(run.regions)
    for name, reg in run.regions.items():
        assert validate_pop(reg.pop) == [], name
    return run


def _records(folder: str) -> list:
    return sorted(glob.glob(os.path.join(folder, "**", "talp_*.json"), recursive=True))


def test_quickstart_writes_a_record_jax_validates(tmp_path, capsys):
    path = _example("torch_quickstart").main(
        ["--device", "cpu", "--steps", "3", "--out", str(tmp_path)])
    assert path and os.path.dirname(path) == str(tmp_path)
    run = _valid(path, ["train_step"])
    assert run.regions["train_step"].measurements.num_steps == 3
    assert "POP factors for region 'train_step'" in capsys.readouterr().out


def test_train_tiny_checkpoints_and_resumes(tmp_path):
    ex = _example("torch_train")
    args = ["--device", "cpu", "--tiny", "--batch", "2", "--seq", "32",
            "--ckpt-dir", str(tmp_path / "ckpt")]
    first = ex.main(args + ["--steps", "4", "--out", str(tmp_path / "first")])
    assert [m["step"] for m in first.metrics_history] == [0, 1, 2, 3]
    again = ex.main(args + ["--steps", "6", "--out", str(tmp_path / "again")])
    assert [m["step"] for m in again.metrics_history] == [4, 5]   # resumed
    for run in ("first", "again"):
        paths = _records(str(tmp_path / run))
        assert len(paths) == 1
        _valid(paths[0], ["train_step"])


@pytest.mark.parametrize("mode", ["paged", "dense", "shared-prefix", "traffic", "chaos"])
def test_serve_batch_mode_writes_a_record_jax_validates(tmp_path, capsys, mode):
    flags = [] if mode == "paged" else [f"--{mode}"]
    _example("torch_serve_batch").main(["--device", "cpu", "--out", str(tmp_path)] + flags)
    out = capsys.readouterr().out
    paths = _records(str(tmp_path))
    assert len(paths) == 1
    regions = ["decode", "prefill"] + (["traffic"] if mode in ("traffic", "chaos") else [])
    _valid(paths[0], regions)
    if mode == "chaos":
        assert "chaos: injected" in out and "watchdog trips" in out
    elif mode == "traffic":
        assert "goodput" in out and "preemptions" in out
    elif mode == "shared-prefix":
        assert "prefix cache:" in out
    else:
        assert "completed 10 requests" in out


def test_serve_batch_spec_gives_the_same_tokens(capsys):
    assert _example("torch_serve_batch").main(["--device", "cpu", "--spec"]) is True
    out = capsys.readouterr().out
    assert "tokens identical: True" in out and "acceptance rate" in out


def test_ci_workflow_renders_a_site_that_flags_the_stall(tmp_path):
    site = _example("torch_ci_workflow").main(["--device", "cpu", "--root", str(tmp_path)])
    assert os.path.isfile(os.path.join(site, "index.html"))
    paths = _records(str(tmp_path / "pipeline_2" / "talp"))
    labels = sorted({os.path.basename(p)[:8] for p in paths})
    assert labels == ["talp_1x1", "talp_1x2"] and len(paths) == 6   # 3 pipelines, merged
    for p in paths:
        _valid(p, ["train_step"])


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_train", "torch_serve_batch"])
def test_examples_default_to_the_card(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError):
        _example(name).main(["--out", str(tmp_path)])
