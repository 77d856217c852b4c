"""The port's one-call session surface against the JAX package's.

``repro_torch.start``, ``null_session`` and the lazy top-level exports,
mirroring ``tests/test_session.py::test_top_level_exports``; one train step
of the smoke qwen3-moe-30b-a3b through ``start`` under ``TALP_ENABLE=1
TALP_BACKEND=monitor`` in each package, whose records agree (regions,
steps, data and expert load balance); ``configs.list_archs`` equal to the
JAX one; ``import repro_torch`` free of JAX and of CUDA initialisation.
"""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.session import ENV_BACKEND, ENV_ENABLE, PerfSession, SessionConfig  # noqa: E402

ARCH = "qwen3-moe-30b-a3b"
# bf16 parameters computed in fp32, as ``test_torch_moe.py``'s loop test:
# the JAX step cannot train fp32 parameters, and bf16 compute rounds the
# packages' activations apart
MIXED = dict(compute_dtype_name="float32")


def test_top_level_exports(monkeypatch):
    monkeypatch.delenv(ENV_ENABLE, raising=False)
    assert repro_torch.PerfSession is PerfSession
    assert repro_torch.SessionConfig is SessionConfig
    ses = repro_torch.start("x")  # off unless the environment enables it
    assert isinstance(ses, PerfSession) and not ses.enabled and ses.backend == "null"
    import repro_torch.session as session_mod

    assert repro_torch.session is session_mod
    assert set(repro_torch.__all__) == set(repro.__all__)
    with pytest.raises(AttributeError):
        repro_torch.no_such_name  # noqa: B018


def test_null_session_is_shared_and_disabled(monkeypatch):
    monkeypatch.setenv(ENV_ENABLE, "1")  # the shared null session ignores it
    ses = repro_torch.null_session()
    assert ses is repro_torch.null_session()
    assert not ses.enabled and ses.backend == "null"
    assert ses.finalize() is None


def test_start_takes_the_backend_from_the_environment(monkeypatch):
    monkeypatch.setenv(ENV_ENABLE, "1")
    monkeypatch.setenv(ENV_BACKEND, "tracer")
    assert repro_torch.start("x").backend == repro.start("x").backend == "tracer"
    monkeypatch.setenv(ENV_ENABLE, "0")
    assert repro_torch.start("x", "monitor").backend == repro.start("x", "monitor").backend
    monkeypatch.delenv(ENV_ENABLE)
    ses = repro_torch.start("x", "monitor", lb_sample_every=3, metadata={"k": "v"})
    assert ses.enabled and ses.config.lb_sample_every == 3 and ses.metadata == {"k": "v"}


def test_list_archs_equals_jax():
    from repro.configs import list_archs as list_j
    from repro_torch.configs import list_archs as list_t

    assert list_t() == list_j()


def test_one_step_through_start_gives_the_jax_record(monkeypatch, tmp_path):
    from repro.configs import smoke_config as smoke_j
    from repro.core.records import ResourceConfig as ResourceConfigJ
    from repro.core.records import RunRecord
    from repro.launch.mesh import make_host_mesh
    from repro.models.flops import train_step_model_flops as flops_j
    from repro.train.train import TrainConfig as TrainConfigJ
    from repro.train.train import compile_train_step, init_state
    from repro_torch.configs import smoke_config as smoke_t
    from repro_torch.convert import from_jax_train_state, params_from_numpy
    from repro_torch.core.records import ResourceConfig
    from repro_torch.models.flops import train_step_model_flops as flops_t
    from repro_torch.train.train import TrainConfig, make_train_step

    monkeypatch.setenv(ENV_ENABLE, "1")
    monkeypatch.setenv(ENV_BACKEND, "monitor")
    monkeypatch.delenv("TALP_OUT", raising=False)
    res = dict(num_hosts=1, devices_per_host=1, mesh={"data": 1, "model": 1}, num_pods=1)
    cfg_j, cfg_t = smoke_j(ARCH).replace(**MIXED), smoke_t(ARCH).replace(**MIXED)
    rng = np.random.default_rng(4)
    labels = rng.integers(0, cfg_j.vocab, size=(1, 2, 32)).astype(np.int32)
    labels[..., -3:] = -1
    batch = {"tokens": rng.integers(4, cfg_j.vocab, size=(1, 2, 32)).astype(np.int32),
             "labels": labels}
    state_j = init_state(cfg_j, TrainConfigJ(), jax.random.PRNGKey(0)).tree()
    state_np = jax.tree_util.tree_map(np.asarray, state_j)

    ses_j = repro.start("moe", lb_sample_every=1, resources=ResourceConfigJ(**res))
    compiled, call = compile_train_step(cfg_j, make_host_mesh(), TrainConfigJ(), state_j, batch)
    step_j = ses_j.wrap_step(call, region="train_step", compiled=compiled,
                             model_flops=flops_j(cfg_j, labels.shape))
    with ses_j:
        _, metrics_j = step_j(state_j, batch)
    ses_j.finalize(str(tmp_path / "jax"), git=False)

    ses_t = repro_torch.start("moe", lb_sample_every=1, resources=ResourceConfig(**res))
    assert ses_t.backend == "monitor"
    step_t = ses_t.wrap_step(make_train_step(cfg_t, TrainConfig()), region="train_step",
                             derive=True, model_flops=flops_t(cfg_t, labels.shape))
    with ses_t:
        _, metrics_t = step_t(from_jax_train_state(state_np, cfg_t, "cpu"),
                              params_from_numpy(batch))
    ses_t.finalize(str(tmp_path / "torch"), git=False)

    np.testing.assert_array_equal(metrics_t["expert_load"].numpy(),
                                  np.asarray(metrics_j["expert_load"]))
    rec_j, rec_t = (RunRecord.load(*glob.glob(os.path.join(tmp_path, k, "talp_*.json")))
                    for k in ("jax", "torch"))
    assert rec_t.app_name == rec_j.app_name == "moe"
    assert rec_t.resources.label == rec_j.resources.label == "1x1"
    assert set(rec_t.regions) == set(rec_j.regions)
    for name, reg_j in rec_j.regions.items():
        m_j, m_t = reg_j.measurements, rec_t.regions[name].measurements
        assert m_t.num_steps == m_j.num_steps, name
        for key in ("data_lb", "expert_lb"):
            a, b = getattr(m_t, key), getattr(m_j, key)
            assert (a is None) == (b is None), (name, key)
            if a is not None:
                assert a == pytest.approx(b, abs=1e-6), (name, key)
    ts = rec_t.regions["train_step"]
    assert ts.measurements.num_steps == 1
    assert 0 < ts.pop["expert_load_balance"] < 1
    assert ts.pop["expert_load_balance"] == pytest.approx(
        rec_j.regions["train_step"].pop["expert_load_balance"], abs=1e-6)
    assert ts.counters.model_flops == rec_j.regions["train_step"].counters.model_flops > 0


def test_import_repro_torch_imports_no_jax_and_starts_no_cuda():
    code = ("import sys, repro_torch\n"
            "assert 'torch' not in sys.modules, 'import repro_torch imported torch'\n"
            "ses = repro_torch.start('x')\n"
            "import torch\n"
            "assert not torch.cuda.is_initialized()\n"
            "assert not [m for m in sys.modules\n"
            "            if m == 'jax' or m.startswith(('jax.', 'repro.'))]\n"
            "print('ok', ses.backend)\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("TALP_")}
    env["PYTHONPATH"] = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok null"


def test_the_talp_cli_imports_no_torch():
    """The report side needs no torch: ``repro_torch.core`` resolves its
    names lazily, so ``python -m repro_torch.core.pages`` starts without
    importing it (a CI job that only renders records pays no torch
    import)."""
    code = ("import sys, repro_torch.core.pages, repro_torch.core as C\n"
            "C.build_table, C.RunRecord, C.validate_pop\n"
            "assert 'torch' not in sys.modules, 'the talp CLI imported torch'\n"
            "C.StepProfile\n"
            "assert 'torch' in sys.modules\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("TALP_")}
    env["PYTHONPATH"] = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr
