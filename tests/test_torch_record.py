"""The port's TALP run record against the JAX package's, on one training run.

The JAX ``TrainLoop`` and the port's, on the smoke tinyllama (bf16, its
own dtype: the JAX loop cannot run fp32 parameters, whose fp32 master
aliases them and is donated twice) from the same (converted) initial
state and the same padded batches, each write
a schema-v3 record. The port's record must load with the JAX
``RunRecord.load``, carry the same regions and step counts, the same
``model_flops`` and data load balance, pass the JAX ``validate_pop``, and
the JAX ``absolute_factors``, given the port's H100 spec as an explicit
``ChipSpec``, must reproduce the factors the port stored.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import smoke_config as smoke_j  # noqa: E402
from repro.core.factors import absolute_factors, validate_pop  # noqa: E402
from repro.core.hardware import ChipSpec as ChipSpecJ  # noqa: E402
from repro.core.records import RunRecord  # noqa: E402
from repro_torch.configs import smoke_config as smoke_t  # noqa: E402

ARCH = "tinyllama-1.1b"
STEPS = 3
DATA = dict(global_batch=2, seq_len=32, vocab=512, pad_fraction=0.05)


def _record(out_dir) -> RunRecord:
    (path,) = glob.glob(os.path.join(out_dir, "talp_*.json"))
    return RunRecord.load(path)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    from repro.data.pipeline import DataConfig as DataConfigJ
    from repro.data.pipeline import SyntheticLM as SyntheticLMJ
    from repro.launch.mesh import make_host_mesh
    from repro.train.loop import LoopConfig as LoopConfigJ
    from repro.train.loop import TrainLoop as TrainLoopJ
    from repro.train.train import TrainConfig as TrainConfigJ
    from repro.train.train import init_state
    from repro_torch.convert import from_jax_train_state
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.train.loop import LoopConfig, TrainLoop
    from repro_torch.train.train import TrainConfig

    out = tmp_path_factory.mktemp("talp")
    cfg_j = smoke_j(ARCH)
    loop_j = TrainLoopJ(cfg_j, make_host_mesh(), TrainConfigJ(total_steps=STEPS),
                        SyntheticLMJ(DataConfigJ(**DATA)),
                        LoopConfigJ(steps=STEPS, lb_sample_every=1)).run()
    loop_j.finalize_run(str(out / "jax"))

    # the JAX loop's initial state (its init_state at the loop's seed)
    state0 = jax.tree_util.tree_map(
        np.asarray, init_state(cfg_j, TrainConfigJ(), jax.random.PRNGKey(0)).tree())
    cfg_t = smoke_t(ARCH)
    loop_t = TrainLoop(cfg_t, TrainConfig(total_steps=STEPS), SyntheticLM(DataConfig(**DATA)),
                       LoopConfig(steps=STEPS, lb_sample_every=1), device="cpu",
                       state=from_jax_train_state(state0, cfg_t, "cpu")).run()
    loop_t.finalize_run(str(out / "torch"))
    return {"jax": (_record(out / "jax"), loop_j.metrics_history),
            "torch": (_record(out / "torch"), loop_t.metrics_history)}


def test_port_record_loads_and_matches_the_jax_record(records):
    rec_j, hist_j = records["jax"]
    rec_t, hist_t = records["torch"]
    assert rec_t.schema_version == rec_j.schema_version == 3
    assert rec_t.hardware == "h100_sxm"
    assert rec_t.resources.label == rec_j.resources.label == "1x1"
    assert set(rec_t.regions) == set(rec_j.regions) == {"Global", "initialize", "train_step"}
    for name in rec_j.regions:
        mj, mt = rec_j.regions[name].measurements, rec_t.regions[name].measurements
        assert (mt.num_steps, mt.num_visits) == (mj.num_steps, mj.num_visits), name
    tj, tt = rec_j.regions["train_step"], rec_t.regions["train_step"]
    assert tt.measurements.num_steps == STEPS
    assert tt.counters.model_flops == tj.counters.model_flops > 0
    # one data shard on both sides: the balance of one real-token count
    assert tt.measurements.data_lb is not None
    assert tt.measurements.data_lb == pytest.approx(tj.measurements.data_lb, rel=1e-12)
    # the per-step losses of the two loops, from one state on one data, in
    # bf16 (the two frameworks round the activations at other places)
    np.testing.assert_allclose([h["loss"] for h in hist_t], [h["loss"] for h in hist_j],
                               rtol=1e-2)
    # the counted step profile: operator breakdown plus the model's FLOPs
    assert tt.counters.useful_flops > 0 and tt.counters.hlo_bytes > 0
    assert "aten.mm" in tt.computations


def test_port_record_factors_hold_under_the_jax_factor_code(records):
    from repro_torch.core.hardware import H100_SXM

    rec_t, _ = records["torch"]
    spec = ChipSpecJ(**dataclasses.asdict(H100_SXM))
    for name, reg in rec_t.regions.items():
        assert validate_pop(reg.pop) == [], name
        want = absolute_factors(reg, rec_t.resources, spec)
        for key, value in want.items():
            assert reg.pop[key] == pytest.approx(value, rel=1e-12, abs=1e-15), (name, key)
