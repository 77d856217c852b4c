"""The port's traffic harness against the JAX package's: workloads equal
field by field, ``replay`` under pool pressure equal in what it computes
and counts, and the port's launcher driving it on the CPU."""

import dataclasses
import functools
import glob
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.serve import traffic as TRJ  # noqa: E402
from repro_torch.serve import traffic as TR  # noqa: E402

CONFIGS = [
    dict(n_requests=32, seed=7, arrival="burst", cancel_frac=0.3),
    dict(n_requests=64, seed=3, arrival="poisson", cancel_frac=0.25,
         priorities=(0, 5), priority_weights=(0.8, 0.2)),
    dict(n_requests=64, seed=0, arrival="burst", rate=0.25, burst_mult=6,
         prompt_short=(32, 128), prompt_long=(384, 768), long_frac=0.25,
         max_new_short=(16, 64), max_new_long=(128, 256), long_out_frac=0.25,
         priorities=(0, 1, 2), cancel_frac=0.1, vocab_hi=32000),
]


@pytest.mark.parametrize("kw", CONFIGS, ids=[f"{c['arrival']}{c['n_requests']}"
                                             for c in CONFIGS])
def test_workload_equals_jax_field_by_field(kw):
    got = TR.generate_workload(TR.TrafficConfig(**kw))
    want = TRJ.generate_workload(TRJ.TrafficConfig(**kw))
    assert [dataclasses.astuple(r) for r in got] == [dataclasses.astuple(r) for r in want]
    assert len(got) == kw["n_requests"]


def test_workload_is_pure_function_of_config():
    tcfg = TR.TrafficConfig(n_requests=32, seed=7, arrival="burst", cancel_frac=0.3)
    a, b = TR.generate_workload(tcfg), TR.generate_workload(tcfg)
    assert a == b
    assert a != TR.generate_workload(dataclasses.replace(tcfg, seed=8))


def test_burst_arrivals_cluster_more_than_poisson():
    def peak(arrival):
        reqs = TR.generate_workload(TR.TrafficConfig(
            n_requests=128, seed=11, arrival=arrival, rate=0.4, burst_mult=8.0))
        counts: dict[int, int] = {}
        for r in reqs:
            counts[r.arrival_tick] = counts.get(r.arrival_tick, 0) + 1
        return max(counts.values())

    assert peak("burst") > peak("poisson")


def test_invalid_configs_rejected_like_jax():
    for kw, match in ((dict(arrival="uniform"), "arrival"),
                      (dict(priorities=(0, 1), priority_weights=(1.0,)), "weights")):
        with pytest.raises(ValueError, match=match):
            TRJ.TrafficConfig(**kw)
        with pytest.raises(ValueError, match=match):
            TR.TrafficConfig(**kw)


# ---------------------------------------------------------------------------
# replay under pressure, port vs JAX
# ---------------------------------------------------------------------------

F32 = dict(compute_dtype_name="float32", param_dtype_name="float32")
SCFG = dict(max_len=64, batch=2, prefill_chunk=4, page_size=8)


def _tcfg(vocab):
    return dict(n_requests=6, seed=5, arrival="burst", rate=1.5, burst_mult=4.0,
                prompt_short=(4, 8), prompt_long=(10, 14), max_new_short=(3, 5),
                max_new_long=(6, 8), cancel_frac=0.3, cancel_delay=(2, 6),
                vocab_hi=vocab)


@functools.cache
def _weights():
    from repro.configs import smoke_config as smoke_j
    from repro.layers.common import init_params as init_j
    from repro.models import transformer as TJ
    from repro_torch.configs import smoke_config as smoke_t
    from repro_torch.convert import from_jax_params

    cfg_j = smoke_j("tinyllama-1.1b").replace(**F32)
    params = init_j(TJ.model_params(cfg_j), jax.random.PRNGKey(0), jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = from_jax_params(tree, smoke_t("tinyllama-1.1b").replace(**F32), "cpu")
    return cfg_j, params, model


def _replay_port(num_pages):
    from repro_torch.serve.serve import BatchScheduler, ServeConfig

    model = _weights()[2]
    sched = BatchScheduler(model, ServeConfig(num_pages=num_pages, **SCFG))
    work = TR.generate_workload(TR.TrafficConfig(**_tcfg(model.cfg.vocab)))
    return sched, TR.replay(sched, work)


@functools.cache
def _replay_jax(num_pages):
    from repro.launch.mesh import make_host_mesh
    from repro.serve.serve import BatchScheduler, ServeConfig

    cfg_j, params, _ = _weights()
    mesh = make_host_mesh()
    with mesh:
        sched = BatchScheduler(cfg_j, mesh, ServeConfig(paged=True, num_pages=num_pages,
                                                        **SCFG), params)
        work = TRJ.generate_workload(TRJ.TrafficConfig(**_tcfg(cfg_j.vocab)))
        return sched, TRJ.replay(sched, work)


COUNTED = ("requests", "completed", "cancelled", "failed", "ticks", "good_tokens",
           "cancelled_tokens", "queue_depth_peak", "queue_depth_mean", "preemptions",
           "resumes", "cancellations", "evictions_for_preempt", "peak_queue_depth",
           "generated")


def test_replay_under_pressure_matches_jax():
    sched, m = _replay_port(3)  # a long request alone fills the pool
    _, want = _replay_jax(3)
    assert {k: m[k] for k in COUNTED} == {k: want[k] for k in COUNTED}
    assert m["kv"]["pressure"] == want["kv"]["pressure"]
    for k in ("ticks", "decode_steps", "prefill_chunks", "preemptions", "resumes"):
        assert m["sched_stats"][k] == want["sched_stats"][k], k
    assert set(m) == set(want)
    assert m["kv"]["pressure"]["pages_freed_by_preempt"] > 0
    assert m["preemptions"] > 1 and m["cancelled"] > 0 and m["failed"] == 0
    assert m["completed"] + m["cancelled"] == len(m["generated"]) + m["cancelled"] == 6
    assert m["good_tokens"] == sum(len(r["generated"]) for r in sched.completed)
    assert m["ttft_p99_s"] >= m["ttft_p50_s"] >= 0
    assert sched._alloc.used == 0
    # pool pressure changes timing, never tokens
    _, ample = _replay_port(16)
    assert ample["generated"] == m["generated"] and ample["preemptions"] < m["preemptions"]


def test_shed_and_recovery_are_zero_until_fault_recovery_is_ported():
    _, m = _replay_port(3)
    _, want = _replay_jax(3)
    assert m["shed"] == 0 == want["shed"]
    assert m["recovery"] == dict.fromkeys(want["recovery"], 0) == want["recovery"]
    assert m["kv"]["recovery"] == m["recovery"]


CHAOS_TCFG = dict(n_requests=5, seed=9, arrival="burst", rate=1.0, prompt_short=(4, 8),
                  prompt_long=(10, 14), max_new_short=(3, 5), max_new_long=(6, 8),
                  cancel_frac=0.0)
CHAOS_FCFG = dict(seed=2, horizon_ticks=16, n_nan=1, n_page_corrupt=0, n_alloc_spike=1,
                  n_hang=0)


def _chaos_port(chaos: bool):
    from repro_torch.serve.faults import FaultConfig, FaultInjector
    from repro_torch.serve.serve import BatchScheduler, ServeConfig

    model = _weights()[2]
    sched = BatchScheduler(model, ServeConfig(num_pages=8, **SCFG))
    work = TR.generate_workload(TR.TrafficConfig(vocab_hi=model.cfg.vocab, **CHAOS_TCFG))
    return sched, TR.replay(sched, work, faults=FaultInjector(FaultConfig(**CHAOS_FCFG))
                            if chaos else None)


@functools.cache
def _chaos_jax(chaos: bool):
    from repro.launch.mesh import make_host_mesh
    from repro.serve.faults import FaultConfig, FaultInjector
    from repro.serve.serve import BatchScheduler, ServeConfig

    cfg_j, params, _ = _weights()
    mesh = make_host_mesh()
    with mesh:
        sched = BatchScheduler(cfg_j, mesh, ServeConfig(paged=True, num_pages=8, **SCFG),
                               params)
        work = TRJ.generate_workload(TRJ.TrafficConfig(vocab_hi=cfg_j.vocab, **CHAOS_TCFG))
        return sched, TRJ.replay(sched, work, faults=FaultInjector(FaultConfig(**CHAOS_FCFG))
                                 if chaos else None)


def test_chaos_replay_composes_faults_with_workload_like_jax():
    """``replay(faults=...)``: the seeded fault schedule over the seeded
    workload gives JAX's streams, counts and recovery counters (the
    injector's too), replays bit for bit, and recovery never changes what a
    surviving request computed (JAX ``tests/test_traffic.py``)."""
    sched, m = _chaos_port(True)
    _, want = _chaos_jax(True)
    assert {k: m[k] for k in COUNTED + ("shed",)} == {k: want[k] for k in COUNTED + ("shed",)}
    assert m["recovery"] == want["recovery"]
    assert m["recovery"]["retries"] >= 1
    assert m["recovery"]["injected"]["nan_injected"] == 1
    assert m["recovery"]["injected"]["alloc_spikes"] == 1
    assert m["completed"] == 5 and m["failed"] == 0 and sched._alloc.used == 0
    assert _chaos_port(True)[1]["generated"] == m["generated"]
    assert _chaos_port(False)[1]["generated"] == m["generated"] == _chaos_jax(False)[1][
        "generated"]


# ---------------------------------------------------------------------------
# the port's launcher on the CPU
# ---------------------------------------------------------------------------

LAUNCH = ["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu", "--batch", "2",
          "--max-len", "64", "--prefill-chunk", "8", "--page-size", "8"]


def test_launcher_prefix_cache_on_cpu(capsys):
    from repro_torch.launch.serve import main

    assert main(LAUNCH + ["--requests", "4", "--max-new", "3", "--prefix-cache"]) == 0
    out = capsys.readouterr().out
    assert "completed 4/4" in out and "prefix cache: hit rate" in out
    hits = int(out.split("prefix cache: hit rate ")[1].split("(")[1].split("/")[0])
    assert hits >= 1 and "pressure: 0 preemptions" in out


def test_launcher_burst_traffic_writes_a_record(capsys, tmp_path, monkeypatch):
    from repro.core.factors import validate_pop
    from repro.core.records import RunRecord as RunRecordJ
    from repro_torch.launch.serve import main

    for k in ("TALP_ENABLE", "TALP_BACKEND", "TALP_OUT"):
        monkeypatch.delenv(k, raising=False)
    assert main(LAUNCH + ["--requests", "8", "--num-pages", "6", "--arrival", "burst",
                          "--rate", "0.8", "--cancel-frac", "0.2",
                          "--talp-out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "traffic (burst): goodput" in out and "TALP record:" in out
    (path,) = glob.glob(os.path.join(str(tmp_path), "talp_*.json"))
    with open(path) as f:
        assert {"decode", "prefill", "traffic"} <= set(json.load(f)["regions"])
    run = RunRecordJ.load(path)
    assert run.regions["traffic"].measurements.num_visits == 1
    assert all(not validate_pop(r.pop) for r in run.regions.values())
