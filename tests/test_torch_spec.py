"""Speculative decoding: the port's drafter and verify against the JAX
package's, on converted weights (smoke tinyllama, fp32).

(a) ``serve/spec.py draft_tokens`` equals the JAX drafter on generated
histories; (b) the JAX ``tests/test_spec.py`` cases mirrored, greedy and
sampled: spec on equals spec off, the copy regime (residual-zeroed
weights, so greedy decode cycles) accepts multi-token windows across
pages, planted rejections leak no page, a tight pool preempts and
resumes, NaN-poisoned verifies retry, and a grow that runs the pool dry
unwinds; each against the port's spec-off run and the JAX scheduler's
spec-on run (tokens and the ``speculation`` dict identical); (c) the monitored record: the ``decode``
region is visited once per verify and counts the verify's profile; the
launcher's ``--spec``/``--sample`` flags.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.configs import smoke_config as smoke_j  # noqa: E402
from repro.layers.common import init_params as init_j  # noqa: E402
from repro.models import transformer as TJ  # noqa: E402
from repro.serve.spec import draft_tokens as draft_j  # noqa: E402
from repro_torch.configs import smoke_config as smoke_t  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.serve.serve import BatchScheduler, ServeConfig, _PoolPressure  # noqa: E402
from repro_torch.serve.spec import draft_tokens  # noqa: E402

F32 = dict(compute_dtype_name="float32", param_dtype_name="float32")
SAMPLED = dict(greedy=False, temperature=0.8, top_k=20, sample_seed=3)
BASE = dict(max_len=64, batch=2, prefill_chunk=4, page_size=8, num_pages=32)
# a repeated 4-gram (the drafter locks on at once) and a prompt it finds
# little in
PROMPTS = ([5, 9, 13, 7] * 3, list(range(20, 28)))


# ---------------------------------------------------------------------------
# (a) the drafter
# ---------------------------------------------------------------------------


@settings(max_examples=300, deadline=None)
@given(hist=st.lists(st.integers(0, 6), max_size=40), k=st.integers(0, 6),
       min_match=st.integers(1, 4), max_match=st.integers(1, 9))
def test_draft_tokens_matches_jax(hist, k, min_match, max_match):
    got = draft_tokens(hist, k, min_match=min_match, max_match=max_match)
    assert got == draft_j(hist, k, min_match=min_match, max_match=max_match)
    assert all(type(t) is int for t in got) and len(got) <= max(k, 0)


def test_draft_tokens_cases():
    h = [7, 8, 1, 2, 9, 1, 2, 3, 1, 2]
    assert draft_tokens(h, 3) == [3, 1, 2]       # most recent occurrence
    assert draft_tokens([1, 2, 3, 4, 2, 3, 9, 1, 2, 3], 2) == [4, 2]  # longer match
    assert draft_tokens([1, 2, 3, 4, 2], 4) == []
    assert draft_tokens([1, 2, 3, 4, 2], 4, min_match=1) == [3, 4, 2]
    assert draft_tokens(np.asarray(h, np.int32), 1) == [3]


# ---------------------------------------------------------------------------
# (b) the scheduler, port against JAX
# ---------------------------------------------------------------------------


@functools.cache
def _weights(copy_regime=False):
    """JAX params and the port's converted model; ``copy_regime`` zeroes
    every layer's weights, so the logits are a function of the last token
    and greedy decode must cycle (JAX ``tests/test_spec.py _copy_regime``)."""
    cfg_j = smoke_j("tinyllama-1.1b").replace(**F32)
    params = init_j(TJ.model_params(cfg_j), jax.random.PRNGKey(0), jnp.float32)
    if copy_regime:
        params = dict(params, slots=jax.tree_util.tree_map(lambda x: x * 0.0,
                                                            params["slots"]))
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = from_jax_params(tree, smoke_t("tinyllama-1.1b").replace(**F32), "cpu")
    return cfg_j, params, model


@functools.cache
def _mesh():
    from repro.launch.mesh import make_host_mesh

    return make_host_mesh()


def _tokens(sched):
    return {r["id"]: r["generated"] for r in sched.completed}


def _submit_all(sched, prompts, max_new):
    for rid, p in enumerate(prompts):
        sched.submit(list(p), request_id=rid, max_new=max_new)
    sched.drain()
    return sched


def _run_port(prompts, *, max_new=6, copy_regime=False, **scfg):
    model = _weights(copy_regime)[2]
    return _submit_all(BatchScheduler(model, ServeConfig(**{**BASE, **scfg})), prompts,
                       max_new)


def _run_jax(prompts, **kw):
    return _run_jax_once(tuple(tuple(p) for p in prompts), **kw)


@functools.cache
def _run_jax_once(prompts, *, max_new=6, copy_regime=False, **scfg):
    """The JAX scheduler, once per configuration."""
    from repro.serve.serve import BatchScheduler as SchedJ
    from repro.serve.serve import ServeConfig as ScfgJ

    cfg_j, params, _ = _weights(copy_regime)
    with _mesh():
        sched = SchedJ(cfg_j, _mesh(), ScfgJ(paged=True, **{**BASE, **scfg}), params)
        return _submit_all(sched, prompts, max_new)


def _same_as_jax(port, jx):
    assert _tokens(port) == _tokens(jx)
    stats = port.kv_cache_stats()
    assert stats["speculation"] == jx.kv_cache_stats()["speculation"]
    assert stats["pressure"] == jx.kv_cache_stats()["pressure"]
    for k in ("decode_steps", "prefill_chunks", "spec_dispatches", "spec_emitted"):
        assert port.stats[k] == jx.stats[k], k


def _mode(greedy):
    return {} if greedy else SAMPLED


@pytest.mark.parametrize("greedy", [True, False])
def test_spec_matches_plain_decode_and_jax(greedy):
    kw = _mode(greedy)
    plain = _run_port(PROMPTS, **kw)
    spec = _run_port(PROMPTS, spec_decode=True, **kw)
    assert _tokens(spec) == _tokens(plain)
    assert spec.stats["spec_dispatches"] > 0 and plain.stats["spec_dispatches"] == 0
    assert spec._alloc.used == 0, "pages leaked after drain"
    _same_as_jax(spec, _run_jax(PROMPTS, spec_decode=True, **kw))
    assert plain.kv_cache_stats()["speculation"]["enabled"] is False


@pytest.mark.parametrize("greedy", [True, False])
def test_spec_multi_token_accept_copy_regime(greedy):
    """Residual-zeroed weights: greedy decode cycles from about token 20,
    the drafter locks on, and the verify accepts windows that cross pages
    (page 8 < the accepted spans), tokens equal to sequential decode.
    Sampled at temperature 0.1 the stream mostly follows the cycle: drafts
    are accepted and rejected, and the spec-off stream is kept."""
    mode = {} if greedy else dict(SAMPLED, temperature=0.1)
    kw = dict(mode, max_new=48, max_len=128, copy_regime=True)
    prompt = ([5, 9, 13, 7] * 4,)
    plain = _run_port(prompt, **kw)
    spec = _run_port(prompt, spec_decode=True, **kw)
    assert _tokens(spec) == _tokens(plain)
    _same_as_jax(spec, _run_jax(prompt, spec_decode=True, **kw))
    sp = spec.kv_cache_stats()["speculation"]
    if greedy:
        assert sp["accepted"] > 0 and sp["acceptance_rate"] > 0.5, sp
        assert sp["tokens_per_dispatch"] > 1.0, sp
        assert spec.stats["decode_steps"] < plain.stats["decode_steps"]
    else:
        assert sp["accepted"] > 0 and sp["rejected"] > 0, sp
    assert spec._alloc.used == 0


def test_spec_rejections_no_leak_and_identity():
    """Plant a decoy after an earlier occurrence of the copy-regime orbit's
    first token: the 1-gram drafter proposes it and the verify rejects it."""
    orbit = _tokens(_run_port(([4, 7],), max_new=4, copy_regime=True))[0]
    decoy = (orbit[1] + 1) % 512
    prompt = ([orbit[0], decoy, 11, 3, 7],)
    kw = dict(max_new=8, copy_regime=True)
    plain = _run_port(prompt, **kw)
    spec = _run_port(prompt, spec_decode=True, spec_min_match=1, **kw)
    assert _tokens(spec) == _tokens(plain)
    assert spec.stats["spec_rejected"] > 0, spec.stats
    assert spec._alloc.used == 0, "rejected speculation leaked pages"
    _same_as_jax(spec, _run_jax(prompt, spec_decode=True, spec_min_match=1, **kw))


@pytest.mark.parametrize("greedy", [True, False])
def test_spec_preempt_resume_identity(greedy):
    """A tight pool preempts a spec request; its replayed history rides the
    verify; tokens equal the ample spec run, plain decode and JAX."""
    prompts = (list(range(4, 12)), list(range(20, 28)))
    kw = dict(_mode(greedy), max_new=8)
    plain = _run_port(prompts, num_pages=16, **kw)
    ample = _run_port(prompts, num_pages=16, spec_decode=True, **kw)
    tight = _run_port(prompts, num_pages=3, spec_decode=True, **kw)
    assert tight.stats["preemptions"] > 0, "pressure never materialized"
    assert tight.stats["resumes"] == tight.stats["preemptions"]
    assert _tokens(tight) == _tokens(ample) == _tokens(plain)
    assert tight._alloc.used == 0, "pages leaked across preempt/resume"
    _same_as_jax(tight, _run_jax(prompts, num_pages=3, spec_decode=True, **kw))


def _chaos_spec(impl, greedy, events):
    """``PROMPTS`` with speculation and a ``FaultInjector`` of ``events``
    ((kind, tick) pairs, built into ``impl``'s own classes), max_new 8."""
    kw = {**BASE, **_mode(greedy), "spec_decode": True}
    if impl == "jax":
        from repro.serve import faults as FJ
        from repro.serve.serve import BatchScheduler as SchedJ
        from repro.serve.serve import ServeConfig as ScfgJ

        inj = FJ.FaultInjector(events=[FJ.FaultEvent(kind=k, tick=t) for k, t in events])
        cfg_j, params, _ = _weights()
        with _mesh():
            sched = SchedJ(cfg_j, _mesh(), ScfgJ(paged=True, **kw), params,
                           fault_injector=inj)
            return _submit_all(sched, PROMPTS, 8)
    from repro_torch.serve import faults as FT

    inj = FT.FaultInjector(events=[FT.FaultEvent(kind=k, tick=t) for k, t in events])
    return _submit_all(BatchScheduler(_weights()[2], ServeConfig(**kw), fault_injector=inj),
                       PROMPTS, 8)


@pytest.mark.parametrize("greedy", [True, False])
def test_spec_fault_retry_identity(greedy):
    """NaN-poisoned verify dispatches: the victim retries through
    recompute-resume (its clean history replays as drafts the verify
    accepts), every stream equals the fault-free spec run's and plain
    decode's, and the recovery counters and tokens equal JAX's (JAX
    ``tests/test_spec.py``)."""
    events = (("nan", 4), ("nan", 9))
    base = _run_port(PROMPTS, spec_decode=True, max_new=8, **_mode(greedy))
    plain = _run_port(PROMPTS, max_new=8, **_mode(greedy))
    chaos = _chaos_spec("port", greedy, events)
    jx = _chaos_spec("jax", greedy, events)
    rec = chaos.kv_cache_stats()["recovery"]
    assert rec["retries"] >= 1 and rec["injected"]["nan_injected"] == 2, rec
    assert _tokens(chaos) == _tokens(base) == _tokens(plain)
    assert rec == jx.kv_cache_stats()["recovery"]
    _same_as_jax(chaos, jx)
    assert chaos._alloc.used == 0, "pages leaked across fault retry"


def test_ensure_pages_unwinds_partial_alloc_on_exhaustion():
    sched = BatchScheduler(_weights()[2], ServeConfig(
        max_len=64, batch=1, prefill_chunk=4, page_size=8, num_pages=8,
        preempt_policy="never", spec_decode=True, spec_k=4))
    sched.submit(list(range(4, 10)), request_id=0, max_new=4)
    for _ in range(10):
        if sched.active[0] is not None:
            break
        sched.step()
    req = sched.active[0]
    assert req is not None
    held = sched._alloc.alloc(sched._alloc.free_pages - 1, owner="hold")
    used, pages, tables = sched._alloc.used, list(sched._slot_pages[0]), sched._tables.copy()
    with pytest.raises(_PoolPressure):
        sched._ensure_pages(0, (len(pages) + 2) * 8 - 1, req)
    assert sched._alloc.used == used and sched._slot_pages[0] == pages
    np.testing.assert_array_equal(sched._tables, tables)
    sched._alloc.release(held)
    sched.drain()
    assert len(sched.completed) == 1 and sched._alloc.used == 0


def test_spec_max_new_one_and_eos_inside_the_window():
    """The first token comes from the prefill readback (max_new 1 retires
    there); an EOS inside an accepted window truncates right after it."""
    orbit = _tokens(_run_port(([5, 9, 13, 7] * 4,), max_new=40, max_len=128,
                              copy_regime=True))[0]
    kw = dict(max_new=40, max_len=128, copy_regime=True, eos_id=orbit[30])
    plain = _run_port(([5, 9, 13, 7] * 4, [3, 4]), **kw)
    spec = _run_port(([5, 9, 13, 7] * 4, [3, 4]), spec_decode=True, **kw)
    assert _tokens(spec) == _tokens(plain)
    assert _tokens(spec)[0][-1] == orbit[30]
    one = _run_port(PROMPTS, max_new=1, spec_decode=True)
    assert all(len(t) == 1 for t in _tokens(one).values())
    assert _tokens(one) == {k: v[:1] for k, v in _tokens(_run_port(PROMPTS)).items()}


# ---------------------------------------------------------------------------
# (c) the monitored record and the launcher
# ---------------------------------------------------------------------------


def test_monitored_spec_record_counts_the_verify(tmp_path):
    from repro.core.factors import validate_pop
    from repro.core.records import RunRecord as RunRecordJ
    from repro_torch.core.records import ResourceConfig
    from repro_torch.session import PerfSession, SessionConfig

    session = PerfSession(SessionConfig(app_name="spec-test", backend="monitor",
                                        lb_sample_every=1, respect_env=False,
                                        top_computations=64),
                          ResourceConfig(num_hosts=1, devices_per_host=1))
    with session:
        sched = BatchScheduler(_weights()[2], ServeConfig(spec_decode=True, **BASE),
                               session=session)
        _submit_all(sched, PROMPTS, 6)
    session.finalize(str(tmp_path))
    run = RunRecordJ.load(session.last_record_path)
    visits = {n: r.measurements.num_visits for n, r in run.regions.items()}
    assert visits["decode"] == sched.stats["spec_dispatches"] > 0
    assert visits["prefill"] == sched.stats["prefill_chunks"]
    for name, reg in run.regions.items():
        assert not validate_pop(reg.pop), name
    # the decode region's profile is the verify's: its acceptance scan and
    # the C-wide forward, not the one-token decode it never ran
    comps = run.regions["decode"].computations
    assert any("cumprod" in c for c in comps), sorted(comps)
    assert _tokens(sched) == _tokens(_run_jax(PROMPTS, spec_decode=True))


def test_launcher_spec_and_sample_flags(capsys):
    from repro_torch.launch.serve import main

    assert main(["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu",
                 "--requests", "3", "--max-new", "6", "--max-len", "64",
                 "--spec", "--spec-k", "3", "--sample", "--temperature", "0.8",
                 "--top-k", "20", "--sample-seed", "3"]) == 0
    out = capsys.readouterr().out
    assert "completed 3/3" in out
    assert "[serve] speculation: acceptance rate" in out
