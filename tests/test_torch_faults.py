"""Fault injection and recovery: the port's ``serve/faults.py`` and the
scheduler's recovery layer against the JAX package's (``tests/test_faults.py``
mirrored), on converted weights (smoke tinyllama, fp32).

(a) schedules, configs and the injector equal JAX's; (b) ``page_edit`` and
``page_fingerprint`` leave the same bits and give the same integer as
JAX's jitted page steps on the same pool, and never touch the spare page;
(c) for every ``FaultEvent`` list the port's scheduler gives JAX's tokens,
``kv_cache_stats()["recovery"]`` (the injector's counters included),
handle statuses and failed and shed ids: NaN retry (greedy and sampled),
quarantine, the watchdog with an allocator spike, shedding, checksum
eviction, co-resident isolation, NaN pages (scrubbed before reuse), the
dense layout; (d) the sentinel, ``PerfSession.event`` under each backend,
and the ``recovery`` region of a monitored chaos run.

``test_fault_isolation_coresident[zamba2-2.7b]`` of the JAX file is held
in ``test_torch_recurrent.py`` (``test_fault_isolation_coresident_zamba2``),
beside the other recurrent-arch scheduler tests and their weights.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as smoke_j  # noqa: E402
from repro.layers.common import init_params as init_j  # noqa: E402
from repro.models import transformer as TJ  # noqa: E402
from repro.serve import faults as FJ  # noqa: E402
from repro_torch.configs import smoke_config as smoke_t  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.serve import faults as FT  # noqa: E402
from repro_torch.serve.serve import BatchScheduler, ServeConfig  # noqa: E402

F32 = dict(compute_dtype_name="float32", param_dtype_name="float32")
SAMPLED = dict(greedy=False, temperature=0.8, top_k=20, sample_seed=3)
# the JAX tests' chaos server. Where a test injects a hang, the watchdog's
# deadline sits far above a clean dispatch of either package on the CPU at
# this size (a few ms, more on a loaded machine) and far below the hang, so
# only the hang trips it
CHAOS = dict(max_len=64, batch=2, prefill_chunk=4, paged=True, page_size=8, num_pages=16)
WATCHDOG, HANG_S = dict(watchdog_deadline_s=1.0), 2.5
PROMPTS = ((tuple(range(4, 14)), tuple(range(30, 38))))


# ---------------------------------------------------------------------------
# (a) schedules, configs, the injector
# ---------------------------------------------------------------------------

SCHEDULES = [
    dict(seed=7, n_nan=3, n_page_corrupt=2, n_alloc_spike=2, n_hang=1),
    dict(seed=0),
    dict(seed=11, horizon_ticks=200, n_nan=5, n_page_corrupt=0, n_hang=2),
    dict(seed=3, horizon_ticks=1, n_alloc_spike=4),
]


@pytest.mark.parametrize("kw", SCHEDULES, ids=[f"seed{c['seed']}" for c in SCHEDULES])
def test_fault_schedule_matches_jax(kw):
    got = FT.generate_faults(FT.FaultConfig(**kw))
    want = FJ.generate_faults(FJ.FaultConfig(**kw))
    assert [dataclasses.astuple(e) for e in got] == [dataclasses.astuple(e) for e in want]
    assert got == FT.generate_faults(FT.FaultConfig(**kw))
    assert dataclasses.asdict(FT.FaultConfig(**kw)) == dataclasses.asdict(FJ.FaultConfig(**kw))


def test_invalid_fault_configs_rejected_like_jax():
    for kw, match in ((dict(corrupt_mode="flip"), "corrupt_mode"),
                      (dict(horizon_ticks=0), "horizon")):
        for cls in (FJ.FaultConfig, FT.FaultConfig):
            with pytest.raises(ValueError, match=match):
                cls(**kw)


def test_injector_due_defer_record_like_jax():
    def script(mod):
        inj = mod.FaultInjector(events=[mod.FaultEvent(kind="nan", tick=2),
                                        mod.FaultEvent(kind="hang", tick=5)])
        log = [[e.kind for e in inj.due(1)]]
        ready = inj.due(3)
        log.append([e.kind for e in ready])
        inj.defer(ready[0], 3)
        log += [[e.kind for e in inj.due(4)], inj.exhausted,
                [e.kind for e in inj.due(10)], inj.exhausted]
        inj.record("alloc_spike")
        inj.record("page_corrupt")
        return log, dict(inj.counters)

    assert script(FT) == script(FJ)
    assert script(FT)[1]["deferrals"] == 1


# ---------------------------------------------------------------------------
# (b) page edits and fingerprints on the device
# ---------------------------------------------------------------------------

DTYPES = {"float32": (jnp.float32, torch.float32, np.uint32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, np.uint16)}


def _pools(dtype_name, seed=0):
    """The JAX test's tiny tree (paged leaves hold "pages" in their path)
    with seeded values, and the port's: the same pools plus a spare page."""
    jd, td, _ = DTYPES[dtype_name]
    rng = np.random.default_rng(seed)
    k, v = (rng.standard_normal((2, 5, 8, 2, 4)).astype(np.float32) for _ in range(2))
    state = np.ones((3, 3), np.float32)
    jx = {"pages_k": jnp.asarray(k[:, :4], jd), "pages_v": jnp.asarray(v[:, :4], jd),
          "state": jnp.asarray(state)}
    pt = {"pages_k": torch.from_numpy(k).to(td), "pages_v": torch.from_numpy(v).to(td),
          "state": torch.from_numpy(state)}
    return jx, pt


def _bits(dtype_name, arr):
    u = DTYPES[dtype_name][2]
    if isinstance(arr, torch.Tensor):
        it = {np.uint16: torch.int16, np.uint32: torch.int32}[u]
        return arr.contiguous().view(it).numpy().view(u)
    return np.asarray(arr).view(u)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("mode", ["nan", "zero", "bitflip"])
def test_page_edit_matches_jax(dtype_name, mode):
    jx, pt = _pools(dtype_name)
    spare = {k: pt[k][:, 4].clone() for k in ("pages_k", "pages_v")}
    for page in (2, 0):
        jx = FJ.page_edit_step(mode)(jx, page)
        FT.page_edit(pt, page, mode)
    for k in ("pages_k", "pages_v"):
        np.testing.assert_array_equal(_bits(dtype_name, pt[k][:, :4]), _bits(dtype_name, jx[k]))
        assert torch.equal(pt[k][:, 4], spare[k]), "the spare page was edited"
    np.testing.assert_array_equal(pt["state"].numpy(), np.asarray(jx["state"]))
    if mode == "bitflip":  # an XOR: twice restores the page
        _, fresh = _pools(dtype_name)
        for page in (2, 0):
            FT.page_edit(pt, page, mode)
        assert all(torch.equal(pt[k].view(torch.int16 if dtype_name == "bfloat16"
                                          else torch.int32),
                               fresh[k].view(torch.int16 if dtype_name == "bfloat16"
                                             else torch.int32))
                   for k in ("pages_k", "pages_v"))
    with pytest.raises(IndexError):
        FT.page_edit(pt, 4, mode)  # the spare page is never a target


@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_page_fingerprint_matches_jax_and_moves_on_any_edit(dtype_name):
    jx, pt = _pools(dtype_name, seed=3)
    fp_j = FJ.page_fingerprint_step()
    base = [FT.page_fingerprint(pt, p) for p in range(4)]
    assert base == [int(fp_j(jx, p)) for p in range(4)]
    assert len(set(base)) == 4
    for mode in ("bitflip", "nan", "zero"):
        ed = {k: v.clone() for k, v in pt.items()}
        FT.page_edit(ed, 1, mode)
        jx_ed = FJ.page_edit_step(mode)(jax.tree_util.tree_map(jnp.copy, jx), 1)  # donated
        assert FT.page_fingerprint(ed, 1) == int(fp_j(jx_ed, 1)) != base[1], mode
        assert FT.page_fingerprint(ed, 2) == base[2]
    # bits past 2**31 in every element: the sum wraps at 32 bits like JAX's
    jx_n, pt_n = dict(jx), {k: v.clone() for k, v in pt.items()}
    for k in ("pages_k", "pages_v"):
        pt_n[k].neg_()
        jx_n[k] = -jx[k]
    assert FT.page_fingerprint(pt_n, 0) == int(fp_j(jx_n, 0))


# ---------------------------------------------------------------------------
# (c) the scheduler under faults, port against JAX
# ---------------------------------------------------------------------------


@functools.cache
def _weights():
    cfg_j = smoke_j("tinyllama-1.1b").replace(**F32)
    params = init_j(TJ.model_params(cfg_j), jax.random.PRNGKey(0), jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = from_jax_params(tree, smoke_t("tinyllama-1.1b").replace(**F32), "cpu")
    return cfg_j, params, model


@functools.cache
def _mesh():
    from repro.launch.mesh import make_host_mesh

    return make_host_mesh()


def _observe(sched, injector) -> dict:
    """What a chaos run must agree on across the two packages."""
    return {
        "tokens": {r["id"]: r["generated"] for r in sched.completed},
        "recovery": sched.kv_cache_stats()["recovery"],
        "status": {rid: r["_status"] for rid, r in sched._by_id.items()},
        "failed": [r["id"] for r in sched.failed],
        "shed": [r["id"] for r in sched.shed],
        "pages_in_use": None if sched._alloc is None else sched._alloc.used,
        "stats": {k: sched.stats[k] for k in ("retries", "resumes", "readbacks",
                                              "decode_steps", "prefill_chunks")},
        "injected": None if injector is None else dict(injector.counters),
        "script_log": getattr(sched, "script_log", None),
    }


def _chaos(impl: str, events=(), fcfg=(), prompts=PROMPTS, max_new=6, greedy=True,
           sched_script=None, **scfg):
    """One chaos run through ``impl`` ("jax" or "port"): ``events`` are
    (kind, tick, request_id) triples, built into each package's own
    ``FaultEvent`` (the injector advances their ticks); ``fcfg`` the
    ``FaultConfig`` fields as (name, value) pairs. Returns (sched, observe)."""
    mod = FJ if impl == "jax" else FT
    injector = None
    if events or fcfg:
        injector = mod.FaultInjector(
            mod.FaultConfig(**dict(fcfg)),
            events=[mod.FaultEvent(kind=k, tick=t, request_id=rid) for k, t, rid in events])
    kw = {**CHAOS, **({} if greedy else SAMPLED), **scfg}
    cfg_j, params, model = _weights()
    if impl == "jax":
        from repro.serve.serve import BatchScheduler as SchedJ
        from repro.serve.serve import ServeConfig as ScfgJ

        mesh = _mesh()
        with mesh:
            sched = SchedJ(cfg_j, mesh, ScfgJ(**kw), params, fault_injector=injector)
            (sched_script or _submit_all)(sched, prompts, max_new)
    else:
        sched = BatchScheduler(model, ServeConfig(**kw), fault_injector=injector)
        (sched_script or _submit_all)(sched, prompts, max_new)
    return sched, _observe(sched, injector)


def _submit_all(sched, prompts, max_new):
    for rid, p in enumerate(prompts):
        sched.submit(list(p), request_id=rid, max_new=max_new)
    sched.drain()


@functools.cache
def _jax(*args, **kw):
    """The JAX run of a chaos case, once per case (its base run first, so
    every trace is compiled before the watchdog times a dispatch)."""
    return _chaos("jax", *args, **kw)[1]


def _both(events=(), fcfg=(), **kw):
    """The port's run and JAX's, each after its package's fault-free run
    of the same case; asserts they agree. Returns (port sched, port
    observe, port base observe)."""
    base_kw = {k: v for k, v in kw.items() if k != "sched_script"}
    base_j = _jax(**base_kw)
    want = _jax(events, fcfg, **kw)
    base = _chaos("port", **base_kw)[1]
    sched, got = _chaos("port", events, fcfg, **kw)
    assert base["tokens"] == base_j["tokens"]
    assert got == want
    return sched, got, base


@pytest.mark.parametrize("greedy", [True, False])
def test_nan_retry_stream_identity_matches_jax(greedy):
    """Two poisoned decode dispatches: the victims retry, every stream
    equals the fault-free run's, the backoff is served, nothing leaks."""
    _, got, base = _both((("nan", 4, None), ("nan", 9, None)), greedy=greedy)
    assert got["injected"]["nan_injected"] == 2
    assert got["recovery"]["retries"] >= 1
    assert got["recovery"]["backoff_total_ticks"] >= got["recovery"]["retries"]
    assert got["tokens"] == base["tokens"] and got["pages_in_use"] == 0


def test_quarantine_frees_pages_neighbours_untouched_like_jax():
    """More NaNs than ``max_retries`` pinned to request 0: it ends
    ``failed`` with its pages freed; request 1's stream is unchanged."""
    events = tuple(("nan", 3 + 3 * i, 0) for i in range(3))
    _, got, base = _both(events, max_retries=2)
    assert got["injected"]["nan_injected"] == 3
    assert got["failed"] == [0] and got["status"][0] == "failed"
    assert got["recovery"]["quarantined"] == 1
    assert got["tokens"] == {1: base["tokens"][1]} and got["pages_in_use"] == 0


def test_watchdog_trip_and_alloc_spike_recover_like_jax():
    """A hung dispatch trips the watchdog (once: no clean dispatch does)
    and its victim retries; a spike parks work through the pressure path;
    both end in the fault-free streams with the spike's pages back."""
    fcfg = (("hang_s", HANG_S), ("spike_pages", 2), ("spike_ticks", 3))
    sched, got, base = _both((("hang", 4, None), ("alloc_spike", 6, None)), fcfg,
                             num_pages=6, **WATCHDOG)
    assert got["injected"]["hangs"] == 1 and got["injected"]["alloc_spikes"] == 1
    assert got["recovery"]["watchdog_trips"] == 1 and got["recovery"]["retries"] >= 1
    assert not sched._spike_holds
    assert got["tokens"] == base["tokens"] and got["pages_in_use"] == 0


def _shed_script(sched, prompts, max_new):
    handles = [sched.submit(list(range(4 + 3 * i, 10 + 3 * i)), request_id=i, max_new=3,
                            priority=(1 if i == 2 else 0)) for i in range(4)]
    sched.drain()
    sched.script_log = [(h.request_id, h.status, h.done, h.tokens) for h in handles]


def test_shed_queue_depth_matches_jax():
    """Past ``shed_queue_depth`` the lowest-priority youngest waiter is shed
    (terminal ``shed``, no tokens); the priority-1 request never is."""
    _, got, _ = _both(batch=1, shed_queue_depth=2, sched_script=_shed_script)
    assert got["recovery"]["shed"] == len(got["shed"]) > 0 and 2 not in got["shed"]
    for rid, status, done, toks in got["script_log"]:
        assert done and (status, toks == []) == (("shed", True) if rid in got["shed"]
                                                 else ("done", False))
    assert got["pages_in_use"] == 0


def _checksum_script(sched, prompts, max_new):
    prompt = list(range(4, 22))  # two full pages enter the trie
    first = sched.submit(prompt, request_id="a", max_new=4).result()
    while not sched.faults.exhausted:  # idle past the event: the trie's page
        sched.step()
    second = sched.submit(prompt, request_id="b", max_new=4).result()
    sched.drain()
    sched.script_log = (first, second, sched._alloc.used - sched._prefix.size)


def test_checksum_catches_bitflip_and_evicts_subtree_like_jax():
    kw = dict(prefix_cache=True, checksum_pages=True, sched_script=_checksum_script)
    events, fcfg = (("page_corrupt", 40, None),), (("corrupt_mode", "bitflip"),)
    _, got, _ = _both(events, fcfg, **kw)
    assert got["injected"]["pages_corrupted"] == 1
    assert got["recovery"]["checksum_failures"] >= 1
    first, second, leaked = got["script_log"]
    assert second == first and leaked == 0


@pytest.mark.parametrize("arch", ["tinyllama-1.1b"])
def test_fault_isolation_coresident(arch):
    """A NaN poison and a NaN page, both pinned to request 0: request 1's
    stream is unchanged, nothing leaks (zamba2-2.7b: in
    ``test_torch_recurrent.py``)."""
    events = (("nan", 5, 0), ("page_corrupt", 7, 0))
    _, got, base = _both(events, max_new=5)
    assert got["injected"]["nan_injected"] == 1
    assert got["tokens"] == base["tokens"] and got["pages_in_use"] == 0


def test_nan_pages_are_scrubbed_before_reuse():
    """NaN pages on decoding slots, several retries and slot reuse: the
    port agrees with JAX, and no page on the free list holds a non-finite
    value (every corrupted page was zeroed before it went back)."""
    prompts = PROMPTS + ((5, 9, 13, 7) * 3, tuple(range(40, 51)))
    events = tuple(("page_corrupt", t, None) for t in (5, 8, 12, 16))
    sched, got, base = _both(events, prompts=prompts, max_new=7)
    assert got["injected"]["pages_corrupted"] == 4 and got["recovery"]["retries"] >= 1
    assert got["tokens"] == base["tokens"] and got["pages_in_use"] == 0
    assert not sched._corrupted_pages
    for slot in sched.caches.values():
        for pool in slot["attn"].values():
            assert torch.isfinite(pool[:, :-1]).all()


def _free_pages_finite(sched, leaves) -> bool:
    free = sorted(set(range(sched._alloc.num_pages)) - set(sched._alloc.refs))
    return all(np.isfinite(np.asarray(leaf, np.float32)[:, free]).all() for leaf in leaves)


def test_a_poisoned_requests_own_pages_are_scrubbed_unlike_jax():
    """A NaN page makes its reader's hidden state NaN, and the reader then
    writes NaN K/V into its own pages at every later position. The JAX
    scheduler scrubs only the page the injector hit, so at the retry the
    reader's other pages go back to the free list holding NaN (the next
    owner reads their unwritten tail masked, and 0 * NaN poisons it); the
    port scrubs every page the flagged request held alone (ROADMAP.md
    Queue 3). Tokens are the fault-free run's either way."""
    events = (("page_corrupt", 5, 0),)
    state = {}

    def script(sched, prompts, max_new):
        for rid, p in enumerate(prompts):
            sched.submit(list(p), request_id=rid, max_new=max_new)
        while sched._by_id[0]["_status"] != "retrying":
            sched.step()
        if isinstance(sched, BatchScheduler):
            leaves = [pool[:, :-1] for c in sched.caches.values()
                      for pool in c["attn"].values()]
        else:
            leaves = [c["attn"][n] for c in sched.caches.values() for n in ("k_pages", "v_pages")]
        state[isinstance(sched, BatchScheduler)] = _free_pages_finite(sched, leaves)
        sched.drain()

    base = _chaos("port", max_new=20)[1]
    got = _chaos("port", events, max_new=20, sched_script=script)[1]
    want = _chaos("jax", events, max_new=20, sched_script=script)[1]
    assert state == {True: True, False: False}
    assert got["tokens"] == want["tokens"] == base["tokens"]
    assert got["injected"]["pages_corrupted"] == 1 and got["pages_in_use"] == 0


def test_faults_on_the_dense_layout_match_jax():
    """``paged=False``: NaN and hang faults retry as on the paged layout;
    page corruptions are dropped (no pages) and spikes wait for a pool
    that is not there, as in JAX."""
    events = (("nan", 4, None), ("page_corrupt", 5, None), ("hang", 7, None))
    sched, got, base = _both(events, (("hang_s", HANG_S),), paged=False, num_pages=None,
                             **WATCHDOG)
    assert sched.kv_cache_stats()["layout"] == "dense"
    assert got["injected"] == {"nan_injected": 1, "pages_corrupted": 0, "alloc_spikes": 0,
                               "hangs": 1, "deferrals": got["injected"]["deferrals"]}
    assert got["recovery"]["watchdog_trips"] == 1
    assert got["tokens"] == base["tokens"]


# ---------------------------------------------------------------------------
# (d) the sentinel, the recovery region
# ---------------------------------------------------------------------------


def test_sentinel_masks_rows_and_an_empty_mask_changes_nothing():
    sched = BatchScheduler(_weights()[2], ServeConfig(max_len=64, batch=3, **SAMPLED))
    logits = torch.randn(3, 512, generator=torch.Generator().manual_seed(0))
    pos = torch.tensor([3, 9, 20], dtype=torch.int32)
    want = sched._sample(logits, sched.rng_keys, pos)
    tok, bad = sched._poison_and_sample(logits, torch.zeros(3, dtype=torch.bool),
                                        sched.rng_keys, pos)
    assert torch.equal(tok, want) and not bad.any()
    tok, bad = sched._poison_and_sample(logits, torch.tensor([False, True, False]),
                                        sched.rng_keys, pos)
    assert bad.tolist() == [False, True, False]
    assert tok[0] == want[0] and tok[2] == want[2]
    inf = logits.clone()
    inf[2, 7] = float("inf")
    assert sched._poison_and_sample(inf, torch.zeros(3, dtype=torch.bool), sched.rng_keys,
                                    pos)[1].tolist() == [False, False, True]


@pytest.mark.parametrize("kind", ["flash_decode", "flash_chunk", "paged_decode",
                                  "paged_prefill"])
def test_nan_check_reads_the_plain_versions(kind):
    """``kernels.nan_check`` on the CPU (where the wrapper runs the plain
    version): a NaN a row sees reaches that row only; a NaN where no row
    may look still reaches the plain version's rows through 0 * NaN, as in
    the JAX package's masked softmax."""
    from repro_torch.kernels import nan_check

    r = nan_check.check(kind, "float32", "cpu")
    assert r["kernel"] == r["plain"]
    assert r["plain"]["seen_nonfinite"] and r["plain"]["unseen_equal"]
    assert not r["plain"]["past_len_finite"]


@pytest.mark.parametrize("backend", ["monitor", "tracer", "null"])
def test_session_event_is_one_visit_under_each_backend(backend, tmp_path):
    from repro_torch.core.records import ResourceConfig
    from repro_torch.session import PerfSession, SessionConfig

    session = PerfSession(SessionConfig(app_name="ev", backend=backend, respect_env=False,
                                        trace_dir=str(tmp_path / "trace")),
                          ResourceConfig(num_hosts=1, devices_per_host=1))
    with session:
        for _ in range(3):
            session.event("recovery")
        with session.region("decode"):
            session.observe_step(torch.zeros(2))
    rec = session.finalize(str(tmp_path), save=False)
    if backend == "null":
        assert rec is None
        return
    assert rec.regions["recovery"].measurements.num_visits == 3
    assert rec.regions["decode"].measurements.num_visits == 1


def test_monitored_chaos_run_records_every_recovery_action():
    """Each retry, quarantine, shed, checksum failure and watchdog trip is
    one visit of the session's ``recovery`` region, as in JAX."""
    from repro_torch.core.records import ResourceConfig
    from repro_torch.session import PerfSession, SessionConfig

    session = PerfSession(SessionConfig(app_name="chaos", backend="monitor",
                                        respect_env=False),
                          ResourceConfig(num_hosts=1, devices_per_host=1))
    injector = FT.FaultInjector(FT.FaultConfig(hang_s=HANG_S), events=[
        FT.FaultEvent(kind="nan", tick=4), FT.FaultEvent(kind="hang", tick=8),
        FT.FaultEvent(kind="nan", tick=10, request_id=0)])
    with session:
        sched = BatchScheduler(_weights()[2], ServeConfig(**{**CHAOS, **WATCHDOG,
                                                             "max_retries": 1,
                                                             "shed_queue_depth": 3}),
                               session=session, fault_injector=injector)
        for rid in range(6):
            sched.submit(list(range(4 + rid, 12 + rid)), request_id=rid, max_new=6)
        sched.drain()
    rec = session.finalize(save=False)
    r = sched.kv_cache_stats()["recovery"]
    acts = (r["retries"] + r["quarantined"] + r["shed"] + r["checksum_failures"]
            + r["watchdog_trips"])
    assert r["shed"] > 0 and r["retries"] > 0 and r["watchdog_trips"] == 1
    assert rec.regions["recovery"].measurements.num_visits == acts
