"""Serving under load: the port's scheduler against the JAX package's on
converted weights (smoke tinyllama, fp32).

(a) ``PageAllocator`` and ``PrefixCache`` driven by one scripted call
sequence give the JAX classes' pages, refcounts and stats; (b) prefix
sharing on a system prompt that ends mid-page: tokens equal to JAX's and
to sharing off, ``prefix_cache`` stats equal to JAX's, trie pages never
written; (c) each ``preempt_policy`` on a tight pool: tokens and
``pressure`` counters equal to JAX's, resumed streams equal to an
ample-pool run; priority preemption; (d) cancel, handles, timeouts,
``stream_async``, ``drain``'s non-quiescence error, ``ServeConfig``'s
refusals; (e) the monitored scheduler's record against the JAX
``RunRecord.load``/``validate_pop`` and the JAX scheduler's counts.
Each JAX scheduler run is built once per module.
"""

import asyncio
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as smoke_j  # noqa: E402
from repro.layers.common import init_params as init_j  # noqa: E402
from repro.models import transformer as TJ  # noqa: E402
from repro_torch.configs import smoke_config as smoke_t  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.serve.serve import (  # noqa: E402
    BatchScheduler,
    PageAllocator,
    PrefixCache,
    ServeConfig,
)

F32 = dict(compute_dtype_name="float32", param_dtype_name="float32")
MAX_LEN = 64


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


def _run_port(script, session=None, **scfg):
    sched = BatchScheduler(_weights()[2], ServeConfig(max_len=MAX_LEN, **scfg),
                           session=session)
    return sched, script(sched)


@functools.cache
def _run_jax(script, **scfg):
    """The JAX scheduler through the same script, once per configuration."""
    from repro.serve.serve import BatchScheduler as SchedJ
    from repro.serve.serve import ServeConfig as ScfgJ

    cfg_j, params, _ = _weights()
    mesh = _mesh()
    with mesh:
        sched = SchedJ(cfg_j, mesh, ScfgJ(max_len=MAX_LEN, paged=True, **scfg), params)
        out = script(sched)
    return sched, out


def _tokens(sched):
    return {r["id"]: r["generated"] for r in sched.completed}


def _run(sched, n, max_ticks=200):
    ticks = 0
    while len(sched.completed) < n and ticks < max_ticks:
        sched.step()
        ticks += 1
    sched.drain()


# ---------------------------------------------------------------------------
# (a) the allocator and the trie, call for call
# ---------------------------------------------------------------------------


def _script_trie(alloc_cls, cache_cls):
    """One sequence of alloc/share/release/insert/match/evict calls; returns
    every observable along the way."""
    log = []
    alloc = alloc_cls(12)
    trie = cache_cls(4, alloc, capacity=5)

    def snap(tag):
        log.append((tag, dict(sorted(alloc.refs.items())), alloc.used,
                    alloc.free_pages, alloc.shared_pages, alloc.peak_used,
                    trie.size, dict(trie.stats), trie.reclaimable()))

    a = alloc.alloc(3, owner="a")                     # pages for 12 tokens
    pa = list(range(10, 22))
    trie.insert(pa, a)
    snap(("insert a", a))
    b = alloc.alloc(2, owner="b")
    pb = pa[:4] + list(range(40, 48))                 # shares page 0 of a
    chain, donor, rows = trie.match(pb + [1, 2])
    log.append(("match b", [n.page for n in chain], donor and donor.page, rows))
    b = [chain[0].page] + b
    alloc.share(b[:1])
    trie.insert(pb, b)
    snap("insert b")
    c = alloc.alloc(2, owner="c")
    trie.insert(list(range(60, 68)), c)               # capacity 5: LRU trim
    snap(("insert c", c))
    chain, donor, rows = trie.match(pa[:6] + [99, 98, 97])
    log.append(("match mid-page", [n.page for n in chain], donor and donor.page, rows))
    alloc.release(a)                                  # request a retires
    alloc.release(b)
    snap("release a, b")
    log.append(("evict_for 2", trie.evict_for(2)))
    snap("evicted")
    node = next(iter(trie.root.children.values()))
    log.append(("evict_subtree", trie.evict_subtree(node)))
    snap("subtree")
    alloc.release(c)
    trie.clear()
    snap("cleared")
    log.append(("free", alloc.free_pages, alloc.used))
    return log


def test_allocator_and_prefix_cache_match_jax_call_for_call():
    from repro.serve.serve import PageAllocator as AllocJ
    from repro.serve.serve import PrefixCache as CacheJ

    got = _script_trie(PageAllocator, PrefixCache)
    want = _script_trie(AllocJ, CacheJ)
    assert got == want
    assert got[-1] == ("free", 12, 0)
    assert any(t[0] == ("insert c", [5, 6]) and t[7]["evicted_pages"] >= 1
               for t in got if isinstance(t[0], tuple))


# ---------------------------------------------------------------------------
# (b) the prefix cache: a system prompt that ends mid-page
# ---------------------------------------------------------------------------

_SYSTEM = np.random.default_rng(13).integers(4, 512, size=20).tolist()  # 2.5 pages of 8
_TAILS = [np.random.default_rng(100 + i).integers(4, 512, size=3 + i).tolist()
          for i in range(5)]
PREFIX_CFG = dict(batch=2, prefill_chunk=4, page_size=8)


def _shared_prefix(sched):
    """JAX's warm-first schedule: request 0 completes (its prompt pages go
    into the trie), then the rest attach against it."""
    prompts = [_SYSTEM + t for t in _TAILS]
    sched.submit(prompts[0], request_id=0, max_new=6)
    _run(sched, 1)
    for rid, p in enumerate(prompts[1:], start=1):
        sched.submit(p, request_id=rid, max_new=6)
    _run(sched, len(prompts))


def _snapshot_trie_pages(sched):
    """Wrap the trie's insert: snapshot each newly pinned page's bytes in
    every pool when it is inserted. Returns {page: [tensor per pool]}."""
    snaps, insert = {}, sched._prefix.insert

    def recording(prompt, pages):
        insert(prompt, pages)
        for p in pages[:len(prompt) // sched.scfg.page_size]:
            snaps.setdefault(p, [pool[:, p].clone() for slot in sched.caches.values()
                                 for pool in slot["attn"].values()])

    sched._prefix.insert = recording
    return snaps


def test_prefix_sharing_matches_jax_and_sharing_off():
    jx, _ = _run_jax(_shared_prefix, prefix_cache=True, **PREFIX_CFG)
    on = BatchScheduler(_weights()[2], ServeConfig(max_len=MAX_LEN, prefix_cache=True,
                                                   **PREFIX_CFG))
    snaps = _snapshot_trie_pages(on)
    _shared_prefix(on)
    off, _ = _run_port(_shared_prefix, **PREFIX_CFG)
    assert _tokens(on) == _tokens(jx) == _tokens(off)
    st = on.kv_cache_stats()
    assert st["prefix_cache"] == jx.kv_cache_stats()["prefix_cache"]
    assert st["pressure"] == jx.kv_cache_stats()["pressure"]
    pc = st["prefix_cache"]
    # page 2 of the system prompt is partial: a hit past it copies it
    assert pc["hits"] == 4 and pc["cow_copies"] >= 1
    assert pc["prefill_tokens_skipped"] > 0
    assert on.stats["prefill_chunks"] < off.stats["prefill_chunks"]
    # trie pages: every byte as at its insert; the pool holds only the pins
    live = {n.page for n in _trie_nodes(on._prefix)}
    assert live and live <= set(snaps)
    for p in live:
        now = [pool[:, p] for slot in on.caches.values() for pool in slot["attn"].values()]
        assert all(torch.equal(a, b) for a, b in zip(now, snaps[p])), p
    assert st["pages_in_use"] == on._prefix.size
    on._prefix.clear()
    assert on.kv_cache_stats()["pages_in_use"] == 0 and not on._alloc.refs


def _trie_nodes(trie):
    out, stack = [], list(trie.root.children.values())
    while stack:
        n = stack.pop()
        out.append(n)
        stack.extend(n.children.values())
    return out


def test_prefix_trie_eviction_and_capacity_match_jax():
    """A pool too small for every retired prompt's pages (LRU eviction on
    attach) and a trie capacity of 2 pages: tokens and stats equal JAX's."""
    for kw in (dict(num_pages=8), dict(prefix_trie_capacity=2)):
        jx, _ = _run_jax(_shared_prefix, prefix_cache=True, **PREFIX_CFG, **kw)
        pt, _ = _run_port(_shared_prefix, prefix_cache=True, **PREFIX_CFG, **kw)
        assert _tokens(pt) == _tokens(jx)
        assert pt.kv_cache_stats()["prefix_cache"] == jx.kv_cache_stats()["prefix_cache"]
        assert pt._alloc.used == pt._prefix.size
    assert pt._prefix.size <= 2


# ---------------------------------------------------------------------------
# (c) preemption under pool pressure
# ---------------------------------------------------------------------------

_LOAD_PROMPTS = [np.random.default_rng(7 + i).integers(4, 512, size=n).tolist()
                 for i, n in enumerate((10, 5, 13, 7))]
_LOAD = list(zip(_LOAD_PROMPTS, (0, 1, 0, 2), (8, 10, 6, 9)))  # prompt, priority, max_new
LOAD_CFG = dict(batch=3, prefill_chunk=4, page_size=4)


def _staggered(sched):
    """Four requests of three priority classes, one arrival a tick.
    Returns the RuntimeError text if the pool raised, else None."""
    try:
        for rid, (p, prio, n) in enumerate(_LOAD):
            sched.submit(p, request_id=rid, max_new=n, priority=prio)
            sched.step()
        sched.drain()
    except RuntimeError as e:
        return str(e).split(" [")[0]
    return None


@pytest.mark.parametrize("policy", ["priority", "pages", "progress", "never"])
def test_preempt_policies_match_jax_and_the_ample_pool(policy):
    jx, jerr = _run_jax(_staggered, num_pages=7, preempt_policy=policy, **LOAD_CFG)
    pt, perr = _run_port(_staggered, num_pages=7, preempt_policy=policy, **LOAD_CFG)
    assert perr == jerr
    assert _tokens(pt) == _tokens(jx)
    assert pt.kv_cache_stats()["pressure"] == jx.kv_cache_stats()["pressure"]
    assert [r["id"] for r in pt.failed] == [r["id"] for r in jx.failed]
    if policy == "never":
        assert "exhausted" in perr and len(pt.failed) == 1
        assert pt._alloc.used == sum(len(p) for p in pt._slot_pages)
        return
    # the ample pool preempts only for the priority-2 arrival behind a full batch
    ample, _ = _run_port(_staggered, preempt_policy=policy, **LOAD_CFG)
    assert perr is None and ample.stats["preemptions"] == 1
    assert pt.stats["preemptions"] > 1 and pt.stats["resumes"] == pt.stats["preemptions"]
    assert _tokens(pt) == _tokens(ample) and len(pt.completed) == 4
    assert pt._alloc.used == 0


def test_victim_selection_matches_jax():
    """Hand-placed occupants: only strictly younger or lower-priority
    occupants are eligible, each policy orders them as the JAX one does."""
    from repro.serve.serve import BatchScheduler as SchedJ
    from repro.serve.serve import ServeConfig as ScfgJ

    cfg_j, params, model = _weights()

    def place(s):
        prios = {"w": 0, "x": 0, "y": 0, "z": 1}
        for rid in ("w", "x", "y", "z"):
            s.submit([1, 2, 3], request_id=rid, max_new=4, priority=prios[rid])
        reqs = {r["id"]: r for r in s.queue}
        s.queue.clear()
        for slot, rid in enumerate(("w", "x", "y", "z")):
            s.active[slot] = reqs[rid]
        s._slot_pages[:] = [[0], [1, 2, 3], [4, 5], [6, 7]]
        reqs["x"]["generated"] = [9]
        return [s._pick_victim(reqs[r]) for r in ("w", "x", "y", "z")]

    for policy in ("priority", "pages", "progress"):
        kw = dict(max_len=64, batch=4, page_size=8, num_pages=32, preempt_policy=policy)
        got = place(BatchScheduler(model, ServeConfig(**kw)))
        with _mesh():
            want = place(SchedJ(cfg_j, _mesh(), ScfgJ(paged=True, **kw), params))
        assert got == want, policy
        assert got[2] is None  # the youngest of its class evicts no elder


def _priority_script(sched):
    h_lo = sched.submit(list(range(4, 12)), request_id="lo", max_new=8, priority=0)
    for _ in range(4):
        sched.step()  # lo prefilled and decoding
    h_hi = sched.submit(list(range(20, 26)), request_id="hi", max_new=6, priority=5)
    hi = h_hi.result()
    sched.drain()
    return hi, h_lo.status, [r["id"] for r in sched.completed]


def test_priority_arrival_preempts_and_both_match_jax():
    kw = dict(batch=1, prefill_chunk=4, page_size=8)
    pt, (hi, lo_status, order) = _run_port(_priority_script, **kw)
    jx, want = _run_jax(_priority_script, **kw)
    assert (hi, lo_status, order) == want
    assert order == ["hi", "lo"] and lo_status == "done"
    assert _tokens(pt) == _tokens(jx)
    assert pt.kv_cache_stats()["pressure"] == jx.kv_cache_stats()["pressure"]
    assert pt.stats["preemptions"] >= 1 and pt.stats["resumes"] >= 1


# ---------------------------------------------------------------------------
# (d) cancel, handles, streams, drain, config
# ---------------------------------------------------------------------------


def _cancel_script(sched, cancel=True):
    sched.submit(list(range(4, 14)), request_id="a", max_new=10)
    h = sched.submit(list(range(30, 38)), request_id="b", max_new=10)
    for _ in range(7):  # both prefilled; b decoding mid-stream
        sched.step()
    seen = None
    if cancel:
        used, pins = sched._alloc.used, sched._prefix.size
        seen = (h.cancel(), h.cancel(), h.status, h.done,
                sched._alloc.used < used, sched._prefix.size == pins)
    sched.drain()
    return seen


def test_mid_stream_cancel_frees_pages_and_spares_the_neighbour():
    kw = dict(batch=2, prefill_chunk=4, page_size=8, prefix_cache=True)
    cut, seen = _run_port(_cancel_script, **kw)
    full, _ = _run_port(functools.partial(_cancel_script, cancel=False), **kw)
    jx, want = _run_jax(_cancel_script, **kw)
    assert seen == want == (True, False, "cancelled", True, True, True)
    assert _tokens(cut)["a"] == _tokens(full)["a"] == _tokens(jx)["a"]
    assert [r["id"] for r in cut.cancelled] == ["b"] and "b" not in _tokens(cut)
    assert cut.stats["cancellations"] == 1
    assert cut._alloc.used == cut._prefix.size
    # a request still waiting in the queue cancels too
    sched = BatchScheduler(_weights()[2], ServeConfig(max_len=MAX_LEN, batch=1,
                                                      prefill_chunk=4))
    sched.submit(list(range(4, 14)), request_id="a", max_new=4)
    hq = sched.submit(list(range(30, 38)), request_id="q", max_new=4)
    sched.step()
    assert hq.cancel() and not sched.queue and hq.status == "cancelled"
    sched.drain()
    assert [r["id"] for r in sched.completed] == ["a"]


def _stall(sched, request_id):
    """Park a request with a ready tick the scheduler never reaches."""
    req = sched._by_id[request_id]
    sched.queue.remove(req)
    req["_status"] = "preempted"
    req["_not_before"] = 10**9
    sched._parked.append(req)


def test_handle_statuses_timeouts_and_drain_error():
    model = _weights()[2]
    sched = BatchScheduler(model, ServeConfig(max_len=MAX_LEN, batch=2, prefill_chunk=4,
                                              page_size=8))
    h = sched.submit(list(range(4, 12)), request_id=0, max_new=3)
    seen = [h.status]
    while not h.done:
        sched.step()
        sched.flush()
        seen.append(h.status)
    assert seen[0] == "queued" and seen[-1] == "done"
    assert {"prefilling", "decoding"} <= set(seen) and len(h.tokens) == 3
    assert h.request_id == 0 and not h.cancel()

    stalled = sched.submit(list(range(4, 12)), request_id=1, max_new=4)
    _stall(sched, 1)
    with pytest.raises(TimeoutError, match="no progress"):
        stalled.result(timeout=5)
    with pytest.raises(TimeoutError, match="no progress"):
        next(iter(stalled.stream(timeout=3)))
    assert stalled.status == "preempted"
    with pytest.raises(RuntimeError) as exc:
        sched.drain()
    msg = str(exc.value)
    assert "no quiescence" in msg and "parked=1" in msg
    assert "kv_cache_stats" in msg and "'recovery'" in msg
    with pytest.raises(KeyError):
        next(iter(sched.stream("missing")))


def _two_prompts(sched):
    for rid, p in (("a", list(range(4, 12))), ("b", list(range(20, 27)))):
        sched.submit(p, request_id=rid, max_new=5)
    sched.drain()


def test_two_stream_async_consumers_interleave():
    sched = BatchScheduler(_weights()[2], ServeConfig(max_len=MAX_LEN, batch=2,
                                                      prefill_chunk=4))
    for rid, p in (("a", list(range(4, 12))), ("b", list(range(20, 27)))):
        sched.submit(p, request_id=rid, max_new=5)
    order = []

    async def collect(rid):
        out = []
        async for t in sched.stream_async(rid):
            out.append(t)
            order.append(rid)
        return out

    async def main():
        return await asyncio.gather(collect("a"), collect("b"))

    got_a, got_b = asyncio.run(main())
    jx, _ = _run_jax(_two_prompts, batch=2, prefill_chunk=4)
    assert {"a": got_a, "b": got_b} == _tokens(jx)
    assert order.index("b") < len(order) - 1 - order[::-1].index("a")  # interleaved


# ServeConfig arguments the JAX package refuses, each with its message
JAX_REFUSED = (
    dict(preempt_policy="lifo"), dict(preempt_policy=""),
    dict(spec_decode=True, spec_k=0), dict(spec_decode=True, spec_min_match=0),
    dict(checksum_pages=True), dict(checksum_pages=True, prefix_cache=True, paged=False),
    dict(prefix_cache=True, paged=False), dict(spec_decode=True, paged=False),
    dict(max_retries=-1), dict(retry_backoff_base=0), dict(retry_backoff_cap=0),
)


def test_serve_config_refuses_what_jax_refuses():
    """Every JAX field, in JAX's order, with JAX's default, and JAX's checks:
    the same refusals with the same messages, the same acceptances."""
    import dataclasses

    from repro.serve.serve import ServeConfig as ScfgJ

    names = [f.name for f in dataclasses.fields(ScfgJ)]
    assert [f.name for f in dataclasses.fields(ServeConfig)] == names
    jx, pt = ScfgJ(max_len=64, batch=2), ServeConfig(max_len=64, batch=2)
    assert dataclasses.asdict(pt) == dataclasses.asdict(jx)
    for bad in JAX_REFUSED:
        with pytest.raises(ValueError) as want:
            ScfgJ(max_len=64, batch=2, **bad)
        with pytest.raises(ValueError) as got:
            ServeConfig(max_len=64, batch=2, **bad)
        assert str(got.value) == str(want.value), bad
    # accepted by both: checks that only hold with another field set, and
    # max_len % page_size, which the paged scheduler checks, not the config
    for ok in (dict(spec_k=0), dict(spec_min_match=0), dict(paged=False),
               dict(checksum_pages=True, prefix_cache=True), dict(max_retries=0),
               dict(max_len=60), dict(max_len=60, paged=False),
               dict(prefix_cache=True, prefix_trie_capacity=3)):
        kw = {"max_len": 64, "batch": 2, **ok}
        assert dataclasses.asdict(ServeConfig(**kw)) == dataclasses.asdict(ScfgJ(**kw))
    with pytest.raises(ValueError, match="divisible"):
        BatchScheduler(_weights()[2], ServeConfig(max_len=60, batch=2))


# ---------------------------------------------------------------------------
# (e) the monitored scheduler
# ---------------------------------------------------------------------------


def test_monitored_record_loads_in_jax_and_counts_visits(tmp_path):
    from repro.core.factors import validate_pop
    from repro.core.records import RunRecord as RunRecordJ
    from repro_torch.core.records import ResourceConfig
    from repro_torch.session import PerfSession, SessionConfig

    session = PerfSession(SessionConfig(app_name="serve-test", backend="monitor",
                                        lb_sample_every=1, respect_env=False),
                          ResourceConfig(num_hosts=1, devices_per_host=1))
    with session:
        pt, _ = _run_port(_staggered, session=session, num_pages=7, **LOAD_CFG)
    session.finalize(str(tmp_path))
    jx, _ = _run_jax(_staggered, num_pages=7, preempt_policy="priority", **LOAD_CFG)
    run = RunRecordJ.load(session.last_record_path)
    assert run.hardware == "h100_sxm"
    visits = {n: r.measurements.num_visits for n, r in run.regions.items()}
    assert visits["decode"] == jx.stats["decode_steps"] == pt.stats["decode_steps"]
    assert visits["prefill"] == jx.stats["prefill_chunks"]
    assert visits["preempt"] == jx.stats["preemptions"] > 0
    for name, reg in run.regions.items():
        assert not validate_pop(reg.pop), name
    for name in ("decode", "prefill"):
        assert run.regions[name].counters.useful_flops > 0
    assert _tokens(pt) == _tokens(jx)
