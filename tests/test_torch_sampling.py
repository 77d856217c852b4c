"""Sampled decoding: the port's ``jax.random`` functions and sampler against
JAX's, and the sampled scheduler against the JAX scheduler on converted
weights (smoke tinyllama, fp32).

(a) ``prng.py``: keys, ``split``, ``fold_in`` and ``random_bits``
bit for bit against ``jax.random``, up to the full vocabulary (32000);
``uniform`` bitwise, ``gumbel`` within 1e-6 of max(1, |value|) (the two
``log`` implementations differ by an ulp, which is ill-conditioned where
a draw is near 0); (b) ``_sample_tokens`` against the JAX one on fixed
logits, greedy and sampled, with and without top-k and vocab padding,
and its draws against ``softmax(top_k(logits / T))`` by a chi-square
test; (c) the JAX ``tests/test_serve.py`` sampling cases mirrored (slot
reuse, co-resident independence and overlap, the greedy flag, prefix
sharing), each stream also equal to the JAX scheduler's.
"""

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
from repro_torch import prng  # noqa: E402
from repro_torch.serve.serve import BatchScheduler, ServeConfig, _sample_tokens  # noqa: E402

F32 = dict(compute_dtype_name="float32", param_dtype_name="float32")
SAMPLED = dict(greedy=False, temperature=0.8, top_k=20, sample_seed=3)
TINY = float(jnp.finfo(jnp.float32).tiny)


def _key_t(key_j) -> torch.Tensor:
    return torch.from_numpy(np.asarray(key_j).astype(np.int64))


def _u32(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


# ---------------------------------------------------------------------------
# (a) the PRNG, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3, 12345, 2**31 - 1])
def test_key_split_fold_in_and_bits_match_jax(seed):
    kj = jax.random.PRNGKey(seed)
    kt = prng.prng_key(seed)
    assert np.array_equal(_u32(kj), kt.numpy())
    assert np.array_equal(_u32(jax.random.split(kj, 16)), prng.split(kt, 16).numpy())
    # one key folded with many positions, and rows folded with their own
    data = np.array([0, 1, 7, 255, 1023, 2**31 - 1, 2**32 - 1], np.uint32)
    want = np.stack([_u32(jax.random.fold_in(kj, int(d))) for d in data])
    assert np.array_equal(prng.fold_in(kt, torch.from_numpy(data.astype(np.int64))).numpy(),
                          want)
    rows_j = jax.random.split(kj, 5)
    pos = jnp.asarray([0, 3, 64, 1000, 99999], jnp.int32)
    want = _u32(jax.vmap(jax.random.fold_in)(rows_j, pos))
    got = prng.fold_in(_key_t(rows_j), torch.from_numpy(np.array(pos)))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(prng.fold_in(kt, 7).numpy(), _u32(jax.random.fold_in(kj, 7)))
    for n in (1, 2, 7, 512, 32000):
        assert np.array_equal(prng.random_bits(kt, n).numpy(),
                              _u32(jax.random.bits(kj, (n,)))), n
    # rows of keys at once, as the sampler draws them
    got = prng.random_bits(_key_t(rows_j), 333).numpy()
    assert np.array_equal(got, _u32(jax.vmap(lambda k: jax.random.bits(k, (333,)))(rows_j)))


def test_fold_in_reproduces_the_known_key():
    assert prng.fold_in(prng.prng_key(3), 7).tolist() == [2647473427, 4234374204]


@pytest.mark.parametrize("seed", [0, 11])
def test_uniform_bitwise_and_gumbel_close(seed):
    kj = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
    kt = _key_t(kj)
    for n, lo in ((32000, TINY), (513, 0.0)):
        want = np.asarray(jax.random.uniform(kj, (n,), jnp.float32, minval=lo, maxval=1.0))
        got = prng.uniform(kt, n, lo, 1.0).numpy()
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
    gj = np.asarray(jax.random.gumbel(kj, (32000,), jnp.float32))
    gt = prng.gumbel(kt, 32000).numpy()
    assert np.all(np.abs(gt - gj) <= 1e-6 * np.maximum(1.0, np.abs(gj)))
    assert np.isfinite(gt).all()


# ---------------------------------------------------------------------------
# (b) the sampler
# ---------------------------------------------------------------------------


def _jax_sampler(logits, keys, positions, **kw):
    from repro.serve.serve import _sample_tokens as sample_j

    return np.asarray(sample_j(jnp.asarray(logits), jnp.asarray(keys.astype(np.uint32)),
                               jnp.asarray(positions), **kw))


def _near_tie(logits, key_row, position, *, temperature, top_k, vocab, got, want) -> float:
    """JAX's (masked logits / T + gumbel) at the two ids the samplers chose:
    their gap (a near tie is below a few ulps of the values)."""
    lg = np.asarray(logits, np.float32) / np.float32(max(temperature, 1e-6))
    lg[vocab:] = -np.inf
    if top_k:
        lg[lg < np.sort(lg)[-top_k]] = -np.inf
    use = jax.random.fold_in(jnp.asarray(key_row.astype(np.uint32)), int(position))
    z = lg + np.asarray(jax.random.gumbel(use, lg.shape, jnp.float32))
    return float(abs(z[got] - z[want]))


@pytest.mark.parametrize("top_k", [None, 1, 5, 512])
@pytest.mark.parametrize("vocab", [512, 500])
@pytest.mark.parametrize("greedy", [True, False])
def test_sample_tokens_matches_jax(greedy, vocab, top_k):
    rng = np.random.default_rng(5)
    N, V = 48, 512
    logits = (3 * rng.standard_normal((N, V))).astype(np.float32)
    keys = _u32(jax.random.split(jax.random.PRNGKey(9), N))
    positions = rng.integers(0, 1024, size=N).astype(np.int32)
    kw = dict(greedy=greedy, temperature=0.7, top_k=top_k, vocab=vocab)
    want = _jax_sampler(logits, keys, positions, **kw)
    got = _sample_tokens(torch.from_numpy(logits), torch.from_numpy(keys),
                         torch.from_numpy(positions), **kw)
    assert got.dtype == torch.int32 and tuple(got.shape) == (N,)
    got = got.numpy()
    if not greedy:
        assert (got < vocab).all()
        if top_k == 1:
            assert np.array_equal(got, np.argmax(logits[:, :vocab], axis=-1))
    for i in np.flatnonzero(got != want):  # allowed only at a near tie
        gap = _near_tie(logits[i], keys[i], positions[i], temperature=0.7, top_k=top_k,
                        vocab=vocab, got=got[i], want=want[i])
        assert gap < 1e-5, (i, got[i], want[i], gap)
    assert (got == want).mean() >= 0.95


def test_sample_tokens_greedy_reads_no_key():
    logits = torch.randn(3, 40)
    out = _sample_tokens(logits, None, None, greedy=True, temperature=0.5, top_k=3, vocab=40)
    assert torch.equal(out, torch.argmax(logits, -1).to(torch.int32))


def test_sampled_ids_follow_softmax_of_top_k():
    """Chi-square of 40,000 draws (40,000 positions folded into one key)
    against softmax(top_k(logits / T)); the statistic must stay below the
    0.999 quantile of its distribution."""
    from scipy.stats import chi2

    rng = np.random.default_rng(17)
    V, T, k, n = 64, 0.8, 12, 40000
    row = rng.standard_normal(V).astype(np.float32) * 2
    logits = torch.from_numpy(np.broadcast_to(row, (n, V)).copy())
    keys = prng.fold_in(prng.prng_key(1), 42).expand(n, 2)
    ids = _sample_tokens(logits, keys, torch.arange(n), greedy=False, temperature=T,
                         top_k=k, vocab=V).numpy()
    lg = row.astype(np.float64) / T
    keep = lg >= np.sort(lg)[-k]
    p = np.where(keep, np.exp(lg - lg.max()), 0.0)
    p /= p.sum()
    assert set(np.unique(ids)) <= set(np.flatnonzero(keep))
    counts = np.bincount(ids, minlength=V)[keep]
    expect = n * p[keep]
    stat = float(((counts - expect) ** 2 / expect).sum())
    assert stat < chi2.ppf(0.999, df=int(keep.sum()) - 1), stat


# ---------------------------------------------------------------------------
# (c) the sampled scheduler, port against JAX
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


def _tokens(sched):
    return {r["id"]: r["generated"] for r in sched.completed}


def _run(sched, n, max_ticks=200):
    ticks = 0
    while len(sched.completed) < n and ticks < max_ticks:
        sched.step()
        ticks += 1
    sched.drain()


def _both(script, **scfg):
    """The port's and the JAX scheduler's tokens through one script."""
    from repro.serve.serve import BatchScheduler as SchedJ
    from repro.serve.serve import ServeConfig as ScfgJ

    cfg_j, params, model = _weights()
    port = BatchScheduler(model, ServeConfig(**scfg))
    out_t = script(port)
    with _mesh():
        jx = SchedJ(cfg_j, _mesh(), ScfgJ(paged=True, **scfg), params)
        out_j = script(jx)
    return (port, out_t), (jx, out_j)


def _slot_reuse(submit_a):
    def script(sched):
        if submit_a:
            sched.submit([5, 6, 7, 8, 9], request_id="a", max_new=5)
        sched.submit([20, 21, 22], request_id="b", max_new=8)
        _run(sched, 2 if submit_a else 1)
        return _tokens(sched)
    return script


_REUSED, _FRESH = _slot_reuse(True), _slot_reuse(False)


def test_sampling_deterministic_and_reset_on_slot_reuse():
    cfg = dict(max_len=64, batch=1, prefill_chunk=4, **SAMPLED)
    (_, reused), (_, reused_j) = _both(_REUSED, **cfg)
    (_, fresh), (_, fresh_j) = _both(_FRESH, **cfg)
    assert reused == reused_j and fresh == fresh_j
    assert reused["b"] == fresh["b"]
    (_, again), _ = _both(_REUSED, **cfg)
    assert again == reused
    assert all(0 <= t < 512 for toks in reused.values() for t in toks)


def _stream_of_b(late):
    def script(sched):
        sched.submit(list(range(4, 14)), request_id="x", max_new=10)
        if late:
            sched.step()
            sched.step()  # x decodes alone for a while
        sched.submit([20, 21, 22], request_id="b", max_new=6)
        _run(sched, 2)
        return _tokens(sched)
    return script


_B_NOW, _B_LATE = _stream_of_b(False), _stream_of_b(True)


def test_sampling_independent_of_coresident_traffic_and_overlap():
    cfg = dict(max_len=64, batch=2, prefill_chunk=4, **SAMPLED)
    (_, base), (_, base_j) = _both(_B_NOW, **cfg)
    (_, late), (_, late_j) = _both(_B_LATE, **cfg)
    (_, sw), (_, sw_j) = _both(_B_LATE, overlap=False, **cfg)
    assert base == base_j and late == late_j and sw == sw_j
    assert base["b"] == late["b"] == sw["b"]
    assert late["x"] == sw["x"]


def _one(sched):
    sched.submit([9, 10, 11, 12], request_id=0, max_new=6)
    _run(sched, 1)
    return _tokens(sched)


def test_greedy_flag_ignores_temperature_and_top_k():
    (_, got), (_, want) = _both(_one, max_len=64, batch=2, temperature=0.7, top_k=5)
    (_, plain), _ = _both(_one, max_len=64, batch=2)
    assert got == want == plain


def _shared_prompts():
    rng = np.random.default_rng(31)
    system = rng.integers(4, 512, size=16).tolist()
    return [system + rng.integers(4, 512, size=int(n)).tolist()
            for n in rng.integers(3, 8, size=4)]


def _prefix_script(sched):
    prompts = _shared_prompts()
    sched.submit(prompts[0], request_id=0, max_new=6)
    _run(sched, 1)
    for rid, p in enumerate(prompts[1:], start=1):
        sched.submit(p, request_id=rid, max_new=6)
    _run(sched, len(prompts))
    return _tokens(sched)


def test_prefix_sharing_sampled_streams_identical():
    cfg = dict(max_len=64, batch=2, prefill_chunk=4, page_size=8, **SAMPLED)
    (on, got), (_, want) = _both(_prefix_script, prefix_cache=True, **cfg)
    (_, off), _ = _both(_prefix_script, **cfg)
    assert got == want == off
    assert on.kv_cache_stats()["prefix_cache"]["hits"] > 0


def _preempt_script(sched):
    for rid, p in enumerate([list(range(4, 12)), list(range(20, 28)), [7, 3, 9]]):
        sched.submit(p, request_id=f"r{rid}", max_new=10)
    _run(sched, 3)
    return _tokens(sched)


def test_sampled_streams_survive_preemption_and_string_ids():
    """String ids key by crc32 of their repr; a tight pool preempts and
    resumes in other slots; the streams equal an ample pool's and JAX's."""
    cfg = dict(max_len=64, batch=2, prefill_chunk=4, page_size=8, **SAMPLED)
    (tight, got), (jx, want) = _both(_preempt_script, num_pages=3, **cfg)
    (_, ample), _ = _both(_preempt_script, **cfg)
    assert tight.stats["preemptions"] > 0
    assert tight.kv_cache_stats()["pressure"] == jx.kv_cache_stats()["pressure"]
    assert got == want == ample
    assert tight._alloc.used == 0
