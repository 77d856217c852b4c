"""The dense KV layout (``paged=False``) and the K2 cost count, against the
JAX package on converted weights (smoke tinyllama, fp32).

(a) the dense attention branch against JAX's ``attention_block`` on a
dense cache: a decode step (one query row a slot at its own position,
some slots inactive) and a ``cache_attend`` chunk into one slot's row,
outputs within 1e-4 and the written caches within 1e-5 (the rest
bitwise); the idle row (no key)
where JAX's softmax gives the mean of V and the kernel's plain version 0;
(b) the dense scheduler against JAX's (``tests/test_serve.py``): greedy
tokens identical with overlap on and off, sampled, priority preemption,
and equal to the port's paged layout; ``ServeConfig``'s dense refusals;
(c) the flash-attention wrapper's counted work from positions and
``kv_len``, the training count unchanged; (d) the launcher's ``--dense``.
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
from repro_torch.kernels import cases  # noqa: E402
from repro_torch.kernels.flash_attention import ops as FA  # noqa: E402
from repro_torch.layers import attention as A  # noqa: E402
from repro_torch.serve.serve import BatchScheduler, ServeConfig  # noqa: E402

F32 = dict(compute_dtype_name="float32", param_dtype_name="float32")
SAMPLED = dict(greedy=False, temperature=0.8, top_k=20, sample_seed=3)


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


# ---------------------------------------------------------------------------
# (a) the attention branch
# ---------------------------------------------------------------------------


def _layer_params():
    cfg_j, params, model = _weights()
    pj = jax.tree_util.tree_map(lambda x: x[0], params["slots"]["slot0_attn"]["attn"])
    pt = {k: v[0].detach() for k, v in model.params()["slots"]["slot0_attn"]["attn"].items()}
    return cfg_j, model.cfg, pj, pt


def _caches(B, Smax, hkv, hd, seed):
    """A dense cache with seeded contents: JAX's (B, Smax) and the port's
    (B + 1, Smax), whose spare row holds other numbers."""
    rng = np.random.default_rng(seed)
    k, v = (rng.standard_normal((B + 1, Smax, hkv, hd)).astype(np.float32) for _ in range(2))
    return ({"k": jnp.asarray(k[:B]), "v": jnp.asarray(v[:B])},
            {"k": torch.from_numpy(k), "v": torch.from_numpy(v)})


def test_dense_decode_branch_matches_jax():
    from repro.layers.attention import attention_block as attn_j

    cfg_j, cfg_t, pj, pt = _layer_params()
    B, Smax = 3, 32
    cj, ct = _caches(B, Smax, cfg_t.n_kv_heads, cfg_t.head_dim_, seed=1)
    spare = {n: t[B].clone() for n, t in ct.items()}
    x = np.random.default_rng(2).standard_normal((B, 1, cfg_t.d_model)).astype(np.float32)
    pos = np.asarray([5, 17, 30], np.int32)
    active = np.asarray([True, False, True])
    out_j, new_j = attn_j(pj, jnp.asarray(x), cfg_j, positions=jnp.asarray(pos)[:, None],
                          cache=cj, cache_len=jnp.asarray(pos + 1),
                          seq_mask=jnp.asarray(active)[:, None])
    out_t = A.attention_block(pt, torch.from_numpy(x), cfg_t,
                              positions=torch.from_numpy(pos)[:, None], cache=ct,
                              cache_len=torch.from_numpy(pos + 1), block_tables=None,
                              seq_mask=torch.from_numpy(active)[:, None])
    rows = np.flatnonzero(active)
    np.testing.assert_allclose(out_t.numpy()[rows], np.asarray(out_j)[rows], atol=1e-4,
                               rtol=1e-4)
    for n in ("k", "v"):
        # written rows: the projections round as in JAX to within fp32
        np.testing.assert_allclose(ct[n][:B].numpy(), np.asarray(new_j[n]), atol=1e-5,
                                   rtol=1e-5)
        # the inactive row's write went to the spare row's first position
        assert torch.equal(ct[n][B, 1:], spare[n][1:])


@pytest.mark.parametrize("slot,start,length", [(1, 8, 4), (0, 0, 3), (2, 28, 4)])
def test_dense_chunk_branch_matches_jax_cache_attend(slot, start, length):
    """A 4-token chunk at ``start`` into ``slot``'s row (the last one runs
    past max_len: the write past the end is dropped): JAX slices the slot
    out and attends the written cache (``cache_attend``)."""
    from repro.layers.attention import attention_block as attn_j

    cfg_j, cfg_t, pj, pt = _layer_params()
    B, Smax, C = 3, 32, 4
    cj, ct = _caches(B, Smax, cfg_t.n_kv_heads, cfg_t.head_dim_, seed=3)
    x = np.random.default_rng(4).standard_normal((1, C, cfg_t.d_model)).astype(np.float32)
    positions = (start + np.arange(C, dtype=np.int32))[None]
    mask = (np.arange(C) < length)[None]
    row_j = {n: c[slot:slot + 1] for n, c in cj.items()}
    out_j, new_j = attn_j(pj, jnp.asarray(x), cfg_j, positions=jnp.asarray(positions),
                          cache=row_j, cache_len=jnp.asarray([start + length]),
                          seq_mask=jnp.asarray(mask), cache_attend=True)
    out_t = A.attention_block(pt, torch.from_numpy(x), cfg_t,
                              positions=torch.from_numpy(positions), cache=ct,
                              cache_len=torch.tensor([start + length], dtype=torch.int32),
                              block_tables=None, seq_mask=torch.from_numpy(mask),
                              cache_row0=slot)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-4, rtol=1e-4)
    for n in ("k", "v"):
        np.testing.assert_allclose(ct[n][slot].numpy(), np.asarray(new_j[n])[0], atol=1e-5,
                                   rtol=1e-5)
        others = [b for b in range(B) if b != slot]
        np.testing.assert_array_equal(ct[n][others].numpy(), np.asarray(cj[n])[others])


def test_idle_dense_row_differs_from_jax_and_is_never_read():
    """A row with no visible key (cache_len 0): JAX's ``decode_attention``
    softmaxes a row of -1e30s into the mean of V, the kernel's plain
    version (and the kernel) writes 0. The scheduler never gives a row
    cache_len 0 (it is pos + 1), and never reads an inactive row's output
    (ROADMAP Queue 3)."""
    from repro.layers.attention import decode_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_reference

    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 1, 4, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, 6, 2, 8)).astype(np.float32) for _ in range(2))
    lens = np.asarray([4, 0], np.int32)
    want = np.asarray(decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       q_position=jnp.asarray(lens - 1),
                                       cache_len=jnp.asarray(lens)))
    got = flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_positions=torch.from_numpy(lens - 1)[:, None],
        k_positions=A.key_positions(2, 6, torch.device("cpu")), causal=True,
        kv_len=torch.from_numpy(lens)).numpy()
    np.testing.assert_allclose(got[0], want[0], atol=1e-5)
    assert np.all(got[1] == 0)
    np.testing.assert_allclose(want[1, 0], np.repeat(v[1].mean(0), 2, axis=0), atol=1e-5)


def _dense_case(case, seed):
    B, Sq, Sk, Hq, Hkv, D, causal, _, _, off, kvl = case
    c = cases.flash_case(B, Sq, Sk, Hq, Hkv, D, seed=seed, q_offset=off, kv_len=kvl)
    got = A.flash_attention(*(torch.from_numpy(c[n]) for n in ("q", "k", "v")),
                            q_positions=torch.from_numpy(c["q_positions"]),
                            k_positions=torch.from_numpy(c["k_positions"]),
                            causal=causal, kv_len=torch.from_numpy(c["kv_len"]))
    return c, got.numpy()


def test_k2_plain_at_the_dense_decode_shape_matches_jax_decode_attention():
    """Full width (32/4 heads, D 64, 512 keys): per-row positions 96..287."""
    from repro.layers.attention import decode_attention

    c, got = _dense_case(cases.MAIN_FLASH_DECODE, seed=7)
    want = decode_attention(*(jnp.asarray(c[n]) for n in ("q", "k", "v")),
                            q_position=jnp.asarray(c["q_positions"][:, 0]),
                            cache_len=jnp.asarray(c["kv_len"]))
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)


def test_k2_plain_at_the_dense_chunk_shape_matches_jax_cache_attend():
    """A 64-token chunk at 192 against 512 keys cut at 256, through the jnp
    flash function as the JAX ``cache_attend`` branch calls it."""
    from repro.layers.attention import flash_attention as flash_j

    c, got = _dense_case(cases.MAIN_FLASH_CHUNK, seed=8)
    want = flash_j(*(jnp.asarray(c[n]) for n in ("q", "k", "v")),
                   q_positions=jnp.asarray(c["q_positions"]),
                   k_positions=jnp.asarray(c["k_positions"]), causal=True,
                   kv_len=jnp.asarray(c["kv_len"]), q_chunk=64, kv_chunk=64,
                   causal_skip=False)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)


def test_dense_cache_layout():
    model = _weights()[2]
    caches = model.init_cache(3, 32, paged=False)
    t = caches["slot0_attn"]["attn"]["k"]
    cfg = model.cfg
    assert set(caches["slot0_attn"]["attn"]) == {"k", "v"}
    assert tuple(t.shape) == (cfg.repeats, 4, 32, cfg.n_kv_heads, cfg.head_dim_)
    assert t[0][:3].is_contiguous() and t[0][1:2].is_contiguous()
    kp = A.key_positions(3, 32, torch.device("cpu"))
    assert kp is A.key_positions(3, 32, torch.device("cpu")), "built once per shape"
    assert kp.dtype == torch.int32 and kp.is_contiguous() and kp[2, 31] == 31


# ---------------------------------------------------------------------------
# (b) the dense scheduler
# ---------------------------------------------------------------------------


def _prompts():
    rng = np.random.default_rng(11)
    return tuple(tuple(rng.integers(4, 512, size=n).tolist()) for n in (10, 17, 5, 8))


def _staggered(sched, prompts):
    """Request 0 is mid-prefill when the rest arrive (4 requests, 2 slots)."""
    sched.submit(list(prompts[0]), request_id=0, max_new=7)
    sched.step()
    for rid in (1, 2, 3):
        sched.submit(list(prompts[rid]), request_id=rid, max_new=7)
    sched.drain()
    return {r["id"]: r["generated"] for r in sched.completed}


def _port(**scfg):
    sched = BatchScheduler(_weights()[2], ServeConfig(max_len=64, batch=2, prefill_chunk=4,
                                                      page_size=16, **scfg))
    return sched, _staggered(sched, _prompts())


@functools.cache
def _jax(**scfg):
    from repro.serve.serve import BatchScheduler as SchedJ
    from repro.serve.serve import ServeConfig as ScfgJ

    cfg_j, params, _ = _weights()
    with _mesh():
        sched = SchedJ(cfg_j, _mesh(), ScfgJ(max_len=64, batch=2, prefill_chunk=4,
                                             page_size=16, **scfg), params)
        toks = _staggered(sched, _prompts())
    return toks, dict(sched.stats), sched.kv_cache_stats()


@pytest.mark.parametrize("overlap", [True, False])
def test_dense_scheduler_matches_jax_dense_and_port_paged(overlap):
    sched, dense = _port(paged=False, overlap=overlap)
    want, stats, kv = _jax(paged=False, overlap=overlap)
    assert dense == want
    for k in ("ticks", "decode_steps", "prefill_chunks", "overlap_ticks", "readbacks"):
        assert sched.stats[k] == stats[k], k
    got_kv = sched.kv_cache_stats()
    assert got_kv["layout"] == kv["layout"] == "dense" and "num_pages" not in got_kv
    assert got_kv["recovery"] == kv["recovery"] and got_kv["pressure"] == kv["pressure"]
    _, paged = _port(paged=True, overlap=overlap)
    assert paged == dense
    assert _jax(paged=True, overlap=overlap)[0] == want


def test_dense_sampled_matches_jax():
    assert _port(paged=False, **SAMPLED)[1] == _jax(paged=False, **SAMPLED)[0]


def test_dense_priority_preemption_matches_jax():
    """A strictly higher-priority arrival behind a full dense batch preempts
    the lowest-priority occupant, which recompute-resumes to the same
    tokens (no pages to free: the preemption frees a slot)."""
    def script(sched):
        prompts = _prompts()
        for rid in (0, 1):
            sched.submit(list(prompts[rid]), request_id=rid, max_new=7)
        for _ in range(6):
            sched.step()
        sched.submit(list(prompts[2]), request_id=2, max_new=7, priority=1)
        sched.drain()
        return ({r["id"]: r["generated"] for r in sched.completed},
                sched.kv_cache_stats()["pressure"])

    from repro.serve.serve import BatchScheduler as SchedJ
    from repro.serve.serve import ServeConfig as ScfgJ

    kw = dict(max_len=64, batch=2, prefill_chunk=4, paged=False)
    got = script(BatchScheduler(_weights()[2], ServeConfig(**kw)))
    cfg_j, params, _ = _weights()
    with _mesh():
        want = script(SchedJ(cfg_j, _mesh(), ScfgJ(**kw), params))
    assert got == want and got[1]["preemptions"] == got[1]["resumes"] == 1
    assert got[1]["pages_freed_by_preempt"] == 0


DENSE_REFUSED = [dict(prefix_cache=True), dict(spec_decode=True),
                 dict(checksum_pages=True, prefix_cache=True)]


@pytest.mark.parametrize("bad", DENSE_REFUSED, ids=["prefix", "spec", "checksum"])
def test_dense_refusals_equal_jax(bad):
    from repro.serve.serve import ServeConfig as ScfgJ

    with pytest.raises(ValueError) as want:
        ScfgJ(max_len=64, batch=2, paged=False, **bad)
    with pytest.raises(ValueError) as got:
        ServeConfig(max_len=64, batch=2, paged=False, **bad)
    assert str(got.value) == str(want.value)


def test_dense_serves_any_max_len():
    """``max_len % page_size`` binds the paged layout only, as in JAX."""
    sched = BatchScheduler(_weights()[2], ServeConfig(max_len=60, batch=2, paged=False))
    sched.submit(list(range(4, 14)), request_id=0, max_new=3)
    sched.drain()
    assert len(sched.completed[0]["generated"]) == 3


# ---------------------------------------------------------------------------
# (c) the K2 cost count from positions
# ---------------------------------------------------------------------------


def _brute_pairs(qpos, kpos, kv_len, causal, window):
    q, k = qpos[:, :, None], kpos[:, None, :]
    vis = np.ones(np.broadcast_shapes(q.shape, k.shape), bool)
    if causal:
        vis &= k <= q
    if window:
        vis &= k > q - window
    if kv_len is not None:
        vis &= k < np.asarray(kv_len)[:, None, None]
    return int(vis.sum())


@pytest.mark.parametrize("causal,window,with_len", [
    (True, None, True), (False, None, True), (True, 5, True), (True, None, False),
    (False, 7, False)])
def test_position_pairs_against_brute_force(causal, window, with_len):
    rng = np.random.default_rng(6)
    qpos = rng.integers(0, 40, size=(3, 6))
    kpos = np.stack([rng.permutation(48) for _ in range(3)])
    kv_len = rng.integers(0, 48, size=3) if with_len else None
    pairs, keys = FA.position_pairs(qpos, kpos, kv_len, causal, window)
    assert pairs == _brute_pairs(qpos, kpos, kv_len, causal, window)
    assert 0 <= keys <= 3 * 48


def test_dense_decode_counts_every_visible_key():
    """The dense decode shape: a row at position p against max_len keys
    cut at p+1 computes p+1 pairs (the index count would give 1) and reads
    the keys up to p."""
    B, Sq, Sk, Hq, Hkv, D = 4, 1, 512, 32, 4, 64
    pos = np.asarray([96, 159, 222, 287])
    q = torch.empty(B, Sq, Hq, D, dtype=torch.bfloat16, device="meta")
    k = torch.empty(B, Sk, Hkv, D, dtype=torch.bfloat16, device="meta")
    kpos = np.broadcast_to(np.arange(Sk), (B, Sk))
    flops, nbytes = FA.launch_costs(q, k, True, None, False, pos[:, None], kpos, pos + 1)
    n = int((pos + 1).sum())
    assert flops == 4.0 * Hq * D * n
    assert nbytes == 2 * B * Hq * D * 2 + 2 * n * Hkv * D * 2 + B * Hq * 4
    old = FA.launch_costs(q, k, True, None, False)[0]
    assert old == 4.0 * B * Hq * D  # one pair a row: the undercount repaired


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("case", cases.FLASH_CASES + [cases.MAIN_FLASH],
                         ids=lambda c: "x".join(map(str, c[:3])) if isinstance(c, tuple) else "")
def test_training_count_unchanged_by_positions(case, backward):
    """At index positions (training) the count from positions equals the
    count the wrapper made before."""
    B, Sq, Sk, Hq, Hkv, D, causal, window, _ = case
    q = torch.empty(B, Sq, Hq, D, dtype=torch.bfloat16, device="meta")
    k = torch.empty(B, Sk, Hkv, D, dtype=torch.bfloat16, device="meta")
    qpos = FA.positions_rows(None, B, Sq, "cpu")
    kpos = FA.positions_rows(None, B, Sk, "cpu")
    assert FA.launch_costs(q, k, causal, window, backward, qpos, kpos, None) == \
        FA.launch_costs(q, k, causal, window, backward)


# ---------------------------------------------------------------------------
# (d) the launcher
# ---------------------------------------------------------------------------

LAUNCH = ["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu", "--batch", "2",
          "--max-len", "64", "--prefill-chunk", "8", "--page-size", "8"]


def test_launcher_dense_and_chaos_on_cpu(capsys):
    from repro_torch.launch.serve import main

    assert main(LAUNCH + ["--requests", "4", "--max-new", "4", "--dense"]) == 0
    out = capsys.readouterr().out
    assert "completed 4/4" in out and "dense KV:" in out and "paged KV" not in out
    assert "recovery: 0 retries" in out
    assert main(LAUNCH + ["--requests", "6", "--max-new", "24", "--num-pages", "12",
                          "--chaos", "--fault-seed", "1"]) == 0
    out = capsys.readouterr().out
    assert "completed 6/6" in out and "injected {" in out
    assert "'nan_injected': 1" in out
