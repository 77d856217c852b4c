"""The port's serving path against the JAX package's, on converted weights.

(c) ``prefill_chunk`` / ``decode_step`` logits of the smoke tinyllama in
fp32 through the paged pool; (d) the JAX ``BatchScheduler`` and the
port's on the same prompts give identical greedy tokens; (e) scheduler
invariants of the port: overlap on/off identity, pool exhaustion that
unwinds only the failing request; (f) the port and ``chip_smoke.py``
import neither JAX nor the JAX package.
"""

import functools
import pathlib
import re

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
from repro_torch.serve.serve import BatchScheduler, ServeConfig  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
F32 = dict(compute_dtype_name="float32", param_dtype_name="float32")
PAGE, CHUNK, BATCH, MAX_LEN, MAX_NEW = 4, 8, 2, 32, 6


@functools.cache
def _weights():
    """Smoke tinyllama in fp32: JAX params and the port's converted model."""
    cfg_j = smoke_j("tinyllama-1.1b").replace(**F32)
    params = init_j(TJ.model_params(cfg_j), jax.random.PRNGKey(0), jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = from_jax_params(tree, smoke_t("tinyllama-1.1b").replace(**F32), "cpu")
    return cfg_j, params, model


def _prompts(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(4, 512, size=int(L)).tolist()
            for L in rng.integers(3, 20, size=n)]


def _serve_port(prompts, **kw):
    _, _, model = _weights()
    sched = BatchScheduler(model, ServeConfig(
        max_len=MAX_LEN, batch=BATCH, prefill_chunk=CHUNK, page_size=PAGE, **kw))
    for rid, p in enumerate(prompts):
        sched.submit(p, request_id=rid, max_new=MAX_NEW)
    sched.drain()
    return sched


@functools.cache
def _jax_tokens():
    """The JAX scheduler's greedy tokens, built once per module."""
    from repro.launch.mesh import make_host_mesh
    from repro.serve.serve import BatchScheduler as SchedJ
    from repro.serve.serve import ServeConfig as ScfgJ

    cfg_j, params, _ = _weights()
    mesh = make_host_mesh()
    with mesh:
        sched = SchedJ(cfg_j, mesh, ScfgJ(
            max_len=MAX_LEN, batch=BATCH, prefill_chunk=CHUNK, paged=True,
            page_size=PAGE, overlap=True), params)
        for rid, p in enumerate(_prompts()):
            sched.submit(p, request_id=rid, max_new=MAX_NEW)
        sched.drain()
    assert sched.kv_cache_stats()["pages_in_use"] == 0
    return {r["id"]: list(r["generated"]) for r in sched.completed}


# ---------------------------------------------------------------------------
# (c) model: prefill_chunk and decode_step logits vs JAX
# ---------------------------------------------------------------------------


def test_prefill_chunk_and_decode_step_match_jax():
    cfg_j, params, model = _weights()
    B, P = 2, 12
    rng = np.random.default_rng(1)
    tbl = np.full((B, MAX_LEN // PAGE), -1, np.int32)
    tbl[0, :4] = [5, 0, 9, 2]
    tbl[1, :4] = [1, 7, 3, 11]
    caches_j = TJ.init_cache(cfg_j, B, MAX_LEN, paged=True, page_size=PAGE,
                             num_pages=P)
    caches_t = model.init_cache(B, MAX_LEN, page_size=PAGE, num_pages=P)
    tbl_j, tbl_t = jnp.asarray(tbl), torch.from_numpy(tbl)
    lengths = np.asarray([8, 6], np.int32)
    errs = []
    # two ragged prefill chunks (the second at all_logits), then decode
    for start, all_logits in ((np.asarray([0, 0], np.int32), False),
                              (lengths.copy(), True)):
        toks = rng.integers(4, 512, size=(B, CHUNK)).astype(np.int32)
        lj, caches_j = TJ.prefill_chunk(
            params, {"tokens": jnp.asarray(toks)}, cfg_j, caches_j,
            jnp.asarray(start), jnp.asarray(lengths), block_tables=tbl_j,
            all_logits=all_logits)
        lt = model.prefill_chunk(torch.from_numpy(toks), caches_t,
                                 torch.from_numpy(start), torch.from_numpy(lengths),
                                 tbl_t, all_logits=all_logits)
        if all_logits:  # positions past length hold garbage on both sides
            lj, lt = lj[:, :int(lengths.min())], lt[:, :int(lengths.min())]
        errs.append(np.abs(lt.numpy() - np.asarray(lj)).max())
    pos = 2 * lengths
    active = np.asarray([True, False])
    for _ in range(3):
        toks = rng.integers(4, 512, size=(B, 1)).astype(np.int32)
        lj, caches_j = TJ.decode_step(params, jnp.asarray(toks), jnp.asarray(pos),
                                      cfg_j, caches_j, active=jnp.asarray(active),
                                      block_tables=tbl_j)
        lt = model.decode_step(torch.from_numpy(toks), torch.from_numpy(pos),
                               caches_t, active=torch.from_numpy(active),
                               block_tables=tbl_t)
        errs.append(np.abs(lt.numpy() - np.asarray(lj)).max())
        pos = pos + active
        active = ~active
    assert max(errs) < 1e-4, errs
    for name, slot in caches_t.items():
        for k, pool in slot["attn"].items():
            # K/V entries reach ~10 (the init's fan-in quirk): relative too
            np.testing.assert_allclose(pool[:, :P].numpy(),
                                       np.asarray(caches_j[name]["attn"][k]),
                                       atol=1e-4, rtol=1e-4)


def test_float64_model_stays_float64_and_lands_near_fp32():
    """The float64 run ``chip_smoke.py`` holds both fp32 runs against: the
    same weights, with every plain version and RoPE accumulating in
    float64, not rounded through fp32 anywhere."""
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_reference
    from repro_torch.layers.attention import apply_rope
    from repro_torch.layers.common import tree_map
    from repro_torch.models.transformer import Transformer

    _, _, model = _weights()
    cfg64 = model.cfg.replace(param_dtype_name="float64", compute_dtype_name="float64")
    exact = Transformer(cfg64, tree_map(lambda t: t.double(), model.params()), "cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(4, 512, (1, CHUNK)))
    tbl = torch.arange(MAX_LEN // PAGE, dtype=torch.int32)[None]
    out = {}
    for name, m in (("fp32", model), ("float64", exact)):
        caches = m.init_cache(1, MAX_LEN, page_size=PAGE)
        lg = m.prefill_chunk(toks, caches, 0, CHUNK, tbl, all_logits=True)
        step = m.decode_step(toks[:, :1], torch.tensor([CHUNK]), caches, block_tables=tbl)
        out[name] = torch.cat([lg[0], step]).double()
        assert caches["slot0_attn"]["attn"]["k_pages"].dtype == m.cfg.compute_dtype
    assert exact.cfg.compute_dtype == torch.float64
    assert float((out["fp32"] - out["float64"]).abs().max()) < 1e-3

    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 5, 2, 8))
    s = rng.standard_normal(8)
    want = x / np.sqrt((x * x).mean(-1, keepdims=True) + 1e-6) * s
    got = rmsnorm_reference(torch.from_numpy(x), torch.from_numpy(s))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    pos = np.arange(15).reshape(3, 5) * 997
    ang = pos[..., None, None] / 10000.0 ** (np.arange(0, 8, 2) / 8)
    want = np.stack([x[..., 0::2] * np.cos(ang) - x[..., 1::2] * np.sin(ang),
                     x[..., 0::2] * np.sin(ang) + x[..., 1::2] * np.cos(ang)], -1)
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want.reshape(x.shape), rtol=0, atol=1e-9)


# ---------------------------------------------------------------------------
# (d) the slice: JAX scheduler vs the port's, token for token
# ---------------------------------------------------------------------------


def test_scheduler_tokens_identical_to_jax():
    want = _jax_tokens()
    sched = _serve_port(_prompts(), overlap=True)
    got = {r["id"]: r["generated"] for r in sched.completed}
    assert got == want
    assert all(len(t) == MAX_NEW for t in got.values())
    assert sched.stats["overlap_ticks"] > 0
    assert sched.stats["decode_after_prefill_ticks"] == 0
    assert sched.kv_cache_stats()["pages_in_use"] == 0


# ---------------------------------------------------------------------------
# (e) scheduler invariants
# ---------------------------------------------------------------------------


def test_overlap_on_and_off_give_identical_tokens():
    prompts = _prompts(5, seed=3)
    on = _serve_port(prompts, overlap=True)
    off = _serve_port(prompts, overlap=False)
    tok = lambda s: {r["id"]: r["generated"] for r in s.completed}
    assert tok(on) == tok(off)
    assert len(on.completed) == 5
    assert off.stats["decode_after_prefill_ticks"] > 0  # the baseline stalls


@pytest.mark.parametrize("overlap", [True, False])
def test_budget_of_one_token_returns_one_token(overlap):
    """Without overlap the prompt's last chunk and the tick's decode land
    before the flush; the retire trims to ``max_new`` (the JAX scheduler
    returns 2 tokens there; ROADMAP Queue 3)."""
    _, _, model = _weights()
    sched = BatchScheduler(model, ServeConfig(
        max_len=MAX_LEN, batch=BATCH, prefill_chunk=CHUNK, page_size=PAGE,
        overlap=overlap))
    sched.submit([5, 6, 7], request_id=0, max_new=1)
    sched.drain()
    assert [len(r["generated"]) for r in sched.completed] == [1]
    assert sched.kv_cache_stats()["pages_in_use"] == 0


def test_eos_retires_early_and_frees_pages():
    prompts = _prompts(3, seed=4)
    ref = _serve_port(prompts)
    first = {r["id"]: r["generated"] for r in ref.completed}
    eos = first[0][2]
    sched = _serve_port(prompts, eos_id=eos, eos_check_every=1)
    for r in sched.completed:
        full = first[r["id"]]
        cut = full.index(eos) + 1 if eos in full else len(full)
        assert r["generated"] == full[:cut]
    assert sched.kv_cache_stats()["pages_in_use"] == 0


def test_pool_exhaustion_raises_and_leaves_neighbours_intact():
    _, _, model = _weights()
    prompts = _prompts(2, seed=5)
    prompts = [prompts[0][:3] + [7] * 5, prompts[1][:3] + [9] * 5]  # 8 tokens each
    # "never": exhaustion unwinds and raises (the default preempts instead)
    sched = BatchScheduler(model, ServeConfig(
        max_len=MAX_LEN, batch=2, prefill_chunk=CHUNK, page_size=PAGE, num_pages=5,
        preempt_policy="never"))
    sched.submit(prompts[0], request_id="a", max_new=4)    # 11 positions, 3 pages
    sched.submit(prompts[1], request_id="b", max_new=12)   # 19 positions, 5 pages
    snap = None
    with pytest.raises(RuntimeError, match="exhausted"):
        for _ in range(64):
            slot_a = next((s for s in range(2) if sched.active[s] is not None
                           and sched.active[s]["id"] == "a"), None)
            if slot_a is not None:
                pages = list(sched._slot_pages[slot_a])
                snap = (slot_a, pages, sched._tables[slot_a].copy(),
                        {n: c["attn"]["k_pages"][:, pages].clone()
                         for n, c in sched.caches.items()})
            sched.step()
    assert snap is not None
    failed = [r["id"] for r in sched.failed]
    assert failed == ["b"]
    slot_a, pages, row, kv = snap
    assert sched._slot_pages[slot_a] == pages
    np.testing.assert_array_equal(sched._tables[slot_a], row)
    for n, c in sched.caches.items():
        assert torch.equal(c["attn"]["k_pages"][:, pages], kv[n])
    assert sched._alloc.used == len(pages)
    sched.drain()
    alone = _serve_port([prompts[0]])
    got = {r["id"]: r["generated"] for r in sched.completed}
    assert got["a"][:4] == alone.completed[0]["generated"][:4]
    assert sched.kv_cache_stats()["pages_in_use"] == 0


def test_submit_rejects_requests_that_cannot_fit():
    _, _, model = _weights()
    sched = BatchScheduler(model, ServeConfig(max_len=16, batch=1, page_size=4,
                                              num_pages=2))
    with pytest.raises(ValueError, match="max_len"):
        sched.submit(list(range(4, 14)), request_id=0, max_new=8)
    with pytest.raises(ValueError, match="pool"):
        sched.submit(list(range(4, 12)), request_id=1, max_new=4)
    with pytest.raises(ValueError, match="max_new"):
        sched.submit([5], request_id=2, max_new=0)


def test_launcher_runs_on_cpu(capsys):
    from repro_torch.launch.serve import main

    assert main(["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu",
                 "--requests", "3", "--max-new", "3", "--batch", "2",
                 "--max-len", "32", "--prefill-chunk", "8"]) == 0
    out = capsys.readouterr().out
    assert "completed 3/3" in out and "paged KV" in out and "rmsnorm 0" in out


# ---------------------------------------------------------------------------
# (f) the port imports no JAX
# ---------------------------------------------------------------------------

_FORBIDDEN = re.compile(
    r"^\s*(?:import\s+jax\b|from\s+jax\b|import\s+repro[.\s]|from\s+repro[.\s])",
    re.MULTILINE,
)


def test_port_and_chip_smoke_import_no_jax():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", *sorted((ROOT / "tools").glob("*.py"))]
    files += sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(files) > 10
    offenders = [str(p.relative_to(ROOT)) for p in files
                 if _FORBIDDEN.search(p.read_text())]
    assert not offenders, f"JAX or the JAX package imported by: {offenders}"


def test_port_and_chip_smoke_name_no_triton():
    """Every kernel of the port is CUDA C++ bound through ``ctypes``: no
    source of the package (Python or CUDA), not ``chip_smoke.py`` and no
    example of the port names Triton, let alone imports it."""
    pkg = ROOT / "src" / "repro_torch"
    files = sorted(pkg.rglob("*.py")) + sorted(pkg.rglob("*.cu")) + [ROOT / "chip_smoke.py"]
    files += sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(files) > 10
    offenders = [str(p.relative_to(ROOT)) for p in files
                 if re.search(r"triton", p.read_text(), re.IGNORECASE)]
    assert not offenders, f"Triton named in: {offenders}"
