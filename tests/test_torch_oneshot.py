"""The one-shot serving steps and the shape-only helpers of the dry run,
against the JAX package, in one process on the CPU.

* ``configs.shapes`` (``tests/test_dryrun_unit.py``'s cell, skip-rule,
  cell-count and vocab-padding tests mirrored, and the shapes and rules
  equal to JAX's for every arch), ``data.pipeline.batch_specs`` (keys,
  shapes and dtypes equal to JAX's ``ShapeDtypeStruct``s),
  ``layers.common.abstract_params`` (every leaf's shape and dtype equal
  to JAX's for all ten archs, nothing allocated),
  ``StepProfile.roofline_terms`` (JAX's dict on the same counters under
  each of the three ``ChipSpec``s);
* ``make_prefill_step``, ``make_decode_step`` and ``make_encoder_step``
  against JAX's (the pattern of ``tests/test_serve.py``'s prefill and
  decode tests) for each family at smoke size in fp32: dense, gemma2's
  window (cut to 8) and softcaps, MoE, zamba2 and xlstm (their stacked
  leaves drawn at their per-layer fan-in: JAX's draw is chaotic for them
  in fp32, ROADMAP Queue 3), llava's frontend, hubert's encoder. Tokens
  equal; logits within ``TOL`` (2e-5) of the largest |value| of JAX's,
  except at the one step named in ``WITNESSED`` (llava's fourth decode
  step, where JAX's own fp32 logits lie 2.3e-5 of the largest |value|
  from JAX's float64 run): there the port's logits are no further from
  JAX's float64 run than JAX's fp32 logits are (the port's lie 3.9e-6
  from it); each cache leaf within ``CACHE_TOL`` (1e-4) of its largest
  |value| (the dense leaves without the port's spare row; xlstm's sLSTM
  cell state after five steps lies 2.0e-5 of its largest value from
  JAX's);
* the one-shot prefill against ``prefill_chunk`` in chunks; a mesh
  without a process group running the whole step;
* the encoder-only model's refusals.

The cache placements and the LSE combine are in
``tests/test_torch_oneshot_mesh.py``.
"""

import contextlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SHAPE_BY_NAME as SHAPE_BY_NAME_J  # noqa: E402
from repro.configs import SHAPES as SHAPES_J  # noqa: E402
from repro.configs import effective_mode as effective_mode_j  # noqa: E402
from repro.configs import get_config as get_j  # noqa: E402
from repro.configs import skip_reason as skip_reason_j  # noqa: E402
from repro.configs import smoke_config as smoke_j  # noqa: E402
from repro.layers.common import abstract_params as abstract_j  # noqa: E402
from repro.layers.common import init_params as init_j  # noqa: E402
from repro.models import transformer as TJ  # noqa: E402
from repro.serve import serve as SJ  # noqa: E402
from repro_torch.configs import SHAPE_BY_NAME, SHAPES, effective_mode, get_config  # noqa: E402
from repro_torch.configs import list_archs, skip_reason  # noqa: E402
from repro_torch.configs import smoke_config as smoke_t  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.data.pipeline import batch_specs  # noqa: E402
from repro_torch.layers.common import abstract_params, tree_leaves  # noqa: E402
from repro_torch.models.transformer import model_params  # noqa: E402
from repro_torch.serve.serve import (  # noqa: E402
    make_decode_step,
    make_encoder_step,
    make_prefill_step,
)

ARCHS = list_archs()
F32 = dict(compute_dtype_name="float32", param_dtype_name="float32")
TOL = 2e-5
CACHE_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _free_jax_executables():
    """The JAX references here run eagerly, op by op, and every operator
    compiled maps its code into the process: about 2,600 mappings an arch.
    They are freed when the module ends, so that a later module in the
    same test worker stays under the kernel's limit of mappings a process
    (``vm.max_map_count``, 65,530 by default), past which XLA's compiler
    segfaults."""
    yield
    jax.clear_caches()


# ---------------------------------------------------------------------------
# configs.shapes, batch_specs (tests/test_dryrun_unit.py mirrored)
# ---------------------------------------------------------------------------


def test_40_cells_defined():
    assert len(list_archs()) == 10
    assert len(SHAPES) == 4
    assert [tuple(vars(s).values()) for s in SHAPES] == [tuple(vars(s).values())
                                                         for s in SHAPES_J]
    assert set(SHAPE_BY_NAME) == set(SHAPE_BY_NAME_J)


def test_skip_rules():
    enc = get_config("hubert-xlarge")
    assert skip_reason(enc, SHAPE_BY_NAME["decode_32k"]) is not None
    assert skip_reason(enc, SHAPE_BY_NAME["long_500k"]) is not None
    assert skip_reason(enc, SHAPE_BY_NAME["train_4k"]) is None
    assert effective_mode(enc, SHAPE_BY_NAME["prefill_32k"]) == "encoder"
    dense = get_config("tinyllama-1.1b")
    assert "full-attention" in skip_reason(dense, SHAPE_BY_NAME["long_500k"])
    for arch in ("zamba2-2.7b", "xlstm-350m"):
        assert skip_reason(get_config(arch), SHAPE_BY_NAME["long_500k"]) is None
    for arch in ARCHS:
        for s, sj in zip(SHAPES, SHAPES_J):
            assert skip_reason(get_config(arch), s) == skip_reason_j(get_j(arch), sj)
            assert effective_mode(get_config(arch), s) == effective_mode_j(get_j(arch), sj)


def test_expected_cell_counts():
    """40 cells: 10 train + 10 prefill + 9 decode (hubert out) + 2 long."""
    runnable = sum(skip_reason(get_config(a), s) is None for a in ARCHS for s in SHAPES)
    assert runnable == 31
    assert len(ARCHS) * len(SHAPES) - runnable == 9


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "hubert-xlarge", "llava-next-mistral-7b"])
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_batch_specs_cover_every_model_input(arch, mode):
    from repro.data.pipeline import batch_specs as batch_specs_j

    shape = SHAPE_BY_NAME["train_4k"]
    specs = batch_specs(get_config(arch), shape, mode)
    want = batch_specs_j(get_j(arch), SHAPE_BY_NAME_J["train_4k"], mode)
    assert list(specs) == list(want)
    for k, t in specs.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[k].shape), k
        assert str(t.dtype).split(".")[-1] == str(want[k].dtype), k
    if mode == "train":
        assert tuple(specs["labels"].shape) == (1, shape.global_batch, shape.seq_len)
        if "tokens" in specs and "frontend" in specs:
            assert specs["frontend"].shape[2] + specs["tokens"].shape[2] == shape.seq_len
    if mode == "decode":
        assert tuple(specs["tokens"].shape) == (shape.global_batch, 1)


def test_vocab_padding_divisible_by_256():
    for arch in ARCHS:
        cfg = get_config(arch)
        assert cfg.vocab_padded % 256 == 0
        assert cfg.vocab_padded >= cfg.vocab


# ---------------------------------------------------------------------------
# abstract_params, roofline_terms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_are_the_jax_shapes_and_dtypes(arch):
    cfg_t, cfg_j = get_config(arch), get_j(arch)
    got = dict(tree_leaves(abstract_params(model_params(cfg_t), cfg_t.param_dtype)))
    want = jax.tree_util.tree_flatten_with_path(
        abstract_j(TJ.model_params(cfg_j), cfg_j.param_dtype))[0]
    want = {"/".join(str(k.key) for k in path): leaf for path, leaf in want}
    assert set(got) == set(want)
    for p, t in got.items():
        assert t.device.type == "meta", p
        assert tuple(t.shape) == tuple(want[p].shape), p
        assert str(t.dtype).split(".")[-1] == str(want[p].dtype), p


def _jax_spec(spec_t):
    from repro.core.hardware import ChipSpec as ChipSpecJ

    return ChipSpecJ(**{f: getattr(spec_t, f) for f in ChipSpecJ.__dataclass_fields__})


@pytest.mark.parametrize("target", ["h100_sxm", "tpu_v5e", "tpu_v5p"])
@pytest.mark.parametrize("counters", [
    dict(num_devices=1, flops=3.1e14, hbm_bytes=2.2e11, model_flops=2.9e14),
    dict(num_devices=256, flops=8.0e17, hbm_bytes=4.0e15, collective_bytes_ici=3.0e13,
         collective_bytes_dcn=2.0e12, model_flops=6.1e17, model_bytes=1.9e15),
    dict(num_devices=4, flops=1.0e9, hbm_bytes=8.0e12, model_bytes=5.0e12),
], ids=["compute", "mesh", "memory"])
def test_roofline_terms_are_the_jax_dict(target, counters):
    from repro.core.profile import StepProfile as StepProfileJ
    from repro_torch.core.hardware import TARGETS
    from repro_torch.core.profile import StepProfile

    spec = TARGETS[target]
    got = StepProfile(**counters).roofline_terms(spec)
    want = StepProfileJ(**counters).roofline_terms(_jax_spec(spec))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == (v if isinstance(v, str) else pytest.approx(v, rel=1e-12)), k
    if target == "h100_sxm":  # the port's default target
        assert StepProfile(**counters).roofline_terms() == got


# ---------------------------------------------------------------------------
# the steps against JAX's
# ---------------------------------------------------------------------------

FAN_IN = ("zamba2-2.7b", "xlstm-350m")
EXTRA = {"gemma2-2b": dict(window=8)}
FAMILIES = ["tinyllama-1.1b", "gemma2-2b", "qwen3-moe-30b-a3b", "zamba2-2.7b", "xlstm-350m",
            "llava-next-mistral-7b"]
B, S, MAX_LEN, STEPS = 2, 16, 32, 4


def _cfgs(arch):
    kw = dict(F32, **EXTRA.get(arch, {}))
    return smoke_j(arch).replace(**kw), smoke_t(arch).replace(**kw)


def _np_params(arch):
    """JAX's fp32 draw as numpy; for ``FAN_IN`` every stacked leaf drawn at
    the default scale rescaled to its per-layer fan-in."""
    cfg_j, cfg_t = _cfgs(arch)
    tree = jax.tree_util.tree_map(np.asarray, init_j(TJ.model_params(cfg_j),
                                                     jax.random.PRNGKey(0), cfg_j.param_dtype))
    if arch in FAN_IN:
        specs = dict(tree_leaves(model_params(cfg_t)))

        def walk(t, prefix=""):
            for k, v in t.items():
                p = f"{prefix}/{k}" if prefix else k
                if isinstance(v, dict):
                    walk(v, p)
                elif p.startswith("slots/") and specs[p].init == "normal" and \
                        specs[p].scale is None:
                    t[k] = (v * math.sqrt(specs[p].shape[0] / specs[p].shape[1])).astype(
                        v.dtype)
        walk(tree)
    return tree


def _batch(cfg, rng):
    if cfg.frontend == "audio":
        return {"frontend": rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)}
    if cfg.frontend == "vlm":
        nf = cfg.n_frontend_tokens
        return {"frontend": (0.02 * rng.standard_normal((B, nf, cfg.d_model))).astype(np.float32),
                "tokens": rng.integers(4, cfg.vocab, (B, S - nf)).astype(np.int32)}
    return {"tokens": rng.integers(4, cfg.vocab, (B, S)).astype(np.int32)}


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (what, err, np.abs(want).max())


WITNESSED = {("llava-next-mistral-7b", "decode 3")}


def _close_or_witness(arch, what, got, want, exact):
    """``_close`` against JAX's fp32 logits ``want``; at a step named in
    ``WITNESSED`` (and there only), where ``got`` lies further than TOL
    from them, ``got`` no further from JAX's float64 run ``exact`` than
    ``want`` is."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if (arch, what) not in WITNESSED or np.abs(got - want).max() <= TOL * max(
            1.0, np.abs(want).max()):
        _close(got, want, what)
        return
    exact = np.asarray(exact, np.float64)
    assert np.abs(got - exact).max() <= np.abs(want - exact).max(), (
        what, np.abs(got - want).max(), np.abs(got - exact).max(), np.abs(want - exact).max())


@contextlib.contextmanager
def _jax_float64(monkeypatch):
    """JAX in float64 throughout, a witness independent of the port: x64 on,
    and the model's fp32 upcasts (``astype(jnp.float32)`` in its norms,
    RoPE and attention) made float64 for the duration."""
    with monkeypatch.context() as m, jax.enable_x64(True):
        m.setattr(jnp, "float32", jnp.float64)
        yield


def _as64(batch: dict) -> dict:
    return {k: jnp.asarray(v.astype(np.float64) if v.dtype == np.float32 else v)
            for k, v in batch.items()}


def _recorded(model) -> list:
    """The logits that ``model``'s ``prefill``, ``decode_step`` and
    ``apply_logits`` return from here on, in order, as the serving steps
    call them (one rank: the whole logits)."""
    seen = []
    for name in ("prefill", "decode_step", "apply_logits"):
        def rec(*a, _fn=getattr(model, name), **k):
            out = _fn(*a, **k)
            seen.append(out[0] if isinstance(out, tuple) else out)
            return out
        setattr(model, name, rec)
    return seen


def _assert_caches(caches_t, caches_j):
    want = {"/".join(str(k.key) for k in path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(caches_j)[0]}
    got = dict(tree_leaves(caches_t))
    assert set(got) == set(want)
    for p, t in got.items():
        t = t[:, :B] if p.endswith(("/k", "/v")) else t  # the spare row
        _close(t.numpy(), want[p], p, CACHE_TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_steps_match_jax(arch, monkeypatch):
    """A B 2 x S 16 one-shot prefill into a dense cache of 32 positions,
    then 4 decode steps fed the same tokens on both sides: tokens equal,
    logits within TOL of the largest |value| (at a ``WITNESSED`` step, or
    no further from JAX's float64 run than JAX's fp32 run is), every cache
    leaf within CACHE_TOL of its largest |value|; JAX's
    ``make_prefill_step`` and ``make_decode_step`` give the same tokens as
    its ``prefill`` and ``decode_step``."""
    from repro.launch.mesh import make_host_mesh as host_mesh_j

    cfg_j, cfg_t = _cfgs(arch)
    tree = _np_params(arch)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    model = from_jax_params(tree, cfg_t, "cpu")
    rng = np.random.default_rng(7)
    batch = _batch(cfg_j, rng)
    mesh = host_mesh_j()
    with mesh:
        caches_j = TJ.init_cache(cfg_j, B, MAX_LEN)
        tok_j, _ = SJ.make_prefill_step(cfg_j, mesh)(
            params, {k: jnp.asarray(v) for k, v in batch.items()}, caches_j)
        lj, caches_j = TJ.prefill(params, {k: jnp.asarray(v) for k, v in batch.items()}, cfg_j,
                                  caches_j)
    np.testing.assert_array_equal(np.asarray(tok_j), np.argmax(np.asarray(lj), -1))
    witness = any(a == arch for a, _ in WITNESSED)
    l64 = None
    if witness:  # JAX's float64 run beside its fp32 one
        cfg64 = cfg_j.replace(compute_dtype_name="float64", param_dtype_name="float64")
        with _jax_float64(monkeypatch), mesh:
            p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)), tree)
            caches64 = TJ.init_cache(cfg64, B, MAX_LEN)
            l64, caches64 = TJ.prefill(p64, _as64(batch), cfg64, caches64)
    seen = _recorded(model)
    caches_t = model.init_cache(B, MAX_LEN, paged=False)
    tok_t, caches_t = make_prefill_step(model)(
        {k: torch.from_numpy(v) for k, v in batch.items()}, caches_t)
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
    assert tok_t.dtype == torch.int32
    _close_or_witness(arch, "prefill logits", seen.pop().numpy(), lj, l64)
    _assert_caches(caches_t, caches_j)
    decode_t = make_decode_step(model)
    decode_j = SJ.make_decode_step(cfg_j, mesh)
    pos = S
    for i in range(STEPS):
        toks = rng.integers(4, cfg_j.vocab, (B, 1)).astype(np.int32)
        # per-slot positions on every other step, a shared one between
        p = np.full((B,), pos, np.int32) if i % 2 else np.int32(pos)
        with mesh:
            nj, _ = decode_j(params, jnp.asarray(toks), jnp.asarray(p), caches_j)
            lj, caches_j = TJ.decode_step(params, jnp.asarray(toks), jnp.asarray(p), cfg_j,
                                          caches_j)
        if witness:
            with _jax_float64(monkeypatch), mesh:
                l64, caches64 = TJ.decode_step(p64, jnp.asarray(toks), jnp.asarray(p), cfg64,
                                               caches64)
        nt, caches_t = decode_t(torch.from_numpy(toks), torch.from_numpy(np.asarray(p)),
                                caches_t)
        assert tuple(nt.shape) == (B, 1)
        np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
        _close_or_witness(arch, f"decode {i}", seen.pop().numpy(), lj, l64)
        pos += 1
    _assert_caches(caches_t, caches_j)


def test_encoder_step_matches_jax():
    """hubert's frames (B 2 x S 16): ``make_encoder_step``'s tokens (B, S)
    equal JAX's, its logits within TOL of the largest |value|."""
    from repro.launch.mesh import make_host_mesh as host_mesh_j

    arch = "hubert-xlarge"
    cfg_j, cfg_t = _cfgs(arch)
    tree = _np_params(arch)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    model = from_jax_params(tree, cfg_t, "cpu")
    batch = _batch(cfg_j, np.random.default_rng(8))
    mesh = host_mesh_j()
    with mesh:
        tok_j = SJ.make_encoder_step(cfg_j, mesh)(params, {"frontend": jnp.asarray(
            batch["frontend"])})
        lj, _ = TJ.apply_logits(params, {"frontend": jnp.asarray(batch["frontend"])}, cfg_j)
    seen = _recorded(model)
    tok_t = make_encoder_step(model)({"frontend": torch.from_numpy(batch["frontend"])})
    lt = seen.pop()
    assert tuple(tok_t.shape) == (B, S) and tok_t.dtype == torch.int32
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
    _close(lt.numpy(), lj, "encoder logits")


def test_encoder_only_model_refuses_prefill_and_decode_steps():
    _, cfg_t = _cfgs("hubert-xlarge")
    model = from_jax_params(_np_params("hubert-xlarge"), cfg_t, "cpu")
    for make in (make_prefill_step, make_decode_step):
        with pytest.raises(NotImplementedError, match="encoder-only"):
            make(model)
    with pytest.raises(NotImplementedError, match="encoder-only"):
        model.prefill({"frontend": torch.zeros((1, 4, cfg_t.d_model))}, {})


@pytest.mark.parametrize("arch,chunk", [("tinyllama-1.1b", 8), ("gemma2-2b", 8),
                                        ("zamba2-2.7b", 16), ("xlstm-350m", 16)])
def test_one_shot_prefill_equals_prefill_chunk_in_chunks(arch, chunk):
    """The port's one-shot prefill of 32 tokens against ``prefill_chunk`` in
    chunks of the same prompt into a second dense cache (a recurrent
    chunk must tile the recurrences' own): the last logits within TOL and
    every cache leaf within CACHE_TOL of their largest |value|, then a
    decode step from each within TOL."""
    _, cfg_t = _cfgs(arch)
    model = from_jax_params(_np_params(arch), cfg_t, "cpu")
    toks = torch.from_numpy(np.random.default_rng(9).integers(4, cfg_t.vocab, (B, 32))
                            .astype(np.int32))
    one = model.init_cache(B, 40, paged=False)
    lo = model.prefill({"tokens": toks}, one)
    ref = model.init_cache(B, 40, paged=False)
    for c0 in range(0, 32, chunk):
        lr = model.prefill_chunk(toks[:, c0:c0 + chunk], ref, c0, chunk)
    _close(lo.numpy(), lr.numpy(), "last logits")
    for (p, a), (_, b) in zip(tree_leaves(one), tree_leaves(ref)):
        _close(a.numpy(), b.numpy(), p, CACHE_TOL)
    nxt = torch.argmax(lo, -1, keepdim=True).to(torch.int32)
    _close(model.decode_step(nxt, 32, one).numpy(), model.decode_step(nxt, 32, ref).numpy(),
           "decode")


def test_a_mesh_without_a_process_group_runs_the_whole_step():
    """The production mesh (16 x 16, shape only) and a 1 x 1 host mesh hold
    no ranks: the steps given them run the whole step, bitwise the steps
    given no mesh."""
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

    _, cfg_t = _cfgs("tinyllama-1.1b")
    model = from_jax_params(_np_params("tinyllama-1.1b"), cfg_t, "cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(4, cfg_t.vocab, (B, S))
                            .astype(np.int32))
    runs = []
    seen = _recorded(model)
    for mesh in (None, make_production_mesh(), make_host_mesh(device="cpu")):
        caches = model.init_cache(B, MAX_LEN, paged=False)
        tok, caches = make_prefill_step(model, mesh)({"tokens": toks}, caches)
        nxt, caches = make_decode_step(model, mesh)(tok[:, None], S, caches)
        runs.append((tok, nxt, *seen))
        seen.clear()
    for run in runs[1:]:
        for a, b in zip(run, runs[0]):
            assert torch.equal(a, b)


def test_prefill_refuses_the_paged_layout():
    _, cfg_t = _cfgs("tinyllama-1.1b")
    model = from_jax_params(_np_params("tinyllama-1.1b"), cfg_t, "cpu")
    with pytest.raises(ValueError, match="dense"):
        model.prefill({"tokens": torch.zeros((1, 4), dtype=torch.int32)},
                      model.init_cache(1, 16))
