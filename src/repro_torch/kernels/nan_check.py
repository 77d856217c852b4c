"""What the attention kernels do with a NaN in the KV cache.

The serving recovery layer relies on the finiteness sentinel: a NaN that a
query row can see (a NaN page the fault injector wrote, a NaN key row)
must make that row non-finite, and every other row must come out as in
the clean call. ``check(kind, dtype, device)`` plants NaNs into the
inputs of one kernel at its serving shape and reads both, for the
wrapper (the kernel on a CUDA tensor, the plain version on the CPU) and
for the plain version:

  ``flash_decode``   K2 at the dense decode shape (``cases.MAIN_FLASH_DECODE``):
                     a NaN key and value row of batch row 1 at position 50
  ``flash_chunk``    K2 at the dense chunk shape (``cases.MAIN_FLASH_CHUNK``):
                     a NaN key at position 224, seen by the queries at 224..255
  ``paged_decode``   K3 at ``cases.MAIN_PAGED``: a NaN page of batch row 1
  ``paged_prefill``  K4 at ``cases.MAIN_PREFILL``: a NaN key at position
                     220, seen by the queries at 220..255

``past_len`` plants a NaN key and value where no row may look: past
``kv_len`` in a tile the kernels skip (K2), or in pool page 0 when no
table names it (K3, K4). The plain versions multiply masked
probabilities (0) by V, so 0 * NaN reaches their output; the kernels do
not read what they skip. This is the divergence ROADMAP.md Queue 3 logs.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cases

KINDS = ("flash_decode", "flash_chunk", "paged_decode", "paged_prefill")
_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _flash(kind, dtype, device):
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention.ref import flash_attention_reference

    case = cases.MAIN_FLASH_DECODE if kind == "flash_decode" else cases.MAIN_FLASH_CHUNK
    B, Sq, Sk, Hq, Hkv, D, causal, win, cap, off, kvl = case
    c = cases.flash_case(B, Sq, Sk, Hq, Hkv, D, seed=61, q_offset=off, kv_len=kvl)
    q, k, v = (torch.from_numpy(c[n]).to(device, _DT[dtype]) for n in ("q", "k", "v"))
    kw = dict(q_positions=torch.from_numpy(c["q_positions"]).to(device),
              k_positions=torch.from_numpy(c["k_positions"]).to(device),
              kv_len=torch.from_numpy(c["kv_len"]).to(device), causal=causal, window=win,
              softcap=cap)
    if kind == "flash_decode":
        # a corrupted cache row of slot 1, and one of slot 0 past its length
        seen, unseen = (slice(1, 2), slice(None)), ([0, 2, 3], slice(None))
        plant = [("k", 1, 50), ("v", 1, 50)]
        past = [("k", 0, 400), ("v", 0, 400)]
    else:
        seen, unseen = (0, slice(32, None)), (0, slice(0, 32))
        plant = [("k", 0, 224)]
        past = [("k", 0, 400), ("v", 0, 400)]

    def run(fn, edits):
        t = {"q": q, "k": k.clone(), "v": v.clone()}
        for name, b, pos in edits:
            t[name][b, pos] = float("nan")
        with torch.no_grad():
            return fn(t["q"], t["k"], t["v"], **kw)

    return run, FA.flash_attention, flash_attention_reference, plant, past, seen, unseen


def _paged(kind, dtype, device):
    from repro_torch.kernels.paged_attention import ops as PA
    from repro_torch.kernels.paged_attention import ref as PR

    if kind == "paged_decode":
        B, Hq, Hkv, D, ps, nL, P, lens, win, cap = cases.MAIN_PAGED
        c = cases.paged_case(B, Hq, Hkv, D, ps, nL, P, lens, seed=62)
        kw = dict(q_position=torch.from_numpy(c["q_position"]).to(device),
                  cache_len=torch.from_numpy(c["cache_len"]).to(device), window=win,
                  softcap=cap)
        fn, ref = PA.paged_attention, PR.paged_attention_reference
    else:
        B, C, Hq, Hkv, D, ps, nL, P, starts, win, cap, lengths = cases.prefill_row(
            cases.MAIN_PREFILL)
        c = cases.prefill_case(B, C, Hq, Hkv, D, ps, nL, P, starts, seed=63, lengths=lengths)
        kw = dict(q_positions=torch.from_numpy(c["q_positions"]).to(device),
                  cache_len=torch.from_numpy(c["cache_len"]).to(device), causal=True,
                  window=win, softcap=cap)
        fn, ref = PA.paged_prefill_attention, PR.paged_prefill_attention_reference
    tbl = c["block_tables"].copy()
    # page 0 named by no table: the plain versions read it for every
    # unallocated (-1) entry, the kernels never
    free = sorted(set(range(P)) - set(tbl[tbl >= 0].tolist()))[0]
    for name in ("k_pages", "v_pages"):
        c[name][free] = c[name][0]
    tbl[tbl == 0] = free
    kp, vp = (torch.from_numpy(c[n]).to(device, _DT[dtype]) for n in ("k_pages", "v_pages"))
    tb = torch.from_numpy(tbl).to(device)
    if kind == "paged_decode":
        page = int(tbl[1, 2])  # slot 1's positions 32..47, below its length
        plant = [(n, page, slice(None)) for n in ("k", "v")]
        seen, unseen = (slice(1, 2), slice(None)), ([0, 2, 3], slice(None))
    else:
        page = int(tbl[0, 220 // ps])
        plant = [("k", page, 220 % ps)]
        seen, unseen = (0, slice(28, None)), (0, slice(0, 28))
    past = [(n, 0, slice(None)) for n in ("k", "v")]

    def run(f, edits):
        t = {"k": kp.clone(), "v": vp.clone()}
        for name, pg, rows in edits:
            t[name][pg, rows] = float("nan")
        with torch.no_grad():
            q = torch.from_numpy(c["q"]).to(device, _DT[dtype])
            return f(q, t["k"], t["v"], tb, **kw)

    return run, fn, ref, plant, past, seen, unseen


def check(kind: str, dtype: str, device) -> dict:
    """Plant and read. Returns, for the wrapper (``kernel``) and the plain
    version (``plain``): ``seen_nonfinite`` (every value of the rows that
    see the NaN is non-finite), ``unseen_equal`` (the other rows equal the
    clean call bitwise), and ``past_len_finite`` (a NaN where no row may
    look leaves every row finite and equal to the clean call)."""
    setup = _flash if kind.startswith("flash") else _paged
    run, fn, ref, plant, past, seen, unseen = setup(kind, dtype, torch.device(device))
    out = {}
    for name, f in (("kernel", fn), ("plain", ref)):
        clean, bad, far = run(f, []), run(f, plant), run(f, past)
        out[name] = {
            "seen_nonfinite": bool((~torch.isfinite(bad[seen])).all()),
            "unseen_equal": bool(torch.equal(bad[unseen], clean[unseen])),
            "past_len_finite": bool(torch.isfinite(far).all() and torch.equal(far, clean)),
        }
    return out
