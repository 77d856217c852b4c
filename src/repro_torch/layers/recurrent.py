"""Recurrent sequence mixers (``repro.layers.recurrent``): Mamba2 (SSD) and
xLSTM (mLSTM, sLSTM), with their parameter trees declared leaf for leaf as
the JAX package declares them.

Each block has the JAX package's two forms: the chunkwise-parallel form
(quadratic within a chunk, linear across chunks; a Python loop over the
chunks takes the place of the ``scan``) for training and prefill, and a
single-token recurrent form for a decode step with a cache. Plain torch
ops throughout; the norms go through ``layers.norms.rmsnorm``, so on the
card they launch the RMSNorm kernel. Where the JAX package computes in
float32, the port computes in ``promote_types(dtype, float32)``, so a
float64 model (a CPU reference) runs in float64 throughout.

A block takes ``cache`` (the state rows of its batch, or None) and
``seq_mask`` (B,S) and returns ``(out, new_state)``: the caller writes the
state back. Masked positions advance no state: mamba2 zeroes ``dt`` and
the conv carry ends at each row's own valid end; mLSTM gives them input
gate -1e30 and forget gate 0; sLSTM selects the old carry. A row with no
valid position (an idle slot) keeps its state bitwise: the single-step
forms select it explicitly, as the JAX package does, and so does the
chunked mLSTM, where the JAX package lets such a row's ``C`` and ``n``
take up the masked inputs while ``m`` stays at -1e30 (they are scaled by
``exp(-1e30 - m')``, 0, at the row's next valid input, so no output
differs).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.layers.common import ParamSpec
from repro_torch.layers.norms import rmsnorm

# the xLSTM stabilizer's initial value in a cache, as in the JAX package
M_INIT = -1e30


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., L). Returns (..., L, L) with out[i,j] = sum_{k=j+1..i} x_k
    for i >= j, -inf otherwise (the log-space causal decay matrix)."""
    L = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, float("-inf"))


def causal_conv1d(x, w, b=None, state=None, valid_len=None):
    """Depthwise causal conv. x: (B,S,C), w: (K,C). ``state``: (B,K-1,C)
    carry; returns (y, new_state). ``valid_len`` (B,): valid leading
    positions per row; the carried-out state then ends at each row's own
    valid end (0 keeps the incoming state)."""
    K = w.shape[0]
    S = x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + S, :] * w[i][None, None, :] for i in range(K))
    if b is not None:
        y = y + b[None, None, :]
    if K <= 1:
        return y, None
    if valid_len is None:
        new_state = xp[:, -(K - 1):, :]
    else:
        idx = valid_len.to(torch.long)[:, None] + torch.arange(K - 1, device=x.device)[None, :]
        new_state = torch.gather(xp, 1, idx[:, :, None].expand(-1, -1, xp.shape[-1]))
    return y, new_state


# ===========================================================================
# Mamba2 / SSD
# ===========================================================================


def mamba2_params(cfg) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_inner = s.d_inner(d)
    h = s.n_heads(d)
    conv_ch = d_inner + 2 * s.n_groups * s.d_state
    return {
        "in_proj": ParamSpec((d, 2 * d_inner + 2 * s.n_groups * s.d_state + h),
                             ("embed", "inner_all")),
        "conv_w": ParamSpec((s.d_conv, conv_ch), (None, "inner"), scale=0.5),
        "conv_b": ParamSpec((conv_ch,), ("inner",), init="zeros"),
        "A_log": ParamSpec((h,), ("ssm_heads",), init="ones"),
        "D": ParamSpec((h,), ("ssm_heads",), init="ones"),
        "dt_bias": ParamSpec((h,), ("ssm_heads",), init="zeros"),
        "norm": ParamSpec((d_inner,), ("inner",), init="ones"),
        "out_proj": ParamSpec(
            (d_inner, d), ("inner", "embed_out"),
            scale=1.0 / (math.sqrt(d_inner) * math.sqrt(2 * cfg.n_layers))),
    }


def _ssd_chunked(x, dt, A, B, C, chunk, init_state=None):
    """SSD chunkwise scan. x: (b,s,h,p); dt: (b,s,h); A: (h,) negative;
    B, C: (b,s,g,n). Returns (y (b,s,h,p), final state (b,h,p,n))."""
    b, s, h, p = x.shape
    g, n = B.shape[-2], B.shape[-1]
    rep = h // g
    L = min(chunk, s)
    nc = s // L
    assert nc * L == s, (s, L)

    xc = x.reshape(b, nc, L, h, p)
    dtc = dt.reshape(b, nc, L, h)
    Bc = B.reshape(b, nc, L, g, n).repeat_interleave(rep, dim=3)   # (b,nc,L,h,n)
    Cc = C.reshape(b, nc, L, g, n).repeat_interleave(rep, dim=3)

    dA = dtc * A[None, None, None, :]             # (b,nc,L,h) log decay
    dA_cs = torch.cumsum(dA, dim=2)

    # intra-chunk (quadratic in L)
    Lmat = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))              # (b,nc,h,L,L)
    scores = torch.einsum("bclhn,bcjhn->bchlj", Cc, Bc) * Lmat
    scores = scores * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_intra = torch.einsum("bchlj,bcjhp->bclhp", scores, xc)

    # per-chunk summary state: S_c = sum_j exp(dA_end - dA_j) dt_j B_j x_j
    decay_to_end = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)          # (b,nc,L,h)
    wB = (decay_to_end * dtc)[..., None] * Bc                       # (b,nc,L,h,n)
    S_chunk = torch.einsum("bcjhn,bcjhp->bchpn", wB, xc)
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])                     # (b,nc,h)

    acc = _acc(x.dtype)
    state = (init_state.to(acc) if init_state is not None
             else torch.zeros((b, h, p, n), dtype=acc, device=x.device))
    y_prev = []
    for c in range(nc):
        # the carried state's contribution to this chunk's outputs
        Cd = Cc[:, c] * torch.exp(dA_cs[:, c])[..., None]          # (b,L,h,n)
        y_prev.append(torch.einsum("blhn,bhpn->blhp", Cd, state))
        state = state * chunk_decay[:, c][..., None, None] + S_chunk[:, c]
    y = y_intra + torch.stack(y_prev, dim=1)
    return y.reshape(b, s, h, p), state


# a tensor-parallel rank's blocks of a split mamba2 (``mamba2_block``):
# its heads' rows of ``out_proj``, its part of the gated norm's scale, and
# its heads' scalars
MAMBA2_SPLIT_LEAVES = ("out_proj", "norm", "A_log", "D", "dt_bias")


def mamba2_splits(cfg, tp) -> bool:
    """Whether a tensor-parallel rank (``tp``, None for none) runs its share
    of a mamba2 block: its SSM heads divide the model axis, as JAX's
    ``"ssm_heads"`` rule asks."""
    return tp is not None and cfg.ssm.n_heads(cfg.d_model) % tp.size == 0


def _own(t: torch.Tensor, n: int, part: slice) -> torch.Tensor:
    """A leaf of leading dim ``n`` as a rank computes with it: its rows
    ``part`` of the whole leaf, or the leaf itself when it arrives as that
    block already."""
    return t[part] if t.shape[0] == n else t


def in_projection(x, w, cfg, heads: slice):
    """``x @ in_proj`` over the columns the heads ``heads`` need: their
    ``z``, ``x`` and ``dt`` columns and the ``B``/``C`` columns whole, in
    the fused layout's order (all columns for all heads)."""
    s = cfg.ssm
    d_inner, h = s.d_inner(cfg.d_model), s.n_heads(cfg.d_model)
    if heads.stop - heads.start < h:
        p, gn = s.head_dim, s.n_groups * s.d_state
        cols = slice(heads.start * p, heads.stop * p)
        w = torch.cat([w[:, cols], w[:, d_inner + cols.start:d_inner + cols.stop],
                       w[:, 2 * d_inner:2 * d_inner + 2 * gn],
                       w[:, 2 * d_inner + 2 * gn + heads.start:2 * d_inner + 2 * gn + heads.stop]],
                      dim=1)
    return x @ w.to(cfg.compute_dtype)


def out_projection(y, w, cfg):
    """``y @ out_proj``: with a rank's ``d_inner`` block of ``y`` and the
    rows of ``w`` that match it, the rank's partial sums."""
    return y @ w.to(cfg.compute_dtype)


def _gated_norm_split(y, scale, eps: float, d: int, tp):
    """The gated RMSNorm over the whole ``d_inner`` (``d``) from a rank's
    block of it: the rank's fp32 sum of squares, all-reduced over
    ``"model"`` (backward: the same sum of each rank's term), then the
    rank's block of the scale. The JAX norm is plain jnp whose mean GSPMD
    sums over the shards; K1 takes no variance from outside, so this norm
    stays torch ops."""
    yf = y.to(_acc(y.dtype))
    var = tp.all_reduce(torch.sum(yf * yf, dim=-1, keepdim=True)) / d
    return (yf * (var + eps) ** -0.5 * scale.to(yf.dtype)).to(y.dtype)


def mamba2_block(params, x, cfg, cache=None, seq_mask=None, tp=None):
    """Returns (out, new_state): ``{"conv": (B,K-1,C), "ssm": (B,h,p,n)}``
    with a cache, else None. Masked positions get ``dt`` 0 (decay 1, input
    0) and the conv carry ends at each row's valid end: an exact freeze.

    With ``tp`` (``distributed.shard.TensorParallel``, cache-less; see
    ``mamba2_splits``), ``x`` is this rank's sequence part: it is
    all-gathered along the sequence, the rank computes its heads
    ``tp.part(h)`` over the whole sequence (``in_proj``'s and the conv's
    ``z``/``x``/``dt`` columns of those heads, ``B`` and ``C`` whole, since
    every head reads the groups), the gated norm's mean is summed over the
    ranks (``_gated_norm_split``), and ``out_proj``'s rows give partial
    sums that a reduce-scatter along the sequence turns into the rank's
    part of the output (B,S/n,d). ``in_proj`` and the conv leaves arrive
    whole (their columns are cut here); the per-head leaves, the norm's
    scale and ``out_proj`` arrive whole or as the rank's block
    (``MAMBA2_SPLIT_LEAVES``). Under ``RowParallel`` (a decode step) ``x``
    is whole and the partial sums are all-reduced.

    With ``tp`` and a cache (the serving steps on a mesh) the SSM state is
    the rank's heads' and the conv state the rank's block of the conv
    channels (JAX's ``"inner"``), which is not the channels its heads
    read: the blocks are all-gathered (B, K-1, C), the rank's channels feed
    its conv, and the new state of every channel, the last K-1 conv inputs
    up to each row's valid end (``x``'s rows times ``in_proj``'s conv
    columns; with ``seq_mask`` the rows ending at each row's last valid
    position, as ``causal_conv1d`` carries them), is cut back to the
    rank's block."""
    s = cfg.ssm
    if tp is not None:
        x = tp.seq_gather(x)
    Bsz, S, d = x.shape
    d_inner = s.d_inner(d)
    h = s.n_heads(d)
    p = s.head_dim
    g, n = s.n_groups, s.d_state
    compute = cfg.compute_dtype
    acc = _acc(compute)
    heads = slice(0, h) if tp is None else tp.part(h)
    cols = slice(heads.start * p, heads.stop * p)
    hr, dr = heads.stop - heads.start, (heads.stop - heads.start) * p

    proj = in_projection(x, params["in_proj"], cfg, heads)
    z, xconv_in, dt_raw = torch.split(proj, [dr, dr + 2 * g * n, hr], dim=-1)
    conv_w, conv_b = params["conv_w"], params["conv_b"]
    conv_state = None if cache is None else cache["conv"]
    if tp is not None and cache is not None:  # every channel's state, the rank's read
        conv_full = tp.channel_gather(conv_state)
        conv_state = conv_full if hr == h else torch.cat(
            [conv_full[..., cols], conv_full[..., d_inner:]], dim=-1)
    if hr < h:  # the rank's x channels, B and C whole
        conv_w = torch.cat([conv_w[:, cols], conv_w[:, d_inner:]], dim=1)
        conv_b = torch.cat([conv_b[cols], conv_b[d_inner:]])
    xconv, new_conv = causal_conv1d(
        xconv_in, conv_w.to(compute), conv_b.to(compute),
        state=conv_state,
        valid_len=None if seq_mask is None else seq_mask.sum(dim=1),
    )
    xconv = F.silu(xconv)
    xs, B_, C_ = torch.split(xconv, [dr, g * n, g * n], dim=-1)
    xs = xs.reshape(Bsz, S, hr, p)
    B_ = B_.reshape(Bsz, S, g, n).to(acc)
    C_ = C_.reshape(Bsz, S, g, n).to(acc)
    if hr < h and g > 1:  # each of the rank's heads with its own group
        B_ = B_.repeat_interleave(h // g, dim=2)[:, :, heads]
        C_ = C_.repeat_interleave(h // g, dim=2)[:, :, heads]
    gr = B_.shape[2]
    dt = F.softplus(dt_raw.to(acc) + _own(params["dt_bias"], h, heads).to(acc))    # (B,S,hr)
    if seq_mask is not None:
        dt = dt * seq_mask[..., None]
    A = -torch.exp(_own(params["A_log"], h, heads).to(acc))

    if cache is not None and S == 1:
        state = cache["ssm"].to(acc)                                # (B,h,p,n)
        dA = torch.exp(dt[:, 0, :] * A[None, :])
        Bh = B_[:, 0].repeat_interleave(hr // gr, dim=1)            # (B,h,n)
        Ch = C_[:, 0].repeat_interleave(hr // gr, dim=1)
        xf = xs[:, 0].to(acc)                                       # (B,h,p)
        state = state * dA[..., None, None] + (
            (dt[:, 0][..., None] * xf)[..., :, None] * Bh[:, :, None, :])
        y = torch.einsum("bhn,bhpn->bhp", Ch, state)[:, None]
        new_ssm = state
    else:
        init = None if cache is None else cache["ssm"]
        y, new_ssm = _ssd_chunked(xs.to(acc), dt, A, B_, C_, chunk=s.chunk, init_state=init)
    y = y + _own(params["D"], h, heads).to(acc)[None, None, :, None] * xs.to(acc)
    y = y.reshape(Bsz, S, dr).to(compute)

    # gated RMSNorm (mamba2 style), over d_inner
    y = y * F.silu(z)
    if tp is None:
        y = rmsnorm(y, params["norm"], cfg.norm_eps)
    else:
        y = _gated_norm_split(y, _own(params["norm"], d_inner, cols), cfg.norm_eps, d_inner, tp)
    out = out_projection(y, _own(params["out_proj"], d_inner, cols), cfg)
    if tp is not None:
        out = tp.seq_scatter(out)
        if cache is None:
            return out, None
        K = params["conv_w"].shape[0]
        w_conv = params["in_proj"][:, d_inner:2 * d_inner + 2 * g * n].to(compute)
        if seq_mask is None:
            tail = x[:, S - min(S, K - 1):] @ w_conv
            full = torch.cat([conv_full.to(tail.dtype), tail], dim=1)[:, -(K - 1):]
        else:  # each row's last K-1 inputs up to its valid end
            xp = torch.cat([conv_full.to(compute), x @ w_conv], dim=1)
            idx = seq_mask.sum(dim=1).long()[:, None] + torch.arange(K - 1, device=x.device)
            full = torch.gather(xp, 1, idx[:, :, None].expand(-1, -1, xp.shape[-1]))
        new_conv = full[..., tp.part(full.shape[-1])]
        return out, {"conv": new_conv.to(cache["conv"].dtype), "ssm": new_ssm}
    new_state = None
    if cache is not None:
        new_state = {"conv": new_conv.to(cache["conv"].dtype), "ssm": new_ssm}
    return out, new_state


def mamba2_cache(cfg, batch: int, dtype, device=None) -> dict:
    """SSM state in fp32 (float64 for a float64 model), conv state in the
    compute dtype."""
    s = cfg.ssm
    d_inner = s.d_inner(cfg.d_model)
    h = s.n_heads(cfg.d_model)
    conv_ch = d_inner + 2 * s.n_groups * s.d_state
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, conv_ch), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, h, s.head_dim, s.d_state), dtype=_acc(dtype),
                           device=device),
    }


# ===========================================================================
# xLSTM: mLSTM (matrix memory) and sLSTM (scalar memory)
# ===========================================================================


def mlstm_params(cfg) -> dict:
    x = cfg.xlstm
    d = cfg.d_model
    di = x.d_inner(d)
    h = cfg.n_heads
    return {
        "up_proj": ParamSpec((d, 2 * di), ("embed", "inner_all")),
        "conv_w": ParamSpec((x.d_conv, di), (None, "inner"), scale=0.5),
        "conv_b": ParamSpec((di,), ("inner",), init="zeros"),
        "wq": ParamSpec((di, di), ("inner", "inner_q")),
        "wk": ParamSpec((di, di), ("inner", "inner_q")),
        "wv": ParamSpec((di, di), ("inner", "inner_q")),
        "w_if": ParamSpec((di, 2 * h), ("inner", None), scale=0.02),
        "b_i": ParamSpec((h,), (None,), init="zeros"),
        "b_f": ParamSpec((h,), (None,), init="ones"),
        "norm": ParamSpec((di,), ("inner",), init="ones"),
        "down_proj": ParamSpec(
            (di, d), ("inner", "embed_out"),
            scale=1.0 / (math.sqrt(di) * math.sqrt(2 * cfg.n_layers))),
    }


def _mlstm_chunked(q, k, v, log_i, log_f, chunk, init=None):
    """Stabilized chunkwise mLSTM. q, k, v: (b,s,h,p); log_i, log_f:
    (b,s,h). Returns (y (b,s,h,p), (C, n, m) final). ``m`` starts at -inf
    without ``init``."""
    b, s, h, p = q.shape
    acc = _acc(q.dtype)
    L = min(chunk, s)
    nc = s // L
    qc = q.reshape(b, nc, L, h, p).to(acc)
    kc = k.reshape(b, nc, L, h, p).to(acc)
    vc = v.reshape(b, nc, L, h, p).to(acc)
    li = log_i.reshape(b, nc, L, h)
    lf = log_f.reshape(b, nc, L, h)
    lf_cs = torch.cumsum(lf, dim=2)                                 # (b,nc,L,h)
    # log weight of source j surviving to target t within the chunk:
    # D[t,j] = sum_{k=j+1..t} lf_k + li_j
    D = _segsum(lf.permute(0, 1, 3, 2)) + li.permute(0, 1, 3, 2)[:, :, :, None, :]
    if init is None:
        C = torch.zeros((b, h, p, p), dtype=acc, device=q.device)
        n = torch.zeros((b, h, p), dtype=acc, device=q.device)
        m = torch.full((b, h), float("-inf"), dtype=acc, device=q.device)
    else:
        C, n, m = init
    ys = []
    for c in range(nc):
        qq, kk, vv, DD = qc[:, c], kc[:, c], vc[:, c], D[:, c]
        b_decay = lf_cs[:, c].permute(0, 2, 1)                      # (b,h,L)
        m_intra = torch.amax(DD, dim=-1)                            # (b,h,L)
        m_new_t = torch.maximum(m[:, :, None] + b_decay, m_intra)
        w_intra = torch.exp(DD - m_new_t[..., None])                # (b,h,L,L)
        s_qk = torch.einsum("blhp,bjhp->bhlj", qq, kk) / math.sqrt(p)
        sw = s_qk * w_intra
        y_num = torch.einsum("bhlj,bjhp->blhp", sw, vv)
        y_den = sw.sum(dim=-1)                                      # (b,h,L)
        w_inter = torch.exp(m[:, :, None] + b_decay - m_new_t)      # (b,h,L)
        qw = qq * w_inter.permute(0, 2, 1)[..., None]               # (b,L,h,p)
        y_num = y_num + torch.einsum("blhp,bhpo->blho", qw, C) / math.sqrt(p)
        y_den = y_den + torch.einsum("blhp,bhp->bhl", qw, n) / math.sqrt(p)
        den = torch.maximum(torch.abs(y_den), torch.exp(-m_new_t))  # the denominator floor
        ys.append(y_num / den.permute(0, 2, 1)[..., None])
        # the state at the chunk's end
        tot = lf_cs[:, c, -1, :]                                    # (b,h)
        m_end = torch.maximum(m + tot, torch.amax(DD[:, :, -1, :], dim=-1))
        w_end = torch.exp((lf_cs[:, c, -1:, :] - lf_cs[:, c] + li[:, c])
                          - m_end[:, None, :])                      # (b,L,h)
        carry = torch.exp(m + tot - m_end)
        kw = kk * w_end[..., None]
        C = C * carry[..., None, None] + torch.einsum("blhp,blho->bhpo", kw, vv)
        n = n * carry[..., None] + kw.sum(dim=1)
        m = m_end
    y = torch.stack(ys, dim=1).reshape(b, s, h, p)
    return y, (C, n, m)


def mlstm_block(params, x, cfg, cache=None, seq_mask=None):
    """Returns (out, new_state): ``{"conv", "C", "n", "m"}`` with a cache.
    Masked positions get input gate -1e30 and forget gate 0 (log space),
    so (C, n, m) pass through; a row with no valid position keeps its state
    bitwise (see the module docstring)."""
    xl = cfg.xlstm
    B, S, d = x.shape
    di = xl.d_inner(d)
    h = cfg.n_heads
    p = di // h
    compute = cfg.compute_dtype
    acc = _acc(compute)

    up = x @ params["up_proj"].to(compute)
    xm, z = torch.chunk(up, 2, dim=-1)
    xc, new_conv = causal_conv1d(
        xm, params["conv_w"].to(compute), params["conv_b"].to(compute),
        state=None if cache is None else cache["conv"],
        valid_len=None if seq_mask is None else seq_mask.sum(dim=1),
    )
    xc = F.silu(xc)
    q = (xc @ params["wq"].to(compute)).reshape(B, S, h, p)
    k = (xc @ params["wk"].to(compute)).reshape(B, S, h, p)
    v = (xm @ params["wv"].to(compute)).reshape(B, S, h, p)
    gates = xm @ params["w_if"].to(compute)
    gi, gf = torch.chunk(gates.to(acc), 2, dim=-1)                  # (B,S,h)
    log_i = gi + params["b_i"].to(acc)
    log_f = F.logsigmoid(gf + params["b_f"].to(acc))
    if seq_mask is not None:
        m3 = seq_mask[..., None]
        log_i = torch.where(m3, log_i, torch.full((), M_INIT, dtype=acc, device=x.device))
        log_f = torch.where(m3, log_f, torch.zeros((), dtype=acc, device=x.device))

    if cache is not None and S == 1:
        C, n, m = cache["C"], cache["n"], cache["m"]
        li, lf = log_i[:, 0], log_f[:, 0]                           # (B,h)
        m_new = torch.maximum(lf + m, li)
        kf, vf = k[:, 0].to(acc), v[:, 0].to(acc)
        fw = torch.exp(lf + m - m_new)
        iw = torch.exp(li - m_new)
        C_new = C * fw[..., None, None] + iw[..., None, None] * (kf[..., :, None] * vf[..., None, :])
        n_new = n * fw[..., None] + iw[..., None] * kf
        qf = q[:, 0].to(acc) / math.sqrt(p)
        num = torch.einsum("bhp,bhpo->bho", qf, C_new)
        den = torch.maximum(torch.abs((qf * n_new).sum(dim=-1)), torch.exp(-m_new))
        y = (num / den[..., None])[:, None]                         # (B,1,h,p)
        new_state = (C_new, n_new, m_new)
    else:
        init = None if cache is None else (cache["C"], cache["n"], cache["m"])
        y, new_state = _mlstm_chunked(q, k, v, log_i, log_f, xl.chunk, init=init)
    if cache is not None and seq_mask is not None:
        # an idle row keeps its state bitwise (gate masking alone leaks into
        # C and n while m is still at its -1e30 init)
        keep = seq_mask.any(dim=1)
        new_state = tuple(
            torch.where(keep.reshape((B,) + (1,) * (new.dim() - 1)), new, old)
            for new, old in zip(new_state, (cache["C"], cache["n"], cache["m"])))

    y = y.reshape(B, S, di).to(compute)
    y = rmsnorm(y, params["norm"], cfg.norm_eps)
    y = y * F.silu(z)
    out = y @ params["down_proj"].to(compute)
    new_cache = None
    if cache is not None:
        new_cache = {"conv": new_conv.to(cache["conv"].dtype),
                     "C": new_state[0], "n": new_state[1], "m": new_state[2]}
    return out, new_cache


def mlstm_cache(cfg, batch: int, dtype, device=None) -> dict:
    xl = cfg.xlstm
    di = xl.d_inner(cfg.d_model)
    h = cfg.n_heads
    p = di // h
    acc = _acc(dtype)
    return {
        "conv": torch.zeros((batch, xl.d_conv - 1, di), dtype=dtype, device=device),
        "C": torch.zeros((batch, h, p, p), dtype=acc, device=device),
        "n": torch.zeros((batch, h, p), dtype=acc, device=device),
        "m": torch.full((batch, h), M_INIT, dtype=acc, device=device),
    }


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_params(cfg) -> dict:
    d = cfg.d_model
    h = cfg.n_heads
    return {
        "w_in": ParamSpec((d, 4 * d), ("embed", "inner_all")),
        "r": ParamSpec((h, d // h, 4 * (d // h)), (None, None, None), scale=0.02),
        "b": ParamSpec((4 * d,), (None,), init="zeros"),
        "norm": ParamSpec((d,), ("embed",), init="ones"),
    }


def slstm_cell(carry, w, h_heads: int, d_head: int):
    """One sLSTM step in the JAX package's layout, the reference the scan
    (``_cell``, ``_SLSTMScan``) is tested against. carry: (c, n, h, m) each
    (B,nh,dh); w: (B,4*d) pre-activations, the recurrent term added."""
    c, n, _hprev, m = carry
    B = w.shape[0]
    wi, wf, wz, wo = torch.chunk(w, 4, dim=-1)
    acc = _acc(w.dtype)

    def heads(t):
        return t.reshape(B, h_heads, d_head).to(acc)

    i_t = heads(wi)
    f_t = heads(wf)
    z_t = torch.tanh(heads(wz))
    o_t = torch.sigmoid(heads(wo))
    log_f = F.logsigmoid(f_t)
    m_new = torch.maximum(log_f + m, i_t)
    i_p = torch.exp(i_t - m_new)
    f_p = torch.exp(log_f + m - m_new)
    c = f_p * c + i_p * z_t
    n = f_p * n + i_p
    h_new = o_t * c / torch.clamp(n, min=1e-6)
    return (c, n, h_new, m_new)


# The scan runs in a (head, batch, .) layout: the carry (nh, B, dh), the
# pre-activations P = w + h r (nh, B, 4dh), one ``baddbmm`` a step. In the
# JAX layout P is (B, 4d), gate g at columns [g*d, (g+1)*d) as (nh, dh),
# and the recurrent term ``einsum("bhd,hdk->bhk")`` reshaped to (B, 4d), so
# gate g of head h is block u = g*nh + h of the 4*nh blocks of dh, and
# block u of P's row b sits at [u // 4, b, (u % 4)*dh:]: ``_gates`` and
# ``_ungates`` map between the two (a view when nh is 4, as in xlstm).


def _gates(P, nh: int, B: int, dh: int):
    G = P.view(nh, B, 4, dh).permute(0, 2, 1, 3).reshape(4, nh, B, dh)
    return G[0], G[1], G[2], G[3]


def _ungates(gi, gf, gz, go, nh: int, B: int, dh: int):
    G = torch.stack([gi, gf, gz, go])
    return G.reshape(nh, 4, B, dh).permute(0, 2, 1, 3).reshape(nh, B, 4 * dh)


def _cell(P, c, n, m, nh: int, B: int, dh: int):
    """``slstm_cell`` on the scan's layout; also returns the values the
    backward reads."""
    i, f, zr, orr = _gates(P, nh, B, dh)
    a = F.logsigmoid(f) + m
    m_new = torch.maximum(a, i)
    fp = torch.exp(a - m_new)
    ip = torch.exp(i - m_new)
    z = torch.tanh(zr)
    o = torch.sigmoid(orr)
    c_new = torch.addcmul(fp * c, ip, z)
    n_new = torch.addcmul(ip, fp, n)
    h_new = o * c_new / torch.clamp(n_new, min=1e-6)
    return (c_new, n_new, h_new, m_new), (f, a, i, m_new, fp, ip, z, o, c_new, n_new)


def _scan(w, r, carry, keep):
    """Forward over S steps. w (S, nh, B, 4dh); r (nh, dh, 4dh); carry (c,
    n, h, m) each (nh, B, dh); keep (S, B) bool or None. Returns the
    carries before every step and after the last (S+1 tuples)."""
    nh, B, dh = carry[0].shape
    carries = [carry]
    for t in range(w.shape[0]):
        c, n, h, m = carry
        new, _ = _cell(torch.baddbmm(w[t], h, r), c, n, m, nh, B, dh)
        if keep is not None:
            k = keep[t][None, :, None]
            new = tuple(torch.where(k, nw, od) for nw, od in zip(new, carry))
        carry = new
        carries.append(carry)
    return carries


class _SLSTMScan(torch.autograd.Function):
    """The sLSTM scan with a hand-written backward: the forward keeps only
    each step's input carry; the backward walks the steps in reverse,
    recomputes a step's gates from its carry and accumulates the
    gradients of w, r and the initial carry. Autograd over the host loop
    would record ~20 nodes a step and take several times the forward."""

    @staticmethod
    def forward(ctx, w, r, c, n, h, m, keep):
        carries = _scan(w, r, (c, n, h, m), keep)
        hs = torch.stack([cr[2] for cr in carries[1:]])               # (S,nh,B,dh)
        ctx.save_for_backward(w, r, keep, *[torch.stack(x) for x in zip(*carries[:-1])])
        return (hs, *carries[-1])

    @staticmethod
    def backward(ctx, g_hs, gc, gn, gh, gm):
        w, r, keep, cs, ns, hs_in, ms = ctx.saved_tensors
        S = w.shape[0]
        nh, B, dh = cs.shape[1:]
        zeros = torch.zeros_like(cs[0])
        gc, gn, gh, gm = (zeros if g is None else g for g in (gc, gn, gh, gm))
        gw = torch.empty_like(w)
        gr = torch.zeros_like(r)
        rT = r.transpose(1, 2)
        for t in range(S - 1, -1, -1):
            if g_hs is not None:
                gh = gh + g_hs[t]
            c, n, h, m = cs[t], ns[t], hs_in[t], ms[t]
            _, (f, a, i, m_new, fp, ip, z, o, c_new, n_new) = _cell(
                torch.baddbmm(w[t], h, r), c, n, m, nh, B, dh)
            if keep is not None:
                k = keep[t][None, :, None]
                pass_through = [torch.where(k, 0.0, g) for g in (gc, gn, gh, gm)]
                gc, gn, gh, gm = (torch.where(k, g, 0.0) for g in (gc, gn, gh, gm))
            # h_new = o * c_new / clamp(n_new, 1e-6)
            cl = torch.clamp(n_new, min=1e-6)
            q = c_new / cl
            do = gh * q
            dq = gh * o
            gcn = gc + dq / cl
            gnn = gn - (dq * q / cl) * (n_new >= 1e-6)
            # c_new = fp*c + ip*z; n_new = fp*n + ip
            e_f = (gcn * c + gnn * n) * fp
            e_i = (gcn * z + gnn) * ip
            gz = gcn * ip
            gc_prev, gn_prev = gcn * fp, gnn * fp
            # fp = exp(a - m_new), ip = exp(i - m_new), m_new = max(a, i)
            # (a tie splits the gradient, as torch.maximum and jnp.maximum do)
            gmn = gm - e_f - e_i
            ta = (a > i).to(a.dtype) + 0.5 * (a == i).to(a.dtype)
            ga = e_f + gmn * ta
            gi = e_i + gmn * (1.0 - ta)
            # a = logsigmoid(f) + m
            gf = ga * torch.sigmoid(-f)
            dP = _ungates(gi, gf, gz * (1.0 - z * z), do * o * (1.0 - o), nh, B, dh)
            gw[t] = dP
            gr.baddbmm_(h.transpose(1, 2), dP)
            gh = torch.bmm(dP, rT)
            gc, gn, gm = gc_prev, gn_prev, ga
            if keep is not None:
                gc, gn, gh, gm = (g + p for g, p in zip((gc, gn, gh, gm), pass_through))
        return gw, gr, gc, gn, gh, gm, None


def slstm_block(params, x, cfg, cache=None, seq_mask=None):
    """Returns (out, new_state): ``{"c", "n", "h", "m"}`` with a cache. The
    cell runs one position at a time (a host loop of S steps, one
    ``baddbmm`` and 16 elementwise launches a step); at masked positions
    the carry passes through unchanged. Where a gradient can flow the scan
    runs through ``_SLSTMScan``."""
    B, S, d = x.shape
    nh = cfg.n_heads
    dh = d // nh
    compute = cfg.compute_dtype
    acc = _acc(compute)
    w_all = x @ params["w_in"].to(compute) + params["b"].to(compute)
    # (S, nh, B, 4dh): the scan's layout (see ``_gates``)
    w = w_all.to(acc).view(B, S, nh, 4 * dh).permute(1, 2, 0, 3).contiguous()
    if cache is not None:
        carry = tuple(cache[k].to(acc).transpose(0, 1) for k in ("c", "n", "h", "m"))
    else:
        zeros = torch.zeros((nh, B, dh), dtype=acc, device=x.device)
        carry = (zeros, zeros, zeros, torch.full((nh, B, dh), M_INIT, dtype=acc,
                                                 device=x.device))
    carry = tuple(t.contiguous() for t in carry)
    r = params["r"].to(acc)
    keep = None if seq_mask is None else seq_mask.transpose(0, 1).contiguous()
    if torch.is_grad_enabled() and (w.requires_grad or r.requires_grad):
        hs, *last = _SLSTMScan.apply(w, r, *carry, keep)
    else:
        carries = _scan(w, r, carry, keep)
        hs, last = torch.stack([cr[2] for cr in carries[1:]]), carries[-1]
    ys = hs.permute(2, 0, 1, 3)                                     # (B,S,nh,dh)
    y = rmsnorm(ys.reshape(B, S, d).to(compute), params["norm"], cfg.norm_eps)
    new_cache = None
    if cache is not None:
        new_cache = {k: v.transpose(0, 1) for k, v in zip(("c", "n", "h", "m"), last)}
    return y, new_cache


def slstm_cache(cfg, batch: int, dtype=torch.float32, device=None) -> dict:
    """sLSTM state in fp32 (float64 for a float64 model), ``m`` at -1e30."""
    nh = cfg.n_heads
    dh = cfg.d_model // nh
    acc = _acc(dtype)
    z = torch.zeros((batch, nh, dh), dtype=acc, device=device)
    return {"c": z, "n": z.clone(), "h": z.clone(),
            "m": torch.full((batch, nh, dh), M_INIT, dtype=acc, device=device)}


# the cache entry of each recurrent block kind, as in the JAX cache tree
CACHE_KEYS = {"mamba2": "mamba", "mlstm": "mlstm", "slstm": "slstm"}
