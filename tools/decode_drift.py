"""Where an fp32 model's logits drift from float64, op by op, on the CPU.

Builds one arch at full layer width (depth and vocabulary cut by the
flags), with the port's initializer and, where the arch has qkv biases,
biases drawn as N(0, --bias-std); runs a --prompt-token prefill in chunks
of 64 through the paged cache and 8 decode steps, in fp32 and again in
float64 on the same weights and tokens, and prints:

* each logit row's relative RMS distance from the float64 run (the last
  prefill chunks and every decode step);
* each op's local error: every fp32 call of RMSNorm, RoPE, the MLP and the
  plain paged decode (K3) and prefill (K4) attention rerun in float64 on
  the same inputs, as relative RMS, by op and by phase;
* for each K3 call, the conditioning of its softmax: the largest |score|,
  the smallest top-2 gap, and how far a relative 6e-8 (one fp32 ulp)
  random change of its inputs moves the float64 result.

Run from the repo root (about 4 minutes and 6 GB at the defaults):

    PYTHONPATH=src python tools/decode_drift.py --arch glm4-9b --repeats 2 \\
        --vocab 4096 --prompt 4160 --bias-std 0.3
"""

from __future__ import annotations

import argparse
import collections
import math

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.paged_attention.ref import gather_pages, paged_attention_reference
from repro_torch.layers import attention as A
from repro_torch.layers import ffn as FFN
from repro_torch.layers.common import tree_map
from repro_torch.models import transformer as TM
from repro_torch.models.transformer import Transformer

DECODE_STEPS, PAGE, CHUNK = 8, 16, 64


def rel_rms(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt())


def chunked_run(model, prompt: np.ndarray, toks=None):
    """Prefill ``prompt`` (1, n) in chunks (each chunk's last logits), then
    DECODE_STEPS decode steps fed ``toks`` or the run's greedy tokens."""
    n = prompt.shape[1]
    nL = -(-(n + DECODE_STEPS) // PAGE)
    caches = model.init_cache(1, nL * PAGE, page_size=PAGE, num_pages=nL)
    tb = torch.arange(nL, dtype=torch.int32)[None]
    rows = []
    for s in range(0, n, CHUNK):
        part = torch.from_numpy(prompt[:, s:s + CHUNK])
        rows.append(model.prefill_chunk(part, caches, s, part.shape[1], tb).double())
    fed = []
    for i in range(DECODE_STEPS):
        fed.append(int(rows[-1][-1].argmax()) if toks is None else toks[i])
        rows.append(model.decode_step(torch.tensor([[fed[-1]]], dtype=torch.int32),
                                      torch.tensor([n + i], dtype=torch.int32), caches,
                                      block_tables=tb).double())
    return torch.cat(rows), fed


class LocalErrors:
    """Wraps the ops in their modules' namespaces; each fp32 call is rerun
    in float64 on its inputs and its relative RMS error logged."""

    def __init__(self):
        self.log: list[tuple[str, str, float]] = []
        self.k3: list[tuple] = []
        self._saved = []

    def _patch(self, mod, name, fn):
        self._saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    def install(self):
        def up(t):
            return t.double() if torch.is_tensor(t) and t.is_floating_point() else t

        def plain(label, f):
            def g(*a, **kw):
                out = f(*a, **kw)
                if out.dtype == torch.float32:
                    ref = f(*map(up, a), **{k: up(v) for k, v in kw.items()})
                    phase = "decode" if out.shape[1] == 1 else "prefill"
                    self.log.append((label, phase, rel_rms(out, ref)))
                    if label == "K3":  # kept apart: later steps write the pools
                        self.k3.append(([t.clone() for t in a],
                                        {k: v.clone() if torch.is_tensor(v) else v
                                         for k, v in kw.items()}))
                return out
            return g

        for mod, name, label in ((A, "paged_attention", "K3"),
                                 (A, "paged_prefill_attention", "K4"),
                                 (A, "apply_rope", "rope"), (TM, "rmsnorm", "rmsnorm")):
            self._patch(mod, name, plain(label, getattr(mod, name)))
        mlp = FFN.mlp_block

        def mlp_g(params, x, cfg):
            out = mlp(params, x, cfg)
            if out.dtype == torch.float32:
                c64 = cfg.replace(param_dtype_name="float64", compute_dtype_name="float64")
                ref = mlp(tree_map(up, params), x.double(), c64)
                self.log.append(("mlp", "decode" if x.shape[1] == 1 else "prefill",
                                 rel_rms(out, ref)))
            return out

        self._patch(FFN, "mlp_block", mlp_g)

    def remove(self):
        for mod, name, f in reversed(self._saved):
            setattr(mod, name, f)
        self._saved.clear()


def k3_conditioning(a, kw, seed: int) -> dict:
    q, kp, vp, tb = a
    n = int(torch.as_tensor(kw["cache_len"]).reshape(-1)[0])
    kc = gather_pages(kp.double(), tb)[:, :n]
    B, _, Hq, D = q.shape
    Hkv = kc.shape[2]
    s = torch.einsum("bhgd,bkhd->bhgk", q.double().reshape(B, Hkv, Hq // Hkv, D), kc)
    s = s / math.sqrt(D)
    top2 = s.topk(2, dim=-1).values
    exact = paged_attention_reference(q.double(), kp.double(), vp.double(), tb, **kw)
    gen = torch.Generator().manual_seed(seed)

    def nudge(t):
        noise = torch.randn(t.shape, generator=gen, dtype=torch.float64)
        return t.double() * (1 + 6e-8 * noise)

    moved = paged_attention_reference(nudge(q), nudge(kp), nudge(vp), tb, **kw)
    return dict(max_score=float(s.abs().max()),
                min_top2_gap=float((top2[..., 0] - top2[..., 1]).min()),
                ulp_sensitivity=rel_rms(moved, exact),
                fp32_error=rel_rms(paged_attention_reference(q, kp, vp, tb, **kw), exact))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--prompt", type=int, default=4160)
    ap.add_argument("--bias-std", type=float, default=0.3)
    ap.add_argument("--seed", type=int, default=55)
    ap.add_argument("--threads", type=int, default=6)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    cfg = get_config(args.arch).replace(param_dtype_name="float32",
                                        compute_dtype_name="float32",
                                        repeats=args.repeats, vocab=args.vocab)
    model = Transformer.from_init(cfg, seed=args.seed, device="cpu")
    gen = torch.Generator().manual_seed(args.seed + 1)
    with torch.no_grad():
        for path, p in model.named_params().items():
            if path.rsplit("/", 1)[-1] in ("bq", "bk", "bv"):
                p.copy_(args.bias_std * torch.randn(p.shape, generator=gen))
    rng = np.random.default_rng(args.seed)
    prompt = rng.integers(4, cfg.vocab, size=(1, args.prompt)).astype(np.int32)
    local = LocalErrors()
    local.install()
    try:
        with torch.no_grad():
            fp32, toks = chunked_run(model, prompt)
    finally:
        local.remove()
    cfg64 = cfg.replace(param_dtype_name="float64", compute_dtype_name="float64")
    with torch.no_grad():
        exact, _ = chunked_run(Transformer(cfg64, tree_map(lambda t: t.double(),
                                                           model.params()), "cpu"),
                               prompt, toks)
    n = -(-args.prompt // CHUNK)
    rel = ((fp32 - exact).pow(2).mean(-1).sqrt() / exact.pow(2).mean(-1).sqrt()).tolist()
    print(f"{args.arch}: d {cfg.d_model}, {cfg.n_layers} layers, vocab {cfg.vocab}, "
          f"prompt {args.prompt}, bias std {args.bias_std}")
    print("logit rows vs float64, last 4 chunks:", " ".join(f"{x:.2e}" for x in rel[n - 4:n]))
    print("logit rows vs float64, decode steps: ", " ".join(f"{x:.2e}" for x in rel[n:]))
    by_op = collections.defaultdict(list)
    for label, phase, err in local.log:
        by_op[(label, phase)].append(err)
    for (label, phase), errs in sorted(by_op.items()):
        print(f"local error {label:8s} {phase:8s} calls {len(errs):4d} "
              f"median {np.median(errs):.2e} max {max(errs):.2e}")
    for i, (a, kw) in enumerate(local.k3):
        c = k3_conditioning(a, kw, seed=i)
        print(f"K3 call {i} (layer {i % cfg.n_layers}, step {i // cfg.n_layers}): "
              f"fp32 error {c['fp32_error']:.2e}, 1-ulp input change moves float64 by "
              f"{c['ulp_sensitivity']:.2e}, max |score| {c['max_score']:.1f}, "
              f"min top-2 gap {c['min_top2_gap']:.2e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
