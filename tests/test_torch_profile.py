"""``StepProfile.count`` leaves the step it counts as it is.

The counter is one pass-through ``TorchDispatchMode``: every operator
runs as it was dispatched, and FLOPs come from ``torch.utils.flop_counter``'s
formula registry (``FlopCounterMode`` itself decomposes the operators its
registry lacks, so bf16 ``silu_backward`` ran as sigmoid, sub, mul and
add under it). Checked on the CPU:

* bf16 ``F.silu`` backward under the counter is bitwise the eager one;
* a bf16 tinyllama smoke train step under the counter gives bitwise the
  uncounted step's loss, ``grad_norm``, gradients and updated state, and
  dispatches the same operator sequence (recorded by a pass-through mode
  around it);
* a prefill chunk and a decode step in inference mode dispatch the same
  operators counted and uncounted, with the same logits;
* the FLOP totals are ``FlopCounterMode``'s, training and serving.
"""

import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core.profile import StepProfile  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.train.train import TrainConfig, init_state, make_train_step  # noqa: E402


class _Recorder(TorchDispatchMode):
    """Every operator dispatched through it, in order; runs each as it came."""

    def __init__(self) -> None:
        super().__init__()
        self.ops: list[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_silu_backward_under_the_counter_is_bitwise_eager():
    x0 = torch.randn(64, 512, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    g = torch.randn(64, 512, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)

    def grad():
        x = x0.clone().requires_grad_(True)
        F.silu(x).backward(g)
        return x.grad

    want = grad()
    got, prof = StepProfile.count(grad)
    assert torch.equal(got, want)
    assert prof.per_computation["aten.silu_backward"].num_instructions == 1
    assert "aten.sigmoid" not in prof.per_computation


def _tiny_step():
    cfg = smoke_config("tinyllama-1.1b")
    assert cfg.param_dtype == torch.bfloat16 and cfg.compute_dtype == torch.bfloat16
    data = SyntheticLM(DataConfig(global_batch=2, seq_len=64, vocab=cfg.vocab, pad_fraction=0.2))
    return cfg, data.batch_at(0)


def _step_and_grads(cfg, batch):
    """Gradients of one forward, then one train step from the same weights."""
    state = init_state(cfg, TrainConfig(), seed=0, device="cpu")
    model = state.model
    leaves = list(model.named_params().values())
    loss, _ = model({k: v[0] for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    state, m = make_train_step(cfg, TrainConfig())(state, batch)
    return grads, m, state


def test_counted_bf16_step_is_bitwise_the_uncounted_step():
    cfg, batch = _tiny_step()
    with _Recorder() as plain_rec:
        grads0, m0, state0 = _step_and_grads(cfg, batch)
    with _Recorder() as counted_rec:
        (grads1, m1, state1), prof = StepProfile.count(_step_and_grads, cfg, batch)
    assert counted_rec.ops == plain_rec.ops
    assert "aten.silu_backward" in prof.per_computation
    for a, b in zip(grads0, grads1):
        assert torch.equal(a, b)
    assert torch.equal(m0["loss"], m1["loss"]) and torch.equal(m0["grad_norm"], m1["grad_norm"])
    for (p, a), b in zip(state0.model.named_params().items(),
                         state1.model.named_params().values()):
        assert torch.equal(a, b), p
    for key in ("m", "v", "master"):
        for p, a in state0.opt_state[key].items():
            assert torch.equal(a, state1.opt_state[key][p]), (key, p)


def test_counted_flops_are_flop_counter_modes():
    cfg, batch = _tiny_step()
    with FlopCounterMode(display=False) as fm:
        _step_and_grads(cfg, batch)
    _, prof = StepProfile.count(_step_and_grads, cfg, batch)
    want = {str(k): float(v) for k, v in fm.get_flop_counts()["Global"].items()}
    got = {k: c.flops for k, c in prof.per_computation.items() if c.flops}
    assert got == want and set(want) == {"aten.mm", "aten.bmm"}


def test_counted_serving_steps_dispatch_the_same_operators():
    cfg = smoke_config("tinyllama-1.1b")
    model = Transformer.from_init(cfg, seed=0, device="cpu")
    toks = torch.randint(4, cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(3))
    bt = torch.arange(16, dtype=torch.int32).reshape(2, 8)

    def serve():
        caches = model.init_cache(2, 64, page_size=8)
        a = model.prefill_chunk(toks, caches, 0, 16, bt)
        b = model.decode_step(toks[:, :1], 16, caches, block_tables=bt)
        return a, b

    with _Recorder() as plain_rec:
        want = serve()
    with _Recorder() as counted_rec:
        got, prof = StepProfile.count(serve)
    assert counted_rec.ops == plain_rec.ops
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with FlopCounterMode(display=False) as fm:
        serve()
    # in inference mode aten.einsum and aten.matmul reach the counter whole:
    # their parts' FLOPs count under their own names
    assert prof.flops == float(fm.get_total_flops()) > 0
    assert prof.per_computation["aten.matmul"].flops > 0
