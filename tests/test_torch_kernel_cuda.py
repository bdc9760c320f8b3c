"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test here is marked ``cuda`` and skips without a card.

This file imports no jax (the machine with the card has none); run it there
without the repo's conftest, which sets jax up for the CPU suite:

    python -m pytest --noconftest -m cuda tests/test_torch_kernel_cuda.py
"""

import numpy as np
import pytest
import torch

from longterm360fov_tpu_torch import oracle
from longterm360fov_tpu_torch.models import seq2seq
from longterm360fov_tpu_torch.models.cell import LSTMParams
from longterm360fov_tpu_torch.ops import fused_lstm, lstm_train
from longterm360fov_tpu_torch.params import params_from_numpy

# the condition string is evaluated when the test runs, not at import
pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif("not torch.cuda.is_available()",
                       reason="CUDA kernel: runs only on an NVIDIA card"),
]


@pytest.fixture(autouse=True, scope="module")
def _exact_f32():
    fused_lstm.exact_f32_matmul()


def _args(cfg, batch, seed):
    p = params_from_numpy(oracle.init_params_np(seed, cfg), "cuda")
    past_n = np.random.default_rng(seed).normal(
        size=(batch, cfg.h_in, cfg.d)).astype(np.float32) * 0.1
    return (p["encoder"], p["decoder"], p["proj"]["w"], p["proj"]["b"],
            torch.as_tensor(past_n, device="cuda"), cfg.h_out)


@pytest.mark.parametrize(
    "layers,hidden,batch",
    # full seq2seq-tf-30 width at ragged and tiny batches; a stacked model;
    # a narrow one (64 rows per block of 64 threads)
    [(1, 128, 4099), (2, 128, 4099), (1, 128, 1), (3, 128, 300), (2, 32, 257)],
)
def test_fused_serve_kernel_matches_plain(layers, hidden, batch):
    cfg = seq2seq.Seq2SeqConfig(hidden=hidden, layers=layers, h_in=30, h_out=30)
    args = _args(cfg, batch, seed=layers)
    before = fused_lstm.fused_serve.launches
    out = fused_lstm.fused_serve(*args)
    torch.cuda.synchronize()
    assert fused_lstm.fused_serve.launches == before + 1
    assert out.shape == (batch, 30, 3) and torch.isfinite(out).all()
    ref = fused_lstm.fused_serve_reference(*args)
    assert (out - ref).abs().max().item() <= 1e-4


def test_fused_serve_rows_are_independent():
    """A row's answer does not depend on which block or batch it rides in."""
    cfg = seq2seq.Seq2SeqConfig(hidden=128, layers=1, h_in=30, h_out=30)
    args = _args(cfg, 200, seed=0)
    full = fused_lstm.fused_serve(*args)
    part = fused_lstm.fused_serve(*args[:4], args[4][70:131].contiguous(), 30)
    assert torch.equal(full[70:131], part)


def test_fused_serve_never_falls_back_on_card():
    cfg = seq2seq.Seq2SeqConfig(hidden=48, layers=1, h_in=4, h_out=3)
    with pytest.raises(ValueError, match="hidden % 32"):
        fused_lstm.fused_serve(*_args(cfg, 4, seed=0))


# ------------------------------------------------- lstm_seq_states kernels
# Forward: 1e-5 absolute on f32 residuals (exact f32 FMAs in another order
# than cuBLAS). With bf16 residuals the same f32 values round to bf16, and a
# 1e-7 difference can cross a rounding boundary: one bf16 step, at most 2^-7 of the
# value. Backward (fed the same residuals): 1e-4 of max|plain| per output,
# since dW sums B·T terms in another order.


def _lstm_case(batch, layers, seed, t=30, d=3, h=128):
    rng = np.random.default_rng(seed)
    ps = []
    for l in range(layers):
        fan = (d if l == 0 else h) + h
        lim = np.sqrt(6 / (fan + 4 * h))
        ps.append(LSTMParams(
            torch.tensor(rng.uniform(-lim, lim, size=(fan, 4 * h)).astype(np.float32), device="cuda"),
            torch.tensor(rng.normal(size=4 * h).astype(np.float32) * 0.1, device="cuda")))
    ts = [torch.tensor(rng.normal(size=s).astype(np.float32) * sc, device="cuda")
          for s, sc in (((batch, t, d), 0.3), ((layers, batch, h), 0.3), ((layers, batch, h), 0.3),
                        ((batch, t, h), 1.0), ((layers, batch, h), 1.0), ((layers, batch, h), 1.0))]
    return ps, ts[:3], ts[3:]


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("rd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layers", [1, 2, 3])
@pytest.mark.parametrize("batch", [1, 257, 4099])
def test_lstm_train_kernels_match_plain(batch, layers, rd):
    ps, (xs, h0, c0), up = _lstm_case(batch, layers, seed=layers)
    before = (lstm_train.lstm_fwd.launches, lstm_train.lstm_bwd.launches, lstm_train.lstm_dw.launches)
    res = lstm_train.lstm_fwd(ps, xs, h0, c0, rd)
    ref = lstm_train._forward_reference(ps, xs, h0, c0, rd)
    torch.cuda.synchronize()
    for a, b in zip(res.hs + res.cs + res.gs, ref.hs + ref.cs + ref.gs):
        assert a.dtype == rd and a.shape == b.shape
        tol = 1e-5 if rd == torch.float32 else 1e-5 + 2.0 ** -7 * b.float().abs()
        assert ((a.float() - b.float()).abs() <= tol).all()
    dg, dxs, dh0, dc0 = lstm_train.lstm_bwd(ps, c0, res, *up)
    dg_p, dxs_p, dh0_p, dc0_p = lstm_train._bwd_recurrence_reference(ps, c0, res, *up)
    dps = lstm_train.lstm_dw(ps, xs, h0, res, dg_p)
    dps_p = lstm_train._dw_reference(ps, xs, h0, res, dg_p)
    torch.cuda.synchronize()
    pairs = list(zip(dg, dg_p)) + [(dxs, dxs_p), (dh0, dh0_p), (dc0, dc0_p)]
    pairs += [(a.w, b.w) for a, b in zip(dps, dps_p)] + [(a.b, b.b) for a, b in zip(dps, dps_p)]
    for a, b in pairs:
        assert torch.isfinite(a).all() and _rel(a, b) <= 1e-4
    after = (lstm_train.lstm_fwd.launches, lstm_train.lstm_bwd.launches, lstm_train.lstm_dw.launches)
    assert after == tuple(n + 1 for n in before)


def test_lstm_train_rows_are_independent():
    """A row's residuals, dgates and dxs do not depend on which block or
    batch it rides in."""
    ps, (xs, h0, c0), up = _lstm_case(300, 2, seed=0)
    part = slice(70, 131)
    res = lstm_train.lstm_fwd(ps, xs, h0, c0, torch.bfloat16)
    sub = lstm_train.lstm_fwd(ps, xs[part].contiguous(), h0[:, part].contiguous(),
                              c0[:, part].contiguous(), torch.bfloat16)
    for a, b in zip(res.hs + res.cs + res.gs, sub.hs + sub.cs + sub.gs):
        assert torch.equal(a[part], b)
    full = lstm_train.lstm_bwd(ps, c0, res, *up)
    cut = lstm_train.lstm_bwd(ps, c0[:, part].contiguous(), sub, up[0][part].contiguous(),
                              up[1][:, part].contiguous(), up[2][:, part].contiguous())
    for a, b in zip(full[0], cut[0]):
        assert torch.equal(a[part], b)
    assert torch.equal(full[1][part], cut[1])
    assert torch.equal(full[2][:, part], cut[2]) and torch.equal(full[3][:, part], cut[3])


def test_lstm_dw_reduction_is_deterministic():
    """No float atomics: the backward gives the same bits twice."""
    ps, (xs, h0, c0), up = _lstm_case(4099, 2, seed=1)
    leaves = [t.clone().requires_grad_(True) for p in ps for t in p]
    grads = []
    for _ in range(2):
        params = [LSTMParams(leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2)]
        out = lstm_train.lstm_seq_states(params, xs, h0, c0, torch.bfloat16)
        s = sum((o * u).sum() for o, u in zip(out, up))
        grads.append(torch.autograd.grad(s, leaves))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_lstm_seq_states_autograd_matches_the_step_loop():
    ps, (xs, h0, c0), up = _lstm_case(513, 2, seed=2)
    grads = {}
    for name, fn in (("kernels", lstm_train.lstm_seq_states),
                     ("loop", lstm_train.lstm_seq_states_reference)):
        leaves = [t.clone().requires_grad_(True) for p in ps for t in p] + \
            [t.clone().requires_grad_(True) for t in (xs, h0, c0)]
        params = [LSTMParams(leaves[i], leaves[i + 1]) for i in range(0, 2 * len(ps), 2)]
        out = fn(params, *leaves[2 * len(ps):])
        s = sum((o * u).sum() for o, u in zip(out, up))
        grads[name] = (out, torch.autograd.grad(s, leaves))
    for a, b in zip(grads["kernels"][0], grads["loop"][0]):
        assert (a - b).abs().max().item() <= 1e-5
    for a, b in zip(grads["kernels"][1], grads["loop"][1]):
        assert _rel(a, b) <= 1e-4


def test_lstm_train_never_falls_back_on_card():
    ps, (xs, h0, c0), _ = _lstm_case(4, 1, seed=0, h=48)
    with pytest.raises(ValueError, match="hidden % 32"):
        lstm_train.lstm_fwd(ps, xs, h0, c0)
