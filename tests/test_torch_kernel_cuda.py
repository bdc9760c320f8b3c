"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test here is marked ``cuda`` and skips without a card.

This file imports no jax (the machine with the card has none); run it there
without the repo's conftest, which sets jax up for the CPU suite:

    python -m pytest --noconftest -m cuda tests/test_torch_kernel_cuda.py
"""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)
import dataclasses

import numpy as np
import pytest
import torch

from longterm360fov_tpu_torch import oracle
from longterm360fov_tpu_torch.models import cross_user, seq2seq, transformer
from longterm360fov_tpu_torch.models.cell import LSTMParams, lstm_cell
from longterm360fov_tpu_torch.ops import (conv_resize, fused_lstm, lstm_align, lstm_ss, lstm_train,
                                          transformer_decode, transformer_encode)
from longterm360fov_tpu_torch.ops import transformer_encode_train as et
from longterm360fov_tpu_torch.params import params_from_numpy, walk

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
#
# The bf16-compute tiers of the training kernels (train --train-compute
# bfloat16) run each check once more, in the bf16 compute type: against the
# bf16 plain version near chip_smoke.py's readings (PERF.md): the forward
# 1e-2 (plus the bf16 step on a value stored in bf16), the backward
# recurrences 1e-2 of max|plain|, the reductions fed the same dgates 1e-4,
# the lockstep decoder's 2e-3 ("ctx_sum": its loader rebuilds the context
# with FMAs, the plain version with a rounding per product);
# against the f32 plain version within JAX's contract for the tier
# (tests/test_lstm_train.py: 0.05 on the forward, 6 % of max|g|); and each
# output the tier rounds stands, in the mean, at least half as far from the
# f32 plain version as the bf16 plain version does, so a kernel that does
# not round fails (the largest gap of a value stored in bf16 is one bf16
# step either way). Its launches count in ``launches_bf16``.

#
# The serving kernels' bf16 tiers (rows 1b, 4b, 2b: compute_dtype=bfloat16,
# the cell on a --bf16 model's tensors) run their checks once more, with
# chip_smoke.py's gates: the serve kernels' predictions ("serve") within
# 1e-2 of the bf16 plain version, the encoder's rounded h ("encode") 1e-2,
# the peer context ("ctx") 1e-3, the cell's bf16 h and c ("cell") 1e-5 plus
# a bf16 step (PERF.md PR 10 has the readings); within JAX's 0.05 of the f32
# plain version (tests/test_fused_lstm.py:112-126); and the same floor.

BF = torch.bfloat16
COMPUTE = [torch.float32, BF]
LIMITS = {torch.float32: [{"fwd": 1e-5, "rec": 1e-4, "sum": 1e-4, "ctx_sum": 1e-4,
                           "serve": 1e-4, "encode": 1e-5, "ctx": 1e-5, "cell": 1e-5}],
          BF: [{"fwd": 1e-2, "rec": 1e-2, "sum": 1e-4, "ctx_sum": 2e-3,
                "serve": 1e-2, "encode": 1e-2, "ctx": 1e-3, "cell": 1e-5},
               {"fwd": 0.05, "rec": 0.06, "sum": 0.06, "ctx_sum": 0.06,
                "serve": 0.05, "encode": 0.05, "ctx": 0.05, "cell": 0.05}]}
ABSOLUTE = ("fwd", "serve", "encode", "ctx", "cell")


def _plains(cd, fn):
    """``fn(compute_dtype)`` in ``cd``, and in bf16 also in f32."""
    return [fn(cd)] if cd == torch.float32 else [fn(BF), fn(torch.float32)]


def _mean_gap(a, b):
    return (a.float() - b.float()).abs().mean().item()


def _check(outs, refs, kind, cd, unrounded=0):
    """A kernel's outputs against its plain versions (``_plains``) at
    LIMITS[cd] (``kind``: "fwd", a backward recurrence "rec", a reduction
    "sum" or the lockstep decoder's "ctx_sum"; a serving kernel's "serve",
    "encode", "ctx" or "cell"); in bf16 the floor on all but the last
    ``unrounded`` outputs, which sum unrounded values (db, dproj_b, dpwt)."""
    for ref, limits in zip(refs, LIMITS[cd], strict=True):
        for x, y in zip(outs, ref, strict=True):
            assert x.shape == y.shape and torch.isfinite(x.float()).all()
            diff = (x.float() - y.float()).abs()
            if kind in ABSOLUTE:
                assert (diff <= limits[kind] + (2.0 ** -7 * y.float().abs() if x.dtype == BF else 0.0)).all()
            else:
                assert diff.max().item() <= limits[kind] * y.float().abs().max().item()
    if cd == BF:
        n = len(outs) - unrounded
        for x, p, f in zip(outs[:n], refs[0][:n], refs[1][:n]):
            assert _mean_gap(x, f) >= 0.5 * _mean_gap(p, f), "the kernel does not round as the tier does"


def _flat(out):
    return [t for x in out for t in (x if isinstance(x, list) else [] if x is None else [x])]


def _wb(ps):
    return [p.w for p in ps] + [p.b for p in ps]


def _fwd(res):
    return res.hs + res.cs + res.gs


def _counts(wrappers):
    return [(f.launches, f.launches_bf16) for f in wrappers]


def _one_more(before, cd):
    """The counts after one launch of each wrapper in the compute type ``cd``."""
    return [(n + (cd != BF), m + (cd == BF)) for n, m in before]


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


@pytest.mark.parametrize("cd", COMPUTE)
@pytest.mark.parametrize("rd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layers", [1, 2, 3])
@pytest.mark.parametrize("batch", [1, 257, 4099])
def test_lstm_train_kernels_match_plain(batch, layers, rd, cd):
    ps, (xs, h0, c0), up = _lstm_case(batch, layers, seed=layers)
    wrappers = (lstm_train.lstm_fwd, lstm_train.lstm_bwd, lstm_train.lstm_dw)
    before = _counts(wrappers)
    res = lstm_train.lstm_fwd(ps, xs, h0, c0, rd, cd)
    refs = _plains(cd, lambda c: lstm_train._forward_reference(ps, xs, h0, c0, rd, c))
    assert all(x.dtype == rd for x in _fwd(res))
    _check(_fwd(res), [_fwd(r) for r in refs], "fwd", cd)
    bw = lstm_train.lstm_bwd(ps, c0, res, *up, compute_dtype=cd)
    bws = _plains(cd, lambda c: lstm_train._bwd_recurrence_reference(ps, c0, res, *up, c))
    _check(_flat(bw), [_flat(b) for b in bws], "rec", cd)
    dps = lstm_train.lstm_dw(ps, xs, h0, res, bws[0][0], cd)
    _check(_wb(dps), _plains(cd, lambda c: _wb(lstm_train._dw_reference(ps, xs, h0, res, bws[0][0], c))),
           "sum", cd, unrounded=layers)
    assert _counts(wrappers) == _one_more(before, cd)


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
    """No float atomics: the backward gives the same bits twice, and so does
    every loader's reduction in both compute types."""
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
    for loader in DW_LOADERS:
        dw, args, *_ = _dw_inputs(loader, 257, torch.bfloat16)
        for cd in COMPUTE:
            first, again = (_dw_flat(dw(*args, cd)) for _ in range(2))
            assert all(torch.equal(a, b) for a, b in zip(first, again, strict=True)), (loader, cd)


# Every loader of the dW reductions: the teacher-forced LSTM (two layers:
# in = 3, then the layer below's o·tanh(c)), the scheduled-sampling decoder
# at C = 0, 128 and 64 (in = 3, 131, 67), the lockstep decoder and its peer
# encoder at the 10 s shapes (T = 100, K = 1 and 7).
DW_LOADERS = ["tf", "ss0", "ss128", "ss64", "align1", "align7", "peer7"]


def _dw_inputs(loader, batch, rd, seed=0):
    """A reduction's wrapper and arguments (the dgates from the kernels'
    backward), its layers, and what its pack pass reads: layer 0's input
    (its first 3 features x_t), h0 and the residuals."""
    if loader == "tf":
        ps, (xs, h0, c0), up = _lstm_case(batch, 2, seed)
        res = lstm_train.lstm_fwd(ps, xs, h0, c0, rd)
        return lstm_train.lstm_dw, (ps, xs, h0, res, lstm_train.lstm_bwd(ps, c0, res, *up)[0]), 2, xs, h0, res
    if loader.startswith("ss"):
        ctx_dim = int(loader[2:])
        ps, a = _ss_case(batch, 2, ctx_dim, "bernoulli", seed)
        ys, res = lstm_ss.ss_fwd(*_ss_fwd_args(ps, a), rd)
        dg = lstm_ss.ss_bwd(ps, a["proj_w"], a["c0"], a["coins"], res, a["dys"], ctx_dim)[0]
        x0 = lstm_ss._layer0_input(a["y0"], a["teacher"], a["coins"], a["ctx"], ys)
        return lstm_ss.ss_dw, (ps, a["h0"], a["y0"], a["teacher"], a["coins"], a["ctx"], ys, res, dg), 2, x0, \
            a["h0"], res
    ps, a = _aligned_case(batch, 2, int(loader[-1]), "bernoulli", seed, t=100)
    php, pcp, ctx = lstm_align.peer_fwd(a["peer"], a["pxs"], a["pwt"], rd)
    ys, res = lstm_align.dec_fwd(ps, a["proj_w"], a["proj_b"], a["h0"], a["c0"], a["y0"], a["teacher"], a["coins"],
                                 ctx, rd)
    bw = lstm_align.dec_bwd(ps, a["proj_w"], a["c0"], a["coins"], res, a["dys"], 128)
    if loader.startswith("peer"):
        dpg = lstm_align.peer_bwd(a["peer"], a["pxs"], a["pwt"], php, pcp, bw[6])[0]
        no_h = torch.zeros((1, php.shape[0], 128), device="cuda")  # the peers start from zero state
        return lstm_align.peer_dw, (a["peer"], a["pxs"], php, dpg), 1, a["pxs"], no_h, \
            lstm_train.Residuals([php], [], [])
    x0 = lstm_ss._layer0_input(a["y0"], a["teacher"], a["coins"], lstm_align._rebuilt_ctx(php, a["pwt"]), ys)
    return lstm_align.dec_dw, (ps, a["h0"], a["y0"], a["teacher"], a["coins"], a["pwt"], php, ys, res, bw[0]), 2, \
        x0, a["h0"], res


def _dw_flat(out):
    return _wb(out) if isinstance(out, list) else [out.w, out.b]


@pytest.mark.parametrize("cd", COMPUTE)
@pytest.mark.parametrize("rd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("loader", DW_LOADERS)
def test_dw_pack_kernel_matches_plain(loader, rd, cd):
    """The reductions' pack pass alone (lstm_train.dw_pack) at every layer
    against its plain version: z in the packed order and the compute type,
    held as a forward output (1e-5, in bf16 one bf16 step more: the
    lockstep context is summed with FMAs, the plain version rounds each
    product, so a value may round the other way)."""
    dw, args, layers, x0, h0, res = _dw_inputs(loader, 67, rd)
    before = _counts([lstm_train.dw_pack])
    for l in range(layers):
        zp = lstm_train.dw_pack(dw, *args, layer=l, compute_dtype=cd)
        n_in = x0.shape[-1] if l == 0 else 128
        assert zp.dtype == cd and zp.shape == (x0.shape[0] * x0.shape[1], lstm_train.dw_zld(n_in, 128))
        _check([zp], _plains(cd, lambda c: [lstm_train._pack_reference(x0, h0, res, l, 3 if l == 0 else 0, c)]),
               "fwd", cd)
    n, m = before[0]
    assert _counts([lstm_train.dw_pack]) == [(n + layers * (cd != BF), m + layers * (cd == BF))]


def test_bf16_db_sums_the_unrounded_dgates():
    """The bf16 tier's db is Σ dgates, not Σ round(dgates): dgates of
    1 + 2^-9, which bf16 rounds to 1, set the two 2^-9 of the sum apart,
    20 times the reductions' limit; dW rounds, held as every bf16 dW."""
    ps, (xs, h0, c0), _ = _lstm_case(4099, 1, seed=4)
    res = lstm_train.lstm_fwd(ps, xs, h0, c0, BF)
    dg = [torch.full((4099, 30, 512), 1.0 + 2.0 ** -9, device="cuda")]
    exact = dg[0].reshape(-1, 512).double().sum(dim=0)
    rounded = dg[0].bfloat16().reshape(-1, 512).double().sum(dim=0)
    assert (rounded - exact).abs().max().item() > 1e-4 * exact.abs().max().item()
    dps = lstm_train.lstm_dw(ps, xs, h0, res, dg, BF)
    assert _rel(dps[0].b.double(), exact) <= 1e-6
    _check(_wb(dps), _plains(BF, lambda c: _wb(lstm_train._dw_reference(ps, xs, h0, res, dg, c))), "sum", BF,
           unrounded=1)


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
    with pytest.raises(ValueError, match="hidden a multiple of 32 up to 256, got hidden=48"):
        lstm_train.lstm_fwd(ps, xs, h0, c0)


# ------------------------------------- fused_serve (static context) and fused_encode
# Same bound as the no-context tier: 1e-4 on normalized outputs after the
# whole horizon (exact f32 FMAs in another order than cuBLAS).


def _stack(rng, in0, layers, hidden=128):
    ps = []
    for l in range(layers):
        fan = (in0 if l == 0 else hidden) + hidden
        lim = np.sqrt(6 / (fan + 4 * hidden))
        ps.append(LSTMParams(
            torch.tensor(rng.uniform(-lim, lim, size=(fan, 4 * hidden)).astype(np.float32), device="cuda"),
            torch.tensor(rng.normal(size=4 * hidden).astype(np.float32) * 0.1, device="cuda")))
    return ps


def _cuda(rng, shape, scale=1.0):
    return torch.tensor(rng.normal(size=shape).astype(np.float32) * scale, device="cuda")


@pytest.mark.parametrize("cd", COMPUTE)
@pytest.mark.parametrize("ctx_dim", [0, 128, 64])  # C = 64: video-fusion
@pytest.mark.parametrize("layers", [1, 2, 3])
@pytest.mark.parametrize("batch", [1, 257, 4099])
def test_fused_serve_context_tier_matches_plain(batch, layers, ctx_dim, cd):
    rng = np.random.default_rng(layers)
    enc, dec = _stack(rng, 3, layers), _stack(rng, 3 + ctx_dim, layers)
    pw, pb = _cuda(rng, (128, 3), 0.1), _cuda(rng, (3,), 0.1)
    x = _cuda(rng, (batch, 30, 3), 0.1)
    ctx = _cuda(rng, (batch, ctx_dim)) if ctx_dim else None
    before = _counts([fused_lstm.fused_serve])
    out = fused_lstm.fused_serve(enc, dec, pw, pb, x, 30, context=ctx, compute_dtype=cd)
    torch.cuda.synchronize()
    assert _counts([fused_lstm.fused_serve]) == _one_more(before, cd)
    assert out.shape == (batch, 30, 3) and out.dtype == torch.float32
    _check([out], _plains(cd, lambda c: [fused_lstm.fused_serve_reference(enc, dec, pw, pb, x, 30, ctx,
                                                                          compute_dtype=c)]), "serve", cd)


@pytest.mark.parametrize("cd", COMPUTE)
@pytest.mark.parametrize("layers", [1, 2, 3])
@pytest.mark.parametrize("batch", [1, 257, 16387])
def test_fused_encode_matches_plain(batch, layers, cd):
    rng = np.random.default_rng(layers)
    ps = _stack(rng, 3, layers)
    xs = _cuda(rng, (batch, 30, 3), 0.3)
    before = _counts([fused_lstm.fused_encode])
    out = fused_lstm.fused_encode(ps, xs, compute_dtype=cd)
    torch.cuda.synchronize()
    assert _counts([fused_lstm.fused_encode]) == _one_more(before, cd)
    assert out.shape == (batch, 128) and out.dtype == torch.float32
    _check([out], _plains(cd, lambda c: [fused_lstm.fused_encode_reference(ps, xs, c)]), "encode", cd)


def test_serve_and_encode_rows_are_independent():
    rng = np.random.default_rng(4)
    enc, dec = _stack(rng, 3, 2), _stack(rng, 3 + 128, 2)
    pw, pb = _cuda(rng, (128, 3), 0.1), _cuda(rng, (3,), 0.1)
    x, ctx = _cuda(rng, (300, 30, 3), 0.1), _cuda(rng, (300, 128))
    part = slice(70, 131)
    full = fused_lstm.fused_serve(enc, dec, pw, pb, x, 30, context=ctx)
    cut = fused_lstm.fused_serve(enc, dec, pw, pb, x[part].contiguous(), 30, context=ctx[part].contiguous())
    assert torch.equal(full[part], cut)
    assert torch.equal(fused_lstm.fused_encode(enc, x)[part], fused_lstm.fused_encode(enc, x[part].contiguous()))


def test_serve_context_and_encode_never_fall_back_on_card():
    rng = np.random.default_rng(0)
    enc, dec = _stack(rng, 3, 1), _stack(rng, 3 + 6, 1)
    pw, pb = _cuda(rng, (128, 3)), _cuda(rng, (3,))
    with pytest.raises(ValueError, match="ctx_dim % 4"):
        fused_lstm.fused_serve(enc, dec, pw, pb, _cuda(rng, (4, 5, 3)), 3, context=_cuda(rng, (4, 6)))
    with pytest.raises(ValueError, match="hidden % 32"):
        fused_lstm.fused_encode(_stack(rng, 3, 1, hidden=48), _cuda(rng, (4, 5, 3)))


# ------------------------------------------------- the cell and decode kernels
# fused_lstm_cell against lstm_cell within 1e-5 (tests/test_fused_lstm.py:
# one step, exact f32 FMAs in another order); fused_decode against its plain
# version within 1e-4, as fused_serve (the same decoder loop).


@pytest.mark.parametrize("cd", COMPUTE)
@pytest.mark.parametrize("d_in", [3, 128, 131])
@pytest.mark.parametrize("batch", [1, 257, 16383])
@pytest.mark.parametrize("hidden", [128, 40, 100, 272, 1024])
def test_lstm_cell_kernel_matches_plain(hidden, batch, d_in, cd):
    """Every tensor in ``cd``; in bf16 (a --bf16 model's cell) h and c come
    back in bf16, against lstm_cell on the bf16 tensors and on their f32
    widening. Both tiers on the tensor cores (f32 in three-pass TF32) at
    every hidden: widths that are no whole warp tile (40, 100), past 256
    (272, 1024: W streamed past shared memory); at hidden other than 128, x
    and h one element past an aligned address; a repeat bit-equal."""
    rng = np.random.default_rng(d_in + hidden)
    (p,) = _stack(rng, d_in, 1, hidden=hidden)
    p = LSTMParams(p.w.to(cd), p.b.to(cd))
    k = int(hidden != 128)
    x = _cuda(rng, (batch * d_in + k,)).to(cd)[k:].view(batch, d_in)
    h = _cuda(rng, (batch * hidden + k,), 0.5).to(cd)[k:].view(batch, hidden)
    c = _cuda(rng, (batch, hidden), 0.5).to(cd)
    before = _counts([fused_lstm.fused_lstm_cell])
    got = fused_lstm.fused_lstm_cell(p, x, (h, c))
    torch.cuda.synchronize()
    assert _counts([fused_lstm.fused_lstm_cell]) == _one_more(before, cd)
    assert all(g.shape == (batch, hidden) and g.dtype == cd for g in got)
    _check(list(got), _plains(cd, lambda c_: list(lstm_cell(LSTMParams(p.w.to(c_), p.b.to(c_)), x.to(c_),
                                                          (h.to(c_), c.to(c_))))), "cell", cd)
    again = fused_lstm.fused_lstm_cell(p, x, (h, c))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("layers,ctx_dim", [(1, 0), (2, 0), (2, 128), (3, 64)])
@pytest.mark.parametrize("batch", [1, 257, 16383])
def test_fused_decode_kernel_matches_plain(batch, layers, ctx_dim):
    rng = np.random.default_rng(layers + ctx_dim)
    dec = _stack(rng, 3 + ctx_dim, layers)
    pw, pb = _cuda(rng, (128, 3), 0.1), _cuda(rng, (3,), 0.1)
    h0, c0 = _cuda(rng, (layers, batch, 128), 0.3), _cuda(rng, (layers, batch, 128), 0.3)
    y0, ctx = _cuda(rng, (batch, 3), 0.1), (_cuda(rng, (batch, ctx_dim)) if ctx_dim else None)
    before = fused_lstm.fused_decode.launches
    out = fused_lstm.fused_decode(dec, pw, pb, h0, c0, y0, 30, context=ctx)
    torch.cuda.synchronize()
    assert fused_lstm.fused_decode.launches == before + 1
    ref = fused_lstm.fused_decode_reference(dec, pw, pb, h0, c0, y0, 30, ctx)
    assert out.shape == (batch, 30, 3) and torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 1e-4


def test_decode_fused_on_the_kernel_cell_equals_fused_serve():
    """seq2seq.decode_fused under cell="pallas" (the encoder on the cell
    kernel, then fused_decode) computes fused_serve's function with the same
    device code for every layer-step."""
    cfg = seq2seq.Seq2SeqConfig(hidden=128, layers=2, h_in=30, h_out=30, cell="pallas")
    args = _args(cfg, 4099, seed=2)
    p = {"encoder": args[0], "decoder": args[1], "proj": {"w": args[2], "b": args[3]}}
    before = (fused_lstm.fused_lstm_cell.launches, fused_lstm.fused_decode.launches)
    out = seq2seq.decode_fused(p, cfg, args[4])
    torch.cuda.synchronize()
    assert (fused_lstm.fused_lstm_cell.launches, fused_lstm.fused_decode.launches) == (before[0] + 60,
                                                                                         before[1] + 1)
    assert (out - fused_lstm.fused_serve(*args)).abs().max().item() <= 1e-4


def test_cell_and_decode_never_fall_back_on_card():
    rng = np.random.default_rng(0)
    (p,) = _stack(rng, 3, 1)
    x, h = _cuda(rng, (4, 3)), _cuda(rng, (4, 128))
    with pytest.raises(RuntimeError, match="no backward"):
        fused_lstm.fused_lstm_cell(p, x.requires_grad_(True), (h, h))
    with pytest.raises(TypeError, match="all float32 or all bfloat16"):
        fused_lstm.fused_lstm_cell(p, x.detach().bfloat16(), (h, h))
    with pytest.raises(ValueError, match="aligned"):
        fused_lstm.fused_lstm_cell(p, x.detach(), (h, torch.empty(4 * 128 + 1, device="cuda")[1:].view(4, 128)))
    # hidden 48, which the FMA design refused (hidden % 32), is taken
    (q,) = _stack(rng, 3, 1, hidden=48)
    h48, c48 = _cuda(rng, (4, 48)), _cuda(rng, (4, 48))
    got = fused_lstm.fused_lstm_cell(q, x.detach(), (h48, c48))
    want = lstm_cell(q, x.detach(), (h48, c48))
    assert all((g - w).abs().max().item() <= 1e-5 for g, w in zip(got, want))
    dec = _stack(rng, 3, 1)
    h0 = _cuda(rng, (1, 4, 128))
    with pytest.raises(RuntimeError, match="no backward"):
        fused_lstm.fused_decode(dec, _cuda(rng, (128, 3)), _cuda(rng, (3,)), h0.requires_grad_(True), h0, x.detach(), 3)


# ------------------------------------------------------------- ss_decode kernels
# Forward: ys within 1e-5 absolute (the feedback is f32 on both sides); the
# residuals as for lstm_seq_states (1e-5, or one bf16 step). Backward, fed
# the same residuals: 1e-4 of max|plain| per output (every reduction sums
# B·T terms in another order).


def _ss_case(batch, layers, ctx_dim, coins, seed, t=30):
    rng = np.random.default_rng(seed)
    ps = _stack(rng, 3 + ctx_dim, layers)
    if coins == "bernoulli":
        c = torch.tensor((rng.random((t, batch, 1)) < 0.5).astype(np.float32), device="cuda")
    else:
        c = torch.full((t, batch, 1), float(coins), device="cuda")
    return ps, dict(
        proj_w=_cuda(rng, (128, 3), 0.1), proj_b=_cuda(rng, (3,), 0.1),
        h0=_cuda(rng, (layers, batch, 128), 0.3), c0=_cuda(rng, (layers, batch, 128), 0.3),
        y0=_cuda(rng, (batch, 3), 0.1), teacher=_cuda(rng, (t, batch, 3), 0.1), coins=c,
        ctx=_cuda(rng, (batch, ctx_dim)) if ctx_dim else None, dys=_cuda(rng, (batch, t, 3)),
    )


def _ss_fwd_args(ps, a):
    return (ps, a["proj_w"], a["proj_b"], a["h0"], a["c0"], a["y0"], a["teacher"], a["coins"], a["ctx"])


def _ss_check(ps, a, layers, ctx_dim, rd, cd):
    """The four ss_decode kernels in the compute type ``cd`` against their
    plain versions, each fed as in chip_smoke.py (the backward the kernel's
    residuals, the reductions the plain dgates and dy)."""
    wrappers = (lstm_ss.ss_fwd, lstm_ss.ss_bwd, lstm_ss.ss_dw, lstm_ss.ss_dproj)
    before = _counts(wrappers)
    ys, res = lstm_ss.ss_fwd(*_ss_fwd_args(ps, a), rd, cd)
    refs = _plains(cd, lambda c: lstm_ss._forward_reference(*_ss_fwd_args(ps, a), rd, c))
    assert all(x.dtype == rd for x in _fwd(res))
    _check([ys] + _fwd(res), [[y] + _fwd(r) for y, r in refs], "fwd", cd)
    args = (ps, a["proj_w"], a["c0"], a["coins"], res, a["dys"], ctx_dim)
    bw = lstm_ss.ss_bwd(*args, cd)
    bws = _plains(cd, lambda c: lstm_ss._bwd_recurrence_reference(*args, compute_dtype=c))
    assert (bw[6] is None) == (ctx_dim == 0)
    _check(_flat(bw), [_flat(b) for b in bws], "rec", cd)
    dw_in = (ps, a["h0"], a["y0"], a["teacher"], a["coins"], a["ctx"], ys, res, bws[0][0])
    _check(_wb(lstm_ss.ss_dw(*dw_in, cd)), _plains(cd, lambda c: _wb(lstm_ss._dw_reference(*dw_in, c))), "sum",
           cd, unrounded=layers)
    _check(list(lstm_ss.ss_dproj(res.hs[-1], bws[0][1], cd)),
           _plains(cd, lambda c: list(lstm_ss._dproj_reference(res.hs[-1], bws[0][1], c))), "sum", cd, unrounded=1)
    assert _counts(wrappers) == _one_more(before, cd)


@pytest.mark.parametrize("cd", COMPUTE)
@pytest.mark.parametrize("rd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layers,ctx_dim", [(1, 0), (2, 128), (3, 128), (2, 64)])  # C = 64: video-fusion
@pytest.mark.parametrize("batch", [1, 257, 4099])
def test_ss_kernels_match_plain(batch, layers, ctx_dim, rd, cd):
    ps, a = _ss_case(batch, layers, ctx_dim, "bernoulli", seed=layers)
    _ss_check(ps, a, layers, ctx_dim, rd, cd)


@pytest.mark.parametrize("cd", COMPUTE)
@pytest.mark.parametrize("coins", ["1", "0"])
def test_ss_kernels_match_plain_at_coin_extremes(coins, cd):
    ps, a = _ss_case(4096, 2, 128, coins, seed=5)
    _ss_check(ps, a, 2, 128, torch.float32, cd)


def test_ss_backward_is_deterministic():
    """No float atomics: the backward recurrence and both reductions give
    the same bits twice."""
    ps, a = _ss_case(4099, 2, 128, "bernoulli", seed=6)
    leaves = [t.clone().requires_grad_(True) for p in ps for t in p]
    ins = [a[k].clone().requires_grad_(True) for k in ("proj_w", "proj_b", "h0", "c0", "y0", "teacher", "ctx")]
    grads = []
    for _ in range(2):
        params = [LSTMParams(leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2)]
        out = lstm_ss.ss_decode(params, *ins[:6], (a["coins"], ins[6]), torch.bfloat16)
        grads.append(torch.autograd.grad((out * a["dys"]).sum(), leaves + ins))
    for x, y in zip(*grads):
        assert torch.equal(x, y)


def test_ss_decode_autograd_matches_the_step_loop():
    ps, a = _ss_case(513, 2, 128, "bernoulli", seed=7)
    grads = {}
    for name, fn in (("kernels", lstm_ss.ss_decode), ("loop", lstm_ss.ss_decode_reference)):
        leaves = [t.clone().requires_grad_(True) for p in ps for t in p]
        ins = [a[k].clone().requires_grad_(True) for k in ("proj_w", "proj_b", "h0", "c0", "y0", "teacher", "ctx")]
        params = [LSTMParams(leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2)]
        out = fn(params, *ins[:6], (a["coins"], ins[6]))
        grads[name] = (out, torch.autograd.grad((out * a["dys"]).sum(), leaves + ins))
    assert (grads["kernels"][0] - grads["loop"][0]).abs().max().item() <= 1e-5
    for x, y in zip(grads["kernels"][1], grads["loop"][1]):
        assert _rel(x, y) <= 1e-4


def test_ss_rows_are_independent():
    ps, a = _ss_case(300, 2, 128, "bernoulli", seed=8)
    part = slice(70, 131)
    sub = {k: (v[:, part] if k in ("h0", "c0", "teacher", "coins") else v[part] if k in ("y0", "ctx", "dys") else v)
           for k, v in a.items()}
    # fresh copies: a row slice of a (B, 3) tensor is not 16-byte aligned
    sub = {k: v.contiguous().clone() for k, v in sub.items()}
    ys, res = lstm_ss.ss_fwd(*_ss_fwd_args(ps, a), torch.bfloat16)
    ys_s, res_s = lstm_ss.ss_fwd(*_ss_fwd_args(ps, sub), torch.bfloat16)
    assert torch.equal(ys[part], ys_s)
    for x, y in zip(res.hs + res.cs + res.gs, res_s.hs + res_s.cs + res_s.gs):
        assert torch.equal(x[part], y)
    full = lstm_ss.ss_bwd(ps, a["proj_w"], a["c0"], a["coins"], res, a["dys"], 128)
    cut = lstm_ss.ss_bwd(ps, sub["proj_w"], sub["c0"], sub["coins"], res_s, sub["dys"], 128)
    for x, y in zip(full[0], cut[0]):
        assert torch.equal(x[part], y)
    assert torch.equal(full[1][part], cut[1]) and torch.equal(full[2][:, part], cut[2])
    assert torch.equal(full[3][part], cut[3]) and torch.equal(full[6][part], cut[6])
    assert torch.equal(full[4][:, part], cut[4]) and torch.equal(full[5][:, part], cut[5])


def test_ss_kernels_never_fall_back_on_card():
    ps, a = _ss_case(4, 1, 6, "1", seed=0, t=3)
    with pytest.raises(ValueError, match="ctx_dim % 4"):
        lstm_ss.ss_fwd(*_ss_fwd_args(ps, a))
    with pytest.raises(ValueError, match="hidden a multiple of 32 up to 256, got hidden=48"):
        lstm_train.fwd_block(48, 1, 3, 4096, mode="static")


# ------------------------------------------- the lockstep-peer tier of fused_serve
# The same bound as the other serve tiers, 1e-4 on normalized outputs after
# the whole horizon; the peer context alone 1e-5 (a bounded state, |h| < 1).


def _peer_case(batch, k, t, seed, masked=True):
    rng = np.random.default_rng(seed)
    peer = _stack(rng, 3, 1)[0]
    pxs = _cuda(rng, (batch, k, t, 3), 0.5)
    m = (rng.random((batch, k)) < 0.6).astype(np.float32)
    if masked:
        m[0] = 0.0  # a row with every peer masked out
    else:
        m[:] = 1.0
    w = torch.tensor(m / np.maximum(m.sum(1, keepdims=True), 1.0), device="cuda")
    return peer, pxs, w


@pytest.mark.parametrize("cd", COMPUTE)
@pytest.mark.parametrize("k", [7, 3, 8, 1])
@pytest.mark.parametrize("batch", [1, 13, 4099])
def test_peer_context_matches_plain(batch, k, cd):
    peer, pxs, w = _peer_case(batch, k, 20, seed=k)
    before = _counts([fused_lstm.peer_context])
    out = fused_lstm.peer_context(peer, pxs, w, compute_dtype=cd)
    torch.cuda.synchronize()
    assert _counts([fused_lstm.peer_context]) == _one_more(before, cd)
    assert out.shape == (batch, 20, 128) and not out[0].any()
    _check([out], _plains(cd, lambda c: [fused_lstm.peer_context_reference(peer, pxs, w, c)]), "ctx", cd)


@pytest.mark.parametrize("cd", COMPUTE)
@pytest.mark.parametrize("layers,k", [(1, 7), (2, 7), (2, 3)])
@pytest.mark.parametrize("batch", [1, 257, 4099])
def test_fused_serve_lockstep_tier_matches_plain(batch, layers, k, cd):
    rng = np.random.default_rng(layers + k)
    enc, dec = _stack(rng, 3, layers), _stack(rng, 3 + 128, layers)
    pw, pb = _cuda(rng, (128, 3), 0.1), _cuda(rng, (3,), 0.1)
    x = _cuda(rng, (batch, 30, 3), 0.1)
    peer, pxs, w = _peer_case(batch, k, 25, seed=layers)
    kw = dict(peer_params=peer, peer_xs=pxs, peer_w=w)
    before = _counts([fused_lstm.fused_serve_peers, fused_lstm.peer_context]) + _counts([fused_lstm.fused_serve])
    out = fused_lstm.fused_serve(enc, dec, pw, pb, x, 25, compute_dtype=cd, **kw)
    torch.cuda.synchronize()
    assert _counts([fused_lstm.fused_serve_peers, fused_lstm.peer_context]) + _counts(
        [fused_lstm.fused_serve]) == _one_more(before[:2], cd) + before[2:]
    assert out.shape == (batch, 25, 3)
    _check([out], _plains(cd, lambda c: [fused_lstm.fused_serve_reference(enc, dec, pw, pb, x, 25, compute_dtype=c,
                                                                          **kw)]), "serve", cd)
    # the all-masked row is the zero-context model on the static tier
    zero = fused_lstm.fused_serve(enc, dec, pw, pb, x[:1].contiguous(), 25,
                                  context=torch.zeros(1, 128, device="cuda"), compute_dtype=cd)
    assert (out[:1] - zero).abs().max().item() <= 1e-6


def test_lockstep_tier_never_falls_back_on_card():
    rng = np.random.default_rng(0)
    enc, dec = _stack(rng, 3, 1), _stack(rng, 3 + 128, 1)
    pw, pb = _cuda(rng, (128, 3)), _cuda(rng, (3,))
    peer, pxs, w = _peer_case(4, 257, 3, seed=0)
    with pytest.raises(ValueError, match="K = 257 peers"):
        fused_lstm.fused_serve(enc, dec, pw, pb, _cuda(rng, (4, 5, 3)), 3, peer_params=peer,
                               peer_xs=pxs, peer_w=w)
    with pytest.raises(ValueError, match="span"):
        fused_lstm.fused_serve(enc, dec, pw, pb, _cuda(rng, (4, 5, 3)), 4, peer_params=peer,
                               peer_xs=pxs, peer_w=w)
    with pytest.raises(ValueError, match="K = 257 peers"):
        lstm_align.peer_fwd(peer, pxs.reshape(4 * 257, 3, 3).contiguous(), w)


# ---------------------------- the bf16 encoders on the tensor cores (lstm_mma.cuh)
# peer_context and fused_encode in bf16 at the widths, depths and peer counts
# their blocks take apart from the serving shapes: W streamed (L >= 2, wide
# H), c in device memory, 16-row tiles, 9 and 5 warps; ragged last blocks.
# The gates of the bf16 tests above; repeats bit-equal; a row's answer does
# not depend on the batch it comes in.


@pytest.mark.parametrize("hidden,layers,batch", [(32, 1, 300), (32, 3, 257), (256, 1, 300), (256, 2, 129),
                                                 (128, 2, 4099), (128, 3, 65), (1024, 3, 33)])
def test_bf16_encode_tensor_core_shapes(hidden, layers, batch):
    rng = np.random.default_rng(hidden + layers)
    ps = _stack(rng, 3, layers, hidden=hidden)
    xs = _cuda(rng, (batch, 12, 3), 0.3)
    before = _counts([fused_lstm.fused_encode])
    out = fused_lstm.fused_encode(ps, xs, compute_dtype=BF)
    torch.cuda.synchronize()
    assert _counts([fused_lstm.fused_encode]) == _one_more(before, BF)
    assert out.shape == (batch, hidden)
    _check([out], _plains(BF, lambda c: [fused_lstm.fused_encode_reference(ps, xs, c)]), "encode", BF)
    assert torch.equal(out, fused_lstm.fused_encode(ps, xs, compute_dtype=BF))
    part = slice(batch // 3, batch // 3 + 37)
    assert torch.equal(out[part], fused_lstm.fused_encode(ps, xs[part].clone(), compute_dtype=BF))


@pytest.mark.parametrize("ctx_dim,k,batch", [(64, 4, 301), (96, 8, 257), (128, 4, 1000), (128, 8, 129),
                                             (32, 3, 300), (128, 9, 70), (1024, 1, 40), (128, 16, 301),
                                             (128, 256, 13)])
def test_bf16_peer_context_tensor_core_shapes(ctx_dim, k, batch):
    rng = np.random.default_rng(ctx_dim + k)
    peer = _stack(rng, 3, 1, hidden=ctx_dim)[0]
    pxs = _cuda(rng, (batch, k, 15, 3), 0.5)
    m = (rng.random((batch, k)) < 0.6).astype(np.float32)
    m[0] = 0.0
    w = torch.tensor(m / np.maximum(m.sum(1, keepdims=True), 1.0), device="cuda")
    before = _counts([fused_lstm.peer_context])
    out = fused_lstm.peer_context(peer, pxs, w, compute_dtype=BF)
    torch.cuda.synchronize()
    assert _counts([fused_lstm.peer_context]) == _one_more(before, BF)
    assert out.shape == (batch, 15, ctx_dim) and not out[0].any()
    _check([out], _plains(BF, lambda c: [fused_lstm.peer_context_reference(peer, pxs, w, c)]), "ctx", BF)
    assert torch.equal(out, fused_lstm.peer_context(peer, pxs, w, compute_dtype=BF))
    part = slice(batch // 3, batch // 3 + 23)
    assert torch.equal(out[part], fused_lstm.peer_context(peer, pxs[part].clone(), w[part].clone(),
                                                          compute_dtype=BF))


def test_bf16_encoders_refuse_the_widest_inputs_on_card():
    """The bf16 encoders' least block, 16 rows of [x, h] in bf16 beside a
    staging row, does not fit the widest inputs (ROADMAP's known
    divergences): a named ValueError, no launch; nor does the f32 tier's
    block of 32 rows in f32, which now runs the same body."""
    hidden, d = 1024, 5209
    ps = [LSTMParams(torch.zeros((d + hidden, 4 * hidden), device="cuda"), torch.zeros(4 * hidden, device="cuda"))]
    xs = torch.zeros((2, 2, d), device="cuda")
    before = _counts([fused_lstm.fused_encode])
    with pytest.raises(ValueError, match="bytes of shared memory"):
        fused_lstm.fused_encode(ps, xs, compute_dtype=BF)
    assert _counts([fused_lstm.fused_encode]) == before
    with pytest.raises(ValueError, match="the f32 encoder's block of 32 rows .* bytes of shared memory"):
        fused_lstm.fused_encode(ps, xs)
    assert _counts([fused_lstm.fused_encode]) == before
    peer = LSTMParams(torch.zeros((7000 + hidden, 4 * hidden), device="cuda"), torch.zeros(4 * hidden, device="cuda"))
    with pytest.raises(ValueError, match="do not fit the bf16 peer context's block"):
        fused_lstm.peer_context(peer, torch.zeros((2, 1, 2, 7000), device="cuda"), torch.ones((2, 1), device="cuda"),
                                compute_dtype=BF)


# ------------------------------------------------------- aligned_ss_decode kernels
# The bounds of the ss_decode kernels: forward 1e-5 (or one bf16 step on bf16
# residuals), backward and reductions 1e-4 of max|plain| per output.


def _aligned_case(batch, layers, k, coins, seed, t=30, masked=True):
    ps, a = _ss_case(batch, layers, 128, coins, seed, t)
    peer, pxs, w = _peer_case(batch, k, t, seed, masked)
    a.update(peer=peer, pwt=w, pxs=pxs.reshape(batch * k, t, 3).contiguous())
    return ps, a


def _aligned_check(batch, layers, k, rd, coins, seed=0, cd=torch.float32, t=30):
    """The six aligned_ss_decode kernels in the compute type ``cd`` against
    their plain versions, each fed the plain version's inputs from the
    kernel before it, as in chip_smoke.py."""
    ps, a = _aligned_case(batch, layers, k, coins, seed, t)
    wrappers = (lstm_align.peer_fwd, lstm_align.dec_fwd, lstm_align.dec_bwd, lstm_align.peer_bwd,
                lstm_align.dec_dw, lstm_align.peer_dw)
    before = _counts(wrappers)
    php, pcp, ctx = lstm_align.peer_fwd(a["peer"], a["pxs"], a["pwt"], rd, cd)
    prefs = _plains(cd, lambda c: list(lstm_align._peer_fwd_reference(a["peer"], a["pxs"], a["pwt"], rd, c)))
    _check([php, pcp, ctx], prefs, "fwd", cd)
    args = (ps, a["proj_w"], a["proj_b"], a["h0"], a["c0"], a["y0"], a["teacher"], a["coins"], prefs[0][2])
    ys, res = lstm_align.dec_fwd(*args, rd, cd)
    refs = _plains(cd, lambda c: lstm_ss._forward_reference(*args, rd, c))
    assert all(x.dtype == rd for x in [php, pcp] + _fwd(res))
    _check([ys] + _fwd(res), [[y] + _fwd(r) for y, r in refs], "fwd", cd)
    bargs = (ps, a["proj_w"], a["c0"], a["coins"], res, a["dys"], 128)
    bws = _plains(cd, lambda c: lstm_ss._bwd_recurrence_reference(*bargs, step_ctx=True, compute_dtype=c))
    _check(_flat(lstm_align.dec_bwd(*bargs, cd)), [_flat(b) for b in bws], "rec", cd)
    pargs = (a["peer"], a["pxs"], a["pwt"], php, pcp, bws[0][6])
    pbs = _plains(cd, lambda c: list(lstm_align._peer_bwd_reference(*pargs, c)))
    _check(list(lstm_align.peer_bwd(*pargs, cd)), pbs, "rec", cd, unrounded=1)
    dw_in = (ps, a["h0"], a["y0"], a["teacher"], a["coins"], a["pwt"], php, ys, res, bws[0][0])
    _check(_wb(lstm_align.dec_dw(*dw_in, cd)), _plains(cd, lambda c: _wb(lstm_align._dw_reference(*dw_in, c))),
           "ctx_sum", cd, unrounded=layers)
    pdw_in = (a["peer"], a["pxs"], php, pbs[0][0])
    _check(_wb([lstm_align.peer_dw(*pdw_in, cd)]),
           _plains(cd, lambda c: _wb([lstm_align._peer_dw_reference(*pdw_in, c)])), "sum", cd, unrounded=1)
    assert _counts(wrappers) == _one_more(before, cd)


@pytest.mark.parametrize("cd", COMPUTE)
@pytest.mark.parametrize("rd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layers,k", [(1, 3), (2, 7)])
@pytest.mark.parametrize("batch", [1, 257, 4099])
def test_aligned_kernels_match_plain(batch, layers, k, rd, cd):
    _aligned_check(batch, layers, k, rd, "bernoulli", seed=layers, cd=cd)


@pytest.mark.parametrize("cd", COMPUTE)
@pytest.mark.parametrize("rd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 7])
def test_aligned_kernels_match_plain_at_10s_shapes(k, rd, cd):
    """stacked-ss-crossuser-10s's shapes (T = 100, C = 128, two layers) at
    K = 1 and 7 and a ragged batch."""
    _aligned_check(67, 2, k, rd, "bernoulli", seed=k, cd=cd, t=100)


@pytest.mark.parametrize("cd", COMPUTE)
@pytest.mark.parametrize("coins", ["1", "0"])
def test_aligned_kernels_match_plain_at_coin_extremes(coins, cd):
    _aligned_check(1000, 2, 7, torch.bfloat16, coins, seed=3, cd=cd)


def test_bf16_compute_backward_is_deterministic():
    """Two runs of ss_decode's bf16-compute kernels give the same bits."""
    ps, a = _ss_case(4096, 2, 128, "bernoulli", seed=6)
    out = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_(True) for p in ps for t in p]
        params = [LSTMParams(leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2)]
        ys = lstm_ss.ss_decode(params, a["proj_w"], a["proj_b"], a["h0"], a["c0"], a["y0"], a["teacher"],
                               (a["coins"], a["ctx"]), compute_dtype=BF)
        out.append([ys] + list(torch.autograd.grad((ys * a["dys"]).sum(), leaves)))
    assert all(torch.equal(x, y) for x, y in zip(*out))


def test_aligned_ss_decode_autograd_matches_the_step_loop():
    """The autograd function through every kernel against autograd of the
    step loop, on every input that takes a gradient (f32 residuals)."""
    ps, a = _aligned_case(301, 2, 7, "bernoulli", seed=9)
    pxs_tm = a["pxs"].reshape(301, 7, 30, 3).permute(2, 0, 1, 3).reshape(30, 301, 21).contiguous()
    grads = {}
    for name, fn in (("kernels", lstm_align.aligned_ss_decode),
                     ("loop", lstm_align.aligned_ss_decode_reference)):
        leaves = [t.clone().requires_grad_(True) for p in ps for t in p]
        ins = [x.clone().requires_grad_(True) for x in (a["proj_w"], a["proj_b"], *a["peer"], a["h0"],
                                                         a["c0"], a["y0"], a["teacher"], pxs_tm, a["pwt"])]
        params = [LSTMParams(leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2)]
        out = fn(params, ins[0], ins[1], LSTMParams(ins[2], ins[3]), *ins[4:9], (a["coins"], ins[9]))
        grads[name] = (out, torch.autograd.grad((out * a["dys"]).sum(), leaves + ins))
    assert (grads["kernels"][0] - grads["loop"][0]).abs().max().item() <= 1e-5
    for x, y in zip(grads["kernels"][1], grads["loop"][1]):
        assert _rel(x, y) <= 1e-4


def test_aligned_backward_is_deterministic():
    ps, a = _aligned_case(1000, 2, 7, "bernoulli", seed=10)
    pxs_tm = a["pxs"].reshape(1000, 7, 30, 3).permute(2, 0, 1, 3).reshape(30, 1000, 21).contiguous()
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_(True) for p in ps for t in p] + [
            t.clone().requires_grad_(True) for t in a["peer"]]
        params = [LSTMParams(leaves[i], leaves[i + 1]) for i in range(0, 2 * len(ps), 2)]
        out = lstm_align.aligned_ss_decode(params, a["proj_w"], a["proj_b"], LSTMParams(*leaves[-2:]),
                                           a["h0"], a["c0"], a["y0"], a["teacher"], pxs_tm,
                                           (a["coins"], a["pwt"]), torch.bfloat16)
        runs.append(torch.autograd.grad((out * a["dys"]).sum(), leaves))
    for x, y in zip(*runs):
        assert torch.equal(x, y)


# ----------------------------------------- the peer backward and dproj on the tensor cores
# The peer backward's products run on mma.sync (three-pass TF32 in f32, bf16
# in bf16) in blocks of 16-row warps, and dproj on 16-byte loads in slices:
# both at shapes whose rows are not a multiple of a block or a slice, at
# every width the peer backward takes, each held to the gates above ("rec",
# "sum"; dpwt and dproj_b unrounded sums).


def _peer_bwd_case(batch, k, t, c, rd, seed):
    """A peer cell of width C, windows, mask weights (row 0 all masked), the
    plain forward's residuals in ``rd`` and an upstream dctx."""
    rng = np.random.default_rng(seed)
    peer = _stack(rng, 3, 1, hidden=c)[0]
    pxs = _cuda(rng, (batch * k, t, 3), 0.5)
    m = (rng.random((batch, k)) < 0.6).astype(np.float32)
    m[0] = 0.0
    pwt = torch.tensor(m / np.maximum(m.sum(1, keepdims=True), 1.0), device="cuda")
    php, pcp, _ = lstm_align._peer_fwd_reference(peer, pxs, pwt, rd)
    return peer, pxs, pwt, php, pcp, _cuda(rng, (batch, t, c), 0.1)


@pytest.mark.parametrize("cd", COMPUTE)
@pytest.mark.parametrize("rd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", lstm_align.PEER_BWD_CTX)
@pytest.mark.parametrize("t", [1, 100])
@pytest.mark.parametrize("k", [1, 7, 8])
def test_peer_bwd_matches_plain_at_ragged_rows(k, t, c, rd, cd):
    args = _peer_bwd_case(67, k, t, c, rd, seed=k + t + c)
    before = _counts([lstm_align.peer_bwd])
    out = list(lstm_align.peer_bwd(*args, cd))
    torch.cuda.synchronize()
    assert _counts([lstm_align.peer_bwd]) == _one_more(before, cd)
    _check(out, _plains(cd, lambda x: list(lstm_align._peer_bwd_reference(*args, x))), "rec", cd, unrounded=1)


@pytest.mark.parametrize("cd", COMPUTE)
@pytest.mark.parametrize("rd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [64, 96, 128, 160])  # 96 and 160: threads past the last row group idle
@pytest.mark.parametrize("d", [1, 3, 4])
def test_dproj_matches_plain_at_ragged_slices(d, h, rd, cd):
    rng = np.random.default_rng(d + h)
    for batch, t in ((4099, 30), (257, 1)):
        hs_top, dy = _cuda(rng, (batch, t, h), 0.5).to(rd), _cuda(rng, (batch, t, d))
        before = _counts([lstm_ss.ss_dproj])
        out = list(lstm_ss.ss_dproj(hs_top, dy, cd))
        assert _counts([lstm_ss.ss_dproj]) == _one_more(before, cd)
        _check(out, _plains(cd, lambda x: list(lstm_ss._dproj_reference(hs_top, dy, x))), "sum", cd, unrounded=1)


@pytest.mark.parametrize("cd", COMPUTE)
def test_peer_bwd_and_dproj_repeat_bit_equal(cd):
    """stacked-ss-crossuser-10s's peer rows (B = 4096, K = 7, T = 100) and
    its decoder's dproj rows: two runs of each give the same bits."""
    args = _peer_bwd_case(4096, 7, 100, 128, torch.bfloat16, seed=1)
    first = lstm_align.peer_bwd(*args, cd)
    assert all(torch.equal(x, y) for x, y in zip(first, lstm_align.peer_bwd(*args, cd)))
    rng = np.random.default_rng(2)
    hs_top, dy = _cuda(rng, (4096, 100, 128), 0.5).bfloat16(), _cuda(rng, (4096, 100, 3))
    first = lstm_ss.ss_dproj(hs_top, dy, cd)
    assert all(torch.equal(x, y) for x, y in zip(first, lstm_ss.ss_dproj(hs_top, dy, cd)))


def test_peer_bwd_one_pass_tf32_build_fails_the_gate():
    """The f32 peer backward's products are three-pass TF32: a build that
    drops the two small terms (-DPEER_ONE_PASS, products of 11-bit
    operands) is held to the same gate, 1e-4 of max|plain|, and fails it
    where the three-pass kernel passes."""
    import ctypes

    from longterm360fov_tpu_torch.ops import _build

    args = _peer_bwd_case(67, 7, 100, 128, torch.float32, seed=3)
    lib = lstm_align.bind(ctypes.CDLL(str(_build.build("lstm_align", ("PEER_ONE_PASS",)).path)))
    ref = lstm_align._peer_bwd_reference(*args)
    gap = [((x - y).abs().max() / y.abs().max()).item() for x, y in
           zip(lstm_align.launch_peer_bwd(lib, *args, torch.float32), ref)]
    three = [((x - y).abs().max() / y.abs().max()).item() for x, y in zip(lstm_align.peer_bwd(*args), ref)]
    assert max(three) <= 1e-4 < max(gap)


def test_peer_bwd_launch_shape_is_the_kernels():
    """The library's sizes, from which the wrapper takes its launch: every
    width the wrapper takes has a block of 4 warps that fits shared memory
    in every type pair, and a weight stream; at stacked-ss-crossuser-10s's
    28,672 peer rows the wrapper takes 7 warps a block, but for f32 compute
    on f32 residuals, whose 7-warp block does not fit (5); widths it does
    not take are refused."""
    lib = lstm_align._library()
    for c in lstm_align.PEER_BWD_CTX:
        for cd in COMPUTE:
            assert lib.peer_bwd_stream_bytes(c, int(cd == BF)) > 0
            for rd in (torch.float32, BF):
                assert 0 < lib.peer_bwd_smem(c, 4, int(rd == BF), int(cd == BF)) <= 232448
                fits = [w for w in range(4, 9) if lib.peer_bwd_smem(c, w, int(rd == BF), int(cd == BF)) <= 232448]
                if c == 128:
                    assert lstm_align.peer_bwd_warps(28672, c, 3, fits, 132) == (
                        5 if rd == cd == torch.float32 else 7)
    assert lib.peer_bwd_smem(160, 4, 1, 0) == -1 and lib.peer_bwd_stream_bytes(160, 0) == -1


# ------------------------------------- the 10 s training recurrences on the tensor cores
# The decoder backward (csrc/lstm_common.cuh ss_bwd_kernel: row 6's static
# context through ss_bwd, row 7's per-step context through dec_bwd; three-pass
# TF32 or bf16 mma) and the lockstep peer forward (peer_fwd on lstm_mma.cuh's
# encoder) at the shapes their blocks take, held to the gates above ("rec",
# "fwd"): the 10 s shape cut in B, K = 1..8, C = 32..128 and 0, coins at 0, 1
# and Bernoulli, both compute and residual types; repeats bit-equal; a
# permuted batch gives the permuted answer bit for bit; the shapes they
# refuse raise ValueError naming them.


def _bwd_case(batch, layers, c, coins, seed, t, step, rd):
    """The backward recurrence's arguments: _ss_case's decoder, its context
    (per step when ``step``), and the plain forward's residuals in ``rd``."""
    ps, a = _ss_case(batch, layers, c, coins, seed, t)
    rng = np.random.default_rng(seed + 1)
    ctx = _cuda(rng, (batch, t, c), 0.5) if step else a["ctx"]
    res = lstm_ss._forward_reference(ps, a["proj_w"], a["proj_b"], a["h0"], a["c0"], a["y0"], a["teacher"],
                                     a["coins"], ctx, rd)[1]
    return ps, a["proj_w"], a["c0"], a["coins"], res, a["dys"], c


@pytest.mark.parametrize("cd", COMPUTE)
@pytest.mark.parametrize("rd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("step,layers,c,coins,batch,t", [
    (True, 2, 128, "bernoulli", 67, 100),  # the 10 s shape cut in B
    (True, 2, 32, "1", 301, 30), (True, 1, 96, "0", 33, 30), (True, 3, 64, "bernoulli", 100, 30),
    (False, 2, 128, "0", 257, 30), (False, 2, 64, "1", 257, 30),  # row 6: stacked-ss-crossuser, video-fusion
    (False, 1, 0, "bernoulli", 31, 30),  # no context: no dctx n-tile
])
def test_ss_bwd_tensor_core_shapes(step, layers, c, coins, batch, t, rd, cd):
    args = _bwd_case(batch, layers, c, coins, seed=layers + c, t=t, step=step, rd=rd)
    kernel = lstm_align.dec_bwd if step else lstm_ss.ss_bwd
    before = _counts([kernel])
    out = kernel(*args, cd)
    again = kernel(*args, cd)
    torch.cuda.synchronize()
    assert _counts([kernel]) == [(n + 2 * (cd != BF), m + 2 * (cd == BF)) for n, m in before]
    refs = _plains(cd, lambda x: lstm_ss._bwd_recurrence_reference(*args, step_ctx=step, compute_dtype=x))
    assert (out[6] is None) == (c == 0)
    _check(_flat(out), [_flat(r) for r in refs], "rec", cd)
    assert all(torch.equal(x, y) for x, y in zip(_flat(out), _flat(again)))


@pytest.mark.parametrize("rd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("step", [False, True])
def test_ss_bwd_two_k_pair_ring_matches_plain(step, rd):
    """A bf16 stack of 4 layers (C = 128) leaves no room for the W ring of
    4 k-pairs and runs the instance whose ring is 2 deep: against the plain
    version, repeats bit-equal. (The f32 tier's ring-2 instance, at 3
    layers, runs in test_ss_kernels_match_plain and
    test_ss_bwd_tensor_core_shapes.)"""
    assert lstm_ss.bwd_block(128, 4, 3, 128, BF, step).stages == 2
    args = _bwd_case(65, 4, 128, "bernoulli", seed=4, t=20, step=step, rd=rd)
    kernel = lstm_align.dec_bwd if step else lstm_ss.ss_bwd
    out = kernel(*args, BF)
    again = kernel(*args, BF)
    refs = _plains(BF, lambda x: lstm_ss._bwd_recurrence_reference(*args, step_ctx=step, compute_dtype=x))
    _check(_flat(out), [_flat(r) for r in refs], "rec", BF)
    assert all(torch.equal(x, y) for x, y in zip(_flat(out), _flat(again)))


@pytest.mark.parametrize("cd", COMPUTE)
@pytest.mark.parametrize("step", [False, True])
def test_ss_bwd_permuted_batch_gives_the_permuted_answer(step, cd):
    """Rows are independent and each row's sums run in a fixed order: a
    permuted batch (across the 32-row blocks) gives the permuted gradients
    bit for bit."""
    batch, t = 300, 30
    args = _bwd_case(batch, 2, 128, "bernoulli", seed=8, t=t, step=step, rd=BF)
    ps, proj_w, c0, coins, res, dys, c = args
    perm = torch.randperm(batch, generator=torch.Generator().manual_seed(0)).cuda()
    res_p = lstm_train.Residuals(*[[x[perm] for x in part] for part in res])
    kernel = lstm_align.dec_bwd if step else lstm_ss.ss_bwd
    full = kernel(*args, cd)
    cut = kernel(ps, proj_w, c0[:, perm], coins[:, perm], res_p, dys[perm], c, cd)
    assert all(torch.equal(x[perm], y) for x, y in zip(full[0], cut[0]))
    assert torch.equal(full[1][perm], cut[1]) and torch.equal(full[2][:, perm], cut[2])
    assert torch.equal(full[3][perm], cut[3]) and torch.equal(full[6][perm], cut[6])
    assert torch.equal(full[4][:, perm], cut[4]) and torch.equal(full[5][:, perm], cut[5])


@pytest.mark.parametrize("cd", COMPUTE)
@pytest.mark.parametrize("rd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,c,batch,t", [(7, 128, 67, 100), (1, 128, 13, 20), (2, 32, 301, 30), (3, 96, 100, 30),
                                         (4, 64, 257, 30), (5, 128, 40, 30), (6, 64, 19, 30), (8, 128, 257, 30),
                                         (16, 128, 67, 30), (256, 128, 5, 20)])
def test_peer_fwd_tensor_core_shapes(k, c, batch, t, rd, cd):
    """The peer forward at K = 1..8, 16 and 256 and C = 32..128: h and c (residual
    type) and ctx against the plain version ("fwd": 1e-5, or one bf16 step
    on a bf16 value), a row with every peer masked, repeats bit-equal."""
    rng = np.random.default_rng(k + c)
    peer = _stack(rng, 3, 1, hidden=c)[0]
    _, pxs, w = _peer_case(batch, k, t, seed=k + c)
    pxs = pxs.reshape(batch * k, t, 3).contiguous()
    before = _counts([lstm_align.peer_fwd])
    out = lstm_align.peer_fwd(peer, pxs, w, rd, cd)
    again = lstm_align.peer_fwd(peer, pxs, w, rd, cd)
    torch.cuda.synchronize()
    assert _counts([lstm_align.peer_fwd]) == [(n + 2 * (cd != BF), m + 2 * (cd == BF)) for n, m in before]
    assert out[0].dtype == out[1].dtype == rd and not out[2][0].any()
    _check(list(out), _plains(cd, lambda x: list(lstm_align._peer_fwd_reference(peer, pxs, w, rd, x))), "fwd", cd)
    assert all(map(torch.equal, out, again))


def test_training_recurrences_refuse_what_their_blocks_do_not_take():
    """Each shape the bodies do not take raises ValueError naming it, on the
    card too (no fall-back): the backward at hidden 288, a context not of
    whole n8 tiles, d = 9 (an f32 stack of 4 layers, refused before, now
    runs in 16-row blocks); the peer forward at ctx_dim 160, d = 9, K = 257."""
    rng = np.random.default_rng(0)
    ps = _stack(rng, 3 + 128, 4)
    a = _ss_case(4, 4, 128, "1", seed=0, t=3)[1]
    res = lstm_ss._forward_reference(ps, a["proj_w"], a["proj_b"], a["h0"], a["c0"], a["y0"], a["teacher"],
                                     a["coins"], a["ctx"], torch.float32)[1]
    assert lstm_ss.bwd_block(128, 4, 3, 128).rows == 16
    for cd in COMPUTE:
        assert lstm_ss.ss_bwd(ps, a["proj_w"], a["c0"], a["coins"], res, a["dys"], 128, cd)[0][0].is_cuda
    for hidden, c, d, match in ((288, 0, 3, "got hidden=288"), (128, 12, 3, "got ctx_dim=12"),
                                (128, 0, 9, "got d=9")):
        with pytest.raises(ValueError, match=match):
            lstm_ss.bwd_block(hidden, 2, d, c)
    peer = _stack(rng, 3, 1, hidden=160)[0]
    with pytest.raises(ValueError, match="ctx_dim in .*got 160"):
        lstm_align.peer_fwd(peer, _cuda(rng, (14, 5, 3)), torch.full((2, 7), 1 / 7, device="cuda"))
    peer = _stack(rng, 9, 1)[0]
    with pytest.raises(ValueError, match="1 <= d <= 8 window features"):
        lstm_align.peer_fwd(peer, _cuda(rng, (14, 5, 9)), torch.full((2, 7), 1 / 7, device="cuda"))
    peer = _stack(rng, 3, 1)[0]
    with pytest.raises(ValueError, match="K = 257 peers"):
        lstm_align.peer_fwd(peer, _cuda(rng, (514, 5, 3)), torch.full((2, 257), 1 / 257, device="cuda"))


# ------------------ row 4 f32 (fused_encode on three-pass TF32) and row 5's backward on the tensor cores
# fused_encode's f32 tier is lstm_mma.cuh's encoder on Tf32Mma (the f32 peer
# context's body): its top-layer h within 1e-5 of the plain version (the
# "encode" gate), at the crossuser peer encoder's width and at the depths and
# widths its blocks take apart from it. lstm_seq_states' backward is
# ss_bwd_kernel's teacher-forced mode in both compute tiers: every output
# within the backward gates ("rec": 1e-4 of max|plain| in f32; bf16 1e-2 of
# its bf16 plain version and 6 % of the f32 one, and the floor), fed random
# upstream dhs_top, dhT and dcT; repeats and permuted batches bit-equal.


def _perm(n, seed=0):
    return torch.randperm(n, generator=torch.Generator().manual_seed(seed)).cuda()


@pytest.mark.parametrize("hidden,layers,batch,t", [
    (128, 1, 4099, 30),  # the crossuser peer encoder (4·B rows), cut in B
    (64, 1, 1000, 30),   # a peer encoder of ctx_dim 64: 128-row blocks
    (128, 2, 257, 30), (128, 3, 130, 12),  # c in device memory at 3
    (32, 1, 300, 12), (256, 1, 129, 12), (128, 8, 40, 5),
])
def test_f32_encode_tensor_core_shapes(hidden, layers, batch, t):
    rng = np.random.default_rng(hidden + layers)
    ps = _stack(rng, 3, layers, hidden=hidden)
    xs = _cuda(rng, (batch, t, 3), 0.3)
    before = _counts([fused_lstm.fused_encode])
    out = fused_lstm.fused_encode(ps, xs)
    again = fused_lstm.fused_encode(ps, xs)
    torch.cuda.synchronize()
    assert _counts([fused_lstm.fused_encode]) == [(n + 2, m) for n, m in before]
    assert out.shape == (batch, hidden) and out.dtype == torch.float32
    _check([out], [[fused_lstm.fused_encode_reference(ps, xs)]], "encode", torch.float32)
    assert torch.equal(out, again)
    perm = _perm(batch)
    assert torch.equal(out[perm], fused_lstm.fused_encode(ps, xs[perm]))


def test_f32_encode_refuses_what_it_does_not_take():
    """hidden not a multiple of 32, and a block of 32 rows past shared
    memory (the FMA body took it in 8-row blocks): a named ValueError, no
    launch."""
    rng = np.random.default_rng(0)
    before = _counts([fused_lstm.fused_encode])
    with pytest.raises(ValueError, match="f32 encoder needs hidden % 32 == 0, got 48"):
        fused_lstm.fused_encode(_stack(rng, 3, 1, hidden=48), _cuda(rng, (4, 5, 3)))
    wide = [LSTMParams(torch.zeros((2 * 1024, 4096), device="cuda"), torch.zeros(4096, device="cuda"))] * 3
    wide[0] = LSTMParams(torch.zeros((3 + 1024, 4096), device="cuda"), torch.zeros(4096, device="cuda"))
    with pytest.raises(ValueError, match="d=3, hidden=1024, layers=3: the f32 encoder's block of 32 rows"):
        fused_lstm.fused_encode(wide, torch.zeros((2, 2, 3), device="cuda"))
    assert _counts([fused_lstm.fused_encode]) == before


def _bwd_args(batch, layers, seed, t, d, h, rd, fwd=True):
    """lstm_bwd's arguments: residuals from the forward kernel in ``rd`` (or,
    ``fwd`` False, from its plain version: a shape no kernel takes),
    random upstream dhs_top, dhT and dcT."""
    ps, (xs, h0, c0), up = _lstm_case(batch, layers, seed, t=t, d=d, h=h)
    forward = lstm_train.lstm_fwd if fwd else lstm_train._forward_reference
    return ps, c0, forward(ps, xs, h0, c0, rd), up


@pytest.mark.parametrize("cd", COMPUTE)
@pytest.mark.parametrize("rd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden,layers,d,batch,t", [
    (128, 1, 3, 4099, 30),   # seq2seq-tf-30's encoder and decoder
    (128, 2, 3, 300, 100),   # the 10 s encoder (f32 residuals there), cut in B
    (128, 1, 3, 1031, 30),   # the crossuser peer encoders through lstm_seq, K·B rows
    (64, 1, 3, 300, 30),     # a peer encoder of ctx_dim 64: 8 warps
    (128, 2, 67, 257, 30),   # video-fusion's teacher-forced decoder, D = 3 + 64
    (128, 2, 131, 257, 30),  # the crossuser teacher-forced decoder, D = 3 + 128
    (128, 3, 3, 65, 12),     # f32: the ring of 2 k-pairs
    (32, 1, 9, 33, 12),      # one narrow column and one wide n-tile
    (256, 1, 3, 300, 12),    # hidden 256: two unit blocks a warp, 16-row blocks
    (160, 2, 3, 65, 8),      # 10 warps: a ragged feedback row split
    (192, 2, 131, 33, 6),
    (256, 2, 264, 33, 6),    # the widest input: 8 narrow columns and 32 wide n-tiles
    (128, 8, 3, 65, 8),      # the deepest stack: 16-row blocks
    (96, 4, 3, 65, 8),       # 12 warps (the feedback's ragged rows)
])
def test_lstm_bwd_tensor_core_shapes(hidden, layers, d, batch, t, rd, cd):
    ps, c0, res, up = _bwd_args(batch, layers, hidden + d, t, d, hidden, rd)
    assert all(u.abs().max() > 0 for u in up)  # dhs_top, dhT and dcT all nonzero
    before = _counts([lstm_train.lstm_bwd])
    out = lstm_train.lstm_bwd(ps, c0, res, *up, compute_dtype=cd)
    again = lstm_train.lstm_bwd(ps, c0, res, *up, compute_dtype=cd)
    torch.cuda.synchronize()
    assert _counts([lstm_train.lstm_bwd]) == [(n + 2 * (cd != BF), m + 2 * (cd == BF)) for n, m in before]
    assert out[1].shape == (batch, t, d) and out[2].shape == out[3].shape == (layers, batch, hidden)
    refs = _plains(cd, lambda c: lstm_train._bwd_recurrence_reference(ps, c0, res, *up, c))
    _check(_flat(out), [_flat(r) for r in refs], "rec", cd)
    assert all(torch.equal(x, y) for x, y in zip(_flat(out), _flat(again)))


@pytest.mark.parametrize("cd", COMPUTE)
@pytest.mark.parametrize("d", [3, 131])
def test_lstm_bwd_permuted_batch_gives_the_permuted_answer(d, cd):
    """Rows are independent and each row's sums run in a fixed order: a
    permuted batch (across the 32-row blocks) gives the permuted gradients
    bit for bit."""
    batch = 300
    ps, c0, res, (dhs, dhT, dcT) = _bwd_args(batch, 2, 5, 30, d, 128, torch.bfloat16)
    perm = _perm(batch)
    res_p = lstm_train.Residuals(*[[x[perm] for x in part] for part in res])
    full = lstm_train.lstm_bwd(ps, c0, res, dhs, dhT, dcT, cd)
    cut = lstm_train.lstm_bwd(ps, c0[:, perm], res_p, dhs[perm], dhT[:, perm], dcT[:, perm], cd)
    assert all(torch.equal(x[perm], y) for x, y in zip(full[0], cut[0]))
    assert torch.equal(full[1][perm], cut[1])
    assert torch.equal(full[2][:, perm], cut[2]) and torch.equal(full[3][:, perm], cut[3])


@pytest.mark.parametrize("h,layers,d,cd,match", [
    # the shapes the FMA backward took that the tensor-core body takes again
    (256, 1, 3, torch.float32, None),
    (160, 2, 3, BF, None),
    (128, 4, 3, torch.float32, None),  # refused before: 16-row blocks now
    (128, 8, 3, BF, None),
    # still refused, before any launch
    (288, 1, 3, torch.float32, "got hidden=288"),
    (128, 1, 137, BF, "got d=137"),
    (256, 4, 3, torch.float32, r"at d=3 \(3 \+ 0 input columns\): layers=4, hidden=256"),
])
def test_lstm_bwd_refuses_what_its_block_does_not_take(h, layers, d, cd, match):
    """Shapes the FMA backward took: those ss_bwd_kernel's teacher-forced
    mode takes again (hidden up to 256, deep stacks in 16-row blocks) run;
    those it does not (hidden above 256, an input wider than hidden + 8, an
    f32 stack of 4 layers at hidden 256) each raise a ValueError naming
    them, before any launch."""
    ps, c0, res, up = _bwd_args(5, layers, 0, 3, d, h, torch.float32, fwd=match is None)
    before = _counts([lstm_train.lstm_bwd])
    if match is None:
        assert lstm_train.lstm_bwd(ps, c0, res, *up, compute_dtype=cd)[0][0].is_cuda
        assert _counts([lstm_train.lstm_bwd]) == _one_more(before, cd)
        return
    with pytest.raises(ValueError, match=match):
        lstm_train.lstm_bwd(ps, c0, res, *up, compute_dtype=cd)
    assert _counts([lstm_train.lstm_bwd]) == before


# ------------- the training forwards on the tensor cores, and the widths the backward takes again
# lstm_seq_states' forward and the scheduled-sampling decoders' (static and
# per-step context) run csrc/lstm_common.cuh's train_fwd_kernel: three-pass
# TF32 in f32, bf16 mma.sync in bf16. Their outputs within the "fwd" gate
# (1e-5 absolute, or one bf16 step on a bf16 residual) of the plain version,
# at the widths and depths the backward takes (hidden up to 256, 8 layers),
# at the training batch with a partial block past it and with c in device
# memory; repeats bit-equal. The backward, fed the kernel's residuals, at
# the same shapes within the "rec" gate.


@pytest.mark.parametrize("cd", COMPUTE)
@pytest.mark.parametrize("rd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden,layers,d,batch,t", [
    (128, 1, 3, 4100, 4),   # the training batch and a partial block past it
    (128, 8, 3, 65, 6),     # the deepest stack: f32 c in device memory
    (256, 2, 3, 100, 8),    # the widest hidden
    (160, 1, 131, 33, 5),   # a wide input in whole k-steps, d = 3 + C
    (256, 1, 264, 40, 4),   # the widest input the backward takes
    (32, 3, 1, 70, 9),
])
def test_lstm_fwd_tensor_core_shapes(hidden, layers, d, batch, t, rd, cd):
    ps, (xs, h0, c0), _ = _lstm_case(batch, layers, seed=hidden + d, t=t, d=d, h=hidden)
    before = _counts([lstm_train.lstm_fwd])
    res = lstm_train.lstm_fwd(ps, xs, h0, c0, rd, cd)
    again = lstm_train.lstm_fwd(ps, xs, h0, c0, rd, cd)
    torch.cuda.synchronize()
    assert _counts([lstm_train.lstm_fwd]) == [(n + 2 * (cd != BF), m + 2 * (cd == BF)) for n, m in before]
    geo = lstm_train.fwd_block(hidden, layers, d, batch, cd)
    assert geo.rp == 32
    assert lstm_train._library().lstm_fwd_smem(geo.rp, d, hidden, layers, int(geo.c_smem), int(cd == BF)) == geo.smem
    refs = _plains(cd, lambda c: lstm_train._forward_reference(ps, xs, h0, c0, rd, c))
    assert all(x.dtype == rd for x in _fwd(res))
    _check(_fwd(res), [_fwd(r) for r in refs], "fwd", cd)
    assert all(map(torch.equal, _fwd(res), _fwd(again)))


def _ss_wide_case(batch, layers, ctx_dim, hidden, seed, t, step, d=3):
    """A decoder of ``hidden`` units and its inputs: bernoulli coins, a
    static (B, C) or per-step (B, T, C) context."""
    rng = np.random.default_rng(seed)
    ps = _stack(rng, d + ctx_dim, layers, hidden)
    ctx = None
    if ctx_dim:
        ctx = _cuda(rng, (batch, t, ctx_dim) if step else (batch, ctx_dim), 0.5)
    coins = torch.tensor((rng.random((t, batch, 1)) < 0.5).astype(np.float32), device="cuda")
    return ps, dict(proj_w=_cuda(rng, (hidden, d), 0.1), proj_b=_cuda(rng, (d,), 0.1),
                    h0=_cuda(rng, (layers, batch, hidden), 0.3), c0=_cuda(rng, (layers, batch, hidden), 0.3),
                    y0=_cuda(rng, (batch, d), 0.1), teacher=_cuda(rng, (t, batch, d), 0.1), coins=coins, ctx=ctx,
                    dys=_cuda(rng, (batch, t, d)))


@pytest.mark.parametrize("cd", COMPUTE)
@pytest.mark.parametrize("rd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("step,hidden,layers,c,d,batch,t", [
    (False, 128, 2, 128, 3, 4100, 3),  # row 6 at the training batch and a partial block past it
    (True, 128, 2, 128, 3, 300, 20),   # row 7, the 10 s decoder cut in B and T
    (False, 256, 2, 128, 3, 70, 8),    # the widest hidden: two unit blocks a warp in the backward
    (True, 192, 1, 192, 3, 40, 6),
    (False, 128, 8, 64, 3, 33, 5),     # the deepest stack: 16-row backward blocks
    (True, 128, 8, 128, 3, 33, 5),
    (False, 160, 2, 8, 8, 45, 6),      # d = 8, one dctx n-tile; the bf16 context padded to a k16 step
    (False, 96, 3, 0, 1, 50, 7),       # no context
])
def test_ss_fwd_and_bwd_tensor_core_shapes(step, hidden, layers, c, d, batch, t, rd, cd):
    """The decoder forward (static or per-step context) against its plain
    version, repeats bit-equal; its backward fed the kernel's residuals."""
    ps, a = _ss_wide_case(batch, layers, c, hidden, seed=hidden + layers + c, t=t, step=step, d=d)
    fwd, bwd = (lstm_align.dec_fwd, lstm_align.dec_bwd) if step else (lstm_ss.ss_fwd, lstm_ss.ss_bwd)
    args = (ps, a["proj_w"], a["proj_b"], a["h0"], a["c0"], a["y0"], a["teacher"], a["coins"], a["ctx"])
    before = _counts([fwd, bwd])
    ys, res = fwd(*args, rd, cd)
    ys2, res2 = fwd(*args, rd, cd)
    torch.cuda.synchronize()
    refs = _plains(cd, lambda x: lstm_ss._forward_reference(*args, rd, x))
    _check([ys] + _fwd(res), [[y] + _fwd(r) for y, r in refs], "fwd", cd)
    assert torch.equal(ys, ys2) and all(map(torch.equal, _fwd(res), _fwd(res2)))
    geo = lstm_train.fwd_block(hidden, layers, d, batch, cd, ctx_dim=c, mode="step" if step else "static")
    assert lstm_ss._library().ss_fwd_smem(geo.rp, d, c, hidden, layers, int(geo.c_smem), int(step),
                                          int(cd == BF)) == geo.smem
    bargs = (ps, a["proj_w"], a["c0"], a["coins"], res, a["dys"], c)
    out = bwd(*bargs, cd)
    bws = _plains(cd, lambda x: lstm_ss._bwd_recurrence_reference(*bargs, step_ctx=step, compute_dtype=x))
    _check(_flat(out), [_flat(b) for b in bws], "rec", cd)
    assert _counts([fwd, bwd]) == [(n + k * (cd != BF), m + k * (cd == BF)) for (n, m), k in zip(before, (2, 1))]


def test_training_forwards_refuse_what_their_blocks_do_not_take():
    """Shapes the FMA forwards took that the tensor-core forward does not:
    hidden above 256 (through lstm_seq too), and the decoders' d above 8;
    each a ValueError naming it, before any launch."""
    rng = np.random.default_rng(0)
    before = _counts([lstm_train.lstm_fwd, lstm_ss.ss_fwd])
    ps = _stack(rng, 3, 1, hidden=288)
    with pytest.raises(ValueError, match="hidden a multiple of 32 up to 256, got hidden=288"):
        lstm_train.lstm_seq(ps, _cuda(rng, (4, 5, 3)))
    ps, a = _ss_wide_case(4, 1, 0, 64, seed=0, t=3, step=False, d=9)
    with pytest.raises(ValueError, match="d=9"):
        lstm_ss.ss_fwd(ps, a["proj_w"], a["proj_b"], a["h0"], a["c0"], a["y0"], a["teacher"], a["coins"], None)
    assert _counts([lstm_train.lstm_fwd, lstm_ss.ss_fwd]) == before


# ------------------------------------------------------------- conv_resize kernel
# Against its plain version (the dense einsum, then cuDNN's conv in exact
# f32): 1e-5 of max|plain|. The kernel sums the resize's two non-zero taps
# a row where the einsum sums every term (the zeros exactly), and the K·K
# taps in another order than cuDNN: a few ulps of values up to ~10.

# (B, H, W) → (h, w), C, K: 3 x 3 filters (the main path's, on the
# kernel's register window), then the body for any odd K
CONV_SHAPES = [
    ((3, 48, 96), (16, 32), 4, 3),  # the JAX suite's shape
    ((64, 960, 1920), (32, 64), 8, 3),  # extract_clip_features' defaults
    ((4099, 64, 128), (16, 32), 4, 3),  # the fusion maps mode
    ((5, 12, 20), (16, 32), 4, 3),  # upsampling: two taps a row
    ((7, 961, 1917), (32, 64), 8, 3),  # odd sizes
    ((2, 40, 2000), (20, 1500), 3, 3),  # a wide output: tiles of 256 columns
    ((2, 60, 30000), (12, 20000), 4, 3),  # rows of 80 KB, past the old design's 48 KB cap
    ((64, 960, 1920), (32, 64), 8, 5),
    ((64, 960, 1920), (32, 64), 8, 7),
    ((3, 50, 700), (20, 530), 3, 5),  # a ragged last column tile: 530 = 2 x 256 + 18
    ((5, 40, 2000), (18, 1030), 4, 7),  # 1030 = 4 x 256 + 6, scalar stores
    ((2, 60, 30000), (12, 20000), 4, 7),
    ((300, 40, 80), (24, 40), 4, 5),  # whole-frame tiles
    ((5, 12, 20), (16, 32), 4, 1),  # K = 1: no halo
]


def _conv_case(shape, c, seed, k=3):
    rng = np.random.default_rng(seed)
    return (_cuda(rng, shape), _cuda(rng, (c, k, k), 1 / k), _cuda(rng, (c,), 0.1))


@pytest.mark.parametrize("shape,out_hw,c,k", CONV_SHAPES)
def test_conv_resize_kernel_matches_plain(shape, out_hw, c, k):
    frames, kernels, bias = _conv_case(shape, c, seed=c + k - 3, k=k)
    before = conv_resize.fused_conv_resize.launches
    out = conv_resize.fused_conv_resize(frames, out_hw, kernels, bias)
    again = conv_resize.fused_conv_resize(frames, out_hw, kernels, bias)
    torch.cuda.synchronize()
    assert conv_resize.fused_conv_resize.launches == before + 2
    ref = conv_resize.conv_resize_reference(frames, out_hw, kernels, bias)
    assert out.shape == (shape[0], c) + out_hw and torch.isfinite(out).all()
    assert _rel(out, ref) <= 1e-5
    assert torch.equal(out, again)


def test_conv_resize_is_deterministic_and_rows_are_independent():
    frames, kernels, bias = _conv_case((9, 200, 400), 4, seed=1)
    full = conv_resize.fused_conv_resize(frames, (16, 32), kernels, bias)
    assert torch.equal(full, conv_resize.fused_conv_resize(frames, (16, 32), kernels, bias))
    assert torch.equal(full[3:7], conv_resize.fused_conv_resize(frames[3:7].contiguous(), (16, 32),
                                                                kernels, bias))


def test_conv_resize_never_falls_back_on_card():
    frames, kernels, bias = _conv_case((2, 48, 96), 4, seed=2)
    with pytest.raises(RuntimeError, match="no backward"):
        conv_resize.fused_conv_resize(frames, (16, 32), kernels.clone().requires_grad_(True), bias)
    with pytest.raises(ValueError, match="odd K"):
        conv_resize.fused_conv_resize(frames, (16, 32), torch.zeros(4, 2, 2, device="cuda"), bias)
    # an output row of 20,000 columns, which the old design refused, is taken
    wide = conv_resize.fused_conv_resize(frames, (16, 20000), kernels, bias)
    assert _rel(wide, conv_resize.conv_resize_reference(frames, (16, 20000), kernels, bias)) <= 1e-5
    with pytest.raises(ValueError, match="does not fit"):  # a filter bank past shared memory
        conv_resize.fused_conv_resize(frames, (16, 32), torch.zeros(6000, 3, 3, device="cuda"),
                                      torch.zeros(6000, device="cuda"))
    with pytest.raises(ValueError, match="contiguous"):
        conv_resize.fused_conv_resize(frames.transpose(1, 2), (16, 32), kernels, bias)


# ------------------------------------------------- transformer kernels
# Both kernels against their plain versions (models.transformer._encode and
# _ar_decode) within 3e-5 absolute, the JAX suite's bound for its kernels
# (tests/test_transformer_encode.py, tests/test_transformer_decode.py): f32
# FMAs in another order and an online softmax.


def _tfm_case(layers, h_in, h_out, batch, k=0, pool="none", window=0, seed=0, d=3):
    """transformer params with random LN scales and biases (init gives 1 and
    0), pasts of ``d`` coordinates, the plain encoder memory and, with k
    peers, their tokens under a mask with a row of no peer and a row of
    one."""
    cfg = seq2seq.Seq2SeqConfig(d=d, hidden=128, layers=layers, h_in=h_in, h_out=h_out, peer_pool=pool,
                                peer_window=window)
    params = transformer.init(torch.Generator().manual_seed(seed), cfg, device="cpu")
    rng = np.random.default_rng(seed)
    for leaf in [v for lay in params["enc"] + params["dec"] for sub in lay.values()
                 for key, v in sub.items() if key in ("scale", "bias", "b1", "b2")]:
        leaf += torch.tensor(rng.normal(size=leaf.shape).astype(np.float32) * 0.1)
    params = params_from_numpy(walk(params, lambda _, t: t.numpy()), "cuda")
    past = torch.tensor(rng.normal(size=(batch, h_in, d)).astype(np.float32) * 0.3, device="cuda")
    enc = transformer._encode(params, cfg, past)
    pm = pv = None
    if k:
        of = torch.tensor(rng.normal(size=(batch, k, h_out, d)).astype(np.float32) * 0.3, device="cuda")
        mask = (torch.tensor(rng.random((batch, k))) < 0.7).float().cuda()
        mask[0] = 0.0
        mask[min(1, batch - 1), 1:] = 0.0
        pm, pv = (x.contiguous() for x in transformer._peer_tokens(params, cfg, of, mask))
    return cfg, params, past, enc, past[:, -1].contiguous(), pm, pv


# the last three at the edges of the f32 tier's 64-row tiles: T = 64 (one
# viewer a block) and T = 1 (64 viewers a block) one viewer past a whole
# tile, and L = 8 (every layer of the pointer table)
@pytest.mark.parametrize("layers,t,batch", [(2, 30, 257), (1, 6, 8), (3, 64, 5), (2, 7, 1), (2, 30, 16387),
                                            (2, 64, 9), (2, 1, 129), (8, 30, 51)])
def test_transformer_encode_kernel_matches_plain(layers, t, batch):
    cfg, params, past, enc, *_ = _tfm_case(layers, t, 4, batch, seed=layers)
    before = transformer_encode.fused_encode_tokens.launches
    out = transformer_encode.fused_encode_tokens(params, cfg, past)
    torch.cuda.synchronize()
    assert transformer_encode.fused_encode_tokens.launches == before + 1
    assert out.shape == enc.shape and torch.isfinite(out).all()
    assert (out - enc).abs().max().item() <= 3e-5


def test_transformer_encode_kernel_repeats_bit_equal():
    cfg, params, past, *_ = _tfm_case(2, 30, 4, 16387, seed=2)
    first = transformer_encode.fused_encode_tokens(params, cfg, past)
    assert torch.equal(first, transformer_encode.fused_encode_tokens(params, cfg, past))


def test_one_pass_tf32_build_fails_the_gate():
    """The f32 tier's products are three-pass TF32: a build that drops the
    two small terms (-DTFM_ONE_PASS, products of 11-bit operands) is held
    to the same 3e-5 and fails it, where the three-pass kernel passes: the
    gate tells three passes from one."""
    import ctypes

    from longterm360fov_tpu_torch.ops import _build

    cfg, params, past, enc, *_ = _tfm_case(2, 30, 4, 257, seed=2)
    lib = transformer_encode.bind(ctypes.CDLL(str(_build.build("transformer_encode", ("TFM_ONE_PASS",)).path)))
    tensors, _ = transformer_encode.layer_pointers(params["enc"], transformer_encode._ENC_LEAVES, 128)
    pos = transformer._pos_enc(30, 128, device="cuda")
    one = transformer_encode.launch(lib, tensors, params["in_proj"], pos, past, torch.float32)
    three = transformer_encode.fused_encode_tokens(params, cfg, past)
    assert torch.isfinite(one).all()
    assert (three - enc).abs().max().item() <= 3e-5 < (one - enc).abs().max().item()


@pytest.mark.parametrize("k,pool,window", [(0, "none", 0), (4, "none", 0), (3, "mean", 0), (4, "none", 2),
                                           (3, "mean", 3)])
@pytest.mark.parametrize("layers,h_in,h_out,batch", [(2, 30, 30, 257), (1, 4, 3, 8), (2, 6, 7, 1)])
def test_transformer_decode_kernel_matches_plain(layers, h_in, h_out, batch, k, pool, window):
    cfg, params, _, enc, y0, pm, pv = _tfm_case(layers, h_in, h_out, batch, k, pool, window, seed=k + layers)
    before = transformer_decode.fused_ar_decode.launches
    out = transformer_decode.fused_ar_decode(params, cfg, enc, y0, peer_mem=pm, peer_valid=pv)
    torch.cuda.synchronize()
    assert transformer_decode.fused_ar_decode.launches == before + 1
    ref = transformer._ar_decode(params, cfg, enc, pm, pv, y0)
    assert out.shape == (batch, h_out, 3) and torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 3e-5
    if k:  # the row with no valid peer is the peerless rollout
        alone = transformer_decode.fused_ar_decode(params, cfg, enc, y0)
        assert (out[0] - alone[0]).abs().max().item() <= 3e-5


def test_transformer_kernels_rows_are_independent():
    cfg, params, past, enc, y0, pm, pv = _tfm_case(2, 30, 30, 200, k=4)
    full = transformer_encode.fused_encode_tokens(params, cfg, past)
    assert torch.equal(full[70:131], transformer_encode.fused_encode_tokens(params, cfg, past[70:131].contiguous()))
    full = transformer_decode.fused_ar_decode(params, cfg, enc, y0, peer_mem=pm, peer_valid=pv)
    part = transformer_decode.fused_ar_decode(params, cfg, enc[70:131].contiguous(), y0[70:131].contiguous(),
                                              peer_mem=pm[70:131].contiguous(), peer_valid=pv[70:131].contiguous())
    assert torch.equal(full[70:131], part)


def test_transformer_kernels_never_fall_back_on_card():
    cfg, params, past, enc, y0, pm, pv = _tfm_case(1, 6, 5, 4, k=2)
    with pytest.raises(RuntimeError, match="no backward"):
        transformer_encode.fused_encode_tokens(params, cfg, past.clone().requires_grad_(True))
    with pytest.raises(RuntimeError, match="no backward"):
        transformer_decode.fused_ar_decode(params, cfg, enc.clone().requires_grad_(True), y0)
    with pytest.raises(ValueError, match="contiguous"):
        transformer_encode.fused_encode_tokens(params, cfg, past.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="contiguous"):
        transformer_decode.fused_ar_decode(params, cfg, enc, past[:, 0])
    with pytest.raises(ValueError, match="T <= 64"):
        transformer_encode.fused_encode_tokens(params, cfg, torch.zeros(2, 65, 3, device="cuda"))
    with torch.no_grad():  # the bf16 tier runs on the card (its parity: test_transformer_bf16_tiers_match_plain)
        out = transformer_decode.fused_ar_decode(params, cfg, enc, y0, compute_dtype=torch.bfloat16)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    with pytest.raises(TypeError, match="float32"):
        transformer_decode.fused_ar_decode(params, cfg, enc.double(), y0)
    with pytest.raises(TypeError, match="float32"):  # the bf16 tier takes the f32 model too
        transformer_decode.fused_ar_decode(params, cfg, enc.bfloat16(), y0, compute_dtype=torch.bfloat16)


# The bf16 tiers against their plain bf16 versions (models.transformer._encode
# and _ar_decode with compute_dtype bfloat16): both round the same operands
# and sum in f32 in another order, so a rounding may flip, which moves an
# activation by 2^-8 of itself; 2e-2, the CPU suite's bound against JAX's
# bf16 kernels (tests/test_torch_transformer_bf16.py), and JAX's 0.08
# against the f32 plain version.
BF16_TOL, BF16_F32_TOL = 2e-2, 0.08


@pytest.mark.parametrize("k,pool,window", [(0, "none", 0), (4, "none", 0), (3, "mean", 0), (4, "none", 2)])
def test_transformer_bf16_tiers_match_plain(k, pool, window):
    cfg, params, past, enc, y0, pm, pv = _tfm_case(2, 30, 30, 257, k, pool, window, seed=k + 7)
    bf16 = torch.bfloat16
    before = (transformer_encode.fused_encode_tokens_bf16.launches, transformer_decode.fused_ar_decode_bf16.launches)
    enc_k = transformer_encode.fused_encode_tokens(params, cfg, past, compute_dtype=bf16)
    out = transformer_decode.fused_ar_decode(params, cfg, enc, y0, peer_mem=pm, peer_valid=pv, compute_dtype=bf16)
    torch.cuda.synchronize()
    assert (transformer_encode.fused_encode_tokens_bf16.launches,
            transformer_decode.fused_ar_decode_bf16.launches) == (before[0] + 1, before[1] + 1)
    enc_p = transformer._encode(params, cfg, past, bf16)
    assert (enc_k - enc_p).abs().max().item() <= BF16_TOL
    assert (enc_k - enc).abs().max().item() <= BF16_F32_TOL
    ref = transformer._ar_decode(params, cfg, enc, pm, pv, y0, compute_dtype=bf16)
    f32 = transformer._ar_decode(params, cfg, enc, pm, pv, y0)
    assert out.shape == (257, 30, 3) and torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= BF16_TOL
    assert (out - f32).abs().max().item() <= BF16_F32_TOL


@pytest.mark.parametrize("pool,window", [("none", 0), ("mean", 2)])
def test_transformer_bf16_shared_tier_matches_plain(pool, window):
    cfg, params, enc, y0, gmem, gvalid, gid, dv = _shared_case(2, 30, 30, 257, 4, pool, window, seed=3)
    before = transformer_decode.fused_ar_decode_bf16.launches
    out = transformer_decode.fused_ar_decode_shared(params, cfg, enc, y0, peer_gmem=gmem, peer_gvalid=gvalid,
                                                    peer_gid=gid, peer_dv=dv, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert transformer_decode.fused_ar_decode_bf16.launches == before + 1
    ref = transformer._ar_decode(params, cfg, enc, gmem, gvalid, y0, peer_gid=gid.long(), peer_dv=dv,
                                 compute_dtype=torch.bfloat16)
    assert (out - ref).abs().max().item() <= BF16_TOL
    masked = gid == 2  # every peer masked: the peerless bf16 rollout
    alone = transformer_decode.fused_ar_decode(params, cfg, enc, y0, compute_dtype=torch.bfloat16)
    assert (out[masked] - alone[masked]).abs().max().item() <= BF16_TOL


# The bf16 decode's body on the tensor cores (decode_rows_mma) at the edges
# of its shapes: blocks of 32 rows (B < 8385) and of 64 (the chooser's other
# shape), each with a ragged last block; L = 1 and 8, d = 1 and 4,
# t_out = 1; every tier. Against the bf16 plain version at chip_smoke.py's
# gate (at thousands of rows the largest gap is of the size of the tier's
# own rounding error: 5e-2), the f32 one at JAX's 0.08, and the floor (the
# kernel as far from f32 in the mean as the bf16 plain version, at least
# half: it rounds where the tier rounds).
BF16_ROWS_TOL = 5e-2


@pytest.mark.parametrize("layers,h_in,h_out,batch,d,k,pool,window,grouped", [
    (2, 30, 30, 8400, 3, 4, "none", 0, False),
    (2, 30, 30, 8400, 3, 0, "none", 0, False),
    (2, 30, 30, 8400, 3, 4, "none", 8, True),
    (1, 6, 9, 100, 1, 4, "mean", 2, False),
    (8, 4, 1, 33, 4, 3, "none", 0, False),
    (2, 12, 12, 70, 4, 4, "none", 3, True),
    (2, 30, 30, 257, 3, 4, "mean", 0, True),
])
def test_bf16_decode_tensor_core_shapes(layers, h_in, h_out, batch, d, k, pool, window, grouped):
    bf16 = torch.bfloat16
    if grouped:
        cfg, params, enc, y0, gmem, gvalid, gid, dv = _shared_case(layers, h_in, h_out, batch, k, pool, window,
                                                                   seed=layers + d, d=d)
        peers = {"peer_gmem": gmem, "peer_gvalid": gvalid, "peer_gid": gid, "peer_dv": dv}
        plain_peers = (gmem, gvalid)
        plain_kw = {"peer_gid": gid.long(), "peer_dv": dv}
    else:
        cfg, params, _, enc, y0, pm, pv = _tfm_case(layers, h_in, h_out, batch, k, pool, window, seed=layers + d, d=d)
        peers = {"peer_mem": pm, "peer_valid": pv} if k else {}
        plain_peers, plain_kw = (pm, pv), {}
    before = transformer_decode.fused_ar_decode_bf16.launches
    out = transformer_decode.fused_ar_decode(params, cfg, enc, y0, compute_dtype=bf16, **peers)
    torch.cuda.synchronize()
    assert transformer_decode.fused_ar_decode_bf16.launches == before + 1
    assert out.shape == (batch, h_out, d) and torch.isfinite(out).all()
    ref = transformer._ar_decode(params, cfg, enc, *plain_peers, y0, compute_dtype=bf16, **plain_kw)
    f32 = transformer._ar_decode(params, cfg, enc, *plain_peers, y0, **plain_kw)
    assert (out - ref).abs().max().item() <= BF16_ROWS_TOL
    assert (out - f32).abs().max().item() <= BF16_F32_TOL
    assert _mean_gap(out, f32) >= 0.5 * _mean_gap(ref, f32), "the kernel does not round as the tier does"
    assert torch.equal(out, transformer_decode.fused_ar_decode(params, cfg, enc, y0, compute_dtype=bf16, **peers))
    if k:  # rows with every peer masked: the peerless bf16 rollout
        masked = gid == 2 if grouped else torch.arange(batch, device="cuda") == 0
        alone = transformer_decode.fused_ar_decode(params, cfg, enc, y0, compute_dtype=bf16)
        assert (out[masked] - alone[masked]).abs().max().item() <= BF16_TOL


# The f32 decode's body on three-pass TF32 (decode_rows_tf32) at the same
# edges: 64-row blocks (B = 8400, a ragged last block) and 32-row ones, L = 1
# and 8, d = 1 and 4, t_out = 1, every tier (per row, pooled, windowed,
# group-shared with δv); within 3e-5 of the exact-f32 plain version, rows
# with every peer masked equal to the peerless rollout, repeats bit-equal.
@pytest.mark.parametrize("layers,h_in,h_out,batch,d,k,pool,window,grouped", [
    (2, 30, 30, 8400, 3, 4, "none", 0, False),
    (2, 30, 30, 8400, 3, 0, "none", 0, False),
    (2, 30, 30, 8400, 3, 4, "none", 8, True),
    (2, 30, 30, 8400, 3, 4, "mean", 2, False),
    (1, 6, 9, 100, 1, 4, "mean", 2, False),
    (8, 4, 1, 33, 4, 3, "none", 0, False),
    (2, 12, 12, 70, 4, 4, "none", 3, True),
    (2, 30, 30, 257, 3, 4, "mean", 0, True),
])
def test_f32_decode_tensor_core_shapes(layers, h_in, h_out, batch, d, k, pool, window, grouped):
    if grouped:
        cfg, params, enc, y0, gmem, gvalid, gid, dv = _shared_case(layers, h_in, h_out, batch, k, pool, window,
                                                                   seed=layers + d, d=d)
        peers = {"peer_gmem": gmem, "peer_gvalid": gvalid, "peer_gid": gid, "peer_dv": dv}
        plain_peers, plain_kw = (gmem, gvalid), {"peer_gid": gid.long(), "peer_dv": dv}
        wrapper = transformer_decode.fused_ar_decode_shared
    else:
        cfg, params, _, enc, y0, pm, pv = _tfm_case(layers, h_in, h_out, batch, k, pool, window, seed=layers + d, d=d)
        peers = {"peer_mem": pm, "peer_valid": pv} if k else {}
        plain_peers, plain_kw = (pm, pv), {}
        wrapper = transformer_decode.fused_ar_decode
    assert transformer_decode.decode_rows(batch, torch.cuda.get_device_properties(0).multi_processor_count) == (
        64 if batch == 8400 else 32)
    before = wrapper.launches
    out = transformer_decode.fused_ar_decode(params, cfg, enc, y0, **peers)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert out.shape == (batch, h_out, d) and torch.isfinite(out).all()
    ref = transformer._ar_decode(params, cfg, enc, *plain_peers, y0, **plain_kw)
    assert (out - ref).abs().max().item() <= 3e-5
    assert torch.equal(out, transformer_decode.fused_ar_decode(params, cfg, enc, y0, **peers))
    if k:  # rows with every peer masked: the peerless rollout
        masked = gid == 2 if grouped else torch.arange(batch, device="cuda") == 0
        alone = transformer_decode.fused_ar_decode(params, cfg, enc, y0)
        assert (out[masked] - alone[masked]).abs().max().item() <= 3e-5


def test_decode_refuses_blocks_it_does_not_take():
    for cd in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="64 or 32 rows, got 48"):
            transformer_decode.decode_smem_bytes(48, cd)
    lib = transformer_decode._library()
    assert [lib.transformer_decode_smem_bytes(r, b) for r in (64, 32) for b in (0, 1)] == [
        transformer_decode.decode_smem_bytes(r, cd) for r in (64, 32) for cd in (torch.float32, torch.bfloat16)]
    assert lib.transformer_decode_smem_bytes(48, 0) == -1


# The bf16 serve kernel's body on the tensor cores (lstm_mma.cuh's server)
# on both W routes (resident at L = 1 without context, streamed from L2 at
# L = 2 and at C = 128), in 32-row tiles (MT = 2, the chooser's) and 16-row
# ones (MT = 1, a block of 16 rows forced), in its three tiers, at ragged
# batches; with the gates of the bf16 tiers above.
@pytest.mark.parametrize("rows", [0, 16])
@pytest.mark.parametrize("layers,ctx_dim,tier", [(1, 0, "none"), (1, 64, "static"), (2, 128, "static"),
                                                 (2, 64, "static"), (2, 128, "lockstep"), (1, 128, "lockstep")])
@pytest.mark.parametrize("batch", [1, 4099])
def test_bf16_serve_tensor_core_shapes(batch, layers, ctx_dim, tier, rows, monkeypatch):
    choose = fused_lstm.serve_tc_rows
    monkeypatch.setattr(fused_lstm, "serve_tc_rows", lambda *a, **kw: choose(*a, rows=rows, **kw))
    geo = fused_lstm.serve_tc_rows(128, layers, 3, ctx_dim, tier == "lockstep")
    assert geo.mt == (1 if rows == 16 else 2) and (rows or geo.w_res == (layers == 1 and ctx_dim == 0))
    rng = np.random.default_rng(layers + ctx_dim)
    enc, dec = _stack(rng, 3, layers), _stack(rng, 3 + ctx_dim, layers)
    pw, pb = _cuda(rng, (128, 3), 0.1), _cuda(rng, (3,), 0.1)
    t_in = t_out = 30
    x = _cuda(rng, (batch, t_in, 3), 0.1)
    kw = {"context": _cuda(rng, (batch, ctx_dim))} if tier == "static" else {}
    if tier == "lockstep":
        peer = _stack(rng, 3, 1, hidden=ctx_dim)[0]
        _, pxs, w = _peer_case(batch, 7, t_out, seed=layers)
        kw = dict(peer_params=peer, peer_xs=pxs, peer_w=w)
    wrapper = fused_lstm.fused_serve_peers if tier == "lockstep" else fused_lstm.fused_serve
    before = wrapper.launches_bf16
    out = fused_lstm.fused_serve(enc, dec, pw, pb, x, t_out, compute_dtype=BF, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches_bf16 == before + 1
    assert out.shape == (batch, t_out, 3)
    _check([out], _plains(BF, lambda c: [fused_lstm.fused_serve_reference(enc, dec, pw, pb, x, t_out, compute_dtype=c,
                                                                          **kw)]), "serve", BF)
    assert torch.equal(out, fused_lstm.fused_serve(enc, dec, pw, pb, x, t_out, compute_dtype=BF, **kw))


def test_bf16_serve_refuses_what_the_tensor_cores_do_not_take():
    rng = np.random.default_rng(0)
    enc, dec = _stack(rng, 3, 1), _stack(rng, 3 + 8, 1)
    pw, pb = _cuda(rng, (128, 3)), _cuda(rng, (3,))
    with pytest.raises(ValueError, match="ctx_dim % 16 == 0, got 8"):
        fused_lstm.fused_serve(enc, dec, pw, pb, _cuda(rng, (4, 5, 3)), 3, context=_cuda(rng, (4, 8)),
                               compute_dtype=BF)
    out = fused_lstm.fused_serve(enc, dec, pw, pb, _cuda(rng, (4, 5, 3)), 3, context=_cuda(rng, (4, 8)))
    assert torch.isfinite(out).all()  # the f32 tier takes it
    lib = fused_lstm._library()
    assert lib.fused_serve_smem_bytes(64, 3, 128, 128, 2, 0, 1, 1) == fused_lstm.serve_tc_rows(128, 2, 3, 128,
                                                                                                True).smem


def test_fused_decode_on_bf16_states_runs_the_f32_kernel():
    """The bf16 serve body takes no given states: fused_decode widens a bf16
    model's tensors to f32 and launches the f32 decode kernel, whose answer
    equals that of the widened tensors."""
    rng = np.random.default_rng(5)
    dec = [LSTMParams(p.w.to(BF), p.b.to(BF)) for p in _stack(rng, 3, 2)]
    pw, pb = _cuda(rng, (128, 3), 0.1).to(BF), _cuda(rng, (3,), 0.1).to(BF)
    h0, c0 = _cuda(rng, (2, 300, 128), 0.3).to(BF), _cuda(rng, (2, 300, 128), 0.3).to(BF)
    y0 = _cuda(rng, (300, 3), 0.1).to(BF)
    before = (fused_lstm.fused_decode.launches, fused_lstm.fused_serve.launches_bf16)
    out = fused_lstm.fused_decode(dec, pw, pb, h0, c0, y0, 10)
    assert (fused_lstm.fused_decode.launches, fused_lstm.fused_serve.launches_bf16) == (before[0] + 1, before[1])
    wide = fused_lstm.fused_decode([LSTMParams(p.w.float(), p.b.float()) for p in dec], pw.float(), pb.float(),
                                   h0.float(), c0.float(), y0.float(), 10)
    assert torch.equal(out, wide)


# The f32 serve kernel, fused_decode and the f32 peer context on three-pass
# TF32 (lstm_mma.cuh's server and encoder with Tf32Mma), in their choosers'
# blocks (64-row tiles) and in 32-row ones, at ragged batches, in every
# tier: within the f32 gates (1e-4 on the predictions, 1e-5 on the peer
# context), each repeat bit-equal and each row bit-equal wherever it sits in
# the batch.


def _same_rows(out, run, batch):
    """``run(perm)`` (None: the batch as it is) repeats ``out`` bit for bit,
    and a permuted batch gives each row's answer bit for bit."""
    perm = torch.randperm(batch, generator=torch.Generator().manual_seed(batch)).cuda()
    assert torch.equal(out, run(None))
    assert torch.equal(out[perm], run(perm))


def _take(t, perm, dim=0):
    return t if t is None or perm is None else t.index_select(dim, perm).contiguous()


@pytest.fixture
def f32_rows(monkeypatch):
    """Force the f32 bodies' blocks to ``rows`` rows (0: the choosers')."""
    serve, peer = fused_lstm.serve_tf32_rows, fused_lstm.peer_tf32_rows

    def force(rows):
        monkeypatch.setattr(fused_lstm, "serve_tf32_rows", lambda *a, **kw: serve(*a, rows=rows, **kw))
        monkeypatch.setattr(fused_lstm, "peer_tf32_rows", lambda *a, **kw: peer(*a, rows=rows, **kw))
    return force


@pytest.mark.parametrize("rows", [0, 32])
@pytest.mark.parametrize("layers,ctx_dim,tier", [(1, 0, "none"), (2, 0, "none"), (1, 64, "static"),
                                                 (2, 128, "static"), (2, 64, "static"), (1, 12, "static"),
                                                 (2, 128, "lockstep"), (1, 128, "lockstep")])
@pytest.mark.parametrize("batch", [1, 4099])
def test_f32_lstm_serve_tensor_core_shapes(batch, layers, ctx_dim, tier, rows, f32_rows):
    f32_rows(rows)
    geo = fused_lstm.serve_tf32_rows(128, layers, 3, ctx_dim, tier == "lockstep")
    assert geo.mt == (4 if tier == "lockstep" and not rows else 2) and not geo.w_res
    rng = np.random.default_rng(layers + ctx_dim)
    enc, dec = _stack(rng, 3, layers), _stack(rng, 3 + ctx_dim, layers)
    pw, pb = _cuda(rng, (128, 3), 0.1), _cuda(rng, (3,), 0.1)
    t_out = 30
    x = _cuda(rng, (batch, 30, 3), 0.1)
    kw = {"context": _cuda(rng, (batch, ctx_dim))} if tier == "static" else {}
    if tier == "lockstep":
        peer = _stack(rng, 3, 1, hidden=ctx_dim)[0]
        _, pxs, w = _peer_case(batch, 7, t_out, seed=layers)
        kw = dict(peer_params=peer, peer_xs=pxs, peer_w=w)
    wrapper = fused_lstm.fused_serve_peers if tier == "lockstep" else fused_lstm.fused_serve
    before = wrapper.launches
    out = fused_lstm.fused_serve(enc, dec, pw, pb, x, t_out, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert out.shape == (batch, t_out, 3)
    ref = fused_lstm.fused_serve_reference(enc, dec, pw, pb, x, t_out, **kw)
    assert (out - ref).abs().max().item() <= 1e-4

    def run(perm):
        pkw = {k: v if k == "peer_params" else _take(v, perm) for k, v in kw.items()}
        return fused_lstm.fused_serve(enc, dec, pw, pb, _take(x, perm), t_out, **pkw)
    _same_rows(out, run, batch)


@pytest.mark.parametrize("rows", [0, 32])
@pytest.mark.parametrize("layers,ctx_dim", [(1, 0), (2, 0), (2, 128), (3, 64), (1, 12)])
@pytest.mark.parametrize("batch", [1, 4099])
def test_f32_lstm_decode_tensor_core_shapes(batch, layers, ctx_dim, rows, f32_rows):
    """fused_decode: the f32 serve kernel from given states (h0 into z, c0
    into the lanes' slots of every tile), the decoder phase alone."""
    f32_rows(rows)
    rng = np.random.default_rng(layers + ctx_dim)
    dec = _stack(rng, 3 + ctx_dim, layers)
    pw, pb = _cuda(rng, (128, 3), 0.1), _cuda(rng, (3,), 0.1)
    h0, c0 = _cuda(rng, (layers, batch, 128), 0.3), _cuda(rng, (layers, batch, 128), 0.3)
    y0, ctx = _cuda(rng, (batch, 3), 0.1), (_cuda(rng, (batch, ctx_dim)) if ctx_dim else None)
    out = fused_lstm.fused_decode(dec, pw, pb, h0, c0, y0, 30, context=ctx)
    ref = fused_lstm.fused_decode_reference(dec, pw, pb, h0, c0, y0, 30, ctx)
    assert (out - ref).abs().max().item() <= 1e-4
    _same_rows(out, lambda perm: fused_lstm.fused_decode(dec, pw, pb, _take(h0, perm, 1), _take(c0, perm, 1),
                                                         _take(y0, perm), 30, context=_take(ctx, perm)), batch)


@pytest.mark.parametrize("rows", [0, 32])
@pytest.mark.parametrize("ctx_dim,k,batch", [(128, 7, 4099), (128, 8, 129), (64, 4, 301), (96, 8, 257),
                                             (32, 3, 300), (128, 1, 70), (32, 8, 1),
                                             # past 8 peers: whole viewers, then one viewer a block of up to 256
                                             # rows, c and (K = 256 at C = 128) the staging in device memory
                                             (128, 9, 300), (128, 16, 257), (128, 64, 45), (128, 65, 9),
                                             (128, 129, 7), (128, 256, 13), (64, 256, 5), (32, 100, 3)])
def test_f32_lstm_peer_context_tensor_core_shapes(ctx_dim, k, batch, rows, f32_rows):
    f32_rows(rows)
    rng = np.random.default_rng(ctx_dim + k)
    peer = _stack(rng, 3, 1, hidden=ctx_dim)[0]
    pxs = _cuda(rng, (batch, k, 40, 3), 0.5)
    m = (rng.random((batch, k)) < 0.6).astype(np.float32)
    m[0] = 0.0
    w = torch.tensor(m / np.maximum(m.sum(1, keepdims=True), 1.0), device="cuda")
    before = fused_lstm.peer_context.launches
    out = fused_lstm.peer_context(peer, pxs, w)
    torch.cuda.synchronize()
    assert fused_lstm.peer_context.launches == before + 1
    assert out.shape == (batch, 40, ctx_dim) and not out[0].any()
    assert (out - fused_lstm.peer_context_reference(peer, pxs, w)).abs().max().item() <= 1e-5
    _same_rows(out, lambda perm: fused_lstm.peer_context(peer, _take(pxs, perm), _take(w, perm)), batch)


def test_f32_lstm_kernels_have_hmma_and_their_blocks_fit():
    """Every f32 instance of the serve kernel and the peer context carries
    HMMA instructions in its SASS (three-pass TF32 on mma.sync), and the
    library's account of a block's shared memory is the choosers'."""
    import subprocess
    from pathlib import Path
    from longterm360fov_tpu_torch.ops import _build
    lib_path = _build.build("fused_serve").path
    sass = subprocess.run([str(Path(_build.find_nvcc()).parent / "cuobjdump"), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    hmma, fn = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = next((k for k in ("fused_serve_kernelILb0EfE", "fused_serve_kernelILb1EfE", "peer_context_kernelIfE")
                       if k in ln), None)
            if fn:
                hmma[fn] = 0
        elif fn and "HMMA" in ln:
            hmma[fn] += 1
    assert len(hmma) == 3 and all(hmma.values()), hmma
    lib = fused_lstm._library()
    for layers, ctx_dim, step in ((1, 0, False), (2, 128, False), (2, 128, True), (2, 64, False), (1, 12, False)):
        for rows in (0, 32):
            g = fused_lstm.serve_tf32_rows(128, layers, 3, ctx_dim, step, rows=rows)
            assert lib.fused_serve_tf32_smem_bytes(g.rp, 3, ctx_dim, 128, layers, 0, int(g.c_smem), int(step)) == g.smem
    for c in (32, 64, 96, 128):
        for k in (7, 16, 64, 256):
            g = fused_lstm.peer_tf32_rows(c, k, 3)
            assert lib.peer_context_smem_bytes(g.rp, g.rows_v * k, 3, c, 0, int(g.c_smem), 0, int(g.h_smem)) == g.smem


def test_f32_lstm_tier_refuses_what_it_does_not_take():
    """The f32 bodies take no shape their choosers refuse: a named
    ValueError and no launch, never the plain version."""
    rng = np.random.default_rng(0)
    enc, dec = _stack(rng, 5, 1), _stack(rng, 5, 1)
    pw, pb = _cuda(rng, (128, 5)), _cuda(rng, (5,))
    before = fused_lstm.fused_serve.launches
    with pytest.raises(ValueError, match="1..4 coordinates a token, got d=5"):
        fused_lstm.fused_serve(enc, dec, pw, pb, _cuda(rng, (4, 5, 5)), 3)
    with pytest.raises(ValueError, match="1..4 coordinates a token, got d=5"):
        fused_lstm.fused_decode(dec, pw, pb, _cuda(rng, (1, 4, 128)), _cuda(rng, (1, 4, 128)), _cuda(rng, (4, 5)), 3)
    assert fused_lstm.fused_serve.launches == before
    peer = _stack(rng, 3, 1, hidden=160)[0]
    with pytest.raises(ValueError, match="ctx_dim 32, 64, 96 or 128, got 160"):
        fused_lstm.peer_context(peer, _cuda(rng, (2, 3, 4, 3)), torch.ones((2, 3), device="cuda"))
    wide = [LSTMParams(torch.zeros((3 + 1024, 4096), device="cuda"), torch.zeros(4096, device="cuda")),
            LSTMParams(torch.zeros((2048, 4096), device="cuda"), torch.zeros(4096, device="cuda"))]
    wdec = [LSTMParams(torch.zeros((3 + 128 + 1024, 4096), device="cuda"), torch.zeros(4096, device="cuda")),
            wide[1]]
    with pytest.raises(ValueError, match="block of 32 rows needs"):
        fused_lstm.fused_serve(wide, wdec, torch.zeros((1024, 3), device="cuda"), torch.zeros(3, device="cuda"),
                               _cuda(rng, (2, 4, 3)), 3, context=_cuda(rng, (2, 128)))


@pytest.mark.parametrize("hidden", [32, 96, 128, 160, 256])
@pytest.mark.parametrize("d_in", [3, 128])
@pytest.mark.parametrize("batch", [16384, 16383])
def test_bf16_cell_tensor_core_shapes(batch, d_in, hidden):
    """The bf16 cell on the tensor cores (W read as stored, blocks of
    32 · (256 / hidden) rows; at 96 and 160 some warps have no tile) against
    lstm_cell on the bf16 tensors at CELL_TOL and on their f32 widening, the
    floor, and a bit-equal repeat."""
    rng = np.random.default_rng(d_in + hidden)
    (p,) = _stack(rng, d_in, 1, hidden=hidden)
    p = LSTMParams(p.w.to(BF), p.b.to(BF))
    x, h, c = (_cuda(rng, shape, scale).to(BF) for shape, scale in (((batch, d_in), 1.0), ((batch, hidden), 0.5),
                                                                     ((batch, hidden), 0.5)))
    before = _counts([fused_lstm.fused_lstm_cell])
    got = fused_lstm.fused_lstm_cell(p, x, (h, c))
    torch.cuda.synchronize()
    assert _counts([fused_lstm.fused_lstm_cell]) == _one_more(before, BF)
    assert all(g.shape == (batch, hidden) and g.dtype == BF for g in got)
    _check(list(got), _plains(BF, lambda c_: list(lstm_cell(LSTMParams(p.w.to(c_), p.b.to(c_)), x.to(c_),
                                                          (h.to(c_), c.to(c_))))), "cell", BF)
    again = fused_lstm.fused_lstm_cell(p, x, (h, c))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_bf16_cell_refuses_what_the_tensor_cores_do_not_take():
    """The shapes the bf16 cell refused before its unit-block grid (hidden
    40 and 272, D_in 2000) are taken, against lstm_cell on the bf16 tensors
    at CELL_TOL plus a bf16 step; a c that is not 16-byte aligned is still
    refused."""
    rng = np.random.default_rng(0)
    for d_in, hidden in ((3, 40), (3, 272), (2000, 128)):
        (p,) = _stack(rng, d_in, 1, hidden=hidden)
        p = LSTMParams(p.w.to(BF), p.b.to(BF))
        x, h, c = _cuda(rng, (257, d_in)).to(BF), _cuda(rng, (257, hidden), 0.5).to(BF), _cuda(
            rng, (257, hidden), 0.5).to(BF)
        got = fused_lstm.fused_lstm_cell(p, x, (h, c))
        for g, w in zip(got, lstm_cell(p, x, (h, c))):
            assert g.shape == (257, hidden) and g.dtype == BF
            assert ((g.float() - w.float()).abs() <= 1e-5 + 2.0 ** -7 * w.float().abs()).all()
    h = _cuda(rng, (4, 128)).to(BF)
    (q,) = _stack(rng, 3, 1)
    q = LSTMParams(q.w.to(BF), q.b.to(BF))
    shifted = torch.empty(4 * 128 + 1, device="cuda", dtype=BF)[1:].view(4, 128)
    with pytest.raises(ValueError, match="aligned"):
        fused_lstm.fused_lstm_cell(q, _cuda(rng, (4, 3)).to(BF), (h, shifted))


@pytest.mark.parametrize("d_in", [3, 8])
def test_bf16_cell_takes_x_and_h_at_any_offset(d_in):
    """x and h are read by element where they are not whole 16-byte pieces
    (as the FMA design read them): x and h at an odd element offset give
    the bits of aligned copies, at D_in = 8 (16-byte rows) too; c, W and b
    stay checked."""
    rng = np.random.default_rng(d_in)
    (p,) = _stack(rng, d_in, 1)
    p = LSTMParams(p.w.to(BF), p.b.to(BF))
    batch = 4099
    xs = _cuda(rng, (batch * d_in + 1,)).to(BF)
    hs = _cuda(rng, (batch * 128 + 1,), 0.5).to(BF)
    x, h, c = xs[1:].view(batch, d_in), hs[1:].view(batch, 128), _cuda(rng, (batch, 128), 0.5).to(BF)
    assert x.data_ptr() % 16 and h.data_ptr() % 16
    got = fused_lstm.fused_lstm_cell(p, x, (h, c))
    want = fused_lstm.fused_lstm_cell(p, x.clone(), (h.clone(), c))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("path", ["apply", "teacher", "encode_peers", "encode_peers_aligned"])
def test_bf16_cell_pallas_step_loops_at_a_ragged_batch(path):
    """cell="pallas" on a bf16 model through the step loops that hand the
    cell rows of a time-major (T, B, 3) tensor (B = 4099: x at an odd byte
    offset every other step): seq2seq.apply decoding and teacher-forced,
    cross_user.encode_peers (C = 96, a width with idle warps) and
    encode_peers_aligned, against cell="xla" on the card within the CPU
    parity test's 2e-2 (tests/test_torch_serve_bf16.py; a bf16 rollout may
    part by a bf16 step and carry it), every cell step one bf16 launch."""
    batch, k = 4099, 3
    ctx = 96 if path == "encode_peers" else 128 if path == "encode_peers_aligned" else 0
    cfg = seq2seq.Seq2SeqConfig(d=3, hidden=128, layers=2, h_in=30, h_out=30, ctx_dim=ctx, cell="pallas",
                                param_dtype="bfloat16")
    xla = dataclasses.replace(cfg, cell="xla")
    params = (cross_user if ctx else seq2seq).init(torch.Generator().manual_seed(7), cfg, device="cuda")
    rng = np.random.default_rng(7)
    past = torch.tensor(rng.normal(size=(batch, 30, 3)).astype(np.float32) * 0.3, device="cuda")
    fut = torch.tensor(rng.normal(size=(batch, 30, 3)).astype(np.float32) * 0.3, device="cuda")
    others = torch.tensor(rng.normal(size=(batch, k, 30, 3)).astype(np.float32) * 0.3, device="cuda")
    mask = (torch.tensor(rng.random((batch, k)), device="cuda") < 0.7).float()
    run = {"apply": lambda c: seq2seq.apply(params, c, past),
           "teacher": lambda c: seq2seq.apply(params, c, past, fut),
           "encode_peers": lambda c: cross_user.encode_peers(params, c, others, mask),
           "encode_peers_aligned": lambda c: cross_user.encode_peers_aligned(params, c, others, mask)}[path]
    before = fused_lstm.fused_lstm_cell.launches_bf16
    got = run(cfg)
    torch.cuda.synchronize()
    assert fused_lstm.fused_lstm_cell.launches_bf16 == before + (30 if ctx else 2 * 30 + 2 * 30)
    plain = run(xla)
    assert got.shape == plain.shape and torch.isfinite(got.float()).all()
    assert (got.float() - plain.float()).abs().max().item() <= 2e-2


def test_serve_fused_defaults_to_bf16_on_the_card():
    cfg, params, past, *_ = _tfm_case(2, 30, 30, 64)
    before = (transformer_encode.fused_encode_tokens_bf16.launches, transformer_decode.fused_ar_decode_bf16.launches,
              transformer_encode.fused_encode_tokens.launches, transformer_decode.fused_ar_decode.launches)
    with torch.no_grad():
        got = transformer.serve_fused(params, cfg, past)
        f32 = transformer.serve_fused(params, cfg, past, compute_dtype=torch.float32)
    torch.cuda.synchronize()
    assert (transformer_encode.fused_encode_tokens_bf16.launches, transformer_decode.fused_ar_decode_bf16.launches,
            transformer_encode.fused_encode_tokens.launches, transformer_decode.fused_ar_decode.launches) == tuple(
        c + 1 for c in before)
    assert torch.equal(got, transformer.serve_fused(params, cfg, past, compute_dtype=torch.bfloat16))
    assert (got - f32).abs().max().item() <= BF16_F32_TOL


# The bf16 encoder on the tensor cores (encode_tokens_kernel<bf16>) at the
# f32 test's shapes, T = 1 and L = 8: within BF16_TOL of its bf16 plain
# version and BF16_F32_TOL of the f32 one, and at least BF16C_FLOOR of the
# bf16 plain version's mean gap from the f32 one, so that a kernel that does
# not round as the tier does fails. A flipped rounding carries through the
# later layers, so at L = 8 the gap to the bf16 plain version is held to
# chip_smoke.py's BF16_TOL, 5e-2 (scripts/torch_encode_bf16_probe.py read
# 2.70e-2 on an NVIDIA H100 80GB HBM3 at 700.00 W, and 2.35e-2 for the FMA
# design it replaced, against 6.8e-2 between the bf16 and f32 plain
# versions).
BF16C_FLOOR = 0.5
DEEP_BF16_TOL = 5e-2


@pytest.mark.parametrize("layers,t,batch", [(2, 30, 257), (1, 6, 8), (3, 64, 5), (2, 7, 1), (2, 30, 16387),
                                            (2, 1, 100), (8, 30, 50)])
def test_transformer_bf16_encode_kernel_matches_plain(layers, t, batch):
    cfg, params, past, enc, *_ = _tfm_case(layers, t, 4, batch, seed=layers)
    before = transformer_encode.fused_encode_tokens_bf16.launches
    out = transformer_encode.fused_encode_tokens(params, cfg, past, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert transformer_encode.fused_encode_tokens_bf16.launches == before + 1
    plain = transformer._encode(params, cfg, past, torch.bfloat16)
    assert out.shape == enc.shape and torch.isfinite(out).all()
    assert (out - plain).abs().max().item() <= (BF16_TOL if layers <= 3 else DEEP_BF16_TOL)
    assert (out - enc).abs().max().item() <= BF16_F32_TOL
    assert _mean_gap(out, enc) >= BF16C_FLOOR * _mean_gap(plain, enc), "the kernel does not round as the tier does"


def test_transformer_bf16_encode_rows_are_independent_and_repeat_bit_equal():
    cfg, params, past, *_ = _tfm_case(2, 30, 4, 200)
    bf16 = torch.bfloat16
    full = transformer_encode.fused_encode_tokens(params, cfg, past, compute_dtype=bf16)
    assert torch.equal(full, transformer_encode.fused_encode_tokens(params, cfg, past, compute_dtype=bf16))
    part = transformer_encode.fused_encode_tokens(params, cfg, past[70:131].contiguous(), compute_dtype=bf16)
    assert torch.equal(full[70:131], part)


# ------------------------------------------------- the shared tier and row 11
# The decode kernel's group-shared tier against the plain shared decode
# (models.transformer._ar_decode with peer_gid and peer_dv) within 3e-5, and
# against the per-row kernel on gathered copies; the encoder's training
# kernels against autograd through models.transformer._encode: the forward
# within 3e-5, every gradient within 2e-4 · max(|g|, 1) (the JAX suite's
# bounds, tests/test_transformer_encode.py), two runs bit-equal.


def _shared_case(layers, h_in, h_out, batch, k, pool, window, seed=0, d=3):
    """G = 3 peer groups of uneven size (1 row, 37 rows or fewer, the rest)
    under an unsorted gid, the last group with every peer masked; random δv."""
    cfg, params, past, enc, y0, *_ = _tfm_case(layers, h_in, h_out, batch, 0, pool, window, seed, d)
    rng = np.random.default_rng(seed)
    gfut = torch.tensor(rng.normal(size=(3, k, h_out, d)).astype(np.float32) * 0.3, device="cuda")
    gmask = torch.ones((3, k), device="cuda")
    gmask[1, 1:] = 0.0
    gmask[2] = 0.0
    gid = np.full(batch, 2, np.int32)
    gid[0] = 0
    gid[1:min(38, batch)] = 1
    gid = torch.tensor(rng.permutation(gid), device="cuda")
    gmem, gvalid = (x.contiguous() for x in transformer._peer_tokens(params, cfg, gfut, gmask))
    dv = torch.tensor(rng.normal(size=(batch, layers, 128)).astype(np.float32) * 0.1, device="cuda")
    return cfg, params, enc, y0, gmem, gvalid, gid, dv


@pytest.mark.parametrize("with_dv", [False, True])
@pytest.mark.parametrize("pool,window", [("none", 0), ("mean", 0), ("none", 8), ("mean", 2)])
@pytest.mark.parametrize("layers,h_in,h_out,batch", [(2, 30, 30, 257), (1, 6, 9, 40)])
def test_shared_tier_matches_plain(layers, h_in, h_out, batch, pool, window, with_dv):
    cfg, params, enc, y0, gmem, gvalid, gid, dv = _shared_case(layers, h_in, h_out, batch, 4, pool, window,
                                                               seed=layers + window)
    dv = dv if with_dv else None
    before = transformer_decode.fused_ar_decode_shared.launches
    out = transformer_decode.fused_ar_decode_shared(params, cfg, enc, y0, peer_gmem=gmem, peer_gvalid=gvalid,
                                                    peer_gid=gid, peer_dv=dv)
    torch.cuda.synchronize()
    assert transformer_decode.fused_ar_decode_shared.launches == before + 1
    ref = transformer._ar_decode(params, cfg, enc, gmem, gvalid, y0, peer_gid=gid.long(), peer_dv=dv)
    assert out.shape == (batch, h_out, 3) and torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 3e-5
    masked = gid == 2  # every peer masked: the peerless rollout, δv or not
    alone = transformer_decode.fused_ar_decode(params, cfg, enc, y0)
    assert (out[masked] - alone[masked]).abs().max().item() <= 3e-5
    if not with_dv:  # the per-row kernel on gathered copies
        rows = transformer_decode.fused_ar_decode(params, cfg, enc, y0, peer_mem=gmem[gid.long()].contiguous(),
                                                  peer_valid=gvalid[gid.long()].contiguous())
        assert (out - rows).abs().max().item() <= 3e-5


def test_shared_tier_never_falls_back_on_card():
    cfg, params, enc, y0, gmem, gvalid, gid, dv = _shared_case(1, 6, 5, 40, 2, "none", 0)
    call = transformer_decode.fused_ar_decode
    with pytest.raises(ValueError, match=r"\[0, 3\)"):
        call(params, cfg, enc, y0, peer_gmem=gmem, peer_gvalid=gvalid, peer_gid=gid + 3)
    with pytest.raises(ValueError, match="contiguous"):
        call(params, cfg, enc, y0, peer_gmem=gmem, peer_gvalid=gvalid, peer_gid=torch.stack([gid, gid], 1)[:, 0])
    with pytest.raises(ValueError, match="int32 or int64"):
        call(params, cfg, enc, y0, peer_gmem=gmem, peer_gvalid=gvalid, peer_gid=gid.float())
    with pytest.raises(TypeError, match="float32"):
        call(params, cfg, enc, y0, peer_gmem=gmem.double(), peer_gvalid=gvalid, peer_gid=gid)
    with pytest.raises(RuntimeError, match="no backward"):
        call(params, cfg, enc, y0, peer_gmem=gmem, peer_gvalid=gvalid, peer_gid=gid,
             peer_dv=dv.clone().requires_grad_(True))


def _encode_train_case(layers, t, batch, seed=0):
    cfg, params, past, *_ = _tfm_case(layers, t, 4, batch, seed=seed)
    for layer in params["enc"]:
        for sub in layer.values():
            for v in sub.values():
                v.requires_grad_(True)
    params["in_proj"].requires_grad_(True)
    cot = torch.tensor(np.random.default_rng(seed).normal(size=(batch, t, 128)).astype(np.float32), device="cuda")
    return cfg, params, past.requires_grad_(True), cot


def _encoder_leaves(params):
    return [params["in_proj"]] + [layer[sub][leaf] for layer in params["enc"] for sub, leaf in et._ENC_LEAVES]


# the last four at the edges of the 64-row tiles: T = 64, T = 1, L = 8, and
# 4097 viewers, one past a whole number of T = 30 tiles
@pytest.mark.parametrize("layers,t,batch", [(2, 30, 257), (1, 6, 8), (3, 64, 5), (2, 13, 1), (2, 30, 4096),
                                            (2, 64, 3), (2, 1, 65), (8, 30, 21), (2, 30, 4097)])
def test_encode_train_kernels_match_autograd(layers, t, batch):
    cfg, params, past, cot = _encode_train_case(layers, t, batch, seed=layers + t)
    counts = [f.launches for f in (et.encode_train_fwd, et.encode_train_bwd, et.encode_train_dw)]
    out = et.fused_encode_train(params, cfg, past)
    got = torch.autograd.grad((out * cot).sum(), [past, *_encoder_leaves(params)])
    torch.cuda.synchronize()
    assert [f.launches for f in (et.encode_train_fwd, et.encode_train_bwd, et.encode_train_dw)] == [
        c + 1 for c in counts]
    ref = transformer._encode(params, cfg, past)
    want = torch.autograd.grad((ref * cot).sum(), [past, *_encoder_leaves(params)])
    assert (out - ref).abs().max().item() <= 3e-5
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.isfinite(a).all()
        assert (a - b).abs().max().item() <= 2e-4 * max(b.abs().max().item(), 1.0)


def test_encode_train_gradients_are_bit_equal_on_repeat():
    cfg, params, past, cot = _encode_train_case(2, 30, 1000)
    runs = [torch.autograd.grad((et.fused_encode_train(params, cfg, past) * cot).sum(),
                                [past, *_encoder_leaves(params)]) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_encode_train_without_grad_is_the_serving_kernel():
    cfg, params, past, _ = _encode_train_case(2, 30, 70)
    before = (transformer_encode.fused_encode_tokens.launches, et.encode_train_fwd.launches)
    with torch.no_grad():
        out = et.fused_encode_train(params, cfg, past)
        assert (transformer_encode.fused_encode_tokens.launches, et.encode_train_fwd.launches) == (
            before[0] + 1, before[1])
        assert torch.equal(out, transformer_encode.fused_encode_tokens(params, cfg, past))


def test_encode_train_never_falls_back_on_card():
    cfg, params, past, _ = _encode_train_case(1, 6, 4)
    with pytest.raises(ValueError, match="T <= 64"):
        et.fused_encode_train(params, cfg, torch.zeros(2, 65, 3, device="cuda", requires_grad=True))
    with pytest.raises(NotImplementedError, match="slice I"):
        et.fused_encode_train(params, cfg, past, compute_dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        et.fused_encode_train(params, cfg, past.double())
    with pytest.raises(ValueError, match="contiguous"):
        params["enc"][0]["attn"]["wq"] = params["enc"][0]["attn"]["wq"].detach().t()
        et.fused_encode_train(params, cfg, past)


# ------------------------------------------------------------ the daemon on the card (slices C-1 and C-2)


@pytest.mark.parametrize("wire", ["json", "binary"])
def test_daemon_on_the_card_answers_a_client(wire):
    """serve_daemon on the card answers a FovClient's push flow and bulk
    request on both wires through the serve kernel (its launch counter
    rises), within 1e-4 of the plain path on the CPU."""
    import threading

    from longterm360fov_tpu_torch import serving
    from longterm360fov_tpu_torch.config import get_preset
    from longterm360fov_tpu_torch.models import get_family

    cfg = get_preset("seq2seq-tf-30")
    fam = get_family(cfg.model_family)
    params_np = oracle.init_params_np(0, cfg.model)
    server = serving.serve_daemon(params_from_numpy(params_np, "cuda"), cfg, fam, device="cuda", port=0,
                                  max_batch=16, warmup=True)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    client = serving.FovClient(*server.server_address, wire=wire)
    rng = np.random.default_rng(3)
    pasts = rng.normal(size=(5, cfg.model.h_in, 3)).astype(np.float32)
    pasts /= np.linalg.norm(pasts, axis=-1, keepdims=True)
    try:
        before = fused_lstm.fused_serve.launches
        arg = pasts if wire == "binary" else pasts.tolist()
        bulk = client.request({"op": "predict_batch", "past": arg})
        for pose in pasts[0]:
            r = client.push("viewer", pose.tolist())
        assert fused_lstm.fused_serve.launches > before
    finally:
        client.close()
        server.shutdown()
        server.server_close()
        server.batcher.stop()
    assert "error" not in bulk and "error" not in r, (bulk, r)
    cpu = serving.make_serve_fn(params_from_numpy(params_np, "cpu"), cfg, fam, device="cpu", impl="plain")
    ref = cpu.unpack(cpu({"past": pasts}).numpy())

    def xyz(out):  # compared as directions: yaw wraps at ±π
        yaw, pitch = np.asarray(out["yaw"], np.float64), np.asarray(out["pitch"], np.float64)
        return np.stack([np.cos(pitch) * np.cos(yaw), np.cos(pitch) * np.sin(yaw), np.sin(pitch)], -1)

    assert np.abs(xyz(bulk) - xyz(ref)).max() <= 1e-4
    assert np.abs(xyz(r) - xyz(ref)[0]).max() <= 1e-4
