"""The port's scheduled-sampling decoder (``ops.lstm_ss``), the encode kernel
and the static-context serve tier (``ops.fused_lstm``) against the JAX
package, on the CPU.

The JAX Pallas kernels run in interpret mode, as the JAX suite runs them
here; the port's wrappers run their plain versions on CPU tensors, through
the same residual contract the CUDA kernels keep. Weights cross between the
packages (params_from_numpy), seeds do not: inputs come from numpy.
"""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longterm360fov_tpu.models import cell as jax_cell
from longterm360fov_tpu.models import seq2seq as S
from longterm360fov_tpu.models.cell import LSTMParams as JaxLSTMParams
from longterm360fov_tpu.ops import fused_lstm as jax_fused
from longterm360fov_tpu.ops import lstm_ss as jax_ss
from longterm360fov_tpu_torch.models import seq2seq
from longterm360fov_tpu_torch.models.cell import LSTMParams
from longterm360fov_tpu_torch.ops import fused_lstm, lstm_ss, lstm_train
from longterm360fov_tpu_torch.params import params_from_numpy

FWD_TOL = 3e-5  # tests/test_lstm_ss.py: ss forward vs the XLA scan
ENC_TOL = 2e-5  # tests/test_cross_user.py: serve_fused vs the scan
# the bf16-compute tier: each forward output within a fifth of its JAX
# bf16-vs-f32 gap of JAX's bf16 kernel, each gradient within a quarter, and
# the port's bf16 at least half the gap from its own f32
# (tests/test_torch_lstm_train.py says why)
FWD_FRAC, GRAD_FRAC = 0.2, 0.25


def _setup(layers, ctx_dim, seed=0, b=8, h_in=5, h_out=6, hidden=32):
    jcfg = S.Seq2SeqConfig(d=3, hidden=hidden, layers=layers, h_in=h_in, h_out=h_out, ctx_dim=ctx_dim)
    tcfg = seq2seq.Seq2SeqConfig(d=3, hidden=hidden, layers=layers, h_in=h_in, h_out=h_out,
                                 ctx_dim=ctx_dim)
    jparams = S.init(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(seed)
    past = rng.normal(size=(b, h_in, 3)).astype(np.float32) * 0.3
    fut = rng.normal(size=(b, h_out, 3)).astype(np.float32) * 0.3
    coins = (rng.random((h_out, b, 1)) < 0.5).astype(np.float32)
    ctx = rng.normal(size=(b, ctx_dim)).astype(np.float32) if ctx_dim else None
    return jcfg, tcfg, jparams, tparams, past, fut, coins, ctx


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


CASES = [(1, 0), (1, 8), (2, 0), (2, 8)]


@pytest.mark.parametrize("layers,ctx_dim", CASES)
def test_ss_forward_matches_jax(layers, ctx_dim):
    """apply_fused_ss (f32 residuals) against the JAX fused forward and the
    JAX XLA scan given the same coins."""
    jcfg, tcfg, jp, tp, past, fut, coins, ctx = _setup(layers, ctx_dim)
    ours = seq2seq.apply_fused_ss(tp, tcfg, _t(past), _t(fut), coins=_t(coins), context=_t(ctx),
                                  residual_dtype=torch.float32)
    fused = S.apply_fused_ss(jp, jcfg, _j(past), _j(fut), coins=_j(coins), context=_j(ctx),
                             tile_b=8, residual_dtype=jnp.float32)
    scan = S.apply(jp, jcfg, _j(past), _j(fut), coins=_j(coins), context=_j(ctx))
    assert ours.shape == (8, jcfg.h_out, 3)
    np.testing.assert_allclose(ours.numpy(), np.asarray(fused), atol=FWD_TOL)
    np.testing.assert_allclose(ours.numpy(), np.asarray(scan), atol=FWD_TOL)
    # the port's own plain paths: apply(coins=) and the bf16-residual default
    np.testing.assert_allclose(
        seq2seq.apply(tp, tcfg, _t(past), _t(fut), coins=_t(coins), context=_t(ctx)).numpy(),
        np.asarray(scan), atol=FWD_TOL)


def test_ss_coin_extremes_match_teacher_forcing_and_decode():
    jcfg, tcfg, jp, tp, past, fut, _, _ = _setup(1, 0, seed=2)
    ones, zeros = torch.ones(jcfg.h_out, 8, 1), torch.zeros(jcfg.h_out, 8, 1)
    out_tf = seq2seq.apply_fused_ss(tp, tcfg, _t(past), _t(fut), coins=ones,
                                    residual_dtype=torch.float32)
    np.testing.assert_allclose(out_tf.numpy(), np.asarray(S.apply(jp, jcfg, _j(past), _j(fut))),
                               atol=FWD_TOL)
    out_ar = seq2seq.apply_fused_ss(tp, tcfg, _t(past), _t(fut), coins=zeros,
                                    residual_dtype=torch.float32)
    np.testing.assert_allclose(out_ar.numpy(), np.asarray(S.decode(jp, jcfg, _j(past))),
                               atol=FWD_TOL)


def _reference_forward(tp, tcfg, past, fut, coins, ctx):
    """The scheduled-sampling forward on the port's step loops: the encoder
    on lstm_seq_states_reference, the decoder on ss_decode_reference."""
    b = past.shape[0]
    z = torch.zeros(tcfg.layers, b, tcfg.hidden)
    _, hT, cT = lstm_train.lstm_seq_states_reference(tp["encoder"], past, z, z)
    y0 = past[:, -1]
    teacher = torch.cat([y0[None], fut.transpose(0, 1)[:-1]])
    return lstm_ss.ss_decode_reference(tp["decoder"], tp["proj"]["w"], tp["proj"]["b"], hT, cT,
                                       y0, teacher, (coins, ctx))


@pytest.mark.parametrize("layers,ctx_dim", CASES)
def test_ss_gradients_match_jax_grad(layers, ctx_dim):
    """Gradients of the mean squared error through apply_fused_ss (the
    autograd function over the kernels' plain versions, f32 residuals)
    against jax.grad of the JAX XLA scan S.apply(coins=...), and against
    torch autograd of ss_decode_reference: 4e-4·scale + 1e-7 for every
    parameter, past, future and ctx (tests/test_lstm_ss.py)."""
    jcfg, tcfg, jp, tp, past, fut, coins, ctx = _setup(layers, ctx_dim, seed=1)

    def loss_ref(p, x, f, c):
        return jnp.mean((S.apply(p, jcfg, x, f, coins=_j(coins), context=c) - f) ** 2)

    argnums = (0, 1, 2) if ctx is None else (0, 1, 2, 3)
    g_jax = jax.tree.leaves(jax.grad(loss_ref, argnums=argnums)(jp, _j(past), _j(fut), _j(ctx)))

    grads = {}
    for name in ("kernels", "reference"):
        leaves = [t.clone().requires_grad_(True) for t in jax.tree.leaves(tp)]
        params = jax.tree.unflatten(jax.tree.structure(tp), leaves)
        ins = [x.clone().requires_grad_(True) for x in (_t(past), _t(fut))]
        ins.append(None if ctx is None else _t(ctx).clone().requires_grad_(True))
        if name == "kernels":
            out = seq2seq.apply_fused_ss(params, tcfg, ins[0], ins[1], coins=_t(coins),
                                         context=ins[2], residual_dtype=torch.float32)
        else:
            out = _reference_forward(params, tcfg, ins[0], ins[1], _t(coins), ins[2])
        loss = torch.mean((out - ins[1]) ** 2)
        wrt = leaves + [x for x in ins if x is not None]
        grads[name] = torch.autograd.grad(loss, wrt)
    assert len(grads["kernels"]) == len(g_jax)
    for ours, plain, ref in zip(grads["kernels"], grads["reference"], g_jax):
        ref = np.asarray(ref)
        scale = max(float(np.abs(ref).max()), 1e-6)
        np.testing.assert_allclose(ours.numpy(), ref, atol=4e-4 * scale + 1e-7)
        np.testing.assert_allclose(ours.numpy(), plain.numpy(), atol=4e-4 * scale + 1e-7)


def _kernel_inputs(layers, ctx_dim, seed, b=8, t=6, hidden=32):
    """Decoder inputs of ss_decode at its own interface, from numpy."""
    rng = np.random.default_rng(seed)
    d = 3
    ps = []
    for l in range(layers):
        fan = (d + ctx_dim if l == 0 else hidden) + hidden
        ps.append((rng.uniform(-0.3, 0.3, size=(fan, 4 * hidden)).astype(np.float32),
                   rng.normal(size=4 * hidden).astype(np.float32) * 0.1))
    arrs = dict(
        proj_w=rng.normal(size=(hidden, d)).astype(np.float32) * 0.2,
        proj_b=rng.normal(size=d).astype(np.float32) * 0.1,
        h0=rng.normal(size=(layers, b, hidden)).astype(np.float32) * 0.3,
        c0=rng.normal(size=(layers, b, hidden)).astype(np.float32) * 0.3,
        y0=rng.normal(size=(b, d)).astype(np.float32) * 0.3,
        teacher=rng.normal(size=(t, b, d)).astype(np.float32) * 0.3,
        coins=(rng.random((t, b, 1)) < 0.5).astype(np.float32),
        ctx=rng.normal(size=(b, ctx_dim)).astype(np.float32) if ctx_dim else None,
        dys=rng.normal(size=(b, t, d)).astype(np.float32),
    )
    return ps, arrs


@pytest.mark.parametrize("rd", ["float32", "bfloat16"])
@pytest.mark.parametrize("layers,ctx_dim", [(1, 0), (2, 8)])
def test_ss_kernels_plain_versions_match_jax_kernels(layers, ctx_dim, rd):
    """The plain versions of the four kernels against the JAX Pallas forward
    and backward (interpret mode), at the kernels' own interface: the
    forward's ys and residuals, then the backward fed the SAME residuals on
    both sides (the port's, time-major for JAX): dW, db, dproj_w, dproj_b,
    dh0, dc0, dy0, dteacher and dctx within 1e-5 of max|JAX| (f32 sums in
    another order)."""
    ps, a = _kernel_inputs(layers, ctx_dim, seed=layers)
    tdt, jdt = getattr(torch, rd), getattr(jnp, rd)
    tps = [LSTMParams(torch.from_numpy(w), torch.from_numpy(b)) for w, b in ps]
    jps = [JaxLSTMParams(w=jnp.asarray(w), b=jnp.asarray(b)) for w, b in ps]
    t = {k: _t(v) for k, v in a.items()}
    j = {k: _j(v) for k, v in a.items()}
    ys, res = lstm_ss.ss_fwd(tps, t["proj_w"], t["proj_b"], t["h0"], t["c0"], t["y0"],
                             t["teacher"], t["coins"], t["ctx"], tdt)
    j_ys, j_hs, j_cs, j_gs = jax_ss._forward(jps, j["proj_w"], j["proj_b"], j["h0"], j["c0"],
                                             j["y0"], j["teacher"], j["coins"], j["ctx"], 8, jdt)
    np.testing.assert_allclose(ys.numpy(), np.swapaxes(np.asarray(j_ys), 0, 1), atol=1e-6)
    for ours, ref in zip(res.hs + res.cs + res.gs, list(j_hs) + list(j_cs) + list(j_gs)):
        ref = np.swapaxes(np.asarray(ref.astype(jnp.float32)), 0, 1)
        # bf16: a 1e-7 difference may round to the neighbouring bf16 value
        tol = 1e-6 if rd == "float32" else 1e-6 + 2.0 ** -7 * np.abs(ref)
        assert np.all(np.abs(ours.float().numpy() - ref) <= tol)

    dgates, dy, dteach, dy0, dh0, dc0, dctx = lstm_ss.ss_bwd(
        tps, t["proj_w"], t["c0"], t["coins"], res, t["dys"], ctx_dim)
    dps = lstm_ss.ss_dw(tps, t["h0"], t["y0"], t["teacher"], t["coins"], t["ctx"], ys, res, dgates)
    dpw, dpb = lstm_ss.ss_dproj(res.hs[-1], dy)
    tm = lambda x: jnp.asarray(np.swapaxes(x.numpy(), 0, 1))  # noqa: E731
    jres = [[jnp.asarray(np.swapaxes(r.float().numpy(), 0, 1)).astype(jdt) for r in group]
            for group in (res.hs, res.cs, res.gs)]
    jd, j_dpw, j_dpb, j_dh0, j_dc0, j_dy0, j_dteach, j_dctx = jax_ss._backward(
        jps, j["proj_w"], j["proj_b"], j["h0"], j["c0"], j["y0"], j["teacher"], j["coins"],
        j["ctx"], tm(ys), *jres, tm(t["dys"]), 8)
    pairs = [(p.w, q.w) for p, q in zip(dps, jd)] + [(p.b, q.b) for p, q in zip(dps, jd)]
    pairs += [(dpw, j_dpw), (dpb, j_dpb), (dh0, j_dh0), (dc0, j_dc0), (dy0, j_dy0),
              (dteach, j_dteach)]
    if ctx_dim:
        pairs.append((dctx, j_dctx))
    else:
        assert dctx is None and j_dctx is None
    for ours, ref in pairs:
        ref = np.asarray(ref)
        np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5 * max(np.abs(ref).max(), 1e-6))


def _bf16_parity(names, jax_bf, jax_f32, ours_bf, ours_f32, n_fwd):
    for i, name in enumerate(names):
        jb, jf = np.asarray(jax_bf[i], np.float32), np.asarray(jax_f32[i], np.float32)
        ob, of = np.asarray(ours_bf[i], np.float32), np.asarray(ours_f32[i], np.float32)
        gap, err = float(np.abs(jb - jf).max()), float(np.abs(ob - jb).max())
        frac = FWD_FRAC if i < n_fwd else GRAD_FRAC
        assert err <= frac * gap, f"{name}: |port − JAX| {err:.3g} > {frac} × gap {gap:.3g}"
        assert float(np.abs(ob - of).max()) >= 0.5 * gap, f"{name}: the port's bf16 does not round"


@pytest.mark.parametrize("rd", ["float32", "bfloat16"])
@pytest.mark.parametrize("layers,ctx_dim", [(1, 64), (2, 128)])
def test_ss_decode_bf16_compute_matches_jax(layers, ctx_dim, rd):
    """compute_dtype=bfloat16 at H = 128 and the contexts of video-fusion
    (C = 64) and stacked-ss-crossuser (C = 128): ys and the gradients of
    every decoder W and b, proj_w, proj_b, h0, c0, y0, the teacher and the
    context, port plain bf16 against jax.grad through JAX's bf16 kernels,
    the same coins; bound in the module header."""
    b, t, d, hidden = 8, 7, 3, 128
    rng = np.random.default_rng(60 + layers)
    keys = jax.random.split(jax.random.PRNGKey(60 + layers), layers)
    jps = [jax_cell.init_lstm(keys[l], (d + ctx_dim if l == 0 else hidden), hidden)
           for l in range(layers)]
    ins = [rng.normal(size=(hidden, d)).astype(np.float32) * 0.2,
           rng.normal(size=d).astype(np.float32) * 0.1,
           rng.normal(size=(layers, b, hidden)).astype(np.float32) * 0.3,
           rng.normal(size=(layers, b, hidden)).astype(np.float32) * 0.3,
           rng.normal(size=(b, d)).astype(np.float32) * 0.3,
           rng.normal(size=(t, b, d)).astype(np.float32) * 0.3,
           rng.normal(size=(b, ctx_dim)).astype(np.float32) * 0.5]
    coins = (rng.random((t, b, 1)) < 0.5).astype(np.float32)
    dys = rng.normal(size=(b, t, d)).astype(np.float32)
    dt = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
    jax_out, ours = {}, {}
    for cd in dt:
        def f(p, pw, pb, h0, c0, y0, te, cx):
            ys = jax_ss.ss_decode(p, pw, pb, h0, c0, y0, te, (_j(coins), cx), 8, dt[rd][0], dt[cd][0])
            return jnp.sum(ys * _j(dys)), ys

        (_, jys), jg = jax.value_and_grad(f, argnums=tuple(range(8)), has_aux=True)(
            jps, *map(jnp.asarray, ins))
        jax_out[cd] = [jys] + [g for q in jg[0] for g in (q.w, q.b)] + list(jg[1:])
        tps = [LSTMParams(torch.tensor(np.asarray(q.w), requires_grad=True),
                          torch.tensor(np.asarray(q.b), requires_grad=True)) for q in jps]
        tin = [torch.tensor(a, requires_grad=True) for a in ins]
        ys = lstm_ss.ss_decode(tps, *tin[:6], (_t(coins), tin[6]), dt[rd][1], dt[cd][1])
        (ys * _t(dys)).sum().backward()
        ours[cd] = [ys.detach()] + [x.grad for q in tps for x in q] + [x.grad for x in tin]
    names = ["ys"] + [f"{n}{l}" for l in range(layers) for n in ("dW", "db")]
    names += ["dproj_w", "dproj_b", "dh0", "dc0", "dy0", "dteacher", "dctx"]
    _bf16_parity(names, jax_out["bfloat16"], jax_out["float32"], ours["bfloat16"],
                 ours["float32"], 1)


@pytest.mark.parametrize("layers", [1, 2])
def test_fused_encode_matches_jax(layers):
    rng = np.random.default_rng(layers)
    ps = []
    for l in range(layers):
        fan = (3 if l == 0 else 16) + 16
        ps.append((rng.uniform(-0.4, 0.4, size=(fan, 64)).astype(np.float32),
                   rng.normal(size=64).astype(np.float32) * 0.1))
    xs = rng.normal(size=(11, 7, 3)).astype(np.float32) * 0.5
    ours = fused_lstm.fused_encode([LSTMParams(_t(w), _t(b)) for w, b in ps], _t(xs))
    ref = jax_fused.fused_encode([JaxLSTMParams(w=_j(w), b=_j(b)) for w, b in ps], _j(xs))
    assert ours.shape == (11, 16)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ENC_TOL)
    np.testing.assert_allclose(fused_lstm.fused_encode_reference(
        [LSTMParams(_t(w), _t(b)) for w, b in ps], _t(xs)).numpy(), np.asarray(ref), atol=ENC_TOL)


@pytest.mark.parametrize("layers", [1, 2])
def test_fused_serve_context_tier_matches_jax(layers):
    jcfg, tcfg, jp, tp, past, _, _, ctx = _setup(layers, 8, seed=4, h_in=6, h_out=5)
    ours = seq2seq.serve_fused(tp, tcfg, _t(past), context=_t(ctx))
    fused = S.serve_fused(jp, jcfg, _j(past), context=_j(ctx), tile_b=8)
    scan = S.decode(jp, jcfg, _j(past), context=_j(ctx))
    np.testing.assert_allclose(ours.numpy(), np.asarray(fused), atol=ENC_TOL)
    np.testing.assert_allclose(ours.numpy(), np.asarray(scan), atol=ENC_TOL)


def test_apply_fused_tf_with_context_matches_jax():
    """The teacher-forced training forward with a static context (f32
    residuals) against JAX apply_fused_tf and its gradient."""
    jcfg, tcfg, jp, tp, past, fut, _, ctx = _setup(2, 8, seed=5)
    ours = seq2seq.apply_fused_tf(tp, tcfg, _t(past), _t(fut), context=_t(ctx),
                                  residual_dtype=torch.float32)
    ref = S.apply_fused_tf(jp, jcfg, _j(past), _j(fut), context=_j(ctx), tile_b=8,
                           residual_dtype=jnp.float32)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=FWD_TOL)
    np.testing.assert_allclose(ours.numpy(), np.asarray(S.apply(jp, jcfg, _j(past), _j(fut),
                                                                context=_j(ctx))), atol=FWD_TOL)


def test_ss_wrappers_reject_what_the_kernels_do_not_take():
    ps, a = _kernel_inputs(1, 8, seed=0)
    tps = [LSTMParams(_t(w), _t(b)) for w, b in ps]
    t = {k: _t(v) for k, v in a.items()}
    args = [tps, t["proj_w"], t["proj_b"], t["h0"], t["c0"], t["y0"], t["teacher"]]
    with pytest.raises(TypeError, match="compute_dtype"):
        lstm_ss.ss_decode(*args, (t["coins"], t["ctx"]), compute_dtype=torch.float16)
    with pytest.raises(TypeError, match="residual_dtype"):
        lstm_ss.ss_fwd(*args, t["coins"], t["ctx"], torch.float16)
    with pytest.raises(ValueError):  # the decoder's W takes [x, ctx]: no context given
        lstm_ss.ss_fwd(*args, t["coins"], None)
    with pytest.raises(ValueError):  # coins of the wrong shape
        lstm_ss.ss_fwd(*args, t["coins"][:, :, 0], t["ctx"])
    with pytest.raises(TypeError):  # f64
        lstm_ss.ss_fwd(*args[:5], t["y0"].double(), t["teacher"], t["coins"], t["ctx"])
    assert lstm_train.fwd_block(128, 2, 3, 4096, ctx_dim=128, mode="static").rp == 32
    with pytest.raises(ValueError, match="hidden a multiple of 32 up to 256, got hidden=48"):
        lstm_train.fwd_block(48, 1, 3, 4096, mode="static")
    with pytest.raises(ValueError, match="rng or explicit coins"):
        tcfg = seq2seq.Seq2SeqConfig(hidden=32, h_in=5, h_out=6, ctx_dim=8)
        p = seq2seq.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
        seq2seq.apply_fused_ss(p, tcfg, torch.zeros(2, 5, 3), torch.zeros(2, 6, 3),
                               context=torch.zeros(2, 8))


def test_dproj_splits():
    """dproj's slices: four blocks an SM at the training batch (B·T =
    122,880 rows on 132 SMs: 528 slices of 233 rows, rounded up to 236 in
    the kernel), at least 64 rows a slice below it; the widths it takes;
    shapes it does not take raise."""
    assert lstm_ss.dproj_splits(4096 * 30, 3, 128, torch.bfloat16, 132) == 528
    assert lstm_ss.dproj_splits(4096 * 100, 3, 128, torch.float32, 132) == 528
    assert lstm_ss.dproj_splits(257, 1, 64, torch.float32, 132) == 4
    assert lstm_ss.dproj_splits(30, 4, 128, torch.bfloat16, 132) == 1
    # any H of whole 16-byte pieces, up to a thread a piece of the block's 256
    for h, rdt in ((4, torch.float32), (96, torch.float32), (100, torch.float32), (1024, torch.float32),
                   (8, torch.bfloat16), (48, torch.bfloat16), (160, torch.bfloat16), (2048, torch.bfloat16)):
        assert lstm_ss.dproj_splits(1000, 3, h, rdt, 132) == 15
    for d, h, rdt in ((0, 128, torch.float32), (5, 128, torch.float32), (3, 102, torch.float32),
                      (3, 12, torch.bfloat16), (3, 100, torch.bfloat16), (3, 1028, torch.float32),
                      (3, 2056, torch.bfloat16)):
        with pytest.raises(ValueError, match="dproj kernel takes"):
            lstm_ss.dproj_splits(1000, d, h, rdt, 132)
