"""The port's lockstep-peer kernels' plain versions against the JAX package,
on the CPU: ``ops.lstm_align.aligned_ss_decode`` (forward and every
gradient, both residual types), its plain pieces, and the lockstep tier of
``ops.fused_lstm.fused_serve``.

The JAX Pallas kernels run in interpret mode, as the JAX suite runs them
here; the port's wrappers run their plain versions on CPU tensors. Shapes
are the JAX suite's (``tests/test_lstm_align.py``): L = 1 and 2, K = 3,
h_in = 4, T = 5, H = 16, C = 8, B = 8. Inputs come from numpy.
"""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longterm360fov_tpu.models import cell as jax_cell
from longterm360fov_tpu.models import cross_user as CU
from longterm360fov_tpu.models import seq2seq as S
from longterm360fov_tpu.models.cell import LSTMParams as JaxLSTMParams
from longterm360fov_tpu.ops import fused_lstm as jax_fused
from longterm360fov_tpu.ops import lstm_align as jax_align
from longterm360fov_tpu_torch.models import cross_user, seq2seq
from longterm360fov_tpu_torch.models.cell import LSTMParams
from longterm360fov_tpu_torch.ops import fused_lstm, lstm_align, lstm_ss
from longterm360fov_tpu_torch.params import params_from_numpy

FWD_TOL = 2e-5  # tests/test_lstm_align.py: the aligned forward vs the XLA path
SERVE_TOL = 1e-5  # the lockstep serve tier vs JAX, normalized outputs
# the bf16-compute tier: each forward output within a fifth of its JAX
# bf16-vs-f32 gap of JAX's bf16 kernel, each gradient within a quarter, and
# the port's bf16 at least half the gap from its own f32
# (tests/test_torch_lstm_train.py says why)
FWD_FRAC, GRAD_FRAC = 0.2, 0.25


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _kernel_inputs(layers, seed, k=3, b=8, t=5, hidden=16, ctx=8, masked=True):
    """aligned_ss_decode's inputs at its own interface, from numpy."""
    rng = np.random.default_rng(seed)
    d = 3

    def lay(fan, h):
        return (rng.uniform(-0.3, 0.3, size=(fan, 4 * h)).astype(np.float32),
                rng.normal(size=4 * h).astype(np.float32) * 0.1)

    dec = [lay((d + ctx if l == 0 else hidden) + hidden, hidden) for l in range(layers)]
    peer = lay(d + ctx, ctx)
    m = (rng.random((b, k)) < 0.6).astype(np.float32)
    m[0] = 0.0  # a row with every peer masked out
    pwt = m / np.maximum(m.sum(1, keepdims=True), 1.0) if masked else np.full((b, k), 1.0 / k)
    arrs = dict(
        proj_w=rng.normal(size=(hidden, d)).astype(np.float32) * 0.2,
        proj_b=rng.normal(size=d).astype(np.float32) * 0.1,
        h0=rng.normal(size=(layers, b, hidden)).astype(np.float32) * 0.3,
        c0=rng.normal(size=(layers, b, hidden)).astype(np.float32) * 0.3,
        y0=rng.normal(size=(b, d)).astype(np.float32) * 0.3,
        teacher=rng.normal(size=(t, b, d)).astype(np.float32) * 0.3,
        pxs=rng.normal(size=(t, b, k * d)).astype(np.float32) * 0.5,
        coins=(rng.random((t, b, 1)) < 0.5).astype(np.float32),
        pwt=pwt.astype(np.float32),
        dys=rng.normal(size=(b, t, d)).astype(np.float32),
    )
    return dec, peer, arrs


def _sides(dec, peer):
    jd = [JaxLSTMParams(w=jnp.asarray(w), b=jnp.asarray(b)) for w, b in dec]
    td = [LSTMParams(_t(w), _t(b)) for w, b in dec]
    return jd, JaxLSTMParams(w=jnp.asarray(peer[0]), b=jnp.asarray(peer[1])), td, LSTMParams(
        _t(peer[0]), _t(peer[1]))


_ORDER = ("proj_w", "proj_b", "h0", "c0", "y0", "teacher", "pxs")


@pytest.mark.parametrize("layers,masked", [(1, True), (2, True), (2, False)])
def test_aligned_forward_matches_jax(layers, masked):
    """The port's forward (the plain versions under the autograd function)
    and its step loop against JAX aligned_ss_decode with explicit coins."""
    dec, peer, a = _kernel_inputs(layers, seed=layers, masked=masked)
    jd, jpeer, td, tpeer = _sides(dec, peer)
    ref = np.asarray(jax_align.aligned_ss_decode(
        jd, *(_j(a[k]) for k in ("proj_w", "proj_b")), jpeer, *(_j(a[k]) for k in _ORDER[2:]),
        (_j(a["coins"]), _j(a["pwt"])), 8))
    args = (td, _t(a["proj_w"]), _t(a["proj_b"]), tpeer, *(_t(a[k]) for k in _ORDER[2:]),
            (_t(a["coins"]), _t(a["pwt"])))
    assert lstm_align.aligned_ss_decode(*args).shape == (8, 5, 3)
    np.testing.assert_allclose(lstm_align.aligned_ss_decode(*args).numpy(), ref, atol=FWD_TOL)
    np.testing.assert_allclose(lstm_align.aligned_ss_decode_reference(*args).numpy(), ref,
                               atol=FWD_TOL)


def _grads(layers, rd, seed):
    """Gradients of Σ out · dys on every input of aligned_ss_decode (dpxs
    and dpwt included), the port's and JAX's, with residuals ``rd``."""
    dec, peer, a = _kernel_inputs(layers, seed=seed)
    jd, jpeer, td, tpeer = _sides(dec, peer)
    jrd = jnp.float32 if rd == torch.float32 else jnp.bfloat16

    def jloss(dp, pw, pb, pe, h0, c0, y0, te, px, pwt):
        out = jax_align.aligned_ss_decode(dp, pw, pb, pe, h0, c0, y0, te, px,
                                          (_j(a["coins"]), pwt), 8, jrd)
        return jnp.sum(out * _j(a["dys"]))

    jg = jax.grad(jloss, argnums=tuple(range(10)))(
        jd, _j(a["proj_w"]), _j(a["proj_b"]), jpeer, *(_j(a[k]) for k in _ORDER[2:]), _j(a["pwt"]))
    ref = jax.tree.leaves(jg)
    leaves = [t.clone().requires_grad_(True) for p in td for t in p]
    ins = [_t(a[k]).clone().requires_grad_(True) for k in ("proj_w", "proj_b")]
    pe = [t.clone().requires_grad_(True) for t in tpeer]
    rest = [_t(a[k]).clone().requires_grad_(True) for k in _ORDER[2:] + ("pwt",)]
    params = [LSTMParams(leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2)]
    out = lstm_align.aligned_ss_decode(params, *ins, LSTMParams(*pe), *rest[:5],
                                       (_t(a["coins"]), rest[5]), rd)
    ours = torch.autograd.grad((out * _t(a["dys"])).sum(), leaves + ins + pe + rest)
    return ours, ref


@pytest.mark.parametrize("layers", [1, 2])
def test_aligned_gradients_match_jax_f32_residuals(layers):
    """Every leaf, the peer windows (dpxs) and the mask weights (dpwt)
    included: atol 5e-4, rtol 1e-3 (tests/test_lstm_align.py)."""
    ours, ref = _grads(layers, torch.float32, seed=layers + 1)
    assert len(ours) == len(ref) == 2 * layers + 10
    for x, y in zip(ours, ref):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=5e-4, rtol=1e-3)


def test_aligned_gradients_match_jax_bf16_residuals():
    """With bf16 residuals, against JAX's bf16 residuals: within 3 % of
    max|g| per leaf (tests/test_lstm_align.py's bound for the bf16 tier)."""
    ours, ref = _grads(2, torch.bfloat16, seed=4)
    for x, y in zip(ours, ref):
        y = np.asarray(y)
        assert np.abs(x.numpy() - y).max() <= 0.03 * max(np.abs(y).max(), 1e-3)


@pytest.mark.parametrize("rd", ["float32", "bfloat16"])
def test_aligned_bf16_compute_matches_jax(rd):
    """compute_dtype=bfloat16 at stacked-ss-crossuser-10s's widths (H = C =
    128, L = 2) with K = 3 peers and a fully masked row: the output and the
    gradient of every input (decoder and peer W and b, proj, h0, c0, y0,
    teacher, dpxs, dpwt), port plain bf16 against jax.grad through JAX's
    bf16 kernels; bound in the module header."""
    b, t, d, h, k, layers = 8, 7, 3, 128, 3, 2
    rng = np.random.default_rng(70)
    keys = jax.random.split(jax.random.PRNGKey(70), layers + 1)
    jd = [jax_cell.init_lstm(keys[l], (d + h if l == 0 else h), h) for l in range(layers)]
    jpeer = jax_cell.init_lstm(keys[layers], d, h)
    m = (rng.random((b, k)) < 0.6).astype(np.float32)
    m[0] = 0.0
    ins = [rng.normal(size=(h, d)).astype(np.float32) * 0.2,
           rng.normal(size=d).astype(np.float32) * 0.1,
           rng.normal(size=(layers, b, h)).astype(np.float32) * 0.3,
           rng.normal(size=(layers, b, h)).astype(np.float32) * 0.3,
           rng.normal(size=(b, d)).astype(np.float32) * 0.3,
           rng.normal(size=(t, b, d)).astype(np.float32) * 0.3,
           rng.normal(size=(t, b, k * d)).astype(np.float32) * 0.5,
           (m / np.maximum(m.sum(1, keepdims=True), 1.0)).astype(np.float32)]
    coins = (rng.random((t, b, 1)) < 0.5).astype(np.float32)
    dys = rng.normal(size=(b, t, d)).astype(np.float32)
    dt = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
    jax_out, ours = {}, {}
    for cd in dt:
        def f(dp, pe, pw, pb, h0, c0, y0, te, px, pwt):
            out = jax_align.aligned_ss_decode(dp, pw, pb, pe, h0, c0, y0, te, px, (_j(coins), pwt),
                                              8, dt[rd][0], dt[cd][0])
            return jnp.sum(out * _j(dys)), out

        (_, jo), jg = jax.value_and_grad(f, argnums=tuple(range(10)), has_aux=True)(
            jd, jpeer, *map(jnp.asarray, ins))
        jax_out[cd] = [jo] + jax.tree.leaves(jg)
        tl = [torch.tensor(np.asarray(x), requires_grad=True) for q in jd + [jpeer] for x in q]
        tin = [torch.tensor(a, requires_grad=True) for a in ins]
        td = [LSTMParams(tl[i], tl[i + 1]) for i in range(0, 2 * layers, 2)]
        out = lstm_align.aligned_ss_decode(td, tin[0], tin[1], LSTMParams(tl[-2], tl[-1]),
                                           *tin[2:7], (_t(coins), tin[7]), dt[rd][1], dt[cd][1])
        (out * _t(dys)).sum().backward()
        ours[cd] = [out.detach()] + [x.grad for x in tl + tin]
    names = ["ys"] + [f"{n}{l}" for l in range(layers) for n in ("dW", "db")]
    names += ["dWp", "dbp", "dproj_w", "dproj_b", "dh0", "dc0", "dy0", "dteacher", "dpxs", "dpwt"]
    assert len(names) == len(ours["bfloat16"]) == len(jax_out["bfloat16"])
    for i, name in enumerate(names):
        jb, jf = np.asarray(jax_out["bfloat16"][i]), np.asarray(jax_out["float32"][i])
        ob, of = ours["bfloat16"][i].numpy(), ours["float32"][i].numpy()
        gap, err = float(np.abs(jb - jf).max()), float(np.abs(ob - jb).max())
        frac = FWD_FRAC if i == 0 else GRAD_FRAC
        assert err <= frac * gap, f"{name}: |port − JAX| {err:.3g} > {frac} × gap {gap:.3g}"
        assert float(np.abs(ob - of).max()) >= 0.5 * gap, f"{name}: the port's bf16 does not round"


def _pieces(layers, seed, rd=torch.float32):
    dec, peer, a = _kernel_inputs(layers, seed=seed)
    _, _, td, tpeer = _sides(dec, peer)
    t = {k: _t(v) for k, v in a.items()}
    t["pxs_rows"] = lstm_align.peer_rows_of(t["pxs"], 3)
    php, pcp, ctx = lstm_align.peer_fwd(tpeer, t["pxs_rows"], t["pwt"], rd)
    ys, res = lstm_align.dec_fwd(td, t["proj_w"], t["proj_b"], t["h0"], t["c0"], t["y0"],
                                 t["teacher"], t["coins"], ctx, rd)
    return td, tpeer, t, (php, pcp, ctx), (ys, res)


@pytest.mark.parametrize("layers", [1, 2])
def test_plain_pieces_match_autograd_of_the_plain_forward(layers):
    """The backward pieces (decoder recurrence, peer backward, both dW
    reductions, dproj) chained by hand against torch autograd of the step
    loop, f32 residuals: 1e-5 of max|autograd| per input."""
    td, tpeer, t, (php, pcp, ctx), (ys, res) = _pieces(layers, seed=layers + 5)
    dgates, dy, dteacher, dy0, dh0, dc0, dctx = lstm_align.dec_bwd(
        td, t["proj_w"], t["c0"], t["coins"], res, t["dys"], 8)
    assert dctx.shape == (8, 5, 8)
    dpg, dpxs, dpwt = lstm_align.peer_bwd(tpeer, t["pxs_rows"], t["pwt"], php, pcp, dctx)
    dps = lstm_align.dec_dw(td, t["h0"], t["y0"], t["teacher"], t["coins"], t["pwt"], php, ys, res,
                            dgates)
    dpeer = lstm_align.peer_dw(tpeer, t["pxs_rows"], php, dpg)
    dpw, dpb = lstm_ss.ss_dproj(res.hs[-1], dy)

    leaves = [x.clone().requires_grad_(True) for p in td for x in p]
    ins = [t[k].clone().requires_grad_(True) for k in _ORDER + ("pwt",)]
    pe = [x.clone().requires_grad_(True) for x in tpeer]
    params = [LSTMParams(leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2)]
    out = lstm_align.aligned_ss_decode_reference(params, ins[0], ins[1], LSTMParams(*pe),
                                                 *ins[2:7], (t["coins"], ins[7]))
    np.testing.assert_allclose(out.detach().numpy(), ys.numpy(), atol=1e-6)
    ref = torch.autograd.grad((out * t["dys"]).sum(), leaves + ins + pe)
    ours = [g for p in dps for g in p] + [dpw, dpb, dh0, dc0, dy0, dteacher,
                                          lstm_align._time_major(dpxs, 8), dpwt, dpeer.w, dpeer.b]
    assert len(ours) == len(ref)
    for x, y in zip(ours, ref):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-5 * max(y.abs().max().item(), 1e-6))


def test_plain_pieces_match_jax_kernels_given_the_same_residuals():
    """The forward pieces' residuals (peer h and c, decoder h, c, gates)
    against JAX _forward, and the backward pieces fed the port's bf16
    residuals against JAX _backward fed the same: 1e-5 of max|JAX|."""
    td, tpeer, t, (php, pcp, ctx), (ys, res) = _pieces(2, seed=9, rd=torch.bfloat16)
    dec, peer, a = _kernel_inputs(2, seed=9)
    jd, jpeer, _, _ = _sides(dec, peer)
    j = {k: _j(v) for k, v in a.items()}
    fw = jax_align._forward(jd, j["proj_w"], j["proj_b"], jpeer, j["h0"], j["c0"], j["y0"],
                            j["teacher"], j["coins"], j["pxs"], j["pwt"], 8, jnp.bfloat16)
    np.testing.assert_allclose(ys.numpy(), np.swapaxes(np.asarray(fw[0]), 0, 1), atol=1e-6)
    tm = lambda x: np.swapaxes(x.float().numpy(), 0, 1)  # noqa: E731
    peer_tm = lambda x: tm(x).reshape(5, 8, -1)  # (B·K, T, C) → (T, B, K·C)  # noqa: E731
    for ours, ref in [(peer_tm(php), fw[4]), (peer_tm(pcp), fw[5])] + [
            (tm(x), y) for x, y in zip(res.hs + res.cs + res.gs, fw[1] + fw[2] + fw[3])]:
        ref = np.asarray(ref.astype(jnp.float32))
        assert np.all(np.abs(ours - ref) <= 1e-6 + 2.0 ** -7 * np.abs(ref))

    dgates, dy, dteacher, dy0, dh0, dc0, dctx = lstm_align.dec_bwd(
        td, t["proj_w"], t["c0"], t["coins"], res, t["dys"], 8)
    dpg, dpxs, dpwt = lstm_align.peer_bwd(tpeer, t["pxs_rows"], t["pwt"], php, pcp, dctx)
    dps = lstm_align.dec_dw(td, t["h0"], t["y0"], t["teacher"], t["coins"], t["pwt"], php, ys, res,
                            dgates)
    dpeer = lstm_align.peer_dw(tpeer, t["pxs_rows"], php, dpg)
    dpw, dpb = lstm_ss.ss_dproj(res.hs[-1], dy)
    jres = [[jnp.asarray(tm(r)).astype(jnp.bfloat16) for r in g] for g in (res.hs, res.cs, res.gs)]
    jb = jax_align._backward(jd, j["proj_w"], j["proj_b"], jpeer, j["h0"], j["c0"], j["y0"],
                             j["teacher"], j["coins"], j["pxs"], j["pwt"], jnp.asarray(tm(ys)),
                             *jres, jnp.asarray(peer_tm(php)).astype(jnp.bfloat16),
                             jnp.asarray(peer_tm(pcp)).astype(jnp.bfloat16),
                             jnp.asarray(tm(t["dys"])), 8)
    jdp, jdpw, jdpb, jdpeer, jdh0, jdc0, jdy0, jdteach, jdpxs, jdpwt = jb
    pairs = [(p.w, q.w) for p, q in zip(dps, jdp)] + [(p.b, q.b) for p, q in zip(dps, jdp)]
    pairs += [(dpw, jdpw), (dpb, jdpb), (dpeer.w, jdpeer.w), (dpeer.b, jdpeer.b), (dh0, jdh0),
              (dc0, jdc0), (dy0, jdy0), (dteacher, jdteach),
              (lstm_align._time_major(dpxs, 8), jdpxs), (dpwt, jdpwt)]
    for ours, ref in pairs:
        ref = np.asarray(ref)
        np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5 * max(np.abs(ref).max(), 1e-6))


def test_aligned_wrappers_reject_what_the_kernels_do_not_take():
    dec, peer, a = _kernel_inputs(1, seed=0)
    _, _, td, tpeer = _sides(dec, peer)
    t = {k: _t(v) for k, v in a.items()}
    args = (td, t["proj_w"], t["proj_b"], tpeer, t["h0"], t["c0"], t["y0"], t["teacher"], t["pxs"],
            (t["coins"], t["pwt"]))
    with pytest.raises(TypeError, match="compute_dtype"):
        lstm_align.aligned_ss_decode(*args, compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="do not match"):
        lstm_align.aligned_ss_decode(*args[:8], t["pxs"][:, :, :6], args[9])
    with pytest.raises(TypeError, match="residual_dtype"):
        lstm_align.peer_fwd(tpeer, lstm_align.peer_rows_of(t["pxs"], 3), t["pwt"], torch.float16)
    # the peer forward's blocks: the serve tier's peer context blocks, all K peers of whole viewers
    assert lstm_align.peer_fwd_block(128, 7, 3).rows_v == 9 and lstm_align.peer_fwd_block(128, 3, 3).rows_v == 21
    assert lstm_align.peer_fwd_block(32, 7, 3, torch.bfloat16) == fused_lstm.peer_tc_rows(32, 7, 3)
    with pytest.raises(ValueError, match="K = 257 peers"):
        lstm_align.peer_fwd_block(128, 257, 3)
    with pytest.raises(ValueError, match="ctx_dim in"):
        lstm_align.peer_fwd_block(8, 3, 3)


@pytest.mark.parametrize("fits", [(4, 5, 6, 7, 8), (4, 5, 6, 7), (4, 5, 6), (4,)])
def test_peer_bwd_launch_shape(fits):
    """The peer backward's warps a block, of those whose block fits shared
    memory (on the card: all of 4 to 8 but at ctx_dim 128, where f32
    compute on f32 residuals fits 6 and on bf16 residuals 7): the grid at
    stacked-ss-crossuser-10s's 28,672 peer rows fills 132 SMs in whole
    waves (256 blocks of 7 warps, two waves); tiny grids take the fewest
    warps; every choice is one that fits."""
    n_sm = 132
    for c in lstm_align.PEER_BWD_CTX:
        for rows in (1, 67 * 7, 4099 * 8, 28672):
            assert lstm_align.peer_bwd_warps(rows, c, 3, fits, n_sm) in fits
        assert lstm_align.peer_bwd_warps(1, c, 3, fits, n_sm) == 4
    full = lstm_align.peer_bwd_warps(28672, 128, 3, fits, n_sm)
    # 4 warps: 448 blocks, 4 waves (16 warp-waves); 5: 359, 3 (15); 6: 299, 3 (18); 7: 256, 2 (14)
    assert full == {8: 7, 7: 7, 6: 5, 4: 4}[max(fits)]
    if full == 7:
        assert -(-28672 // (16 * 7)) == 256 and -(-256 // n_sm) == 2


def test_peer_bwd_rejects_shapes_it_does_not_take():
    for c in (16, 160, 256):
        with pytest.raises(ValueError, match="ctx_dim in"):
            lstm_align.peer_bwd_warps(100, c, 3, (4, 5), 132)
    for d in (0, 9):
        with pytest.raises(ValueError, match="window features"):
            lstm_align.peer_bwd_warps(100, 128, d, (4, 5), 132)
    with pytest.raises(ValueError, match="fits shared memory"):
        lstm_align.peer_bwd_warps(100, 128, 3, (), 132)


# ------------------------------------------------------- the lockstep serve tier


def _serve_case(layers, seed, b=8):
    cfg = S.Seq2SeqConfig(d=3, hidden=16, layers=layers, h_in=4, h_out=5, ctx_dim=8,
                          peer_align=True)
    tcfg = seq2seq.Seq2SeqConfig(d=3, hidden=16, layers=layers, h_in=4, h_out=5, ctx_dim=8,
                                 peer_align=True)
    jp = CU.init(jax.random.PRNGKey(seed), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(seed)
    past = rng.normal(size=(b, 4, 3)).astype(np.float32)
    peers = (0.2 * rng.normal(size=(b, 3, 5, 3))).astype(np.float32)
    mask = rng.integers(0, 2, size=(b, 3)).astype(np.float32)
    mask[0] = 0.0  # every peer of row 0 masked out
    return cfg, tcfg, jp, tp, past, peers, mask


@pytest.mark.parametrize("layers", [1, 2])
def test_fused_serve_lockstep_tier_matches_jax(layers):
    """ops.fused_lstm.fused_serve(peer_xs=...) against the JAX kernel
    (interpret mode), the all-masked row against the zero-context model."""
    cfg, tcfg, jp, tp, past, peers, mask = _serve_case(layers, seed=layers)
    w = mask / np.maximum(mask.sum(1, keepdims=True), 1.0)
    jargs = (jp["encoder"], jp["decoder"], jp["proj"]["w"], jp["proj"]["b"], _j(past), 5)
    targs = (tp["encoder"], tp["decoder"], tp["proj"]["w"], tp["proj"]["b"], _t(past), 5)
    ref = jax_fused.fused_serve(*jargs, peer_params=jp["peer_encoder"], peer_xs=_j(peers),
                                peer_w=_j(w), tile_b=8)
    ours = fused_lstm.fused_serve(*targs, peer_params=tp["peer_encoder"], peer_xs=_t(peers),
                                  peer_w=_t(w))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=SERVE_TOL)
    zero = fused_lstm.fused_serve(*targs, context=torch.zeros(8, 8))
    np.testing.assert_allclose(ours[0].numpy(), zero[0].numpy(), atol=1e-7)
    ctx = fused_lstm.peer_context(tp["peer_encoder"], _t(peers), _t(w))
    np.testing.assert_allclose(ctx.numpy(), np.asarray(CU.encode_peers_aligned(
        jp, cfg, _j(peers), _j(mask))), atol=SERVE_TOL)
    with pytest.raises(ValueError, match="either context or peer_xs"):
        fused_lstm.fused_serve(*targs, context=torch.zeros(8, 8), peer_params=tp["peer_encoder"],
                               peer_xs=_t(peers), peer_w=_t(w))
    with pytest.raises(ValueError, match="span"):
        fused_lstm.fused_serve(*targs[:5], 4, peer_params=tp["peer_encoder"], peer_xs=_t(peers),
                               peer_w=_t(w))


@pytest.mark.parametrize("masked", [True, False])
def test_cross_user_serve_fused_peer_align_matches_jax(masked):
    cfg, tcfg, jp, tp, past, peers, mask = _serve_case(2, seed=3)
    m = mask if masked else None
    ref = CU.serve_fused(jp, cfg, _j(past), other_future_n=_j(peers), other_mask=_j(m), tile_b=8)
    ours = cross_user.serve_fused(tp, tcfg, _t(past), other_future_n=_t(peers), other_mask=_t(m))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=SERVE_TOL)
    scan = CU.apply(jp, cfg, _j(past), other_future_n=_j(peers), other_mask=_j(m))
    np.testing.assert_allclose(ours.numpy(), np.asarray(scan), atol=SERVE_TOL)
