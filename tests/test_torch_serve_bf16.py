"""The bf16 tiers of the serving kernels against the JAX package, on the CPU:
``fused_serve`` with ``compute_dtype=bfloat16`` in its no-context,
static-context and lockstep-peer tiers, ``fused_encode`` in bf16, and the
one-step cell ``fused_lstm_cell`` on a bf16 model's tensors; then the entry
points that reach them (``seq2seq.serve_fused``, ``cross_user.serve_fused``
static and lockstep, ``cell="pallas"`` and ``decode_fused`` on bf16 params).

The JAX Pallas kernels run in interpret mode; the port runs its kernels'
plain versions on CPU tensors. Widths are the presets' (H = 128, C = 128),
cut in batch (16), steps and peers (K = 3).

The bound, read here (JAX 0.9.0, torch 2.13, on the CPU): the port's bf16
plain version and JAX's bf16 kernel round the same operands and sum in f32
in another order, so a rounding may go the other way and carry through the
later steps. Measured, their gap is 0.14-0.33 of JAX's own bf16-vs-f32 gap
at the maximum and 0.02-0.07 of it in the mean. So the port stands within
half of JAX's bf16-vs-f32 gap at the maximum and a quarter of it in the
mean, and its own bf16-vs-f32 gap is at least half of JAX's: a version that
does not round stands a whole gap away (the f32 versions agree to 1e-7).
``fused_encode``'s bf16 output is the rounded h: where the two h round the
same way they are equal, else a bf16 step apart (read: 0.0 over 16 rows,
6.1e-5 on one entry of 64 where JAX's largest gap is 1.2e-4), so each
entry may stand one bf16 step of its value more.
"""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longterm360fov_tpu.models import cross_user as JCU
from longterm360fov_tpu.models import seq2seq as JS
from longterm360fov_tpu.ops import fused_lstm as JF
from longterm360fov_tpu_torch.models import cell, cross_user, seq2seq
from longterm360fov_tpu_torch.ops import fused_lstm
from longterm360fov_tpu_torch.params import params_from_numpy

B, K = 16, 3
MAX_FRAC, MEAN_FRAC, FLOOR = 0.5, 0.25, 0.5  # of JAX's bf16-vs-f32 gap (module docstring)
TIERS = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _gaps(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return d.max(), d.mean()


def _hold(ours, theirs, rounded=False):
    """``ours`` and ``theirs``: {"f32", "bf16"} outputs → the module's
    bound; a ``rounded`` output (stored in bf16) may stand one bf16 step
    (at most 2^-7 of the value) more, elementwise: two values within the
    bound may round either way."""
    gap_max, gap_mean = _gaps(theirs["bf16"], theirs["f32"])
    err_max, err_mean = _gaps(ours["bf16"], theirs["bf16"])
    step = 2.0 ** -7 * np.abs(theirs["bf16"]) if rounded else 0.0
    assert (np.abs(ours["bf16"] - theirs["bf16"]) <= MAX_FRAC * gap_max + step).all(), \
        f"max |port - JAX| {err_max:.3g} vs JAX's gap {gap_max:.3g}"
    assert err_mean <= MEAN_FRAC * gap_mean, f"mean |port - JAX| {err_mean:.3g} vs JAX's gap {gap_mean:.3g}"
    assert _gaps(ours["bf16"], ours["f32"])[1] >= FLOOR * gap_mean, "the port's bf16 tier does not round"
    assert _gaps(ours["f32"], theirs["f32"])[0] <= 1e-6


def _serve_case(layers, ctx, k, t_in, t_out, seed):
    """JAX params (init key ``seed``), a past of N(0, 0.05²), and the
    static context (N(0, 0.3²)) or K peer futures with their mask weights
    (a row with every peer masked) as JAX and port keyword arguments."""
    cfg = JS.Seq2SeqConfig(d=3, hidden=128, layers=layers, h_in=t_in, h_out=t_out, ctx_dim=ctx)
    jp = (JCU.init if ctx else JS.init)(jax.random.PRNGKey(seed), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(seed)
    past = (rng.normal(size=(B, t_in, 3)) * 0.05).astype(np.float32)
    kw_j, kw_t = {}, {}
    if ctx and not k:
        c = (rng.normal(size=(B, ctx)) * 0.3).astype(np.float32)
        kw_j["context"], kw_t["context"] = jnp.asarray(c), torch.from_numpy(c)
    if k:
        pxs = (rng.normal(size=(B, k, t_out, 3)) * 0.3).astype(np.float32)
        m = (rng.random((B, k)) < 0.7).astype(np.float32)
        m[0] = 0.0
        w = m / np.maximum(m.sum(1, keepdims=True), 1.0)
        kw_j.update(peer_params=jp["peer_encoder"], peer_xs=jnp.asarray(pxs), peer_w=jnp.asarray(w))
        kw_t.update(peer_params=tp["peer_encoder"], peer_xs=torch.from_numpy(pxs), peer_w=torch.from_numpy(w))
    return jp, tp, past, kw_j, kw_t


@pytest.mark.parametrize("layers,ctx,k,t_in,t_out", [(1, 0, 0, 30, 30), (2, 0, 0, 12, 12), (2, 128, 0, 12, 12),
                                                     (2, 128, K, 12, 12)],
                         ids=["seq2seq-tf-30", "no-ctx-L2", "static-ctx", "lockstep"])
def test_fused_serve_bf16_matches_jax(layers, ctx, k, t_in, t_out):
    """Row 1b in its three tiers (the lockstep tier: peer_context and the
    serve kernel's per-step context): the port's bf16 plain version against
    JAX's interpret-mode bf16 kernel; no launch on the CPU."""
    jp, tp, past, kw_j, kw_t = _serve_case(layers, ctx, k, t_in, t_out, seed=layers + k)
    counts = [(f, f.launches, f.launches_bf16) for f in
              (fused_lstm.fused_serve, fused_lstm.fused_serve_peers, fused_lstm.peer_context)]
    ours, theirs = {}, {}
    for tier, (jd, td) in TIERS.items():
        theirs[tier] = JF.fused_serve(jp["encoder"], jp["decoder"], jp["proj"]["w"], jp["proj"]["b"],
                                      jnp.asarray(past), t_out, compute_dtype=jd, **kw_j)
        out = fused_lstm.fused_serve(tp["encoder"], tp["decoder"], tp["proj"]["w"], tp["proj"]["b"],
                                     torch.from_numpy(past), t_out, compute_dtype=td, **kw_t)
        assert out.dtype == torch.float32 and out.shape == (B, t_out, 3)
        ours[tier] = out.numpy()
    _hold(ours, theirs)
    assert all((f.launches, f.launches_bf16) == (a, b) for f, a, b in counts)


@pytest.mark.parametrize("layers", [1, 2])
def test_fused_encode_bf16_matches_jax(layers):
    """Row 4b: the rounded top-layer h, in f32, against JAX's within the
    module's bound."""
    cfg = JS.Seq2SeqConfig(d=3, hidden=128, layers=layers)
    jp = JS.init(jax.random.PRNGKey(3), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    xs = (np.random.default_rng(3).normal(size=(4 * B, 12, 3)) * 0.3).astype(np.float32)
    ours, theirs = {}, {}
    for tier, (jd, td) in TIERS.items():
        theirs[tier] = np.asarray(JF.fused_encode(jp["encoder"], jnp.asarray(xs), compute_dtype=jd))
        out = fused_lstm.fused_encode(tp["encoder"], torch.from_numpy(xs), compute_dtype=td)
        assert out.dtype == torch.float32
        ours[tier] = out.numpy()
    _hold(ours, theirs, rounded=True)
    assert np.array_equal(ours["bf16"], ours["bf16"].astype(jnp.bfloat16).astype(np.float32))  # rounded h


@pytest.mark.parametrize("d_in", [3, 128])
def test_cell_bf16_matches_jax(d_in):
    """Row 2b: the cell on a bf16 model's x, h, c, W, b gives bf16 h and c,
    as JAX's kernel (its outputs take the inputs' dtypes); within one bf16
    step (at most 2^-7 of the value) of JAX's, where an f32 sum in another order
    rounds the other way, and equal in 99 % of the entries."""
    rng = np.random.default_rng(d_in)
    jw = JS.init(jax.random.PRNGKey(d_in), JS.Seq2SeqConfig(d=d_in, hidden=128, param_dtype="bfloat16"))
    jp = jw["encoder"][0]
    x, h, c = (jnp.asarray(rng.normal(size=(B, n)) * s, jnp.bfloat16) for n, s in ((d_in, 1.0), (128, 0.5), (128, 0.5)))
    want = JF.fused_lstm_cell(jp, x, (h, c))
    tp = params_from_numpy({"encoder": [jp], "decoder": [], "proj": {"w": np.zeros(1), "b": np.zeros(1)}},
                           "cpu")["encoder"][0]
    tx, th, tc = (torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16() for a in (x, h, c))
    got = cell.get_cell_fn("pallas")(tp, tx, (th, tc))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and str(w.dtype) == "bfloat16"
        g, w = g.float().numpy(), np.asarray(w.astype(jnp.float32))
        assert (np.abs(g - w) <= 2.0 ** -7 * np.abs(w)).all()
        assert np.mean(g == w) >= 0.99


def _entry_case(peer_align, seed=7):
    kw = dict(d=3, hidden=128, layers=2, h_in=10, h_out=8, ctx_dim=128, peer_align=peer_align)
    jcfg, tcfg = JS.Seq2SeqConfig(**kw), seq2seq.Seq2SeqConfig(**kw)
    jp = JCU.init(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(seed)
    past = (rng.normal(size=(B, 10, 3)) * 0.05).astype(np.float32)
    others = (rng.normal(size=(B, K, 8, 3)) * 0.3).astype(np.float32)
    mask = (rng.random((B, K)) < 0.7).astype(np.float32)
    mask[0] = 0.0
    return jcfg, tcfg, jp, tp, past, others, mask


@pytest.mark.parametrize("entry", ["seq2seq", "cross_user-static", "cross_user-lockstep"])
def test_serve_fused_entry_points_bf16_match_jax(entry):
    """``seq2seq.serve_fused`` and ``cross_user.serve_fused`` (static: the
    peers through row 4b, the decoder through row 1b; lockstep: row 1b's
    peer tier) with ``compute_dtype=bfloat16`` against JAX's."""
    jcfg, tcfg, jp, tp, past, others, mask = _entry_case(entry == "cross_user-lockstep")
    ours, theirs = {}, {}
    for tier, (jd, td) in TIERS.items():
        if entry == "seq2seq":
            c = np.random.default_rng(1).normal(size=(B, 128)).astype(np.float32) * 0.3
            theirs[tier] = JS.serve_fused(jp, jcfg, jnp.asarray(past), context=jnp.asarray(c), compute_dtype=jd)
            ours[tier] = seq2seq.serve_fused(tp, tcfg, torch.from_numpy(past), context=torch.from_numpy(c),
                                             compute_dtype=td).numpy()
        else:
            theirs[tier] = JCU.serve_fused(jp, jcfg, jnp.asarray(past), other_future_n=jnp.asarray(others),
                                           other_mask=jnp.asarray(mask), compute_dtype=jd)
            ours[tier] = cross_user.serve_fused(tp, tcfg, torch.from_numpy(past),
                                                other_future_n=torch.from_numpy(others),
                                                other_mask=torch.from_numpy(mask), compute_dtype=td).numpy()
    _hold(ours, theirs)


def test_bf16_wrappers_refuse_other_compute_dtypes():
    jp, tp, past, _, kw_t = _serve_case(1, 128, K, 4, 3, seed=0)
    x = torch.from_numpy(past)
    with pytest.raises(TypeError, match="compute_dtype"):
        fused_lstm.fused_encode(tp["encoder"], x, compute_dtype=torch.float16)
    with pytest.raises(TypeError, match="compute_dtype"):
        fused_lstm.peer_context(kw_t["peer_params"], kw_t["peer_xs"], kw_t["peer_w"], compute_dtype=torch.float16)
    with pytest.raises(TypeError, match="compute_dtype"):
        fused_lstm.fused_serve(tp["encoder"], tp["decoder"], tp["proj"]["w"], tp["proj"]["b"], x, 3,
                               compute_dtype=torch.float64, **kw_t)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_lstm.fused_encode(tp["encoder"], x.double())


@pytest.mark.parametrize("path", ["apply", "decode_fused", "encode_peers"])
def test_cell_pallas_on_a_bf16_model_matches_jax(path):
    """``cell="pallas"`` on bf16 params: the step loops hand the cell bf16
    x, h, c (row 2b) in seq2seq's autoregressive ``apply``, in
    ``decode_fused``'s encoder (its decoder widens the bf16 weights to the
    f32 decode kernel, as JAX's f32 dot does) and in cross_user's
    ``encode_peers``; against JAX with the same cell. A bf16 decode feeds
    back rounded states, so the two may part by a bf16 step and carry it:
    within 2e-2 on unit-scale outputs (read: 3.9e-3), and the port's cell
    equals ``cell="xla"`` (its plain version) exactly."""
    kw = dict(d=3, hidden=128, layers=2, h_in=10, h_out=8, ctx_dim=128, cell="pallas", param_dtype="bfloat16")
    jcfg, tcfg = JS.Seq2SeqConfig(**kw), seq2seq.Seq2SeqConfig(**kw)
    jp = JCU.init(jax.random.PRNGKey(5), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert all(t.dtype == torch.bfloat16 for t in tp["encoder"][0])
    rng = np.random.default_rng(5)
    past = (rng.normal(size=(B, 10, 3)) * 0.3).astype(np.float32)
    others = (rng.normal(size=(B, K, 8, 3)) * 0.3).astype(np.float32)
    xla = dataclasses.replace(tcfg, cell="xla")
    ctx = jnp.zeros((B, 128), jnp.bfloat16)
    if path == "apply":
        want = JS.apply(jp, jcfg, jnp.asarray(past), context=ctx)
        got, plain = (seq2seq.apply(tp, c, torch.from_numpy(past), context=torch.zeros(B, 128)) for c in (tcfg, xla))
    elif path == "decode_fused":
        want = JS.decode_fused(jp, jcfg, jnp.asarray(past), context=ctx.astype(jnp.float32))
        got, plain = (seq2seq.decode_fused(tp, c, torch.from_numpy(past), context=torch.zeros(B, 128))
                      for c in (tcfg, xla))
    else:
        want = JCU.encode_peers(jp, jcfg, jnp.asarray(others), None)
        got, plain = (cross_user.encode_peers(tp, c, torch.from_numpy(others), None) for c in (tcfg, xla))
    assert torch.equal(got, plain)
    err = np.abs(got.float().numpy() - np.asarray(want.astype(jnp.float32))).max()
    assert err <= 2e-2, err
