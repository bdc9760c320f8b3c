"""The port's transformer family against the JAX package, on the CPU: init
and the params tree, each piece of the model, both passes of ``apply``
(noisy teacher forcing with the noise patched on both sides), and the
gradient of a row whose peers are all masked.

Weights cross between the packages (params_from_numpy), seeds do not; both
sides get the same numpy inputs.
"""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longterm360fov_tpu import serving as jax_serving
from longterm360fov_tpu.models import transformer as TR
from longterm360fov_tpu.models.seq2seq import Seq2SeqConfig as JaxConfig
from longterm360fov_tpu_torch import serving
from longterm360fov_tpu_torch.models import get_family, transformer
from longterm360fov_tpu_torch.models.seq2seq import Seq2SeqConfig
from longterm360fov_tpu_torch.params import params_from_numpy, tree_leaves

PIECE_TOL = 1e-5  # one piece: f32 sums in another order
APPLY_TOL = 3e-5  # tests/test_transformer_decode.py's bound for the rollout


def _setup(seed=0, b=8, k=3, **kw):
    base = dict(d=3, hidden=128, layers=2, h_in=6, h_out=7)
    base.update(kw)
    jcfg, tcfg = JaxConfig(**base), Seq2SeqConfig(**base)
    jp = TR.init(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(seed)
    past = rng.normal(size=(b, jcfg.h_in, 3)).astype(np.float32) * 0.1
    fut = rng.normal(size=(b, jcfg.h_out, 3)).astype(np.float32) * 0.1
    others = rng.normal(size=(b, k, jcfg.h_out, 3)).astype(np.float32) * 0.1
    mask = np.ones((b, k), np.float32)
    mask[0] = 0.0  # no valid peer
    mask[1, 1:] = 0.0  # one valid peer
    return jcfg, tcfg, jp, tp, past, fut, others, mask


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def test_init_shapes_and_tree_order_match_jax():
    jcfg, tcfg, jp, *_ = _setup(layers=3)
    ours = transformer.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    ref = jax.tree.leaves(jp)
    assert [tuple(a.shape) for a in tree_leaves(ours)] == [a.shape for a in ref]
    assert [a.dtype for a in tree_leaves(ours)] == [torch.float32] * len(ref)
    # the export keys, and so the optimizer state and checkpoint order
    assert [k for k, _ in serving.flat_param_items(ours)] == [k for k, _ in jax_serving.flat_param_items(jp)]
    # Glorot limits, zero biases, LN scale 1 / bias 0
    assert float(ours["in_proj"].abs().max()) <= np.sqrt(6 / (3 + 128))
    assert float(ours["dec"][0]["mlp"]["w2"].abs().max()) <= np.sqrt(6 / (512 + 128))
    assert torch.equal(ours["enc"][1]["ln2"]["scale"], torch.ones(128))
    assert not ours["dec"][2]["mlp"]["b1"].any() and not ours["out_proj"]["b"].any()
    assert get_family("transformer") is transformer


def test_params_from_numpy_carries_the_jax_tree():
    _, _, jp, tp, *_ = _setup()
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp), strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    bad = jax.tree.map(np.asarray, jp)
    del bad["dec"][0]["ln3"]
    with pytest.raises(KeyError, match="layer keys"):
        params_from_numpy(bad, "cpu")


@pytest.mark.parametrize("piece", ["ln", "pos_enc", "attention_masked", "mlp", "encode", "peer_tokens_none",
                                   "peer_tokens_mean", "peer_tokens_unmasked", "window_mask"])
def test_piece_matches_jax(piece):
    jcfg, tcfg, jp, tp, past, _, others, mask = _setup(seed=2)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(8, 7, 128)).astype(np.float32)
    layer_j, layer_t = jp["dec"][1], tp["dec"][1]
    pairs = []
    if piece == "ln":
        p = {k: rng.normal(size=128).astype(np.float32) for k in ("scale", "bias")}
        x_ln = x * 30 + 2
        pairs = [(transformer._ln({k: _t(v) for k, v in p.items()}, _t(x_ln)),
                  TR._ln({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x_ln)))]
    elif piece == "pos_enc":
        pairs = [(transformer._pos_enc(30, 128), TR._pos_enc(30, 128)),
                 (transformer._pos_enc(9, 128, offset=21), TR._pos_enc(9, 128, offset=21))]
    elif piece == "attention_masked":
        kv = rng.normal(size=(8, 11, 128)).astype(np.float32)
        m = rng.random((8, 7, 11)) < 0.5
        m[0] = False  # a query row with nothing to attend: uniform, as with -1e9
        pairs = [(transformer._attention(layer_t["peer_attn"], _t(x), _t(kv), mask=_t(m)),
                  TR._attention(layer_j["peer_attn"], jnp.asarray(x), jnp.asarray(kv), mask=jnp.asarray(m)))]
    elif piece == "mlp":
        pairs = [(transformer._mlp(layer_t["mlp"], _t(x * 3)), TR._mlp(layer_j["mlp"], jnp.asarray(x * 3)))]
    elif piece == "encode":
        pairs = [(transformer._encode(tp, tcfg, _t(past)), TR._encode(jp, jcfg, jnp.asarray(past)))]
    elif piece.startswith("peer_tokens"):
        pool = "mean" if piece.endswith("mean") else "none"
        jc, tc = dataclasses.replace(jcfg, peer_pool=pool), dataclasses.replace(tcfg, peer_pool=pool)
        m = None if piece.endswith("unmasked") else mask
        tok_t, val_t = transformer._peer_tokens(tp, tc, _t(others), _t(m))
        tok_j, val_j = TR._peer_tokens(jp, jc, jnp.asarray(others), None if m is None else jnp.asarray(m))
        np.testing.assert_array_equal(val_t.numpy(), np.asarray(val_j))
        pairs = [(tok_t, tok_j)]
    else:  # window_mask
        for pool, w, kt in (("none", 2, 21), ("mean", 3, 7), ("none", 0, 21)):
            jc = dataclasses.replace(jcfg, peer_pool=pool, peer_window=w)
            tc = dataclasses.replace(tcfg, peer_pool=pool, peer_window=w)
            got = transformer._peer_window_mask(tc, kt, tq=7)
            ref = TR._peer_window_mask(jc, kt, tq=7)
            if w == 0:
                assert got is None and ref is None
                continue
            for t in range(7):
                np.testing.assert_array_equal(transformer._peer_window_mask(tc, kt, t=t).numpy(),
                                              np.asarray(TR._peer_window_mask(jc, kt, t=t)))
            pairs.append((got.float(), ref.astype(jnp.float32)))
    for got, ref in pairs:
        assert tuple(got.shape) == ref.shape
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=0, atol=PIECE_TOL)


@pytest.mark.parametrize("mode", ["ar", "tf", "noisy"])
@pytest.mark.parametrize("peers", ["none", "none-w2", "mean-w3", "nopeers"])
def test_apply_matches_jax(mode, peers, monkeypatch):
    """Both passes of apply against TR.apply: the KV-cached decode and the
    teacher-forced parallel pass, the latter with noisy teacher forcing at
    teacher_prob 0.4 (the noise, patched on both sides, is the same array)."""
    pool, _, w = peers.partition("-w")
    kw = {} if pool == "nopeers" else dict(peer_pool=pool, peer_window=int(w or 0))
    jcfg, tcfg, jp, tp, past, fut, others, mask = _setup(seed=4, layers=1 if mode == "noisy" else 2, **kw)
    extra_j = extra_t = {}
    if pool != "nopeers":
        extra_j = dict(other_future_n=jnp.asarray(others), other_mask=jnp.asarray(mask))
        extra_t = dict(other_future_n=_t(others), other_mask=_t(mask))
    f_j, f_t = (None, None) if mode == "ar" else (jnp.asarray(fut), _t(fut))
    noise_kw_j, noise_kw_t = {}, {}
    if mode == "noisy":
        noise = np.random.default_rng(5).normal(size=(8, 7, 3)).astype(np.float32)
        monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(noise))
        monkeypatch.setattr(transformer, "draw_noise", lambda gen, shape: torch.from_numpy(noise))
        noise_kw_j = dict(rng=jax.random.PRNGKey(1), teacher_prob=0.4)
        noise_kw_t = dict(rng=torch.Generator(), teacher_prob=0.4)
    ref = TR.apply(jp, jcfg, jnp.asarray(past), f_j, **noise_kw_j, **extra_j)
    got = transformer.apply(tp, tcfg, _t(past), f_t, **noise_kw_t, **extra_t)
    assert got.shape == ref.shape == (8, 7, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=APPLY_TOL)
    if mode == "noisy":  # the noise moved the pass
        clean = transformer.apply(tp, tcfg, _t(past), f_t, **extra_t)
        assert (got - clean).abs().max() > 1e-4


def test_noisy_teacher_forcing_semantics():
    """teacher_prob 1 with a generator equals the clean pass; the noise is
    sigma·N(0, 1) with sigma = (1 - teacher_prob)·std(future), the
    population std over the whole array; the AR decode ignores it."""
    _, tcfg, _, tp, past, fut, *_ = _setup(layers=1)
    past_t, fut_t = _t(past), _t(fut)
    clean = transformer.apply(tp, tcfg, past_t, fut_t)
    same = transformer.apply(tp, tcfg, past_t, fut_t, rng=torch.Generator().manual_seed(1), teacher_prob=1.0)
    assert torch.equal(clean, same)
    y0 = past_t[:, -1]
    tok = transformer.teacher_tokens(tcfg, y0, fut_t, torch.Generator().manual_seed(2), 0.25)
    base = transformer.teacher_tokens(tcfg, y0, fut_t)
    z = transformer.draw_noise(torch.Generator().manual_seed(2), base.shape)
    np.testing.assert_allclose(tok.numpy(), (base + 0.75 * float(np.std(fut)) * z).numpy(), atol=1e-7)
    ar = transformer.apply(tp, tcfg, past_t, None, rng=torch.Generator().manual_seed(1), teacher_prob=0.3)
    assert torch.equal(ar, transformer.apply(tp, tcfg, past_t, None))


@pytest.mark.parametrize("pool", ["none", "mean"])
def test_fully_masked_row_has_finite_gradients(pool):
    """A row whose peers are all masked: its positions gate the peer residual
    to exactly 0, and no NaN reaches any gradient (the masked logits are
    -1e9, not -inf)."""
    _, tcfg, _, tp, past, fut, others, mask = _setup(seed=6, layers=1, peer_pool=pool, peer_window=2)
    mask[:] = 0.0
    leaves = [p.requires_grad_(True) for p in tree_leaves(tp)]
    out = transformer.apply(tp, tcfg, _t(past), _t(fut), other_future_n=_t(others), other_mask=_t(mask))
    alone = transformer.apply(tp, tcfg, _t(past), _t(fut))
    assert torch.equal(out, alone)
    grads = torch.autograd.grad(out.square().sum(), leaves, allow_unused=True, materialize_grads=True)
    assert all(torch.isfinite(g).all() for g in grads)
    by_key = dict(zip((k for k, _ in serving.flat_param_items(tp)), grads))
    assert not by_key["dec.0.peer_attn.wq"].any()  # gated off: no gradient reaches the peer path
