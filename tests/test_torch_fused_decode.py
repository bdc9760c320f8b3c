"""The whole-horizon decode kernel's wrapper, ``ops.fused_lstm.fused_decode``,
and ``seq2seq.decode_fused``, on the CPU: against the JAX ``decode_fused``
(its ``fused_decode`` kernel in interpret mode) at the JAX suite's shapes,
(L, C) = (1, 0), (2, 0), (2, 8), and a 16-row batch over 4 of JAX's grid
tiles, within its 2e-5 (tests/test_fused_lstm.py); the plain version
against the serve kernel's decoder loop; the configured cell; and what
the wrapper refuses.

The CUDA kernel is held against ``fused_decode_reference`` on the card
(tests/test_torch_kernel_cuda.py, chip_smoke.py).
"""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longterm360fov_tpu.models import seq2seq as S
from longterm360fov_tpu_torch.models import seq2seq
from longterm360fov_tpu_torch.ops import fused_lstm
from longterm360fov_tpu_torch.params import params_from_numpy

TOL = 2e-5  # tests/test_fused_lstm.py test_fused_decode_parity


def _case(layers, ctx_dim, b=8, h_in=6, h_out=9, seed=2):
    base = dict(d=3, hidden=128, layers=layers, h_in=h_in, h_out=h_out, ctx_dim=ctx_dim)
    jcfg, tcfg = S.Seq2SeqConfig(**base), seq2seq.Seq2SeqConfig(**base)
    jp = S.init(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(seed)
    past = rng.normal(size=(b, h_in, 3)).astype(np.float32) * 0.1
    ctx = rng.normal(size=(b, ctx_dim)).astype(np.float32) if ctx_dim else None
    return jcfg, tcfg, jp, tp, past, ctx


@pytest.mark.parametrize("layers,ctx_dim,b,tile_b", [(1, 0, 8, 256), (2, 0, 8, 256), (2, 8, 8, 256),
                                                     (1, 0, 16, 4)])
def test_decode_fused_matches_jax(layers, ctx_dim, b, tile_b):
    jcfg, tcfg, jp, tp, past, ctx = _case(layers, ctx_dim, b=b, h_in=4 if tile_b == 4 else 6,
                                          h_out=5 if tile_b == 4 else 9, seed=2 if tile_b == 256 else 3)
    want = S.decode_fused(jp, jcfg, jnp.asarray(past), context=None if ctx is None else jnp.asarray(ctx),
                          tile_b=tile_b)
    tctx = None if ctx is None else torch.from_numpy(ctx)
    before = fused_lstm.fused_decode.launches
    got = seq2seq.decode_fused(tp, tcfg, torch.from_numpy(past), context=tctx)
    assert fused_lstm.fused_decode.launches == before  # CPU tensors: the plain version
    assert got.shape == tuple(want.shape) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    # the plain decoder is decode's, step for step
    assert torch.equal(got, seq2seq.decode(tp, tcfg, torch.from_numpy(past), context=tctx))


def test_plain_decode_is_the_serve_kernels_decoder():
    """fused_decode from the encoder's final states equals fused_serve's
    plain version, which runs the same decoder loop after its encoder."""
    _, tcfg, _, tp, past, ctx = _case(2, 8)
    x, tctx = torch.from_numpy(past), torch.from_numpy(ctx)
    states = seq2seq._encode(tp, tcfg, x)
    h0, c0 = (torch.stack([s[i] for s in states]) for i in (0, 1))
    got = fused_lstm.fused_decode(tp["decoder"], tp["proj"]["w"], tp["proj"]["b"], h0, c0, x[:, -1].contiguous(),
                                  9, context=tctx)
    want = fused_lstm.fused_serve_reference(tp["encoder"], tp["decoder"], tp["proj"]["w"], tp["proj"]["b"], x, 9,
                                            tctx)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


def test_decode_fused_runs_the_configured_cell(monkeypatch):
    """Under cell="pallas" the encoder steps through fused_lstm_cell (its
    plain version here: the same numbers) and the decoder is one
    fused_decode call."""
    _, tcfg, _, tp, past, _ = _case(2, 0)
    calls = []
    real = fused_lstm.fused_lstm_cell
    monkeypatch.setattr(fused_lstm, "fused_lstm_cell", lambda *a: calls.append(1) or real(*a))
    x = torch.from_numpy(past)
    got = seq2seq.decode_fused(tp, dataclasses.replace(tcfg, cell="pallas"), x)
    assert len(calls) == 2 * 6  # two layers x six encoder steps
    assert torch.equal(got, seq2seq.decode_fused(tp, tcfg, x))


def test_fused_decode_refusals():
    _, tcfg, _, tp, past, ctx = _case(2, 8, b=4)
    x = torch.from_numpy(past)
    states = seq2seq._encode(tp, tcfg, x)
    h0, c0 = (torch.stack([s[i] for s in states]) for i in (0, 1))
    dec, pw, pb = tp["decoder"], tp["proj"]["w"], tp["proj"]["b"]
    y0, tctx = x[:, -1].contiguous(), torch.from_numpy(ctx)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_lstm.fused_decode(dec, pw, pb, h0.clone().requires_grad_(True), c0, y0, 3, context=tctx)
    with pytest.raises(ValueError, match="decoder layers"):
        fused_lstm.fused_decode(dec[:1], pw, pb, h0, c0, y0, 3, context=tctx)
    with pytest.raises(ValueError, match="expected shape"):
        fused_lstm.fused_decode(dec, pw, pb, h0, c0, y0, 3)  # the decoder's layer 0 takes [y, ctx]
    with pytest.raises(ValueError, match="contiguous"):
        fused_lstm.fused_decode(dec, pw, pb, h0, c0, x[:, -1], 3, context=tctx)
    with pytest.raises(TypeError, match="float32"):
        fused_lstm.fused_decode(dec, pw, pb, h0.double(), c0, y0, 3, context=tctx)
    with pytest.raises(ValueError, match="t_out >= 1"):
        fused_lstm.fused_decode(dec, pw, pb, h0, c0, y0, 0, context=tctx)
