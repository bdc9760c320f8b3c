"""The one-step LSTM cell kernel's wrapper, ``ops.fused_lstm.fused_lstm_cell``
(the cell of ``cfg.cell == "pallas"``), on the CPU: its plain version
against the JAX ``fused_lstm_cell`` (interpret mode) at the JAX suite's two
shapes within its 1e-5 (tests/test_fused_lstm.py); ``get_cell_fn``; what
the wrapper refuses (grad: the TPU kernel has no VJP; mixed dtypes);
and the step-loop entries of seq2seq and cross_user under ``cell="pallas"``
against JAX with the same cell.

The CUDA kernel is held against ``lstm_cell`` on the card
(tests/test_torch_kernel_cuda.py, chip_smoke.py).
"""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longterm360fov_tpu.models import cell as jax_cell
from longterm360fov_tpu.models import cross_user as CU
from longterm360fov_tpu.models import seq2seq as S
from longterm360fov_tpu.ops.fused_lstm import fused_lstm_cell as jax_fused_lstm_cell
from longterm360fov_tpu_torch.models import cell, cross_user, seq2seq
from longterm360fov_tpu_torch.ops import fused_lstm
from longterm360fov_tpu_torch.params import params_from_numpy

CELL_TOL = 1e-5  # tests/test_fused_lstm.py
MODEL_TOL = 2e-5  # tests/test_torch_seq2seq.py ATOL: f32 sums in another order over the rollout


def _cell_case(seed, b, d, h, zero_state):
    p = jax_cell.init_lstm(jax.random.PRNGKey(seed), d, h)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, d)).astype(np.float32)
    if zero_state:
        hc = np.zeros((b, h), np.float32), np.zeros((b, h), np.float32)
    else:
        hc = tuple(rng.normal(size=(b, h)).astype(np.float32) for _ in range(2))
    tp = cell.LSTMParams(*(torch.from_numpy(np.array(a)) for a in p))
    return p, tp, x, hc


@pytest.mark.parametrize("seed,b,d,zero_state", [(0, 16, 3, False), (1, 8, 128, True)])
def test_cell_matches_the_jax_kernel(seed, b, d, zero_state):
    """tests/test_fused_lstm.py's shapes: the layer-0 input (D = 3) from a
    random state, and a layer > 0 input (D = H = 128) from zero state."""
    p, tp, x, (h, c) = _cell_case(seed, b, d, 128, zero_state)
    want = jax_fused_lstm_cell(p, jnp.asarray(x), (jnp.asarray(h), jnp.asarray(c)))
    before = fused_lstm.fused_lstm_cell.launches
    got = fused_lstm.fused_lstm_cell(tp, torch.from_numpy(x), (torch.from_numpy(h), torch.from_numpy(c)))
    assert fused_lstm.fused_lstm_cell.launches == before  # CPU tensors: the plain version, no launch
    for g, w in zip(got, want):
        assert g.shape == (b, 128) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=CELL_TOL)
    plain = cell.lstm_cell(tp, torch.from_numpy(x), (torch.from_numpy(h), torch.from_numpy(c)))
    assert all(torch.equal(g, q) for g, q in zip(got, plain))


ANY_HIDDEN = [(40, 3), (100, 16), (272, 5)]  # widths the kernel took only since its unit-block grid


@pytest.fixture(scope="module")
def jax_cells_at_any_hidden():
    """JAX's fused_lstm_cell (interpret mode) at each ANY_HIDDEN shape, B =
    6, from a random state: the inputs and its (h, c), computed once."""
    out = {}
    for i, (h, d) in enumerate(ANY_HIDDEN):
        p, tp, x, hc = _cell_case(10 + i, 6, d, h, False)
        out[h] = tp, x, hc, jax_fused_lstm_cell(p, jnp.asarray(x), tuple(jnp.asarray(a) for a in hc))
    return out


@pytest.mark.parametrize("hidden", [h for h, _ in ANY_HIDDEN])
def test_cell_matches_the_jax_kernel_at_any_hidden(hidden, jax_cells_at_any_hidden):
    """Hidden 40, 100 and 272 (not multiples of 32, 272 past 256), which the
    JAX kernel takes without a check: the wrapper's plain path against it
    within its 1e-5; on the card the kernel takes them too
    (tests/test_torch_kernel_cuda.py)."""
    tp, x, (h, c), want = jax_cells_at_any_hidden[hidden]
    before = fused_lstm.fused_lstm_cell.launches
    got = fused_lstm.fused_lstm_cell(tp, torch.from_numpy(x), (torch.from_numpy(h), torch.from_numpy(c)))
    assert fused_lstm.fused_lstm_cell.launches == before
    for g, w in zip(got, want):
        assert g.shape == (6, hidden)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=CELL_TOL)


def test_get_cell_fn():
    assert cell.get_cell_fn() is cell.lstm_cell and cell.get_cell_fn("xla") is cell.lstm_cell
    assert cell.get_cell_fn("pallas") is fused_lstm.fused_lstm_cell
    with pytest.raises(ValueError, match="unknown cell impl 'triton'"):
        cell.get_cell_fn("triton")


def test_cell_refusals():
    _, tp, x, (h, c) = _cell_case(2, 4, 3, 16, False)
    x, h, c = torch.from_numpy(x), torch.from_numpy(h), torch.from_numpy(c)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_lstm.fused_lstm_cell(tp, x.clone().requires_grad_(True), (h, c))
    with pytest.raises(RuntimeError, match="no backward"):
        fused_lstm.fused_lstm_cell(cell.LSTMParams(tp.w.clone().requires_grad_(True), tp.b), x, (h, c))
    with torch.no_grad():  # no grad in flight: nothing to refuse
        fused_lstm.fused_lstm_cell(cell.LSTMParams(tp.w.clone().requires_grad_(True), tp.b), x, (h, c))
    with pytest.raises(TypeError, match="all float32 or all bfloat16"):
        fused_lstm.fused_lstm_cell(tp, x.bfloat16(), (h, c))
    with pytest.raises(ValueError, match="contiguous"):
        fused_lstm.fused_lstm_cell(tp, x, (h.t().contiguous().t(), c))
    with pytest.raises(ValueError, match="expected shape"):
        fused_lstm.fused_lstm_cell(tp, x[:, :2].contiguous(), (h, c))


def _s2s(seed=0, **kw):
    base = dict(d=3, hidden=32, h_in=5, h_out=4, cell="pallas", **kw)
    jcfg, tcfg = S.Seq2SeqConfig(**base), seq2seq.Seq2SeqConfig(**base)
    rng = np.random.default_rng(seed)
    past = rng.normal(size=(6, 5, 3)).astype(np.float32) * 0.1
    fut = rng.normal(size=(6, 4, 3)).astype(np.float32) * 0.1
    return jcfg, tcfg, past, fut


@pytest.mark.parametrize("mode", ["decode", "teacher", "context"])
def test_seq2seq_on_the_pallas_cell_matches_jax(mode):
    """seq2seq.apply and decode under cell="pallas", two layers: the
    autoregressive decode, teacher forcing, and a static context."""
    jcfg, tcfg, past, fut = _s2s(layers=2, ctx_dim=8 if mode == "context" else 0)
    jp = S.init(jax.random.PRNGKey(3), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    ctx = np.random.default_rng(4).normal(size=(6, 8)).astype(np.float32) if mode == "context" else None
    if mode == "teacher":
        want = S.apply(jp, jcfg, jnp.asarray(past), jnp.asarray(fut))
        got = seq2seq.apply(tp, tcfg, torch.from_numpy(past), torch.from_numpy(fut))
    else:
        want = S.decode(jp, jcfg, jnp.asarray(past), context=None if ctx is None else jnp.asarray(ctx))
        got = seq2seq.decode(tp, tcfg, torch.from_numpy(past), context=None if ctx is None else torch.from_numpy(ctx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=MODEL_TOL)
    xla = dataclasses.replace(tcfg, cell="xla")
    ref = seq2seq.apply(tp, xla, torch.from_numpy(past), torch.from_numpy(fut) if mode == "teacher" else None,
                        context=None if ctx is None else torch.from_numpy(ctx))
    assert torch.equal(got, ref)  # the cell's plain version is lstm_cell itself


@pytest.mark.parametrize("peer_align", [False, True])
def test_cross_user_on_the_pallas_cell_matches_jax(peer_align):
    """cross_user.apply under cell="pallas": the peer encoder's step loop
    (encode_peers' non-fused route, or encode_peers_aligned) and the
    seq2seq decode on the kernel cell."""
    jcfg, tcfg, past, _ = _s2s(ctx_dim=16, peer_align=peer_align)
    jp = CU.init(jax.random.PRNGKey(5), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(6)
    others = rng.normal(size=(6, 3, 4, 3)).astype(np.float32) * 0.5
    mask = (rng.random((6, 3)) < 0.6).astype(np.float32)
    mask[0] = 0.0
    want = CU.apply(jp, jcfg, jnp.asarray(past), other_future_n=jnp.asarray(others), other_mask=jnp.asarray(mask))
    got = cross_user.apply(tp, tcfg, torch.from_numpy(past), other_future_n=torch.from_numpy(others),
                           other_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=MODEL_TOL)
