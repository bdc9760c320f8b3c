"""Cross-framework LSTM oracle: torch.nn.LSTMCell (CPU) vs our cell.

The repo's numpy oracle (oracle.py) shares this codebase's gate-order
conventions, so a transposed weight or swapped gate there could in
principle hide the same bug in both. torch's LSTMCell is an INDEPENDENT
implementation of the exact semantics the reference's framework-provided
LSTM used (SURVEY.md §2.1 models.*: gate order (i, f, g, o), sigmoid/
tanh), so matching it pins our cell — and transitively every fused
Pallas kernel parity-tested against it — to the ecosystem-standard LSTM.

Weight mapping: ours is one fused ``[x, h] @ W`` with W (D+H, 4H);
torch keeps w_ih (4H, D) and w_hh (4H, H) with two biases, so
W = [w_ih.T; w_hh.T] and b = b_ih + b_hh.
"""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from longterm360fov_tpu.models.cell import (  # noqa: E402
    LSTMParams,
    init_lstm,
    lstm_cell,
)


def _to_torch_cell(params: LSTMParams, d: int, hidden: int):
    cell = torch.nn.LSTMCell(d, hidden)
    w = np.asarray(params.w)  # (d+H, 4H)
    b = np.asarray(params.b)  # (4H,)
    with torch.no_grad():
        cell.weight_ih.copy_(torch.from_numpy(w[:d].T.copy()))
        cell.weight_hh.copy_(torch.from_numpy(w[d:].T.copy()))
        cell.bias_ih.copy_(torch.from_numpy(b.copy()))
        cell.bias_hh.zero_()
    return cell


@pytest.mark.parametrize("d,hidden,batch", [(3, 16, 8), (7, 32, 4)])
def test_cell_matches_torch_lstmcell(d, hidden, batch):
    rng = np.random.default_rng(0)
    params = init_lstm(jax.random.PRNGKey(0), d, hidden)
    x = rng.normal(size=(batch, d)).astype(np.float32)
    h0 = rng.normal(size=(batch, hidden)).astype(np.float32) * 0.1
    c0 = rng.normal(size=(batch, hidden)).astype(np.float32) * 0.1

    ours_h, ours_c = lstm_cell(
        params, jnp.asarray(x), (jnp.asarray(h0), jnp.asarray(c0))
    )

    cell = _to_torch_cell(params, d, hidden)
    with torch.no_grad():
        th, tc = cell(
            torch.from_numpy(x), (torch.from_numpy(h0), torch.from_numpy(c0))
        )
    np.testing.assert_allclose(np.asarray(ours_h), th.numpy(), atol=2e-6)
    np.testing.assert_allclose(np.asarray(ours_c), tc.numpy(), atol=2e-6)


def test_sequence_matches_torch_over_horizon():
    """30-step rollout (the flagship horizon): divergence stays at fp32
    noise, i.e. the recurrence semantics match step-for-step."""
    d, hidden, batch, steps = 3, 24, 6, 30
    rng = np.random.default_rng(1)
    params = init_lstm(jax.random.PRNGKey(1), d, hidden)
    xs = rng.normal(size=(steps, batch, d)).astype(np.float32)

    state = (jnp.zeros((batch, hidden)), jnp.zeros((batch, hidden)))
    cell = _to_torch_cell(params, d, hidden)
    th = torch.zeros(batch, hidden)
    tc = torch.zeros(batch, hidden)
    for t in range(steps):
        state = lstm_cell(params, jnp.asarray(xs[t]), state)
        with torch.no_grad():
            th, tc = cell(torch.from_numpy(xs[t]), (th, tc))
    np.testing.assert_allclose(
        np.asarray(state[0]), th.numpy(), atol=1e-5
    )
