"""``cell="pallas"`` on the LSTM families. It selects the one-step cell
kernel, ``ops.fused_lstm.fused_lstm_cell``, in the step loops of seq2seq,
cross_user and fusion (``apply`` in every mode, ``decode``, the peer
encoders' non-fused routes), as the JAX package's ``get_cell_fn`` does; the
fused entries (``apply_fused_tf``, ``apply_fused_ss``, ``serve_fused``) run
whole-sequence kernels and ignore it, as in JAX. The cell kernel has no
backward (nor has the TPU kernel): a step loop under grad refuses it. The
transformer family has no LSTM cell, and ignores ``cell``, as in JAX."""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)
import dataclasses

import pytest
import torch

from longterm360fov_tpu_torch.models import cross_user, fusion, seq2seq, transformer
from longterm360fov_tpu_torch.ops import fused_lstm


def _case(fam):
    ctx = {"seq2seq": 0, "cross_user": 8, "fusion": 16, "transformer": 0}[fam.__name__.rsplit(".", 1)[-1]]
    cfg = seq2seq.Seq2SeqConfig(d=3, hidden=16, layers=1, h_in=4, h_out=3, ctx_dim=ctx)
    params = fam.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    past, fut = torch.randn(2, 4, 3) * 0.1, torch.randn(2, 3, 3) * 0.1
    return dataclasses.replace(cfg, cell="pallas"), params, past, fut


@pytest.fixture
def cell_calls(monkeypatch):
    """Count the calls of the kernel cell's wrapper (its plain version runs on
    the CPU, so its launch count stays 0)."""
    calls = []
    real = fused_lstm.fused_lstm_cell
    monkeypatch.setattr(fused_lstm, "fused_lstm_cell", lambda *a: calls.append(1) or real(*a))
    return calls


@pytest.mark.parametrize("entry", ["apply", "apply-tf", "apply_fused_tf", "apply_fused_ss", "serve_fused"])
@pytest.mark.parametrize("fam", [seq2seq, cross_user, fusion], ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_lstm_families_on_the_pallas_cell(fam, entry, cell_calls):
    """The plain entries step through the kernel cell, once a layer a step
    (4 encoder + 3 decoder steps; the cross_user and fusion contexts here
    are zeros, no peer loop); the fused ones never call it. Both equal the
    same entry under cell="xla"."""
    cfg, params, past, fut = _case(fam)
    args = {"apply": (), "apply-tf": (fut,), "apply_fused_tf": (fut,), "apply_fused_ss": (fut,),
            "serve_fused": ()}[entry]
    kw = {"coins": torch.ones(3, 2, 1)} if entry == "apply_fused_ss" else {}
    fn = getattr(fam, entry.split("-")[0])
    got = fn(params, cfg, past, *args, **kw)
    assert len(cell_calls) == (7 if entry in ("apply", "apply-tf") else 0)
    assert torch.equal(got, fn(params, dataclasses.replace(cfg, cell="xla"), past, *args, **kw))


def test_cross_user_peer_align_on_the_pallas_cell(cell_calls):
    """peer_align: apply's aligned peer encoder steps through the kernel cell
    (3 peer steps, then 4 + 3 model steps); the lockstep kernels of
    serve_fused and apply_fused_tf ignore the cell."""
    cfg, params, past, fut = _case(cross_user)
    cfg = dataclasses.replace(cfg, peer_align=True)
    xla = dataclasses.replace(cfg, cell="xla")
    others = torch.randn(2, 2, 3, 3) * 0.1
    got = cross_user.apply(params, cfg, past, other_future_n=others)
    assert len(cell_calls) == 10
    assert torch.equal(got, cross_user.apply(params, xla, past, other_future_n=others))
    for call in (lambda c: cross_user.serve_fused(params, c, past, other_future_n=others),
                 lambda c: cross_user.apply_fused_tf(params, c, past, fut, other_future_n=others)):
        assert torch.equal(call(cfg), call(xla))
    assert len(cell_calls) == 10


def test_pallas_cell_refuses_grad():
    """Training through the step loop (train_impl "xla") differentiates
    through the cell: the kernel cell has no backward, so apply raises where
    a parameter requires grad, as JAX's linearization fails there."""
    cfg, params, past, fut = _case(seq2seq)
    params["decoder"][0].w.requires_grad_(True)
    with pytest.raises(RuntimeError, match="fused_lstm_cell has no backward"):
        seq2seq.apply(params, cfg, past, fut)
    assert seq2seq.apply(params, dataclasses.replace(cfg, cell="xla"), past, fut).requires_grad


def test_transformer_ignores_cell_as_in_jax():
    cfg, params, past, _ = _case(transformer)
    ref = transformer.apply(params, dataclasses.replace(cfg, cell="xla"), past)
    assert torch.equal(transformer.apply(params, cfg, past), ref)
