"""``cell="pallas"`` on the LSTM families. The JAX package runs its
``fused_lstm_cell`` TPU kernel there, which the port has not ported yet
(ROADMAP.md Queue 2 #2, slice I): every entry point of seq2seq, cross_user
and fusion raises instead of running the plain cell in its place. The
transformer family has no LSTM cell, and ignores ``cell``, as in JAX."""

import dataclasses

import pytest
import torch

from longterm360fov_tpu_torch.models import cross_user, fusion, seq2seq, transformer


def _case(fam):
    ctx = {"seq2seq": 0, "cross_user": 8, "fusion": 16, "transformer": 0}[fam.__name__.rsplit(".", 1)[-1]]
    cfg = seq2seq.Seq2SeqConfig(d=3, hidden=16, layers=1, h_in=4, h_out=3, ctx_dim=ctx)
    params = fam.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    past, fut = torch.randn(2, 4, 3) * 0.1, torch.randn(2, 3, 3) * 0.1
    return dataclasses.replace(cfg, cell="pallas"), params, past, fut


@pytest.mark.parametrize("entry", ["apply", "apply-tf", "apply_fused_tf", "apply_fused_ss", "serve_fused"])
@pytest.mark.parametrize("fam", [seq2seq, cross_user, fusion], ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_lstm_families_refuse_the_pallas_cell(fam, entry):
    cfg, params, past, fut = _case(fam)
    calls = {
        "apply": lambda: fam.apply(params, cfg, past),
        "apply-tf": lambda: fam.apply(params, cfg, past, fut),
        "apply_fused_tf": lambda: fam.apply_fused_tf(params, cfg, past, fut),
        "apply_fused_ss": lambda: fam.apply_fused_ss(params, cfg, past, fut, coins=torch.ones(3, 2, 1)),
        "serve_fused": lambda: fam.serve_fused(params, cfg, past),
    }
    with pytest.raises(NotImplementedError, match="Queue 2 #2, slice I"):
        calls[entry]()
    # the same call with the plain cell runs
    xla = dataclasses.replace(cfg, cell="xla")
    assert torch.isfinite(getattr(fam, entry.split("-")[0])(
        params, xla, past, *([fut] if entry not in ("apply", "serve_fused") else []),
        **({"coins": torch.ones(3, 2, 1)} if entry == "apply_fused_ss" else {}))).all()


def test_cross_user_peer_align_refuses_the_pallas_cell():
    cfg, params, past, fut = _case(cross_user)
    cfg = dataclasses.replace(cfg, peer_align=True)
    others = torch.randn(2, 2, 3, 3) * 0.1
    for call in (lambda: cross_user.serve_fused(params, cfg, past, other_future_n=others),
                 lambda: cross_user.apply_fused_tf(params, cfg, past, fut, other_future_n=others)):
        with pytest.raises(NotImplementedError, match="slice I"):
            call()


def test_transformer_ignores_cell_as_in_jax():
    cfg, params, past, _ = _case(transformer)
    ref = transformer.apply(params, dataclasses.replace(cfg, cell="xla"), past)
    assert torch.equal(transformer.apply(params, cfg, past), ref)
