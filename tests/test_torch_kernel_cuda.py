"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test here is marked ``cuda`` and skips without a card.

This file imports no jax (the machine with the card has none); run it there
without the repo's conftest, which sets jax up for the CPU suite:

    python -m pytest --noconftest -m cuda tests/test_torch_kernel_cuda.py
"""

import numpy as np
import pytest
import torch

from longterm360fov_tpu_torch import oracle
from longterm360fov_tpu_torch.models import seq2seq
from longterm360fov_tpu_torch.ops import fused_lstm
from longterm360fov_tpu_torch.params import params_from_numpy

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
