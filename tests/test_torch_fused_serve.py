"""The port's fused_serve against the JAX Pallas fused_serve.

On the CPU the port's wrapper runs its plain PyTorch version, and the JAX
kernel runs in Pallas interpret mode, as tests/test_fused_lstm.py runs it.
Both get the same numpy weights and inputs; tolerance 2e-5, the JAX test's.
The kernel itself runs only on the card: tests/test_torch_kernel_cuda.py
compares it with the plain version there.
"""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longterm360fov_tpu.models import seq2seq as jax_seq2seq
from longterm360fov_tpu.ops.fused_lstm import fused_serve as jax_fused_serve
from longterm360fov_tpu_torch import oracle
from longterm360fov_tpu_torch.ops import _build, fused_lstm
from longterm360fov_tpu_torch.params import params_from_numpy

ATOL = 2e-5


def _setup(layers, hidden, t_in, t_out, batch, seed):
    cfg = jax_seq2seq.Seq2SeqConfig(
        d=3, hidden=hidden, layers=layers, h_in=t_in, h_out=t_out
    )
    params = jax.tree.map(np.asarray, jax_seq2seq.init(jax.random.PRNGKey(seed), cfg))
    past_n = np.random.default_rng(seed).normal(size=(batch, t_in, 3)).astype(np.float32) * 0.1
    return cfg, params, past_n


def _args(params, past_n, t_out, device="cpu"):
    p = params_from_numpy(params, device)
    return (p["encoder"], p["decoder"], p["proj"]["w"], p["proj"]["b"],
            torch.as_tensor(past_n, device=device), t_out)


@pytest.mark.parametrize(
    "layers,hidden,t_in,t_out,batch,tile_b",
    [
        (1, 32, 5, 4, 12, 2048),
        (2, 16, 4, 6, 8, 2048),
        # 2 grid tiles: the JAX tile picker splits only in 128-row steps
        (2, 16, 4, 5, 256, 128),
    ],
)
def test_matches_jax_fused_serve(layers, hidden, t_in, t_out, batch, tile_b):
    cfg, params, past_n = _setup(layers, hidden, t_in, t_out, batch, seed=layers)
    ref = jax_fused_serve(
        params["encoder"], params["decoder"], params["proj"]["w"],
        params["proj"]["b"], jnp.asarray(past_n), t_out, tile_b=tile_b,
    )
    before = fused_lstm.fused_serve.launches
    out = fused_lstm.fused_serve(*_args(params, past_n, t_out))
    assert out.shape == (batch, t_out, 3) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    assert fused_lstm.fused_serve.launches == before  # CPU: no kernel launch


def test_reference_matches_numpy_oracle():
    cfg, params, past_n = _setup(2, 32, 6, 5, 10, seed=3)
    out = fused_lstm.fused_serve_reference(*_args(params, past_n, cfg.h_out))
    np.testing.assert_allclose(
        out.numpy(), oracle.oracle_decode(params, cfg, past_n), atol=ATOL
    )


@pytest.mark.parametrize(
    "kw",
    [
        # every tier takes f32 and bf16 compute, as JAX's; another compute
        # dtype is a TypeError, and the roofline _probe modes are not ported
        {"context": torch.zeros(4, 8), "compute_dtype": torch.float16},
        {"peer_xs": torch.zeros(4, 2, 3, 3), "compute_dtype": torch.float16},
        {"compute_dtype": torch.float16},
        {"_probe": "mm"},
    ],
    ids=["context", "peers", "bf16", "probe"],
)
def test_rejects_tiers_not_ported(kw):
    _, params, past_n = _setup(1, 32, 4, 3, 4, seed=0)
    with pytest.raises(NotImplementedError if "_probe" in kw else TypeError):
        fused_lstm.fused_serve(*_args(params, past_n, 3), **kw)


def test_rejects_what_the_kernel_does_not_take():
    _, params, past_n = _setup(2, 32, 4, 3, 4, seed=0)
    enc, dec, pw, pb, x, t_out = _args(params, past_n, 3)
    with pytest.raises(TypeError):  # f64
        fused_lstm.fused_serve(enc, dec, pw, pb, x.double(), t_out)
    with pytest.raises(ValueError):  # non-contiguous
        fused_lstm.fused_serve(enc, dec, pw, pb, x.transpose(0, 1).contiguous().transpose(0, 1), t_out)
    with pytest.raises(ValueError):  # decoder depth != encoder depth
        fused_lstm.fused_serve(enc, dec[:1], pw, pb, x, t_out)
    with pytest.raises(ValueError):  # projection of the wrong width
        fused_lstm.fused_serve(enc, dec, pw[:, :2], pb, x, t_out)
    with pytest.raises(ValueError):  # tensors on two devices
        fused_lstm.fused_serve(enc, dec, pw.to("meta"), pb, x, t_out)
    with pytest.raises(ValueError):  # nothing to predict
        fused_lstm.fused_serve(enc, dec, pw, pb, x, 0)


def test_kernel_rows():
    """The f32 cell's rows a block (cell_block; the FMA body's kernel_rows
    it replaced took only hidden % 32 == 0): 64 rows of 64 units with W
    resident at seq2seq-tf-30's layer-0 step, 128 of 32 at D_in = 128, 128
    of 32 with W streamed past shared memory, on 16 warps; the hidden the
    FMA body refused taken."""
    assert fused_lstm.cell_block(3, 128, False)[:4] == (64, 64, 16, True)
    assert fused_lstm.cell_block(128, 128, False)[:4] == (128, 32, 16, True)
    assert fused_lstm.cell_block(3, 256, False)[:4] == (128, 32, 16, True)
    assert fused_lstm.cell_block(3, 1024, False)[:4] == (128, 32, 16, False)
    for hidden, units in ((48, 48), (16, 16), (1, 8)):
        assert fused_lstm.cell_block(3, hidden, False)[:4] == (64, units, units // 4, True)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_build_cache_key_follows_the_defines():
    """A probe build (``-DTFM_PROBE``) gets its own library, beside the
    kernel's, and passes its macro to nvcc."""
    plain, probe = _build._lib_path("transformer_encode"), _build._lib_path("transformer_encode", ("TFM_PROBE",))
    assert probe != plain and probe.parent == plain.parent and probe.name.startswith("transformer_encode-")
    assert _build._flags(("TFM_PROBE",)) == (*_build.NVCC_FLAGS, "-DTFM_PROBE")


def test_build_cache_key_follows_source_and_flags(monkeypatch, tmp_path):
    path = _build._lib_path("fused_serve")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("fused_serve-") and path.suffix == ".so"
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build._lib_path("fused_serve") != path
    monkeypatch.undo()
    edited = tmp_path / "fused_serve.cu"
    edited.write_bytes((_build.CSRC / "fused_serve.cu").read_bytes() + b"\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build._lib_path("fused_serve").name != path.name
