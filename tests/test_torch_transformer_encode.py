"""The transformer encoder of the port against the JAX package, on the CPU:
the plain version behind ``ops.transformer_encode.fused_encode_tokens``
against the JAX kernel (interpret mode) and the JAX ``_encode``; what the
wrapper refuses; and the library yardstick ``chip_smoke.py`` times beside
the kernel, which must compute the same function.

The CUDA kernel itself is held against this plain version on the card
(tests/test_torch_kernel_cuda.py, chip_smoke.py).
"""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from longterm360fov_tpu.models import transformer as TR
from longterm360fov_tpu.models.seq2seq import Seq2SeqConfig as JaxConfig
from longterm360fov_tpu.ops.transformer_encode import fused_encode_tokens as jax_fused_encode_tokens
from longterm360fov_tpu_torch.models import transformer
from longterm360fov_tpu_torch.models.seq2seq import Seq2SeqConfig
from longterm360fov_tpu_torch.ops import transformer_encode
from longterm360fov_tpu_torch.params import params_from_numpy

TOL = 3e-5  # tests/test_transformer_encode.py


def _setup(layers=2, h_in=6, b=8, seed=0, perturb=False):
    kw = dict(d=3, hidden=128, layers=layers, h_in=h_in, h_out=4)
    jcfg, tcfg = JaxConfig(**kw), Seq2SeqConfig(**kw)
    jp = TR.init(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    if perturb:  # LN scales and every bias away from init's 1 and 0
        jp = jax.tree_util.tree_map_with_path(
            lambda path, x: x + rng.normal(size=x.shape).astype(np.float32) * 0.1
            if str(path[-1].key) in ("scale", "bias", "b1", "b2") else x, jp)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    past = rng.normal(size=(b, h_in, 3)).astype(np.float32) * 0.1
    return jcfg, tcfg, jp, tp, past


@pytest.mark.parametrize("layers,h_in,b", [(1, 4, 8), (2, 6, 8), (2, 10, 16)])
def test_plain_encoder_matches_the_jax_kernel_and_encode(layers, h_in, b):
    jcfg, tcfg, jp, tp, past = _setup(layers, h_in, b, seed=layers, perturb=True)
    got = transformer_encode.fused_encode_tokens(tp, tcfg, torch.from_numpy(past))
    kernel = jax_fused_encode_tokens(jp, jcfg, jnp.asarray(past), compute_dtype=jnp.float32)
    plain = TR._encode(jp, jcfg, jnp.asarray(past))
    assert got.shape == (b, h_in, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), rtol=0, atol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(plain), rtol=0, atol=TOL)


def test_viewers_are_independent():
    """A viewer's memory does not depend on the others in its call (the
    kernel packs 64 // T viewers into a block)."""
    _, tcfg, _, tp, past = _setup(h_in=30, b=11, seed=3)
    x = torch.from_numpy(past)
    full = transformer_encode.fused_encode_tokens(tp, tcfg, x)
    part = transformer_encode.fused_encode_tokens(tp, tcfg, x[3:8])
    np.testing.assert_allclose(full[3:8].numpy(), part.numpy(), rtol=0, atol=1e-6)


def test_routing_threshold_and_refusals():
    assert transformer_encode.encode_kernel_fits(64) and not transformer_encode.encode_kernel_fits(65)
    _, tcfg, _, tp, past = _setup(layers=1)
    x = torch.from_numpy(past)
    with pytest.raises(RuntimeError, match="no backward"):
        transformer_encode.fused_encode_tokens(tp, tcfg, x.clone().requires_grad_(True))
    leaf = tp["enc"][0]["attn"]["wq"].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        transformer_encode.fused_encode_tokens(tp, tcfg, x)
    leaf.requires_grad_(False)
    with torch.no_grad():  # no grad, no refusal
        transformer_encode.fused_encode_tokens(tp, tcfg, x)
    with torch.no_grad():  # the bf16 tier's plain version on CPU tensors
        assert torch.equal(transformer_encode.fused_encode_tokens(tp, tcfg, x, compute_dtype=torch.bfloat16),
                           transformer._encode(tp, tcfg, x, torch.bfloat16))
    with pytest.raises(ValueError, match="non-empty"):
        transformer_encode.fused_encode_tokens(tp, tcfg, x[:, :, 0])


@pytest.mark.parametrize("perturb", [False, True])
def test_library_yardstick_equals_encode(perturb):
    """chip_smoke.encoder_library (nn.TransformerEncoder with the same
    weights, pre-LN, eps 1e-6, tanh GELU) computes _encode's layers."""
    _, tcfg, _, tp, past = _setup(layers=2, h_in=30, b=5, seed=4, perturb=perturb)
    x = torch.from_numpy(past)
    net = chip_smoke.encoder_library(tp, "cpu")
    emb = x @ tp["in_proj"] + transformer._pos_enc(30, 128)
    with torch.no_grad():
        got = net(emb)
    np.testing.assert_allclose(got.numpy(), transformer._encode(tp, tcfg, x).numpy(), rtol=0, atol=1e-5)


def test_kernel_tables_hold_the_layouts_the_kernels_read():
    """The pointer table the wrappers hand the encoder kernels: in the f32
    tier (and row 11's forward) every matrix as Wᵀ (N, K), contiguous, since
    its three-pass products stage B k-contiguous
    (csrc/transformer_f32mma.cuh: FwdSrc reads Wq..Woᵀ, W1ᵀ (4H, H), W2ᵀ
    (H, 4H)); in the bf16 tier W (K, N) in bf16; the LN parameters and
    biases the model's own f32 tensors in both."""
    _, _, _, tp, _ = _setup(layers=2, seed=5, perturb=True)
    leaves = transformer_encode._ENC_LEAVES
    tensors, _ = transformer_encode.layer_pointers(tp["enc"], leaves, 128)
    f32, ptrs = transformer_encode.stored_pointers(tensors, leaves, torch.float32)
    bf16, _ = transformer_encode.stored_pointers(tensors, leaves, torch.bfloat16)
    assert list(ptrs) == [t.data_ptr() for t in f32]
    for t, a, b, (_, leaf) in zip(tensors, f32, bf16, leaves * 2):
        if leaf in ("wq", "wk", "wv", "wo", "w1", "w2"):
            assert a.is_contiguous() and a.shape == t.shape[::-1] and torch.equal(a, t.t())
            assert b.dtype == torch.bfloat16 and b.shape == t.shape and torch.equal(b, t.to(torch.bfloat16))
        else:
            assert a is t and b is t

