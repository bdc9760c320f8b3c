"""The transformer's bf16 serving tier on the CPU: the port's plain bf16
versions of the encoder and decode kernels (``models.transformer._encode``
and ``_ar_decode`` with ``compute_dtype=torch.bfloat16``, behind
``ops.transformer_encode.fused_encode_tokens`` and
``ops.transformer_decode.fused_ar_decode``) against the JAX package's bf16
kernels in interpret mode, in every tier: no peers, per-row peers with
``peer_pool`` "none" and "mean", a peer window, and group-shared peers with
δv; each also within JAX's own 0.08 of the f32 reference; and
``serve_fused``'s default, which resolves by device: f32 on CPU tensors.

Bounds. Both sides round the same operands to bf16 and sum in f32, in
another order; a sum that lands on the other side of a bf16 rounding
boundary moves an activation by 2^-8 of itself, and the rollout carries it
on. Measured at these seeds: the encoder 1.1e-6 and 8.0e-3 (seeds 0, 1),
the per-row decode tiers 9.5e-7 to 7.2e-3: BF16_TOL = 2e-2. JAX's shared
tier rounds q and the softmax weights to bf16 too, for its MXU products,
where the port attends in f32 in every tier, as JAX's per-row tiers do:
measured 1.2e-2 and 1.5e-2, GROUP_BF16_TOL = 3e-2. Against the f32
reference, JAX's bound for both kernels (tests/test_transformer_decode.py,
tests/test_transformer_encode.py): F32_TOL = 0.08.

The CUDA kernels' bf16 tiers are held against these plain versions on the
card (tests/test_torch_kernel_cuda.py, chip_smoke.py).
"""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longterm360fov_tpu.models import transformer as TR
from longterm360fov_tpu.models.seq2seq import Seq2SeqConfig as JaxConfig
from longterm360fov_tpu.ops.transformer_decode import fused_ar_decode as jax_fused_ar_decode
from longterm360fov_tpu.ops.transformer_encode import fused_encode_tokens as jax_fused_encode_tokens
from longterm360fov_tpu_torch.models import transformer
from longterm360fov_tpu_torch.models.seq2seq import Seq2SeqConfig
from longterm360fov_tpu_torch.ops import transformer_decode, transformer_encode, transformer_encode_train
from longterm360fov_tpu_torch.params import params_from_numpy

BF16_TOL = 2e-2
GROUP_BF16_TOL = 3e-2
F32_TOL = 0.08
BF16 = torch.bfloat16


def _setup(seed, h_in=6, b=8, **kw):
    base = dict(d=3, hidden=128, layers=2, h_in=h_in, h_out=7, **kw)
    jcfg, tcfg = JaxConfig(**base), Seq2SeqConfig(**base)
    jp = TR.init(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    past = np.random.default_rng(seed).normal(size=(b, h_in, 3)).astype(np.float32) * 0.1
    return jcfg, tcfg, jp, tp, past


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_bf16_encoder_matches_the_jax_kernel(seed):
    jcfg, tcfg, jp, tp, past = _setup(seed, h_in=10)
    want = np.asarray(jax_fused_encode_tokens(jp, jcfg, jnp.asarray(past), compute_dtype=jnp.bfloat16))
    before = transformer_encode.fused_encode_tokens_bf16.launches
    got = transformer_encode.fused_encode_tokens(tp, tcfg, torch.from_numpy(past), compute_dtype=BF16)
    assert transformer_encode.fused_encode_tokens_bf16.launches == before  # the plain version ran
    assert got.dtype == torch.float32 and got.shape == (8, 10, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=BF16_TOL)
    f32 = transformer._encode(tp, tcfg, torch.from_numpy(past)).detach().numpy()
    assert np.abs(got.numpy() - f32).max() < F32_TOL
    assert not np.array_equal(got.numpy(), f32)  # the tier rounds


@pytest.mark.parametrize("tier", ["nopeers", "none", "mean", "none-w2"])
def test_plain_bf16_decode_matches_the_jax_kernel(tier):
    """Per row: no peers; K = 2 peers with peer_pool "none" and "mean" and
    window 2, a row with no valid peer and a row with one; the same encoder
    memory and peer tokens (JAX's, f32) on both sides."""
    pool, _, w = tier.partition("-w")
    kw = {} if pool == "nopeers" else dict(peer_pool=pool, peer_window=int(w or 0))
    jcfg, tcfg, jp, tp, past = _setup(0, **kw)
    rng = np.random.default_rng(1)
    jpast = jnp.asarray(past)
    enc = TR._encode(jp, jcfg, jpast)
    jpm = jpv = pm = pv = None
    if kw:
        others = rng.normal(size=(8, 2, 7, 3)).astype(np.float32) * 0.1
        mask = np.ones((8, 2), np.float32)
        mask[0] = 0.0
        mask[1, 1:] = 0.0
        jpm, jpv = TR._peer_tokens(jp, jcfg, jnp.asarray(others), jnp.asarray(mask))
        jpm = jpm.astype(jnp.float32)
        pm, pv = torch.from_numpy(np.array(jpm)), torch.from_numpy(np.array(jpv))
    want = np.asarray(jax_fused_ar_decode(jp, jcfg, enc, jpast[:, -1], peer_mem=jpm, peer_valid=jpv,
                                          compute_dtype=jnp.bfloat16))
    args = (tp, tcfg, torch.from_numpy(np.array(enc)), torch.from_numpy(past[:, -1].copy()))
    before = transformer_decode.fused_ar_decode_bf16.launches
    got = transformer_decode.fused_ar_decode(*args, peer_mem=pm, peer_valid=pv, compute_dtype=BF16)
    assert transformer_decode.fused_ar_decode_bf16.launches == before
    assert got.dtype == torch.float32 and got.shape == (8, 7, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=BF16_TOL)
    f32 = transformer_decode.fused_ar_decode(*args, peer_mem=pm, peer_valid=pv).numpy()
    assert np.abs(got.numpy() - f32).max() < F32_TOL
    assert not np.array_equal(got.numpy(), f32)
    if kw:  # the row with no valid peer is the peerless bf16 rollout
        alone = transformer_decode.fused_ar_decode(*args, compute_dtype=BF16)
        assert torch.equal(got[0], alone[0])


@pytest.mark.parametrize("pool,w", [("none", 0), ("mean", 2)])
def test_plain_bf16_shared_tier_matches_the_jax_kernel(pool, w):
    """Group-shared peers with δv: G = 2 groups of 128 rows (JAX's tiles are
    group-pure), one layer, 4 + 5 frames."""
    base = dict(d=3, hidden=128, layers=1, h_in=4, h_out=5, peer_window=w, peer_pool=pool)
    jcfg, tcfg = JaxConfig(**base), Seq2SeqConfig(**base)
    jp = TR.init(jax.random.PRNGKey(11 + w), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(11 + w)
    past = rng.normal(size=(256, 4, 3)).astype(np.float32) * 0.1
    gfut = rng.normal(size=(2, 3, 5, 3)).astype(np.float32) * 0.1
    gmask = rng.integers(0, 2, size=(2, 3)).astype(np.float32)
    gmask[:, 0] = 1.0
    gid = np.repeat(np.arange(2, dtype=np.int32), 128)
    dv = rng.normal(size=(256, 1, 128)).astype(np.float32) * 0.1
    jpast = jnp.asarray(past)
    gmem, gvalid = TR._peer_tokens(jp, jcfg, jnp.asarray(gfut), jnp.asarray(gmask))
    enc = TR._encode(jp, jcfg, jpast)
    want = np.asarray(jax_fused_ar_decode(
        jp, jcfg, enc, jpast[:, -1], peer_gmem=gmem.astype(jnp.float32), peer_gvalid=gvalid,
        peer_gid=jnp.asarray(gid), peer_dv=jnp.asarray(dv), tile_b=128, compute_dtype=jnp.bfloat16))
    kw = dict(peer_gmem=torch.from_numpy(np.array(gmem, np.float32)),
              peer_gvalid=torch.from_numpy(np.array(gvalid)), peer_gid=torch.from_numpy(gid),
              peer_dv=torch.from_numpy(dv))
    args = (tp, tcfg, torch.from_numpy(np.array(enc)), torch.from_numpy(past[:, -1].copy()))
    got = transformer_decode.fused_ar_decode_shared(*args, compute_dtype=BF16, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=GROUP_BF16_TOL)
    f32 = transformer_decode.fused_ar_decode_shared(*args, **kw).numpy()
    assert np.abs(got.numpy() - f32).max() < F32_TOL


def _serve_case(seed=3, b=6, k=3):
    _, tcfg, _, tp, past = _setup(seed, b=b)
    rng = np.random.default_rng(seed)
    others = torch.from_numpy(rng.normal(size=(b, k, 7, 3)).astype(np.float32) * 0.1)
    mask = torch.ones((b, k))
    mask[0] = 0.0
    return tcfg, tp, torch.from_numpy(past), others, mask


def test_serve_fused_default_is_f32_on_cpu_tensors():
    """``compute_dtype=None`` resolves by the tensors' device: on the CPU the
    exact f32 tier, bit for bit, per row and grouped; an explicit bf16 runs
    the bf16 tier's plain versions there (never the f32 ones)."""
    tcfg, tp, x, others, mask = _serve_case()
    with torch.no_grad():
        for kw in (dict(other_future_n=others, other_mask=mask),
                   dict(group_future_n=others[:2], group_mask=mask[:2], peer_gid=torch.tensor([0, 1, 1, 0, 1, 0]),
                        peer_anchor=x[:, -1])):
            default = transformer.serve_fused(tp, tcfg, x, **kw)
            assert torch.equal(default, transformer.serve_fused(tp, tcfg, x, compute_dtype=torch.float32, **kw))
            bf16 = transformer.serve_fused(tp, tcfg, x, compute_dtype=BF16, **kw)
            assert not torch.equal(bf16, default)
            assert (bf16 - default).abs().max().item() < F32_TOL
        # the explicit bf16 serve is the two plain bf16 versions in a row
        pm, pv = transformer._peer_tokens(tp, tcfg, others, mask)
        enc = transformer._encode(tp, tcfg, x, BF16)
        want = transformer._ar_decode(tp, tcfg, enc, pm, pv, x[:, -1], compute_dtype=BF16)
        assert torch.equal(transformer.serve_fused(tp, tcfg, x, other_future_n=others, other_mask=mask,
                                                   compute_dtype=BF16), want)


def test_serving_tiers_and_refusals():
    """Only f32 and bf16 are tiers; the training hooks ignore a bf16
    compute_dtype (``train --train-compute bfloat16``), as the JAX
    transformer, which has no fused training hook, does, and the training
    encoder keeps its bf16 raise; the bf16 plain decode stays f32-valued."""
    tcfg, tp, x, *_ = _serve_case()
    enc = transformer._encode(tp, tcfg, x).detach()
    for call in (lambda: transformer.serve_fused(tp, tcfg, x, compute_dtype=torch.float16),
                 lambda: transformer_encode.fused_encode_tokens(tp, tcfg, x, compute_dtype=torch.float64),
                 lambda: transformer_decode.fused_ar_decode(tp, tcfg, enc, x[:, -1], compute_dtype=torch.float16)):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            call()
    fut = torch.zeros(6, 7, 3)
    assert torch.equal(transformer.apply_fused_tf(tp, tcfg, x, fut, compute_dtype=BF16),
                       transformer.apply_fused_tf(tp, tcfg, x, fut))
    with pytest.raises(NotImplementedError, match="slice I-b"):
        transformer_encode_train.fused_encode_train(tp, tcfg, x, compute_dtype=BF16)
    with torch.no_grad():
        out = transformer_decode.fused_ar_decode_bf16(tp, tcfg, enc, x[:, -1].contiguous())
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
