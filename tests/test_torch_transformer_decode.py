"""The transformer decode of the port against the JAX package, on the CPU:
the plain version behind ``ops.transformer_decode.fused_ar_decode`` against
the JAX kernel (interpret mode, f32) and the JAX scan decode in every
ported tier; the fully masked row; the model's per-position peer gate
against the TPU kernel's per-row gate; ``serve_fused`` and the predict
function against JAX's; and what the serving entry points refuse.

The CUDA kernel itself is held against this plain version on the card
(tests/test_torch_kernel_cuda.py, chip_smoke.py).
"""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longterm360fov_tpu import infer as jax_infer
from longterm360fov_tpu.config import get_preset as jax_get_preset
from longterm360fov_tpu.models import get_family as jax_get_family
from longterm360fov_tpu.models import transformer as TR
from longterm360fov_tpu.models.seq2seq import Seq2SeqConfig as JaxConfig
from longterm360fov_tpu.ops.transformer_decode import fused_ar_decode as jax_fused_ar_decode
from longterm360fov_tpu_torch import geometry, infer, serving
from longterm360fov_tpu_torch.config import get_preset
from longterm360fov_tpu_torch.models import transformer
from longterm360fov_tpu_torch.models.seq2seq import Seq2SeqConfig
from longterm360fov_tpu_torch.ops import transformer_decode
from longterm360fov_tpu_torch.params import params_from_numpy

TOL = 3e-5  # tests/test_transformer_decode.py:43
PREDICT_TOL = 5e-5  # tests/test_transformer_decode.py:181


def _setup(seed=0, layers=2, b=8, k=3, **kw):
    base = dict(d=3, hidden=128, layers=layers, h_in=6, h_out=7)
    base.update(kw)
    jcfg, tcfg = JaxConfig(**base), Seq2SeqConfig(**base)
    jp = TR.init(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(seed)
    past = rng.normal(size=(b, 6, 3)).astype(np.float32) * 0.1
    others = rng.normal(size=(b, k, base["h_out"], 3)).astype(np.float32) * 0.1
    mask = np.ones((b, k), np.float32)
    mask[0] = 0.0  # no valid peer
    mask[1, 1:] = 0.0  # one valid peer
    return jcfg, tcfg, jp, tp, past, others, mask


@pytest.mark.parametrize("tier", ["nopeers", "none", "mean", "none-w2", "mean-w3"])
def test_plain_decode_matches_the_jax_kernel_and_scan(tier):
    """Every ported tier: no peers; per-row peers with peer_pool "none" and
    "mean", with and without the window; a row with no valid peer (it
    must equal the peerless rollout) and a row with one."""
    pool, _, w = tier.partition("-w")
    kw = {} if pool == "nopeers" else dict(peer_pool=pool, peer_window=int(w or 0))
    # the preset's two layers on the main tier, one on the others (the JAX
    # interpret-mode kernel is slow)
    jcfg, tcfg, jp, tp, past, others, mask = _setup(seed=6, layers=2 if tier == "none" else 1, **kw)
    jpast, tpast = jnp.asarray(past), torch.from_numpy(past)
    enc_j = TR._encode(jp, jcfg, jpast)
    enc_t = torch.from_numpy(np.array(enc_j))
    pm_j = pv_j = pm_t = pv_t = None
    extra = {}
    if pool != "nopeers":
        pm_j, pv_j = TR._peer_tokens(jp, jcfg, jnp.asarray(others), jnp.asarray(mask))
        pm_t, pv_t = transformer._peer_tokens(tp, tcfg, torch.from_numpy(others), torch.from_numpy(mask))
        extra = dict(other_future_n=jnp.asarray(others), other_mask=jnp.asarray(mask))
    got = transformer_decode.fused_ar_decode(tp, tcfg, enc_t, tpast[:, -1], peer_mem=pm_t, peer_valid=pv_t)
    kernel = jax_fused_ar_decode(jp, jcfg, enc_j, jpast[:, -1], peer_mem=pm_j, peer_valid=pv_j,
                                 compute_dtype=jnp.float32)
    scan = TR.apply(jp, jcfg, jpast, **extra)
    assert got.shape == (8, 7, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), rtol=0, atol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(scan), rtol=0, atol=TOL)
    if pool != "nopeers":
        alone = transformer_decode.fused_ar_decode(tp, tcfg, enc_t, tpast[:, -1])
        np.testing.assert_allclose(got[0].numpy(), alone[0].numpy(), rtol=0, atol=TOL)
        assert not np.allclose(got[2:].numpy(), alone[2:].numpy(), atol=1e-4)  # the peers count


@pytest.mark.parametrize("pool,window", [("none", 0), ("none", 1), ("none", 2), ("mean", 3), ("mean", 1)])
def test_per_position_gate_equals_the_per_row_gate(pool, window):
    """The model gates peer attention per position (any valid token in the
    window), the TPU kernel per row (any valid peer). In the per-row tiers,
    where each peer's segment is h_out long, token t_k = t of every valid
    peer is in the window, so the two agree; the CUDA kernel follows the
    model."""
    cfg = Seq2SeqConfig(d=3, hidden=16, layers=1, h_in=4, h_out=7, peer_pool=pool, peer_window=window)
    params = transformer.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(1)
    mask = torch.from_numpy((rng.random((64, 4)) < 0.3).astype(np.float32))
    _, valid = transformer._peer_tokens(params, cfg, torch.zeros(64, 4, cfg.h_out, 3), mask)
    per_row = valid.any(dim=1)
    assert per_row.any() and not per_row.all()
    for t in range(cfg.h_out):
        tmask = transformer._peer_window_mask(cfg, valid.shape[1], t=t)
        per_pos = valid.any(dim=1) if tmask is None else (valid & tmask).any(dim=1)
        assert torch.equal(per_pos, per_row)


@pytest.mark.parametrize("peers", [False, True])
def test_serve_fused_matches_jax(peers):
    jcfg, tcfg, jp, tp, past, others, mask = _setup(seed=5, layers=1, k=2)
    extra_j = extra_t = {}
    if peers:
        extra_j = dict(other_future_n=jnp.asarray(others), other_mask=jnp.asarray(mask))
        extra_t = dict(other_future_n=torch.from_numpy(others), other_mask=torch.from_numpy(mask))
    ref = TR.serve_fused(jp, jcfg, jnp.asarray(past), compute_dtype=jnp.float32, **extra_j)
    got = transformer.serve_fused(tp, tcfg, torch.from_numpy(past), **extra_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=TOL)
    plain = transformer.apply(tp, tcfg, torch.from_numpy(past), **extra_t)
    np.testing.assert_allclose(plain.numpy(), got.numpy(), rtol=0, atol=1e-6)


def test_predict_fn_matches_jax():
    """infer.make_predict_fn(impl="fused") of a cut transformer-30 against the
    JAX predict function (normalize, decode, denormalize), peers in the batch."""
    over = dict(model_h_in=6, model_h_out=7, model_layers=1)
    jcfg, tcfg = jax_get_preset("transformer-30", **over), get_preset("transformer-30", **over)
    fam = jax_get_family(jcfg.model_family)
    jp = fam.init(jax.random.PRNGKey(0), jcfg.model)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(0)
    past = rng.normal(size=(8, 6, 3)).astype(np.float32)
    past /= np.linalg.norm(past, axis=-1, keepdims=True)
    of = rng.normal(size=(8, 4, 7, 3)).astype(np.float32)
    of /= np.linalg.norm(of, axis=-1, keepdims=True)
    batch = {"past": past, "other_future": of}
    ref = jax_infer.make_predict_fn(jp, jcfg, fam.apply, impl="xla", extras_fn=fam.batch_extras)(
        {k: jnp.asarray(v) for k, v in batch.items()})
    for impl in ("fused", "plain"):
        got = infer.make_predict_fn(tp, tcfg, device="cpu", impl=impl)(batch)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=PREDICT_TOL)


def test_unported_serving_tiers_raise():
    """bf16 is ported in every tier, the group-shared one included: on CPU
    tensors each runs the bf16 plain versions (tests/test_torch_transformer_bf16.py
    holds them against JAX's bf16 kernels); the transformer's grouped gateway
    is ported; the decode refuses grad and half-given peers."""
    _, tcfg, _, tp, past, others, _ = _setup(k=2)
    x = torch.from_numpy(past)
    bf16 = torch.bfloat16
    with torch.no_grad():
        enc = transformer._encode(tp, tcfg, x, bf16)
        gmem, gvalid = transformer._peer_tokens(tp, tcfg, torch.from_numpy(others[:2]), None)
        gid = torch.zeros(8, dtype=torch.long)
        assert torch.equal(
            transformer.serve_fused(tp, tcfg, x, group_future_n=torch.from_numpy(others[:2]), peer_gid=gid,
                                    compute_dtype=bf16),
            transformer._ar_decode(tp, tcfg, enc, gmem, gvalid, x[:, -1], peer_gid=gid, compute_dtype=bf16))
        want = transformer._ar_decode(tp, tcfg, enc, None, None, x[:, -1], compute_dtype=bf16)
        assert torch.equal(transformer.serve_fused(tp, tcfg, x, compute_dtype=bf16), want)
        assert torch.equal(transformer_decode.fused_ar_decode(tp, tcfg, enc, x[:, -1], compute_dtype=bf16), want)
    cfg = get_preset("transformer-30")
    assert serving.make_grouped_serve_fn(tp, cfg, transformer, device="cpu").tile_b == 1
    with pytest.raises(RuntimeError, match="no backward"):
        transformer_decode.fused_ar_decode(tp, tcfg, transformer._encode(tp, tcfg, x).requires_grad_(True),
                                           x[:, -1])
    with pytest.raises(ValueError, match="come together"):
        transformer_decode.fused_ar_decode(tp, dataclasses.replace(tcfg), torch.zeros(8, 6, 128), x[:, -1],
                                           peer_mem=torch.zeros(8, 14, 128))


def test_load_exported_params_of_a_jax_transformer_export(tmp_path):
    """The JAX export's dotted keys (enc.0.attn.wq, ...) load into the port's
    tree, leaf for leaf, and the port's flat keys are JAX's."""
    from longterm360fov_tpu import serving as jax_serving
    from longterm360fov_tpu_torch.params import tree_leaves

    over = dict(model_h_in=6, model_h_out=7)
    jcfg, tcfg = jax_get_preset("transformer-30", **over), get_preset("transformer-30", **over)
    jp = TR.init(jax.random.PRNGKey(3), jcfg.model)
    path = str(tmp_path / "export.npz")
    np.savez(path, **{k: np.asarray(v) for k, v in jax_serving.flat_param_items(jp)})
    ours = serving.load_exported_params(path, tcfg, transformer, device="cpu")
    for a, b in zip(tree_leaves(ours), jax.tree.leaves(jp), strict=True):
        assert np.array_equal(a.numpy(), np.asarray(b))
    keys = [k for k, _ in serving.flat_param_items(ours)]
    assert keys == [k for k, _ in jax_serving.flat_param_items(jp)] and "enc.0.attn.wq" in keys
    assert len(jax.tree.leaves(jax_serving.load_exported_params(path, jcfg, TR))) == len(keys)


def test_batcher_serves_peers_like_jax():
    """Single requests with K peers, two, and K all masked, and one bulk
    request with a mask, through the DynamicBatcher in front of the fused
    serve program (the kernels' plain versions here): every answer equals
    the JAX predict function on the same peers and mask."""
    over = dict(model_h_in=6, model_h_out=7, model_layers=1, n_other_users=3)
    jcfg, tcfg = jax_get_preset("transformer-30", **over), get_preset("transformer-30", **over)
    jp = TR.init(jax.random.PRNGKey(6), jcfg.model)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    fn = serving.make_serve_fn(tp, tcfg, transformer, device="cpu", impl="fused")
    rng = np.random.default_rng(6)
    pasts = rng.normal(size=(7, 6, 3)).astype(np.float32)
    pasts /= np.linalg.norm(pasts, axis=-1, keepdims=True)
    others = rng.normal(size=(7, 3, 7, 3)).astype(np.float32)
    others /= np.linalg.norm(others, axis=-1, keepdims=True)
    mask = np.ones((7, 3), np.float32)
    mask[1, 2:] = 0.0
    mask[2] = 0.0
    mask[4, 0] = 0.0
    bat = serving.DynamicBatcher(fn, h_in=6, extra_specs=serving.extra_specs_for(tcfg), max_batch=16,
                                 max_wait_ms=20.0)
    try:
        res = [bat.predict(pasts[0], other_future=others[0]),
               bat.predict(pasts[1], other_future=others[1, :2]),
               bat.predict(pasts[2], other_future=others[2], other_mask=mask[2])]
        chunks = bat.submit_many(pasts[3:], other_future=others[3:], other_mask=mask[3:])
        for c in chunks:
            assert c.event.wait(30) and c.error is None
    finally:
        bat.stop()
    of = others.copy()
    of[1, 2:] = 0.0
    batch = {"past": jnp.asarray(pasts), "other_future": jnp.asarray(of), "other_mask": jnp.asarray(mask)}
    ref = jax_infer.make_predict_fn(jp, jcfg, TR.apply, impl="xla", extras_fn=TR.batch_extras)(batch)
    yaw, pitch = geometry.xyz_to_euler(torch.tensor(np.asarray(ref)))
    for key, want in (("yaw", yaw), ("pitch", pitch)):
        got = np.concatenate([np.stack([r[key] for r in res]), chunks[0].result[key]])
        np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-4)
