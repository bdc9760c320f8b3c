"""The group-shared peer tier of the transformer decode, on the CPU: the
port's plain version behind ``ops.transformer_decode.fused_ar_decode``
(``peer_gmem``/``peer_gvalid``/``peer_gid``/``peer_dv``) against the JAX
kernel's shared tier in interpret mode; the shared tier against the per-row
tier on gathered copies; unsorted and impure group ids, which the port
takes and JAX refuses; ``serve_fused``'s grouped entry with the anchor
correction against JAX's; and the grouped gateway against per-row serving.

The CUDA kernel's shared tier is held against this plain version on the
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
from longterm360fov_tpu_torch import serving
from longterm360fov_tpu_torch.config import ExperimentConfig
from longterm360fov_tpu_torch.models import transformer
from longterm360fov_tpu_torch.models.seq2seq import Seq2SeqConfig
from longterm360fov_tpu_torch.ops import transformer_decode
from longterm360fov_tpu_torch.params import params_from_numpy

TOL = 3e-5  # tests/test_transformer_decode.py test_peer_shared_parity
ROW_TOL = 2e-5  # tests/test_transformer_decode.py test_peer_shared_matches_per_row_tier


def _grouped_setup(w=0, pool="none", seed=11, g=2, rows_per_group=128, k=3, layers=1, h_in=4, h_out=5):
    """tests/test_transformer_decode.py's _grouped_setup, narrowed (one
    layer, 4 + 5 frames): both frameworks' configs and params, pasts, G
    group peer sets with a mask that keeps peer 0, gids of group-pure
    128-row tiles (the JAX kernel's layout), and random δv."""
    base = dict(d=3, hidden=128, layers=layers, h_in=h_in, h_out=h_out, peer_window=w, peer_pool=pool)
    jcfg, tcfg = JaxConfig(**base), Seq2SeqConfig(**base)
    jp = TR.init(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(seed)
    b = g * rows_per_group
    past = rng.normal(size=(b, h_in, 3)).astype(np.float32) * 0.1
    gfut = rng.normal(size=(g, k, h_out, 3)).astype(np.float32) * 0.1
    gmask = rng.integers(0, 2, size=(g, k)).astype(np.float32)
    gmask[:, 0] = 1.0
    gid = np.repeat(np.arange(g, dtype=np.int32), rows_per_group)
    dv = rng.normal(size=(b, layers, 128)).astype(np.float32) * 0.1
    return jcfg, tcfg, jp, tp, past, gfut, gmask, gid, dv


def _port_shared(tp, tcfg, past, gfut, gmask, gid, dv=None):
    tpast = torch.from_numpy(past)
    enc = transformer._encode(tp, tcfg, tpast)
    gmem, gvalid = transformer._peer_tokens(tp, tcfg, torch.from_numpy(gfut), torch.from_numpy(gmask))
    return transformer_decode.fused_ar_decode(
        tp, tcfg, enc, tpast[:, -1], peer_gmem=gmem, peer_gvalid=gvalid, peer_gid=torch.from_numpy(gid),
        peer_dv=None if dv is None else torch.from_numpy(dv))


@pytest.mark.parametrize("pool,w,with_dv", [("none", 0, True), ("none", 2, False), ("mean", 0, False),
                                            ("mean", 2, True)])
def test_plain_shared_tier_matches_the_jax_kernel(pool, w, with_dv):
    """The shared tier, plain against JAX's kernel (interpret mode, f32):
    peer_pool "none" and "mean", window 0 and 2, with and without δv."""
    jcfg, tcfg, jp, tp, past, gfut, gmask, gid, dv = _grouped_setup(w=w, pool=pool, seed=11 + w)
    dv = dv if with_dv else None
    jpast = jnp.asarray(past)
    gmem, gvalid = TR._peer_tokens(jp, jcfg, jnp.asarray(gfut), jnp.asarray(gmask))
    want = jax_fused_ar_decode(
        jp, jcfg, TR._encode(jp, jcfg, jpast), jpast[:, -1], peer_gmem=gmem.astype(jnp.float32),
        peer_gvalid=gvalid, peer_gid=jnp.asarray(gid), peer_dv=None if dv is None else jnp.asarray(dv),
        tile_b=128, compute_dtype=jnp.float32)
    got = _port_shared(tp, tcfg, past, gfut, gmask, gid, dv)
    assert got.shape == (256, 5, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


@pytest.mark.parametrize("pool,w", [("none", 0), ("none", 2), ("mean", 0), ("mean", 3)])
def test_shared_tier_equals_per_row_tier_on_gathered_copies(pool, w):
    """Without δv the shared tier is the per-row tier on each row's copy of
    its group's peers (three groups: 1 row, 37 rows, the rest; gids
    unsorted; one group with every peer masked, whose rows equal the
    peerless rollout)."""
    _, tcfg, _, tp, past, gfut, gmask, _, _ = _grouped_setup(w=w, pool=pool, seed=3, g=3, rows_per_group=20,
                                                              layers=2, h_out=6)
    gmask[2] = 0.0
    gid = np.full(60, 2, np.int32)
    gid[0] = 0
    gid[1:38] = 1
    gid = np.random.default_rng(0).permutation(gid).astype(np.int32)
    got = _port_shared(tp, tcfg, past, gfut, gmask, gid)
    tpast = torch.from_numpy(past)
    enc = transformer._encode(tp, tcfg, tpast)
    pm, pv = transformer._peer_tokens(tp, tcfg, torch.from_numpy(gfut[gid]), torch.from_numpy(gmask[gid]))
    rows = transformer_decode.fused_ar_decode(tp, tcfg, enc, tpast[:, -1], peer_mem=pm, peer_valid=pv)
    np.testing.assert_allclose(got.numpy(), rows.numpy(), rtol=0, atol=ROW_TOL)
    alone = transformer_decode.fused_ar_decode(tp, tcfg, enc, tpast[:, -1])
    masked = gid == 2
    np.testing.assert_allclose(got[masked].numpy(), alone[masked].numpy(), rtol=0, atol=ROW_TOL)


def test_unsorted_impure_gid_equals_the_sorted_answer():
    """The port reads the group id per row: an interleaved gid (every tile
    mixes the groups) gives each row the answer it gets in the sorted
    batch. JAX's shared tier reads it per 128-row tile and raises on such a
    gid (tests/test_transformer_decode.py
    test_serve_fused_rejects_impure_gid_tiles): a recorded divergence."""
    _, tcfg, _, tp, past, gfut, gmask, gid, dv = _grouped_setup(seed=14, rows_per_group=16, layers=2)
    perm = np.random.default_rng(1).permutation(len(gid))
    ref = _port_shared(tp, tcfg, past, gfut, gmask, gid, dv)
    got = _port_shared(tp, tcfg, past[perm], gfut, gmask, gid[perm], dv[perm])
    np.testing.assert_allclose(got.numpy(), ref[perm].numpy(), rtol=0, atol=1e-6)


def test_serve_fused_grouped_with_anchor_matches_jax():
    """``serve_fused`` on raw group sets with each row's anchor (δv = anchor
    · in_proj · wv[l]) against JAX's grouped ``serve_fused``, and against
    the port's per-row serving of anchored copies."""
    jcfg, tcfg, jp, tp, past, gfut, gmask, gid, _ = _grouped_setup(seed=21)
    anchor = np.random.default_rng(21).normal(size=(past.shape[0], 3)).astype(np.float32) * 0.1
    want = TR.serve_fused(jp, jcfg, jnp.asarray(past), group_future_n=jnp.asarray(gfut),
                          group_mask=jnp.asarray(gmask), peer_gid=jnp.asarray(gid), peer_anchor=jnp.asarray(anchor),
                          tile_b=128, compute_dtype=jnp.float32)
    args = dict(group_future_n=torch.from_numpy(gfut), group_mask=torch.from_numpy(gmask),
                peer_gid=torch.from_numpy(gid), peer_anchor=torch.from_numpy(anchor))
    got = transformer.serve_fused(tp, tcfg, torch.from_numpy(past), **args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    rows = transformer.serve_fused(tp, tcfg, torch.from_numpy(past),
                                   other_future_n=torch.from_numpy(gfut[gid] - anchor[:, None, None]),
                                   other_mask=torch.from_numpy(gmask[gid]))
    np.testing.assert_allclose(got.numpy(), rows.numpy(), rtol=0, atol=TOL)


def test_shared_tier_refuses_what_it_does_not_take():
    _, tcfg, _, tp, past, gfut, gmask, gid, dv = _grouped_setup(rows_per_group=4)
    tpast = torch.from_numpy(past)
    enc = transformer._encode(tp, tcfg, tpast)
    gmem, gvalid = transformer._peer_tokens(tp, tcfg, torch.from_numpy(gfut), torch.from_numpy(gmask))
    pm, pv = gmem[gid], gvalid[gid]
    call = transformer_decode.fused_ar_decode
    y0, tgid, tdv = tpast[:, -1], torch.from_numpy(gid), torch.from_numpy(dv)
    with pytest.raises(ValueError, match="replace per-row"):
        call(tp, tcfg, enc, y0, peer_mem=pm, peer_valid=pv, peer_gmem=gmem, peer_gvalid=gvalid, peer_gid=tgid)
    with pytest.raises(ValueError, match="group-shared tier only"):
        call(tp, tcfg, enc, y0, peer_mem=pm, peer_valid=pv, peer_dv=tdv)
    with pytest.raises(ValueError, match=r"\[0, 2\)"):
        call(tp, tcfg, enc, y0, peer_gmem=gmem, peer_gvalid=gvalid, peer_gid=tgid + 1)
    with pytest.raises(ValueError, match=r"\[0, 2\)"):
        call(tp, tcfg, enc, y0, peer_gmem=gmem, peer_gvalid=gvalid, peer_gid=tgid - 1)
    with pytest.raises(ValueError, match="int32 or int64"):
        call(tp, tcfg, enc, y0, peer_gmem=gmem, peer_gvalid=gvalid, peer_gid=tgid.float())
    with pytest.raises(ValueError, match="peer_dv"):
        call(tp, tcfg, enc, y0, peer_gmem=gmem, peer_gvalid=gvalid, peer_gid=tgid, peer_dv=tdv[:, :, :64])
    with pytest.raises(ValueError, match="come together"):
        call(tp, tcfg, enc, y0, peer_gmem=gmem, peer_gid=tgid)
    with pytest.raises(ValueError, match="not both"):
        transformer.serve_fused(tp, tcfg, tpast, other_future_n=torch.from_numpy(gfut[gid]),
                                group_future_n=torch.from_numpy(gfut), peer_gid=tgid)
    with pytest.raises(ValueError, match="come together"):
        transformer.serve_fused(tp, tcfg, tpast, group_future_n=torch.from_numpy(gfut))
    with torch.no_grad():  # the bf16 tier: its plain versions on CPU tensors, within JAX's 0.08 of f32
        bf16 = transformer.serve_fused(tp, tcfg, tpast, group_future_n=torch.from_numpy(gfut), peer_gid=tgid,
                                       compute_dtype=torch.bfloat16)
        f32 = transformer.serve_fused(tp, tcfg, tpast, group_future_n=torch.from_numpy(gfut), peer_gid=tgid)
    assert not torch.equal(bf16, f32) and (bf16 - f32).abs().max().item() < 0.08


@pytest.mark.parametrize("impl", ["fused", "plain"])
def test_grouped_gateway_matches_per_row_serving(impl):
    """tests/test_serving.py's grouped test on the port: ``grouped_predict``
    through ``make_grouped_serve_fn`` (the shared tier with δv for "fused",
    the gather tier for "plain") equals per-row ``make_serve_fn`` serving
    of the same windows, in the caller's row order; no group is padded."""
    cfg = ExperimentConfig(name="tiny-transformer-grouped", model=Seq2SeqConfig(d=3, hidden=128, layers=1, h_in=5,
                                                                                 h_out=6),
                           model_family="transformer", n_other_users=3)
    params = transformer.init(torch.Generator().manual_seed(3), cfg.model, device="cpu")
    rng = np.random.default_rng(3)
    v = rng.normal(size=(7, 5, 3)).astype(np.float32)
    pasts = v / np.linalg.norm(v, axis=-1, keepdims=True)
    keys = ["v1", "v0", "v0", "v1", "v0", "v1", "v0"]
    sets = {k: rng.normal(size=(3, 6, 3)).astype(np.float32) * 0.1 for k in ("v0", "v1")}
    masks = {"v0": np.ones(3, np.float32), "v1": np.array([1, 1, 0], np.float32)}
    gfn = serving.make_grouped_serve_fn(params, cfg, transformer, device="cpu", impl=impl)
    assert gfn.tile_b == 1
    perm, gid, _, _ = serving.group_pack(keys, gfn.tile_b)
    assert len(perm) == len(keys)
    got = serving.grouped_predict(gfn, pasts, keys, sets, masks)
    per_row = serving.make_serve_fn(params, cfg, transformer, device="cpu", impl=impl)
    out = per_row({"past": pasts, "other_future": np.stack([sets[k] for k in keys]),
                   "other_mask": np.stack([masks[k] for k in keys])})
    ref = per_row.unpack(out.numpy())
    np.testing.assert_allclose(got["yaw"], ref["yaw"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["pitch"], ref["pitch"], rtol=0, atol=1e-4)
    assert (got["prefetch"] == ref["prefetch"]).mean() > 0.99
