"""Sharded serving of the port (``parallel.serve``, ``serving`` with a
``mesh``) on the CPU: the serving mesh is a device list, here the CPU named
two, four or eight times, as JAX's tests take its 8 virtual CPU devices.
Answers must not depend on the mesh (against the unsharded port) and must
agree with JAX's ``make_sharded_predict_fn``; the batcher's ``divisor``
ladder and its validation are JAX's; a daemon on a mesh answers as one
without."""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longterm360fov_tpu import config as jax_config
from longterm360fov_tpu import serving as jax_serving
from longterm360fov_tpu.models import get_family as jax_get_family
from longterm360fov_tpu.parallel import mesh as jax_mesh
from longterm360fov_tpu.parallel.serve import make_sharded_predict_fn as jax_sharded_predict_fn
from longterm360fov_tpu_torch import infer, serving
from longterm360fov_tpu_torch.config import ExperimentConfig
from longterm360fov_tpu_torch.models import get_family
from longterm360fov_tpu_torch.models.seq2seq import Seq2SeqConfig
from longterm360fov_tpu_torch.params import params_from_numpy
from longterm360fov_tpu_torch.parallel import make_sharded_predict_fn

TOL = 1e-5  # port against JAX: JAX's own sharding-invariance bound (tests/test_parallel_serve.py)
SHARD_TOL = 1e-6  # sharded against unsharded port: rows are independent; CPU products of other shapes


def _cfgs(family, **model):
    """Small configs of the three families: hidden 16 (the transformer 32),
    6 + 5 frames (the windowed transformer 6 + 8), K = 3 peers."""
    m = dict(d=3, hidden=16, layers=1, h_in=6, h_out=5, ctx_dim=16 if family == "cross_user" else 0)
    m.update(model)
    cfg = ExperimentConfig(name=f"dp-serve-{family}", model=Seq2SeqConfig(**m), model_family=family,
                           n_other_users=3)
    jcfg = jax_config.ExperimentConfig(name=cfg.name, model=jax_config.Seq2SeqConfig(**dataclasses.asdict(cfg.model)),
                                       model_family=family, n_other_users=3)
    return cfg, jcfg


CASES = {
    "seq2seq": dict(family="seq2seq"),
    "cross_user": dict(family="cross_user", layers=2),
    "transformer_windowed": dict(family="transformer", hidden=32, h_in=6, h_out=8, peer_window=8),
}


def _batch(cfg, b, seed=0):
    rng = np.random.default_rng(seed)
    past = rng.normal(size=(b, cfg.model.h_in, 3)).astype(np.float32)
    out = {"past": past / np.linalg.norm(past, axis=-1, keepdims=True)}
    if cfg.model_family != "seq2seq":
        peers = rng.normal(size=(b, cfg.n_other_users, cfg.model.h_out, 3)).astype(np.float32)
        out["other_future"] = peers / np.linalg.norm(peers, axis=-1, keepdims=True)
        mask = (rng.random((b, cfg.n_other_users)) < 0.7).astype(np.float32)
        mask[0] = 0.0
        out["other_mask"] = mask
    return out


@pytest.fixture(scope="module")
def models():
    """case -> (port cfg, JAX cfg, port family, JAX family, port params, JAX params)."""
    out = {}
    for name, spec in CASES.items():
        spec = dict(spec)
        family = spec.pop("family")
        cfg, jcfg = _cfgs(family, **spec)
        jfam = jax_get_family(family)
        jparams = jfam.init(jax.random.PRNGKey(3), jcfg.model)
        out[name] = (cfg, jcfg, get_family(family), jfam, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"),
                     jparams)
    return out


@pytest.mark.parametrize("size", [2, 4, 8])
@pytest.mark.parametrize("case,impl", [("seq2seq", "plain"), ("seq2seq", "fused"), ("cross_user", "fused"),
                                       ("transformer_windowed", "fused")])
def test_sharding_invariance_against_jax(models, case, impl, size):
    """16 viewers over a mesh of the CPU named ``size`` times: each slice
    through the unmodified serve path, the results in order, equal to the
    unsharded port's within SHARD_TOL and to JAX's sharded serve over its 8
    CPU devices within TOL ("xla" on the JAX side for the transformer: its
    interpret-mode kernels are its slow tier)."""
    cfg, jcfg, fam, jfam, params, jparams = models[case]
    batch = _batch(cfg, 16)
    sharded = make_sharded_predict_fn(params, cfg, fam, ["cpu"] * size, impl=impl,
                                      extras_fn=getattr(fam, "batch_extras", None))
    out = sharded(batch)
    ref = infer.make_predict_fn(params, cfg, device="cpu", impl=impl)(batch)
    assert out.shape == ref.shape == (16, cfg.model.h_out, 3)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=SHARD_TOL, rtol=0)
    jimpl = "xla" if impl == "plain" or cfg.model_family == "transformer" else "fused"
    jsharded = jax_sharded_predict_fn(jparams, jcfg, jfam.apply, jax_mesh.make_mesh(), impl=jimpl,
                                      extras_fn=getattr(jfam, "batch_extras", None))
    jout = jsharded({k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=TOL, rtol=0)


def test_tiles_and_tensor_input_gather_in_order(models):
    """A (B, H_in, 3) tensor in, with_tiles: both outputs gathered in row
    order on the mesh's first device, equal to the unsharded call's."""
    cfg, _, fam, _, params, _ = models["seq2seq"]
    past = torch.from_numpy(_batch(cfg, 12)["past"])
    xyz, tiles = make_sharded_predict_fn(params, cfg, fam, ["cpu"] * 3, with_tiles=True)(past)
    rxyz, rtiles = infer.make_predict_fn(params, cfg, device="cpu", with_tiles=True)(past)
    np.testing.assert_allclose(xyz.numpy(), rxyz.numpy(), atol=SHARD_TOL, rtol=0)
    assert torch.equal(tiles, rtiles)


def test_indivisible_batch_raises_with_jax_message(models):
    cfg, jcfg, fam, jfam, params, jparams = models["seq2seq"]
    batch = _batch(cfg, 12)
    with pytest.raises(ValueError) as ours:
        make_sharded_predict_fn(params, cfg, fam, ["cpu"] * 8)(batch)
    with pytest.raises(ValueError) as ref:
        jax_sharded_predict_fn(jparams, jcfg, jfam.apply, jax_mesh.make_mesh())(
            {k: jnp.asarray(v) for k, v in batch.items()})
    assert str(ours.value) == str(ref.value) == "batch 12 not divisible by mesh data size 8"


def test_packed_serve_fn_on_a_mesh_follows_reloads(models):
    """make_serve_fn(mesh=...): the packed output equals the unsharded
    program's; a swap of the store's params reaches every slice at the next
    dispatch."""
    cfg, _, fam, _, params, _ = models["cross_user"]
    store = serving.ParamStore(params)
    sharded = serving.make_serve_fn(params, cfg, fam, device="cpu", param_store=store, mesh=["cpu"] * 4)
    plain = serving.make_serve_fn(params, cfg, fam, device="cpu", param_store=store)
    batch = _batch(cfg, 8)
    np.testing.assert_allclose(sharded(batch).numpy(), plain(batch).numpy(), atol=SHARD_TOL, rtol=0)
    before = sharded(batch).clone()
    other = fam.init(torch.Generator().manual_seed(9), cfg.model, device="cpu")
    store.swap(other)
    after = sharded(batch)
    assert not torch.equal(after, before)
    np.testing.assert_allclose(after.numpy(), plain(batch).numpy(), atol=SHARD_TOL, rtol=0)
    with pytest.raises(ValueError, match="batch 6 not divisible by mesh data size 4"):
        sharded(_batch(cfg, 6))


def _nothing(batch):
    raise AssertionError("not served")


@pytest.mark.parametrize("max_batch,divisor", [(8, 3), (8, 0), (6, 4), (4, 8)])
def test_batcher_refuses_a_bad_divisor_with_jax_message(max_batch, divisor):
    with pytest.raises(ValueError) as ours:
        serving.DynamicBatcher(_nothing, h_in=5, max_batch=max_batch, divisor=divisor)
    with pytest.raises(ValueError) as ref:
        jax_serving.DynamicBatcher(_nothing, h_in=5, max_batch=max_batch, divisor=divisor)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("divisor", [1, 2, 4, 8])
def test_batcher_ladder_matches_jax(divisor):
    """Buckets divisor, 2·divisor, … up to max_batch, for every row count."""
    ours = serving.DynamicBatcher(_nothing, h_in=5, max_batch=64, divisor=divisor)
    ref = jax_serving.DynamicBatcher(_nothing, h_in=5, max_batch=64, divisor=divisor)
    try:
        assert ours.divisor == divisor
        got = [ours._bucket(n) for n in range(1, 65)]
        assert got == [ref._bucket(n) for n in range(1, 65)]
        assert all(b % divisor == 0 for b in got)
    finally:
        ours.stop()
        ref.stop()


def _start(server):
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def _stop(server):
    server.shutdown()
    server.server_close()
    server.batcher.stop()


@pytest.mark.parametrize("case", ["seq2seq", "cross_user"])
def test_daemon_on_a_mesh_answers_as_one_without(models, case):
    """serve_daemon(mesh=[cpu] x 4): divisor 4, every rung of the ladder 4,
    8 warmed; a viewer's pushes, a single predict with peers and a bulk
    predict_batch of 11 windows get the answers of the daemon without a
    mesh."""
    cfg, _, fam, _, params, _ = models[case]
    opts = dict(device="cpu", host="127.0.0.1", port=0, max_batch=8, max_wait_ms=5.0)
    ours = _start(serving.serve_daemon(params, cfg, fam, mesh=["cpu"] * 4, **opts))
    ref = _start(serving.serve_daemon(params, cfg, fam, **opts))
    try:
        assert ours.batcher.divisor == 4 and ref.batcher.divisor == 1
        assert ours.grouped_fn is None  # no grouped path under a mesh, as in JAX
        clients = [serving.FovClient(*s.server_address, timeout=60.0) for s in (ours, ref)]
        rng = np.random.default_rng(1)
        for i in range(cfg.model.h_in):
            pose = [float(rng.uniform(-0.5, 0.5)), float(rng.uniform(-0.3, 0.3))]
            a, b = (c.push("v0", pose) for c in clients)
        pasts = _batch(cfg, 11, seed=2)
        extras = {k: v[0].tolist() for k, v in pasts.items() if k != "past"}
        replies = [a, b] + [c.predict(pasts["past"][0].tolist(), **extras) for c in clients]
        replies += [c.request({"op": "predict_batch", "past": pasts["past"].tolist()}) for c in clients]
        for x, y in zip(replies[::2], replies[1::2]):
            for key in ("yaw", "pitch"):
                np.testing.assert_allclose(np.asarray(x[key]), np.asarray(y[key]), atol=SHARD_TOL, rtol=0)
            assert x.get("prefetch") == y.get("prefetch")
        for c in clients:
            c.close()
    finally:
        _stop(ours)
        _stop(ref)


def test_grouped_warmup_on_a_mesh_raises_with_jax_message(models):
    cfg, jcfg, fam, jfam, params, jparams = models["cross_user"]
    with pytest.raises(ValueError) as ours:
        serving.serve_daemon(params, cfg, fam, device="cpu", port=0, mesh=["cpu"] * 2, warmup=False,
                             grouped_warmup=[(8, 2)])
    with pytest.raises(ValueError) as ref:
        jax_serving.serve_daemon(jparams, jcfg, jfam, port=0, mesh=jax_mesh.make_mesh(), warmup=False,
                                 grouped_warmup=[(8, 2)])
    assert str(ours.value) == str(ref.value)
