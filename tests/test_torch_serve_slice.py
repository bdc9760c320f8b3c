"""The port's serve slice against the JAX serving path on the CPU: the
packed serve program, the tile-prefetch functions, the DynamicBatcher's
padding invariance, and the export-npz loader."""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longterm360fov_tpu import config as jax_config
from longterm360fov_tpu import infer as jax_infer
from longterm360fov_tpu import serving as jax_serving
from longterm360fov_tpu.models import get_family as jax_get_family
from longterm360fov_tpu_torch import geometry, infer, serving
from longterm360fov_tpu_torch.config import ExperimentConfig
from longterm360fov_tpu_torch.models import get_family
from longterm360fov_tpu_torch.models.seq2seq import Seq2SeqConfig
from longterm360fov_tpu_torch.params import params_from_numpy


def tiny_cfg(**kw):
    model = Seq2SeqConfig(**{"d": 3, "hidden": 16, "h_in": 5, "h_out": 4, **kw})
    return ExperimentConfig(name="tiny-seq2seq", model=model)


def jax_twin(cfg):
    return jax_config.ExperimentConfig(
        name=cfg.name,
        model=jax_config.Seq2SeqConfig(**dataclasses.asdict(cfg.model)),
    )


def setup(seed=0, **kw):
    cfg = tiny_cfg(**kw)
    jparams = jax_get_family("seq2seq").init(jax.random.PRNGKey(seed), jax_twin(cfg).model)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return cfg, jparams, tparams


def random_past(rng, n, h_in=5):
    v = rng.normal(size=(n, h_in, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return v


def test_packed_serve_matches_jax_fused():
    cfg, jparams, tparams = setup()
    pasts = random_past(np.random.default_rng(1), 9)
    ref_fn = jax_serving.make_serve_fn(
        jparams, jax_twin(cfg), jax_get_family("seq2seq"), impl="fused", packed=True
    )
    ref = ref_fn.unpack(np.asarray(ref_fn({"past": jnp.asarray(pasts)})))
    fn = serving.make_serve_fn(tparams, cfg, get_family("seq2seq"), device="cpu")
    got = fn.unpack(fn({"past": pasts}).numpy())
    np.testing.assert_allclose(got["yaw"], ref["yaw"], atol=1e-5)
    np.testing.assert_allclose(got["pitch"], ref["pitch"], atol=1e-5)
    assert got["prefetch"].dtype == bool and got["prefetch"].shape == (9, 72)
    # a tile may flip only where its center sits within 1e-4° of the threshold
    xyz = infer.predict_xyz(tparams, cfg, get_family("seq2seq"),
                            {"past": torch.from_numpy(pasts)}, impl="plain")
    ang = geometry.great_circle_deg(xyz[..., None, :], infer.tile_centers(6, 12, device="cpu"))
    thr = 45.0 + 0.5 * np.degrees(np.hypot(np.pi / 6, 2 * np.pi / 12))
    near = ((ang - thr).abs() < 1e-4).any(dim=1).numpy()
    assert not ((got["prefetch"] != ref["prefetch"]) & ~near).any()


def test_fused_and_plain_impls_agree():
    cfg, _, tparams = setup()
    pasts = random_past(np.random.default_rng(2), 6)
    outs = []
    for impl in ("fused", "plain"):
        fn = serving.make_serve_fn(tparams, cfg, get_family("seq2seq"), device="cpu", impl=impl)
        outs.append(fn.unpack(fn({"past": pasts}).numpy()))
    for key in ("yaw", "pitch"):
        np.testing.assert_allclose(outs[0][key], outs[1][key], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(outs[0]["prefetch"], outs[1]["prefetch"])
    with pytest.raises(ValueError, match="impl"):
        serving.make_serve_fn(tparams, cfg, get_family("seq2seq"), device="cpu", impl="xla")


def test_tile_functions_match_jax():
    rng = np.random.default_rng(3)
    pred, true = random_past(rng, 4, 6), random_past(rng, 4, 6)
    np.testing.assert_allclose(
        infer.tile_centers(6, 12, device="cpu").numpy(),
        np.asarray(jax_infer.tile_centers(6, 12)), atol=1e-6,
    )
    np.testing.assert_array_equal(
        infer.tile_of(torch.from_numpy(true)).numpy(),
        np.asarray(jax_infer.tile_of(jnp.asarray(true))),
    )
    np.testing.assert_array_equal(
        infer.tiles_for_fov(torch.from_numpy(pred), fov_deg=60.0).numpy(),
        np.asarray(jax_infer.tiles_for_fov(jnp.asarray(pred), fov_deg=60.0)),
    )
    ours = infer.prefetch_accuracy(torch.from_numpy(pred), torch.from_numpy(true))
    ref = jax_infer.prefetch_accuracy(jnp.asarray(pred), jnp.asarray(true))
    np.testing.assert_allclose([float(v) for v in ours], [float(v) for v in ref], atol=1e-6)


def test_make_predict_fn_shapes():
    cfg, _, tparams = setup()
    serve = infer.make_predict_fn(tparams, cfg, device="cpu", with_tiles=True)
    xyz, mask = serve(random_past(np.random.default_rng(4), 3))
    assert xyz.shape == (3, 4, 3) and mask.shape == (3, 4, 72) and mask.dtype == torch.bool
    np.testing.assert_allclose(torch.linalg.vector_norm(xyz, dim=-1).numpy(), 1.0, atol=1e-6)


def test_padding_and_cobatching_invariance():
    cfg, _, tparams = setup()
    serve_fn = serving.make_serve_fn(tparams, cfg, get_family("seq2seq"), device="cpu")
    pasts = random_past(np.random.default_rng(0), 7)
    ref = serve_fn.unpack(serve_fn({"past": pasts}).numpy())
    bat = serving.DynamicBatcher(serve_fn, h_in=5, max_batch=8, max_wait_ms=50.0)
    try:
        pending = [bat.submit(p) for p in pasts]
        bulk = bat.submit_many(pasts[:3])
        for p in pending + bulk:
            assert p.event.wait(30)
            assert p.error is None, p.error
        for i, p in enumerate(pending):
            np.testing.assert_allclose(p.result["yaw"], ref["yaw"][i], atol=1e-5)
            np.testing.assert_array_equal(p.result["prefetch"], ref["prefetch"][i])
        np.testing.assert_allclose(bulk[0].result["pitch"], ref["pitch"][:3], atol=1e-5)
        s = bat.stats()
        assert s["requests"] == 10
        assert s["pad_fraction"] > 0  # 7 singles → bucket 8
    finally:
        bat.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        bat.submit(pasts[0])


def test_param_store_hot_swap():
    cfg, _, tparams = setup(seed=0)
    _, _, other = setup(seed=1)
    store = serving.ParamStore(tparams)
    fn = serving.make_serve_fn(None, cfg, get_family("seq2seq"), device="cpu", param_store=store)
    pasts = random_past(np.random.default_rng(5), 2)
    before = fn.unpack(fn({"past": pasts}).numpy())["yaw"]
    store.swap(other)
    assert store.version == 1
    assert not np.array_equal(fn.unpack(fn({"past": pasts}).numpy())["yaw"], before)


def _export(params, path):
    """Write ``params`` as the JAX ``export`` npz does."""
    flat = {k: np.asarray(v) for k, v in jax_serving.flat_param_items(params)}
    np.savez(path, **flat)
    return flat


def test_flat_keys_match_jax():
    cfg, jparams, tparams = setup(layers=2)
    assert [k for k, _ in serving.flat_param_items(tparams)] == [
        k for k, _ in jax_serving.flat_param_items(jparams)
    ]


def test_load_exported_params_roundtrip(tmp_path):
    cfg, jparams, tparams = setup(layers=2)
    _export(jparams, tmp_path / "params.npz")
    loaded = serving.load_exported_params(
        str(tmp_path / "params.npz"), cfg, get_family("seq2seq"), device="cpu"
    )
    for (ka, a), (kb, b) in zip(serving.flat_param_items(tparams),
                                serving.flat_param_items(loaded)):
        assert ka == kb and a.dtype == b.dtype
        assert torch.equal(a, b)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_load_exported_params_errors_like_jax(fault, tmp_path):
    cfg, jparams, _ = setup()
    flat = _export(jparams, tmp_path / "ok.npz")
    if fault == "missing":
        flat.pop(sorted(flat)[0])
    elif fault == "extra":
        flat["proj.extra"] = np.zeros(3, np.float32)
    else:
        flat["proj.w"] = np.zeros((5, 3), np.float32)
    np.savez(tmp_path / "bad.npz", **flat)
    bad = str(tmp_path / "bad.npz")
    with pytest.raises((KeyError, ValueError)) as ref:
        jax_serving.load_exported_params(bad, jax_twin(cfg), jax_get_family("seq2seq"))
    with pytest.raises(ref.type) as ours:
        serving.load_exported_params(bad, cfg, get_family("seq2seq"), device="cpu")
    assert str(ours.value) == str(ref.value)
