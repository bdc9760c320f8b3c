"""The port's feature extraction (``features.equirect``) against the JAX
package on the CPU, on the same numpy frames and carried weights.

Tolerances: luminance, motion and the box filters are the same f32
elementwise operations and small convolutions: 1e-6. Saliency goes through
a forward and an inverse FFT (pocketfft in JAX, torch's own FFT here), which
sum in different orders, and the log-amplitude amplifies the small
differences of small spectral amplitudes: 1e-5 on maps normalised to
[0, 1]. The conv stack inherits that, with the conv+resize kernel's bounds
(1e-5 against JAX's reference, 1e-4 against its interpret-mode kernel).
"""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longterm360fov_tpu.features import equirect as JFE
from longterm360fov_tpu_torch.features import equirect as FE

SAL_TOL = 1e-5


def _frames(t=5, h=48, w=96, seed=0):
    return np.random.default_rng(seed).integers(0, 255, size=(t, h, w, 3), dtype=np.uint8)


def _params(seed=0, **kw):
    """JAX's conv-stack params, and the same numbers as the port's tensors."""
    jp = JFE.init_conv_features(jax.random.PRNGKey(seed), **kw)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


@pytest.mark.parametrize("kind", ["uint8", "float"])
def test_luminance_matches_jax(kind):
    frames = _frames() if kind == "uint8" else np.random.default_rng(1).random((3, 8, 16, 3)).astype(
        np.float32)
    ours = FE.luminance(torch.from_numpy(frames)).numpy()
    ref = np.asarray(JFE.luminance(jnp.asarray(frames)))
    assert ours.dtype == np.float32 and ours.shape == frames.shape[:-1]
    np.testing.assert_allclose(ours, ref, atol=1e-6)
    if kind == "uint8":
        assert 0.0 <= ours.min() and ours.max() <= 1.0


@pytest.mark.parametrize("seed", [0, 1])
def test_saliency_map_matches_jax(seed):
    luma = np.array(JFE.luminance(jnp.asarray(_frames(seed=seed))))
    ours = FE.saliency_map(torch.from_numpy(luma)).numpy()
    np.testing.assert_allclose(ours, np.asarray(JFE.saliency_map(jnp.asarray(luma))), atol=SAL_TOL)
    assert ours.max() <= 1.0 + 1e-5 and np.isfinite(ours).all()


def test_saliency_highlights_odd_region():
    """A flat frame with one textured patch: the saliency peak is inside it,
    as the JAX suite checks."""
    luma = np.full((1, 48, 96), 0.5, np.float32)
    luma[0, 20:28, 40:56] += np.random.default_rng(2).normal(0, 0.4, (8, 16))
    sal = FE.saliency_map(torch.from_numpy(luma)).numpy()[0]
    py, px = np.unravel_index(sal.argmax(), sal.shape)
    assert 18 <= py < 30 and 38 <= px < 58


def test_motion_map_matches_jax():
    luma = np.array(JFE.luminance(jnp.asarray(_frames(seed=3))))
    ours = FE.motion_map(torch.from_numpy(luma)).numpy()
    np.testing.assert_allclose(ours, np.asarray(JFE.motion_map(jnp.asarray(luma))), atol=1e-6)
    assert not ours[0].any()


def test_init_conv_features_matches_jax_structure():
    ours = FE.init_conv_features(torch.Generator().manual_seed(0), device="cpu")
    ref = JFE.init_conv_features(jax.random.PRNGKey(0))
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert tuple(ours[k].shape) == ref[k].shape and ours[k].dtype == torch.float32
    assert not ours["bias"].any() and not ours["head_b"].any()
    limit = np.sqrt(6.0 / (8 * 8 * 16 + 64))
    assert ours["head_w"].abs().max() <= limit


@pytest.mark.parametrize("use_pallas", [True, False])
def test_conv_features_matches_jax(use_pallas):
    jp, tp = _params(channels=4, feat_dim=16, grid=(4, 8))
    maps = np.random.default_rng(4).random((6, 40, 80)).astype(np.float32)
    ours = FE.conv_features(tp, torch.from_numpy(maps), grid=(4, 8), use_pallas=use_pallas).numpy()
    ref = JFE.conv_features(jp, jnp.asarray(maps), grid=(4, 8), use_pallas=use_pallas)
    assert ours.shape == (6, 16)
    np.testing.assert_allclose(ours, np.asarray(ref), atol=1e-4 if use_pallas else 1e-5)


@pytest.mark.parametrize("jax_use_pallas", [True, False])
def test_extract_clip_features_matches_jax(jax_use_pallas):
    """The port's one route (the kernel's wrapper) against both of JAX's:
    its interpret-mode kernel and its plain version."""
    jp, tp = _params(seed=1, channels=4, feat_dim=16, grid=(4, 8))
    frames = _frames(seed=5)
    ours = FE.extract_clip_features(tp, frames, grid=(4, 8)).numpy()
    ref = JFE.extract_clip_features(jp, frames, grid=(4, 8), use_pallas=jax_use_pallas)
    assert ours.shape == (5, 32) and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, np.asarray(ref), atol=1e-4)


def _blocky_luma(noise, t=3, h=48, w=96, seed=0):
    """A texture upsampled 8x by repetition, panning 4 pixels a frame, with
    optional per-pixel noise in [-noise, noise] grey levels → JAX's luma."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h // 8, w // 8, 3)).repeat(8, 0).repeat(8, 1)
    if noise:
        img = img + rng.integers(-noise, noise + 1, img.shape)
    base = np.clip(img, 0, 255).astype(np.uint8)
    clip = np.stack([np.roll(base, 4 * i, axis=1) for i in range(t)])
    return np.array(JFE.luminance(jnp.asarray(clip)))


@pytest.mark.parametrize("size", [(24, 48), (48, 96)])
def test_saliency_is_ill_conditioned_on_blocky_frames(size):
    """On blocky frames the spectrum has exact zeros whose log-amplitude is
    rounding noise, so f32 saliency is ill-conditioned there: JAX's own f32
    saliency moves by more than 1e-2 when half of its input moves by one
    ulp, and stands as far from the f64 reading (the port's function in
    f64, which agrees with JAX to 1e-6 on full-spectrum frames). The port's
    f32 differs from JAX's f32 by no more than that spread. With per-pixel
    noise the spectrum is full and all of these agree within SAL_TOL."""
    for noise in (0, 8):
        luma = _blocky_luma(noise, h=size[0], w=size[1])
        one_ulp = np.where(np.random.default_rng(1).random(luma.shape) < 0.5,
                           np.nextafter(luma, np.float32(2)), luma).astype(np.float32)
        jax32 = np.asarray(JFE.saliency_map(jnp.asarray(luma)))
        jax32_ulp = np.asarray(JFE.saliency_map(jnp.asarray(one_ulp)))
        f64 = FE.saliency_map(torch.from_numpy(luma.astype(np.float64))).numpy()
        port32 = FE.saliency_map(torch.from_numpy(luma)).numpy()
        d_ulp, d_f64 = np.abs(jax32_ulp - jax32).max(), np.abs(jax32 - f64).max()
        d_port = np.abs(port32 - jax32).max()
        if noise:
            assert max(d_ulp, d_f64, d_port) <= SAL_TOL
        else:
            assert d_ulp > 1e-2 and d_f64 > 1e-2
            assert d_port <= 2 * max(d_ulp, d_f64)


def test_extract_clip_features_default_width():
    """The extract-features defaults: 8 channels, a (8, 16) grid, 64 + 64
    features a frame."""
    tp = FE.init_conv_features(torch.Generator().manual_seed(0), device="cpu")
    out = FE.extract_clip_features(tp, _frames(t=3, h=64, w=128))
    assert out.shape == (3, 128) and torch.isfinite(out).all()


@pytest.mark.parametrize("fmt", ["npy", "npz"])
def test_decode_frames_matches_jax(fmt, tmp_path):
    frames = _frames(t=7)
    path = tmp_path / f"clip.{fmt}"
    if fmt == "npy":
        np.save(path, frames)
    else:
        np.savez(path, frames=frames)
    for kw in ({}, {"max_frames": 3}, {"stride": 2}, {"stride": 3, "max_frames": 2}):
        ours = FE.decode_frames(str(path), **kw)
        np.testing.assert_array_equal(ours, JFE.decode_frames(str(path), **kw))


def test_decode_frames_without_opencv_raises(tmp_path, monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    with pytest.raises(RuntimeError, match="OpenCV unavailable"):
        FE.decode_frames(str(tmp_path / "clip.mp4"))
