"""The port's geometry and windowing against the JAX functions on the same
numpy inputs, at atol 1e-6."""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longterm360fov_tpu import geometry as jax_geometry
from longterm360fov_tpu import windows as jax_windows
from longterm360fov_tpu_torch import geometry, windows

ATOL = 1e-6


def _vectors(seed, n=64):
    """Random (n, 3) vectors, off the sphere, plus the hard cases: equal,
    antipodal, and at the poles."""
    v = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    v[0] = [0.0, 0.0, 1.0]
    v[1] = [0.0, 0.0, -2.0]
    v[2] = [1e-3, 0.0, 1.0]
    return v


def _pair(seed):
    p, q = _vectors(seed), _vectors(seed + 1)
    q[3] = p[3]  # identical direction
    q[4] = -p[4]  # antipodal
    return p, q


def _close(ours, ref):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL)


def test_normalize_sphere():
    v = _vectors(0)
    _close(geometry.normalize_sphere(torch.from_numpy(v)),
           jax_geometry.normalize_sphere(jnp.asarray(v)))


def test_euler_xyz_round_trip():
    rng = np.random.default_rng(1)
    yaw = rng.uniform(-np.pi, np.pi, 64).astype(np.float32)
    pitch = rng.uniform(-np.pi / 2, np.pi / 2, 64).astype(np.float32)
    xyz = geometry.euler_to_xyz(torch.from_numpy(yaw), torch.from_numpy(pitch))
    _close(xyz, jax_geometry.euler_to_xyz(jnp.asarray(yaw), jnp.asarray(pitch)))
    for ours, ref in zip(geometry.xyz_to_euler(xyz),
                         jax_geometry.xyz_to_euler(jnp.asarray(xyz.numpy()))):
        _close(ours, ref)


def test_xyz_to_euler_raw_vectors():
    v = _vectors(2)
    for ours, ref in zip(geometry.xyz_to_euler(torch.from_numpy(v)),
                         jax_geometry.xyz_to_euler(jnp.asarray(v))):
        _close(ours, ref)


def test_wrap_angle():
    a = np.linspace(-10, 10, 101).astype(np.float32)
    _close(geometry.wrap_angle(torch.from_numpy(a)),
           jax_geometry.wrap_angle(jnp.asarray(a)))


@pytest.mark.parametrize("unit", ["rad", "deg"])
def test_great_circle(unit):
    p, q = _pair(3)
    ours = getattr(geometry, f"great_circle_{unit}")
    ref = getattr(jax_geometry, f"great_circle_{unit}")
    got = ours(torch.from_numpy(p), torch.from_numpy(q))
    scale = 180 / np.pi if unit == "deg" else 1.0
    np.testing.assert_allclose(
        got.numpy(), np.asarray(ref(jnp.asarray(p), jnp.asarray(q))),
        atol=ATOL * scale,
    )
    assert got[3] < 1e-3 * scale and abs(got[4] - np.pi * scale) < 1e-3 * scale


def test_great_circle_broadcasts():
    p, q = _vectors(4, 5), _vectors(5, 7)
    got = geometry.great_circle_rad(
        torch.from_numpy(p)[:, None, :], torch.from_numpy(q)
    )
    assert got.shape == (5, 7)
    _close(got, jax_geometry.great_circle_rad(jnp.asarray(p)[:, None, :],
                                              jnp.asarray(q)))


@pytest.mark.parametrize("with_future", [False, True])
def test_normalize_denormalize_window(with_future):
    rng = np.random.default_rng(6)
    past = rng.normal(size=(9, 5, 3)).astype(np.float32)
    fut = rng.normal(size=(9, 4, 3)).astype(np.float32) if with_future else None
    ours = windows.normalize_window(
        torch.from_numpy(past), None if fut is None else torch.from_numpy(fut)
    )
    ref = jax_windows.normalize_window(
        jnp.asarray(past), None if fut is None else jnp.asarray(fut)
    )
    for o, r in zip(ours, ref):
        assert (o is None) == (r is None)
        if o is not None:
            _close(o, r)
    pred = rng.normal(size=(9, 4, 3)).astype(np.float32) * 0.1
    for to_sphere in (True, False):
        _close(
            windows.denormalize_window(torch.from_numpy(pred), ours[2],
                                       to_sphere=to_sphere),
            jax_windows.denormalize_window(jnp.asarray(pred), ref[2],
                                           to_sphere=to_sphere),
        )


@pytest.mark.parametrize("stride", [1, 3])
def test_make_windows_is_the_jax_copy(stride):
    trace = np.random.default_rng(7).normal(size=(40, 3)).astype(np.float32)
    ours = windows.make_windows(trace, 6, 5, stride)
    ref = jax_windows.make_windows(trace, 6, 5, stride)
    np.testing.assert_array_equal(ours.past, ref.past)
    np.testing.assert_array_equal(ours.future, ref.future)
    with pytest.raises(ValueError):
        windows.make_windows(trace[:10], 6, 5)
