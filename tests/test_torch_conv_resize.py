"""The port's fused conv+resize (``ops.conv_resize``) against the JAX
package on the CPU: the resize operator, the two-tap tables the CUDA kernel
gathers with, the plain version against JAX's reference and its Pallas
kernel in interpret mode, and the library yardstick ``F.interpolate``
against the einsum. The CUDA kernel itself is checked on the card
(``tests/test_torch_kernel_cuda.py``, ``chip_smoke.py``).
"""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from longterm360fov_tpu.ops import conv_resize as JCR
from longterm360fov_tpu_torch.ops import conv_resize as CR

# the five shapes the card checks, scaled down (B, H, W) → (h, w), C:
# the JAX suite's shape, a clip's saliency maps, the fusion maps mode,
# upsampling, and odd source sizes
SHAPES = [
    ((3, 48, 96), (16, 32), 4),
    ((4, 96, 192), (8, 16), 8),
    ((9, 16, 32), (4, 8), 4),
    ((5, 12, 20), (16, 32), 4),
    ((3, 97, 191), (8, 16), 8),
]
# (dst, src) pairs of every full-size shape the card runs
FULL_PAIRS = [(16, 48), (32, 96), (32, 960), (64, 1920), (16, 64), (32, 128), (16, 12),
              (32, 20), (32, 961), (64, 1917)]


# odd K other than the main path's 3, scaled down from the card tests'
# CONV_SHAPES: (B, H, W) → (h, w), C, K
ODD_K = [
    ((3, 48, 96), (16, 32), 4, 5),
    ((2, 20, 40), (12, 18), 3, 7),
    ((5, 12, 20), (16, 32), 4, 1),
]


def _case(shape, c, seed, k=3):
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=shape).astype(np.float32)
    kernels = rng.normal(size=(c, k, k)).astype(np.float32)
    bias = rng.normal(size=(c,)).astype(np.float32)
    return frames, kernels, bias


@pytest.mark.parametrize("dst,src", FULL_PAIRS)
def test_resize_matrix_bit_equal_to_jax(dst, src):
    assert np.array_equal(CR.resize_matrix(dst, src), JCR.resize_matrix(dst, src))


@pytest.mark.parametrize("dst,src", FULL_PAIRS)
def test_resize_taps_rebuild_the_matrix(dst, src):
    """The kernel's (lo, hi, w_lo, w_hi) tables are the matrix's own f32
    non-zeros: at most two a row, rebuilt bit for bit."""
    idx, wt = CR.resize_taps(dst, src)
    assert idx.shape == wt.shape == (2, dst) and idx.dtype == np.int32
    r = np.zeros((dst, src), np.float32)
    rows = np.arange(dst)
    np.add.at(r, (rows, idx[0]), wt[0])
    np.add.at(r, (rows, idx[1]), wt[1])
    assert np.array_equal(r, JCR.resize_matrix(dst, src))
    assert ((idx >= 0) & (idx < src)).all()


@pytest.mark.parametrize("shape,out_hw,c", SHAPES)
def test_plain_version_matches_jax(shape, out_hw, c):
    """1e-5 against JAX's reference (f32 sums in another order) and 1e-4
    against JAX's kernel in interpret mode (tests/test_features.py's
    bound)."""
    frames, kernels, bias = _case(shape, c, seed=c)
    ours = CR.conv_resize_reference(torch.from_numpy(frames), out_hw, torch.from_numpy(kernels),
                                    torch.from_numpy(bias)).numpy()
    j_in = (jnp.asarray(frames), out_hw, jnp.asarray(kernels), jnp.asarray(bias))
    assert ours.shape == (shape[0], c) + out_hw
    np.testing.assert_allclose(ours, np.asarray(JCR.conv_resize_reference(*j_in)), atol=1e-5)
    np.testing.assert_allclose(ours, np.asarray(JCR.fused_conv_resize(*j_in)), atol=1e-4)


@pytest.mark.parametrize("shape,out_hw,c,k", ODD_K)
def test_plain_version_matches_jax_at_odd_k(shape, out_hw, c, k):
    """The same bounds as at K = 3, for the kernel's body that takes any
    odd K: its K // 2 halo on each side is JAX's "SAME" padding."""
    frames, kernels, bias = _case(shape, c, seed=c + k, k=k)
    ours = CR.conv_resize_reference(torch.from_numpy(frames), out_hw, torch.from_numpy(kernels),
                                    torch.from_numpy(bias)).numpy()
    j_in = (jnp.asarray(frames), out_hw, jnp.asarray(kernels), jnp.asarray(bias))
    assert ours.shape == (shape[0], c) + out_hw
    np.testing.assert_allclose(ours, np.asarray(JCR.conv_resize_reference(*j_in)), atol=1e-5)
    np.testing.assert_allclose(ours, np.asarray(JCR.fused_conv_resize(*j_in)), atol=1e-4)


@pytest.mark.parametrize("shape,out_hw,c", SHAPES)
def test_wrapper_on_cpu_is_the_plain_version(shape, out_hw, c):
    frames, kernels, bias = (torch.from_numpy(a) for a in _case(shape, c, seed=1))
    before = CR.fused_conv_resize.launches
    out = CR.fused_conv_resize(frames, out_hw, kernels, bias)
    assert torch.equal(out, CR.conv_resize_reference(frames, out_hw, kernels, bias))
    assert CR.fused_conv_resize.launches == before  # no kernel ran


@pytest.mark.parametrize("shape,out_hw", [((2, 48, 96), (16, 32)), ((2, 960, 1920), (32, 64)),
                                          ((3, 64, 128), (16, 32)), ((2, 12, 20), (16, 32)),
                                          ((2, 961, 1917), (32, 64))])
def test_interpolate_equals_the_einsum(shape, out_hw):
    """The library yardstick of chip_smoke.py computes the same resize, at
    the full sizes the card runs: in float64, F.interpolate(bilinear,
    align_corners=False, antialias=False) applies resize_matrix's operators
    bit for bit (one-hot rows and columns, the other axis kept at its size),
    and on random frames it equals the einsum within 1e-12 (f64 sums in
    another order)."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=shape))
    h, w = out_hw

    def interp(t, size):
        return F.interpolate(t[:, None], size=size, mode="bilinear", align_corners=False,
                             antialias=False)[:, 0]

    rh = torch.from_numpy(CR.resize_matrix(h, shape[1])).double()
    rw = torch.from_numpy(CR.resize_matrix(w, shape[2])).double()
    rows = torch.eye(shape[1], dtype=torch.float64)[:, :, None].expand(-1, -1, 2)
    cols = torch.eye(shape[2], dtype=torch.float64)[:, None, :].expand(-1, 2, -1)
    assert torch.equal(interp(rows, (h, 2))[:, :, 0].t(), rh)
    assert torch.equal(interp(cols, (2, w))[:, 0, :].t(), rw)
    diff = (interp(x, out_hw) - torch.einsum("hH,bHW,wW->bhw", rh, x, rw)).abs().max().item()
    assert diff <= 1e-12


def test_wrapper_raises_on_requires_grad():
    frames, kernels, bias = (torch.from_numpy(a) for a in _case((2, 48, 96), 4, seed=2))
    with pytest.raises(RuntimeError, match="no backward"):
        CR.fused_conv_resize(frames, (16, 32), kernels.requires_grad_(True), bias)
    with torch.no_grad():  # no graph: the kernel's forward is all that is asked
        CR.fused_conv_resize(frames, (16, 32), kernels, bias)


def test_plain_version_is_differentiable():
    frames, kernels, bias = (torch.from_numpy(a) for a in _case((2, 48, 96), 4, seed=3))
    kernels.requires_grad_(True)
    CR.conv_resize_reference(frames, (16, 32), kernels, bias).sum().backward()
    assert kernels.grad is not None and kernels.grad.abs().sum() > 0


@pytest.mark.parametrize("bad", ["even-k", "bias", "dtype", "rank"])
def test_bad_inputs_raise(bad):
    frames, kernels, bias = (torch.from_numpy(a) for a in _case((2, 16, 32), 4, seed=4))
    if bad == "even-k":
        kernels = torch.zeros(4, 2, 2)
    elif bad == "bias":
        bias = torch.zeros(3)
    elif bad == "dtype":
        frames = frames.double()
    else:
        frames = frames[0]
    with pytest.raises((ValueError, TypeError)):
        CR.fused_conv_resize(frames, (8, 16), kernels, bias)


def test_tile_rows_fit_a_block():
    """conv_tile: whole frames where the frames alone make two blocks an SM
    (a clip, the maps mode), else bands of 8 rows (64 frames: 256 blocks);
    rows in tiles of up to 256 columns, a multiple of 4; wide rows past the
    old 48 KB cap taken; a filter bank past shared memory refused, naming
    the shape."""
    assert CR.conv_tile(1200, 32, 64, 8, 3) == (32, 64, CR.conv_smem(32, 64, 8, 3))
    assert CR.conv_tile(4099, 16, 32, 4, 3)[:2] == (16, 32)
    assert CR.conv_tile(64, 32, 64, 8, 3)[:2] == (8, 64)
    assert CR.conv_tile(3, 4, 8, 4, 3)[:2] == (4, 8)
    for w in (2000, 15000, 20000, 100003):  # one output row past 48 KB from 12,000 columns
        t = CR.conv_tile(2, 32, w, 8, 3)
        assert t.cols == 256 and t.smem <= 232448
        assert t.rows == (32 if 2 * -(-w // 256) >= 2 * 132 else 8)
    assert CR.conv_tile(2, 40, 30, 3, 3).cols == 32
    assert CR.conv_smem(32, 64, 8, 3) == 4 * ((8 * 10 + 4 * 34 + 4 * 66 + 3) // 4 * 4 + 34 * 68)
    with pytest.raises(ValueError, match=r"out_hw=\(32, 64\), C=6000, K=3: .* does not fit"):
        CR.conv_tile(2, 32, 64, 6000, 3)


@pytest.mark.parametrize("batch,h,w,c,k,rows,cols,col_tiles", [
    (64, 32, 64, 8, 5, 8, 64, 1),
    (64, 32, 64, 8, 7, 8, 64, 1),
    (3, 20, 530, 3, 5, 8, 256, 3),  # a ragged last tile of 18 columns
    (5, 18, 1030, 4, 7, 8, 256, 5),  # of 6 columns
    (2, 12, 20000, 4, 7, 8, 256, 79),  # 158 column tiles: bands of 8 rows
    (300, 24, 40, 4, 5, 24, 40, 1),
    (5, 16, 32, 4, 1, 8, 32, 1),
])
def test_tile_at_odd_k(batch, h, w, c, k, rows, cols, col_tiles):
    """conv_tile at the card tests' odd-K shapes: the halo of K // 2 on each
    side in the shared memory it counts (the kernel's small_ld: rows padded
    to whole 16 bytes), the column tiles over the row with a ragged last."""
    t = CR.conv_tile(batch, h, w, c, k)
    pad = k // 2
    head = -(-(c * (k * k + 1) + 4 * (t.rows + 2 * pad) + 4 * (t.cols + 2 * pad)) // 4) * 4
    assert (t.rows, t.cols) == (rows, cols) and -(-w // t.cols) == col_tiles
    assert t.smem == 4 * (head + (t.rows + 2 * pad) * -(-(t.cols + 2 * pad) // 4) * 4) <= 232448
