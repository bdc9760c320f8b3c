"""Fused bilinear resize + KxK conv + bias + ReLU: the hand-written CUDA
kernel and its plain PyTorch version.

Twin of ``longterm360fov_tpu.ops.conv_resize``. Bilinear resampling of a
frame is a pair of sparse linear operators on its rows and columns,
``small = R_h @ X @ R_wᵀ`` (:func:`resize_matrix`, align_corners=False);
a K x K cross-correlation with "SAME" zero padding, a bias and a ReLU
follow: ``(B, H, W)`` f32 → ``(B, C, h, w)`` f32.

* :func:`conv_resize_reference`, the plain version: the einsum with the
  dense operators, then ``F.conv2d`` (``padding=K//2``, which is what
  ``lax.conv``'s "SAME" pads at odd K), the bias and the ReLU, in exact f32
  (on the card it raises under TF32: ``fused_lstm.exact_f32_matmul``).
  It is differentiable, and it is what the fusion family trains through.
* :func:`fused_conv_resize`, the wrapper: on CPU tensors it runs the plain
  version; on CUDA tensors it launches ``csrc/conv_resize.cu``, whose header
  says what bounds it and why it gathers the two taps of each output row and
  column (:func:`resize_taps`) instead of forming the dense products, in
  tiles of :func:`conv_tile` (any output width); it never falls back. Like
  the TPU kernel it has no backward: an input that requires grad raises.
  ``.launches`` counts its kernel launches.

The kernel takes odd K only: the TPU kernel pads K//2 on each side, and at
even K that is not what its own reference's "SAME" pads, so even K raises
here on both paths.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

__all__ = [
    "resize_matrix",
    "resize_taps",
    "conv_resize_reference",
    "fused_conv_resize",
    "ConvTile",
    "conv_smem",
    "conv_tile",
]

_SMEM_LIMIT = 232448  # dynamic shared memory a Hopper block may use (227 KB)
_MAX_TILE_COLS = 256  # output columns a block at most
_MAX_GRID = 65535  # the grid's y and z dimensions


def resize_matrix(dst: int, src: int) -> np.ndarray:
    """(dst, src) bilinear interpolation operator, align_corners=False
    (matches jax.image.resize's 'linear' sampling grid). A copy of the JAX
    package's, bit for bit."""
    r = np.zeros((dst, src), np.float32)
    scale = src / dst
    for i in range(dst):
        x = (i + 0.5) * scale - 0.5
        x0 = int(np.floor(x))
        frac = x - x0
        lo = min(max(x0, 0), src - 1)
        hi = min(max(x0 + 1, 0), src - 1)
        r[i, lo] += 1.0 - frac
        r[i, hi] += frac
    return r


@functools.lru_cache(maxsize=64)
def resize_taps(dst: int, src: int) -> Tuple[np.ndarray, np.ndarray]:
    """The two taps of every row of ``resize_matrix(dst, src)``:
    ``idx`` (2, dst) int32 (lo, hi) and ``wt`` (2, dst) f32 (w_lo, w_hi),
    the matrix's own non-zeros (a row with one non-zero, a clamped border,
    gets hi = lo and w_hi = 0). ``R[i, idx[0, i]] += wt[0, i]; R[i, idx[1,
    i]] += wt[1, i]`` rebuilds the matrix bit for bit. Cached: the arrays
    are read-only."""
    r = resize_matrix(dst, src)
    idx = np.zeros((2, dst), np.int32)
    wt = np.zeros((2, dst), np.float32)
    for i in range(dst):
        cols = np.flatnonzero(r[i])
        if not 1 <= len(cols) <= 2:
            raise AssertionError(f"resize_matrix row {i} has {len(cols)} non-zeros")
        idx[:, i] = cols[0], cols[-1]
        wt[0, i] = r[i, cols[0]]
        if len(cols) == 2:
            wt[1, i] = r[i, cols[1]]
    idx.flags.writeable = wt.flags.writeable = False
    return idx, wt


def _no_tf32(t: torch.Tensor, name: str):
    if t.is_cuda and (torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32):
        raise RuntimeError(f"{name}: TF32 is on; call ops.fused_lstm.exact_f32_matmul() first")


def _check(frames: torch.Tensor, out_hw, kernels: torch.Tensor, bias: torch.Tensor):
    if frames.dim() != 3 or min(frames.shape) < 1:
        raise ValueError(f"frames must be a non-empty (B, H, W), got {tuple(frames.shape)}")
    h, w = out_hw
    if h < 1 or w < 1:
        raise ValueError(f"out_hw must be positive, got {out_hw}")
    if kernels.dim() != 3 or kernels.shape[1] != kernels.shape[2] or kernels.shape[1] % 2 == 0:
        raise ValueError(f"kernels must be (C, K, K) with odd K, got {tuple(kernels.shape)}")
    if tuple(bias.shape) != (kernels.shape[0],):
        raise ValueError(f"bias must be ({kernels.shape[0]},), got {tuple(bias.shape)}")
    for t in (frames, kernels, bias):
        if t.dtype != torch.float32:
            raise TypeError(f"conv_resize takes float32 tensors, got {t.dtype}")
        if t.device != frames.device:
            raise ValueError(f"tensors on {t.device} and {frames.device}")


def conv_resize_reference(
    frames: torch.Tensor, out_hw: Tuple[int, int], kernels: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version: the same resize matrices as an einsum, then
    ``F.conv2d`` with K//2 zero padding, bias and ReLU → (B, C, h, w)."""
    _check(frames, out_hw, kernels, bias)
    _no_tf32(frames, "conv_resize_reference")
    h, w = out_hw
    rh = torch.from_numpy(resize_matrix(h, frames.shape[1])).to(frames.device)
    rw = torch.from_numpy(resize_matrix(w, frames.shape[2])).to(frames.device)
    small = torch.einsum("hH,bHW,wW->bhw", rh, frames, rw)
    out = F.conv2d(small[:, None], kernels[:, None], padding=kernels.shape[-1] // 2)
    return torch.relu(out + bias[None, :, None, None])


class ConvTile(NamedTuple):
    """A block of the kernel: ``rows`` x ``cols`` output pixels of one
    frame, ``smem`` bytes of dynamic shared memory."""
    rows: int
    cols: int
    smem: int


def conv_smem(rows: int, cols: int, c_out: int, ksize: int) -> int:
    """``csrc/conv_resize.cu``'s shared memory of a block (bytes): the
    filters and bias, the row and column taps of the tile with its K//2
    halo (4 values each), and from a 16-byte boundary small with the halo,
    its rows padded to whole 16 bytes."""
    pad = ksize // 2
    pr, pc = rows + 2 * pad, cols + 2 * pad
    head = -(-(c_out * (ksize * ksize + 1) + 4 * pr + 4 * pc) // 4) * 4
    return 4 * (head + pr * -(-pc // 4) * 4)


def conv_tile(batch: int, h: int, w: int, c_out: int, ksize: int, sms: int = 132) -> ConvTile:
    """The kernel's tile: rows of up to 256 output columns (a multiple of
    4: 16-byte stores); whole frames where ``batch`` frames alone make two
    blocks for each of ``sms`` SMs (no halo computed twice), else bands of 8
    rows (64 frames of 32 rows: 256 blocks, measured faster than bands of 4,
    7, 16 or 32 on the card, PERF.md §6); halved while its shared memory
    passes 227 KB. Any width is taken; raises, naming the shape, where even
    one row does not fit (a filter bank past shared memory)."""
    cols = min(-(-w // 4) * 4, _MAX_TILE_COLS)
    col_tiles = -(-w // cols)
    rows = h if batch * col_tiles >= 2 * sms else min(h, 8)
    while rows > 1 and conv_smem(rows, cols, c_out, ksize) > _SMEM_LIMIT:
        rows = -(-rows // 2)
    smem = conv_smem(rows, cols, c_out, ksize)
    if smem > _SMEM_LIMIT or -(-h // rows) > _MAX_GRID or col_tiles > _MAX_GRID:
        raise ValueError(f"out_hw=({h}, {w}), C={c_out}, K={ksize}: a block of {rows} x {cols} output pixels does "
                         f"not fit one block's shared memory ({smem} bytes, at most {_SMEM_LIMIT}) or the grid")
    return ConvTile(rows, cols, smem)


@functools.cache
def _taps_on(dst: int, src: int, device: torch.device):
    idx, wt = resize_taps(dst, src)
    return torch.tensor(idx, device=device), torch.tensor(wt, device=device)


def fused_conv_resize(
    frames: torch.Tensor,  # (B, H, W) float32
    out_hw: Tuple[int, int],
    kernels: torch.Tensor,  # (C, K, K)
    bias: torch.Tensor,  # (C,)
) -> torch.Tensor:
    """→ (B, C, h, w) ReLU conv features of bilinearly-resized frames, in one
    kernel launch on the card (the plain version on CPU tensors). No
    backward: inputs that require grad raise (train through
    :func:`conv_resize_reference`)."""
    _check(frames, out_hw, kernels, bias)
    if any(t.requires_grad for t in (frames, kernels, bias)) and torch.is_grad_enabled():
        raise RuntimeError(
            "fused_conv_resize has no backward (nor has the TPU kernel): "
            "differentiate through conv_resize_reference"
        )
    if frames.device.type == "cpu":
        return conv_resize_reference(frames, out_hw, kernels, bias)
    if frames.device.type != "cuda":
        raise ValueError(f"fused_conv_resize runs on cpu or cuda, not {frames.device}")
    for t in (frames, kernels, bias):
        if not t.is_contiguous():
            raise ValueError(f"tensor of shape {tuple(t.shape)} is not contiguous")
    batch, src_h, src_w = frames.shape
    h, w = out_hw
    c_out, ksize = kernels.shape[0], kernels.shape[-1]
    tile = conv_tile(batch, h, w, c_out, ksize, _build.sm_count(frames.device))
    ridx, rwt = _taps_on(h, src_h, frames.device)
    cidx, cwt = _taps_on(w, src_w, frames.device)
    out = torch.empty((batch, c_out, h, w), device=frames.device, dtype=torch.float32)
    with torch.cuda.device(frames.device):
        err = _library().conv_resize_f32(
            frames.data_ptr(), ridx.data_ptr(), rwt.data_ptr(), cidx.data_ptr(), cwt.data_ptr(),
            kernels.data_ptr(), bias.data_ptr(), out.data_ptr(),
            batch, src_h, src_w, h, w, c_out, ksize, tile.rows, tile.cols,
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"conv_resize kernel launch failed: "
            f"{_library().conv_resize_error_string(err).decode()} (cuda error {err})"
        )
    fused_conv_resize.launches += 1
    return out


fused_conv_resize.launches = 0


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library, built at first use and loaded once."""
    lib = _build.load("conv_resize")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.conv_resize_f32.argtypes = [vp] * 8 + [i32] * 9 + [vp]
    lib.conv_resize_f32.restype = i32
    lib.conv_resize_smem_bytes.argtypes = [i32] * 4
    lib.conv_resize_smem_bytes.restype = ctypes.c_longlong
    lib.conv_resize_error_string.argtypes = [i32]
    lib.conv_resize_error_string.restype = ctypes.c_char_p
    return lib
