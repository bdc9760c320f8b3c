"""Whole-request fused LSTM serve: the hand-written CUDA kernel and its plain
PyTorch version.

Twin of ``longterm360fov_tpu.ops.fused_lstm.fused_serve`` in its no-context
f32 tier: the L-layer encoder over the past window, then the T_out-step
autoregressive decoder with projection and feedback, in one launch
(``csrc/fused_serve.cu``, whose header says what bounds it on Hopper and what
its design does about that).

:func:`fused_serve` runs :func:`fused_serve_reference` on CPU tensors, and
launches the kernel on CUDA tensors or raises. It never falls back.
``fused_serve.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from ..models.cell import LSTMParams, lstm_cell
from . import _build

__all__ = [
    "fused_serve",
    "fused_serve_reference",
    "kernel_rows",
    "exact_f32_matmul",
]

MAX_LAYERS = 8  # csrc/fused_serve.cu MAX_LAYERS
_SMEM_LIMIT = 232448  # dynamic shared memory a Hopper block may use (227 KB)
_MAX_THREADS = 256  # the kernel's __launch_bounds__
_TR, _TJ = 8, 4  # rows and hidden units per thread


def exact_f32_matmul():
    """f32 matrix products and convolutions in full f32 on the card: TF32
    keeps about three decimal digits, and 60 recurrent steps amplify that.
    Process-wide flags: entry points (``cli.serve_bench``, ``chip_smoke.py``)
    call this once; library functions do not."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fused_serve_reference(
    enc_params: Sequence[LSTMParams],
    dec_params: Sequence[LSTMParams],
    proj_w: torch.Tensor,
    proj_b: torch.Tensor,
    past_n: torch.Tensor,
    t_out: int,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (B, T_in, D) normalized past →
    (B, t_out, D) normalized predictions, step by step. On the card it
    needs exact f32 products (:func:`exact_f32_matmul`) and raises under
    TF32."""
    if past_n.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "fused_serve_reference: TF32 matmul is on; call "
            "exact_f32_matmul() first"
        )
    batch, t_in, _ = past_n.shape
    zero = past_n.new_zeros((batch, proj_w.shape[0]))
    states = [(zero, zero) for _ in enc_params]
    for t in range(t_in):
        inp = past_n[:, t]
        for l, p in enumerate(enc_params):
            states[l] = lstm_cell(p, inp, states[l])
            inp = states[l][0]
    y = past_n[:, -1]
    ys = []
    for _ in range(t_out):
        inp = y
        for l, p in enumerate(dec_params):
            states[l] = lstm_cell(p, inp, states[l])
            inp = states[l][0]
        y = inp @ proj_w + proj_b
        ys.append(y)
    return torch.stack(ys, dim=1)


def kernel_rows(hidden: int, layers: int, d: int) -> int:
    """Batch rows per block: as many as 256 threads of 8 rows x 4 hidden
    units cover, halved until the block's shared memory (h and c of every
    layer, and the layer-0 input) fits. Raises for shapes the kernel does
    not take."""
    if hidden < 32 or hidden % 32:
        raise ValueError(f"the kernel needs hidden % 32 == 0, got {hidden}")
    if not 1 <= layers <= MAX_LAYERS:
        raise ValueError(f"the kernel takes 1..{MAX_LAYERS} layers, got {layers}")
    rows = min(64, _MAX_THREADS // (hidden // _TJ) * _TR)
    while rows >= _TR and 4 * (2 * layers * hidden + d) * rows > _SMEM_LIMIT:
        rows //= 2
    if rows < _TR:
        raise ValueError(
            f"layers={layers}, hidden={hidden}: h and c of every layer do "
            f"not fit one block's shared memory"
        )
    return rows


def _check(enc_params, dec_params, proj_w, proj_b, past_n, t_out):
    if past_n.dim() != 3:
        raise ValueError(f"past_n must be (B, T_in, D), got {tuple(past_n.shape)}")
    batch, t_in, d = past_n.shape
    hidden = proj_w.shape[0]
    layers = len(enc_params)
    if batch < 1 or t_in < 1 or t_out < 1:
        raise ValueError(f"empty request: past_n {tuple(past_n.shape)}, t_out {t_out}")
    if len(dec_params) != layers or layers < 1:
        raise ValueError(
            f"{layers} encoder and {len(dec_params)} decoder layers: the "
            f"decoder starts from the encoder's state, layer for layer"
        )
    expect = []
    for l in range(layers):
        in_l = d if l == 0 else hidden
        for p in (enc_params[l], dec_params[l]):
            expect += [(p.w, (in_l + hidden, 4 * hidden)), (p.b, (4 * hidden,))]
    expect += [(proj_w, (hidden, d)), (proj_b, (d,)), (past_n, (batch, t_in, d))]
    for t, shape in expect:
        if tuple(t.shape) != shape:
            raise ValueError(f"expected shape {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"the f32 tier takes float32 tensors, got {t.dtype}")
        if t.device != past_n.device:
            raise ValueError(f"tensors on {t.device} and {past_n.device}")
        if not t.is_contiguous():
            raise ValueError(f"tensor of shape {shape} is not contiguous")
    return [t for t, _ in expect]


def fused_serve(
    enc_params: Sequence[LSTMParams],
    dec_params: Sequence[LSTMParams],
    proj_w: torch.Tensor,
    proj_b: torch.Tensor,
    past_n: torch.Tensor,  # (B, T_in, D) anchor-normalized past windows
    t_out: int,
    *,
    context=None,
    peer_params=None,
    peer_xs=None,
    peer_w=None,
    compute_dtype=torch.float32,
    _probe: str = "",
) -> torch.Tensor:
    """Whole serve request, encode and autoregressive decode, in one kernel
    launch → (B, t_out, D) f32 normalized predictions.

    Same shapes and semantics as the JAX ``fused_serve``. The JAX tiers this
    port does not have yet raise: a static ``context`` and the lockstep
    ``peer_*`` tier, the bf16 ``compute_dtype`` and the ``_probe`` modes."""
    if context is not None or peer_params is not None or peer_xs is not None \
            or peer_w is not None:
        raise NotImplementedError(
            "fused_serve: the context and lockstep-peer tiers are not ported "
            "yet (ROADMAP.md, slice 'cross_user')"
        )
    if compute_dtype != torch.float32:
        raise NotImplementedError(
            f"fused_serve: only the exact f32 tier is ported, got "
            f"compute_dtype={compute_dtype} (ROADMAP.md, Queue 2 #1)"
        )
    if _probe:
        raise NotImplementedError(
            "fused_serve: the roofline _probe modes are not ported"
        )
    tensors = _check(enc_params, dec_params, proj_w, proj_b, past_n, t_out)
    if past_n.device.type == "cpu":
        return fused_serve_reference(
            enc_params, dec_params, proj_w, proj_b, past_n, t_out
        )
    if past_n.device.type != "cuda":
        raise ValueError(f"fused_serve runs on cpu or cuda, not {past_n.device}")
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("the kernel reads 16-byte vectors: tensors must be 16-byte aligned")

    batch, t_in, d = past_n.shape
    hidden, layers = proj_w.shape[0], len(enc_params)
    rows = kernel_rows(hidden, layers, d)
    lib = _library()
    out = torch.empty((batch, t_out, d), device=past_n.device, dtype=torch.float32)

    def ptrs(ts):
        return (ctypes.c_void_p * layers)(*[t.data_ptr() for t in ts])

    with torch.cuda.device(past_n.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fused_serve_f32(
            past_n.data_ptr(), out.data_ptr(),
            ptrs([p.w for p in enc_params]), ptrs([p.b for p in enc_params]),
            ptrs([p.w for p in dec_params]), ptrs([p.b for p in dec_params]),
            proj_w.data_ptr(), proj_b.data_ptr(),
            batch, t_in, t_out, d, hidden, layers, rows, stream,
        )
    if err:
        raise RuntimeError(
            f"fused_serve kernel launch failed: "
            f"{lib.fused_serve_error_string(err).decode()} (cuda error {err})"
        )
    fused_serve.launches += 1
    return out


fused_serve.launches = 0


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library, built at first use and loaded once."""
    lib = _build.load("fused_serve")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    arr = ctypes.POINTER(ctypes.c_void_p)
    lib.fused_serve_f32.argtypes = [
        vp, vp, arr, arr, arr, arr, vp, vp,
        i32, i32, i32, i32, i32, i32, i32, vp,
    ]
    lib.fused_serve_f32.restype = i32
    lib.fused_serve_error_string.argtypes = [i32]
    lib.fused_serve_error_string.restype = ctypes.c_char_p
    return lib
