"""Scheduled-sampling LSTM decoder for training: hand-written CUDA forward
and backward kernels, their plain PyTorch versions, and the autograd
function that joins them.

Twin of ``longterm360fov_tpu.ops.lstm_ss``: :func:`ss_decode` runs the
decoder of a scheduled-sampling seq2seq from the encoder's final states
``h0, c0 (L, B, H)`` and the last observed position ``y0 (B, D)``. At step t
its layer-0 input is ``[x_t, ctx]`` with ``x_t = teacher_t`` where
``coin_t > 0`` and ``y_{t-1}`` (the model's own previous output, ``y0`` at
t = 0) elsewhere; L stacked cells follow, then ``y_t = h_top · proj_w +
proj_b``, which is fed back. It returns ``ys (B, T, D)`` f32. Coins arrive
as an explicit ``(T, B, 1)`` array; ``teacher_tm`` is ``(T, B, D)``, as in
JAX. ``compute_dtype`` bf16 is the JAX ``compute_dtype=bfloat16`` tier, as
in ``ops.lstm_train``: the operands of every product (here also the
projection ``h_top·proj_w``, ``dy·proj_wᵀ`` and ``dproj_w = Σ h_topᵀ·dy``)
rounded to bf16 and summed in f32; ``ys``, the fed-back ``y``, ``db`` and
``dproj_b`` unrounded.

Four kernels of ``csrc/lstm_ss.cu`` carry it on the card:

* :func:`ss_fwd`, the forward recurrence: ``ys`` f32 and, per layer, the
  residuals ``hs``, ``cs (B, T, H)`` and the gates ``(B, T, 4H)`` in
  ``residual_dtype``; the training forward on the tensor cores
  (``csrc/lstm_common.cuh`` train_fwd_kernel: the serve kernel's decoder
  body with the coins, the teacher and the residual stores), its block from
  ``lstm_train.fwd_block``;
* :func:`ss_bwd`, the backward recurrence in reverse time: the total
  gradient ``dy`` of every ``y_t`` (upstream plus the feedback from step
  t + 1), ``dgates`` per layer, ``dteacher (T, B, D)``, ``dy0``, ``dh0``,
  ``dc0`` and ``dctx``; its products ``dgates · Wᵀ`` on the tensor cores
  (three-pass TF32 in f32, bf16 mma in bf16), W packed by
  :func:`pack_bwd_weights`, its block from :func:`bwd_block`;
* :func:`ss_dw`, the dW/db reduction of ``lstm_train``'s kernel with layer
  0's ``z = [x_t, ctx, h_{t-1}]``, ``x_t`` rebuilt from the coins, the
  teacher and the f32 ``ys`` (``y0`` at t = 0), as the TPU backward rebuilds
  it;
* :func:`ss_dproj`, ``dproj_w = Σ h_topᵀ·dy`` and ``dproj_b = Σ dy`` with
  ``h_top`` read from the residuals (bf16-rounded with bf16 residuals).

Every sum across rows is split into slices whose partial sums a second pass
adds in a fixed order: no float atomics, so two runs give the same bits.
Each wrapper runs its plain version (``_forward_reference``,
``_bwd_recurrence_reference``, ``_dw_reference``, ``_dproj_reference``) on
CPU tensors, and launches its kernel on CUDA tensors or raises; it never
falls back. Each counts its kernel launches in ``.launches`` (f32 compute)
and ``.launches_bf16`` (bf16 compute).
:func:`ss_decode_reference` is the decoder as a step loop of
``cell.lstm_cell``, whose gradient torch autograd gives.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..models.cell import LSTMParams, lstm_cell, mm
from . import _build
from .lstm_train import (
    RESIDUAL_DTYPES,
    Residuals,
    _check_card,
    _check_pack_layer,
    _dw_reference as _lstm_dw_reference,
    _pack_reference,
    _no_tf32,
    _ptrs,
    check_compute,
    count_launch,
    dw_pack,
    dw_splits,
    dw_zld,
    c_buffer,
    fwd_block,
    fwd_weights,
    in_compute,
    widen,
)

__all__ = [
    "ss_decode",
    "ss_decode_reference",
    "ss_fwd",
    "ss_bwd",
    "ss_dw",
    "ss_dproj",
    "bwd_block",
    "pack_bwd_weights",
]

_SMEM_LIMIT = 232448  # dynamic shared memory a Hopper block may use (227 KB)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def ss_decode_reference(
    dec_params: Sequence[LSTMParams], proj_w: torch.Tensor, proj_b: torch.Tensor,
    h0: torch.Tensor, c0: torch.Tensor, y0: torch.Tensor, teacher_tm: torch.Tensor,
    coins_ctx: tuple,
) -> torch.Tensor:
    """The decoder as a step loop of ``cell.lstm_cell`` in f32, with no
    residual rounding; torch autograd gives its gradient."""
    coins, context = coins_ctx
    _no_tf32(y0, "ss_decode_reference")
    states = [(h0[l], c0[l]) for l in range(len(dec_params))]
    y = y0
    ys = []
    for t in range(teacher_tm.shape[0]):
        inp = torch.where(coins[t] > 0, teacher_tm[t], y)
        if context is not None:
            inp = torch.cat([inp, context], dim=-1)
        for l, p in enumerate(dec_params):
            states[l] = lstm_cell(p, inp, states[l])
            inp = states[l][0]
        y = inp @ proj_w + proj_b
        ys.append(y)
    return torch.stack(ys, dim=1)


def _forward_reference(
    params, proj_w, proj_b, h0, c0, y0, teacher_tm, coins, context, residual_dtype,
    compute_dtype=torch.float32,
) -> Tuple[torch.Tensor, Residuals]:
    """Plain version of the forward kernel: the recurrence in f32 with f32
    carries and the f32 feedback, the products in ``compute_dtype``, every
    step's h, c and gates stored in ``residual_dtype`` → (ys (B, T, D) f32,
    residuals). ``context`` is (B, C), or (B, T, C) for a per-step context
    (``ops.lstm_align``)."""
    _no_tf32(y0, "ss_fwd plain version")
    t_len, batch, d = teacher_tm.shape
    hidden = h0.shape[-1]
    res = Residuals([], [], [])
    for _ in params:
        res.hs.append(y0.new_empty((batch, t_len, hidden), dtype=residual_dtype))
        res.cs.append(y0.new_empty((batch, t_len, hidden), dtype=residual_dtype))
        res.gs.append(y0.new_empty((batch, t_len, 4 * hidden), dtype=residual_dtype))
    ys = y0.new_empty((batch, t_len, d))
    h = list(h0.unbind(0))
    c = list(c0.unbind(0))
    y = y0
    for t in range(t_len):
        inp = torch.where(coins[t] > 0, teacher_tm[t], y)
        if context is not None:
            inp = torch.cat([inp, context[:, t] if context.dim() == 3 else context], dim=-1)
        for l, p in enumerate(params):
            gates = mm(torch.cat([inp, h[l]], dim=-1), p.w, compute_dtype) + p.b
            i, f, g, o = gates.chunk(4, dim=-1)
            i, f, g, o = i.sigmoid(), f.sigmoid(), g.tanh(), o.sigmoid()
            c[l] = f * c[l] + i * g
            h[l] = o * torch.tanh(c[l])
            res.gs[l][:, t] = torch.cat([i, f, g, o], dim=-1)
            res.cs[l][:, t] = c[l]
            res.hs[l][:, t] = h[l]
            inp = h[l]
        y = mm(inp, proj_w, compute_dtype) + proj_b
        ys[:, t] = y
    return ys, res


def _bwd_recurrence_reference(params, proj_w, c0, coins, res: Residuals, dys, ctx_dim,
                              step_ctx=False, compute_dtype=torch.float32):
    """Plain version of the backward recurrence kernel → (dgates per layer
    (B, T, 4H), dy (B, T, D), dteacher (T, B, D), dy0 (B, D), dh0, dc0
    (L, B, H), dctx (B, C) summed over t, or (B, T, C) per step with
    ``step_ctx``, or None), all f32; the products in ``compute_dtype``."""
    _no_tf32(dys, "ss_bwd plain version")
    batch, t_len, d = dys.shape
    hidden = proj_w.shape[0]
    layers = len(params)
    dh = [dys.new_zeros((batch, hidden)) for _ in params]
    dc = [dys.new_zeros((batch, hidden)) for _ in params]
    dgates = [dys.new_empty((batch, t_len, 4 * hidden)) for _ in params]
    dy = dys.new_empty((batch, t_len, d))
    dteacher = dys.new_empty((t_len, batch, d))
    dctx = dys.new_zeros((batch, t_len, ctx_dim) if step_ctx else (batch, ctx_dim))
    feedback = dys.new_zeros((batch, d))
    for t in reversed(range(t_len)):
        dy_t = dys[:, t] + feedback
        dy[:, t] = dy_t
        above = mm(dy_t, proj_w.t(), compute_dtype)
        for l in reversed(range(layers)):
            d_in = d + ctx_dim if l == 0 else hidden
            i, f, g, o = res.gs[l][:, t].float().chunk(4, dim=-1)
            c_t = res.cs[l][:, t].float()
            c_prev = res.cs[l][:, t - 1].float() if t > 0 else c0[l]
            dh_total = above + dh[l]
            tanh_c = torch.tanh(c_t)
            dc_total = dh_total * o * (1.0 - tanh_c * tanh_c) + dc[l]
            dg = torch.cat([
                dc_total * g * i * (1.0 - i),
                dc_total * c_prev * f * (1.0 - f),
                dc_total * i * (1.0 - g * g),
                dh_total * tanh_c * o * (1.0 - o),
            ], dim=-1)
            dgates[l][:, t] = dg
            dz = mm(dg, params[l].w.t(), compute_dtype)
            dh[l] = dz[:, d_in:]
            dc[l] = dc_total * f
            above = dz[:, :d_in]
        dx = above[:, :d]
        if step_ctx:
            dctx[:, t] = above[:, d:]
        else:
            dctx += above[:, d:]
        coin = coins[t]
        dteacher[t] = dx * coin
        feedback = dx * (1.0 - coin)
    return (dgates, dy, dteacher, feedback, torch.stack(dh), torch.stack(dc),
            dctx if ctx_dim else None)


def _layer0_input(y0, teacher_tm, coins, context, ys):
    """Layer 0's input ``[x_t, ctx]`` at every (b, t), as the backward
    rebuilds it: ``x_t`` is the teacher where the coin is up, else the f32
    ``ys[t - 1]`` (``y0`` at t = 0); ``context`` (B, C) or per step
    (B, T, C) → (B, T, D + C)."""
    y_prev = torch.cat([y0[:, None], ys[:, :-1]], dim=1)
    x = torch.where(coins.transpose(0, 1) > 0, teacher_tm.transpose(0, 1), y_prev)
    if context is None:
        return x
    if context.dim() == 2:
        context = context[:, None].expand(-1, x.shape[1], -1)
    return torch.cat([x, context], dim=-1)


def _dw_reference(params, h0, y0, teacher_tm, coins, context, ys, res, dgates,
                  compute_dtype=torch.float32) -> List[LSTMParams]:
    """Plain version of the dW/db reduction kernel."""
    return _lstm_dw_reference(
        params, _layer0_input(y0, teacher_tm, coins, context, ys), h0, res, dgates,
        compute_dtype,
    )


def _dproj_reference(hs_top: torch.Tensor, dy: torch.Tensor, compute_dtype=torch.float32):
    """Plain version of the dproj reduction kernel → (dproj_w (H, D) in
    ``compute_dtype``, dproj_b (D,) unrounded)."""
    _no_tf32(dy, "ss_dproj plain version")
    h = hs_top.float().reshape(-1, hs_top.shape[-1])
    g = dy.reshape(-1, dy.shape[-1])
    return mm(h.t(), g, compute_dtype), g.sum(dim=0)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check(params, proj_w, proj_b, h0, c0, y0, teacher_tm, coins, context, residual_dtype,
           step_ctx=False):
    if teacher_tm.dim() != 3:
        raise ValueError(f"teacher_tm must be (T, B, D), got {tuple(teacher_tm.shape)}")
    t_len, batch, d = teacher_tm.shape
    layers = len(params)
    hidden = proj_w.shape[0]
    ctx_dim = 0 if context is None else context.shape[-1]
    if layers < 1 or min(t_len, batch, d) < 1:
        raise ValueError(f"empty call: {layers} layers, teacher {tuple(teacher_tm.shape)}")
    if residual_dtype not in RESIDUAL_DTYPES:
        raise TypeError(f"residual_dtype must be one of {RESIDUAL_DTYPES}, got {residual_dtype}")
    expect = [(proj_w, (hidden, d)), (proj_b, (d,)), (h0, (layers, batch, hidden)),
              (c0, (layers, batch, hidden)), (y0, (batch, d)), (teacher_tm, (t_len, batch, d)),
              (coins, (t_len, batch, 1))]
    if context is not None:
        expect.append((context, (batch, t_len, ctx_dim) if step_ctx else (batch, ctx_dim)))
    for l, p in enumerate(params):
        in_l = d + ctx_dim if l == 0 else hidden
        expect += [(p.w, (in_l + hidden, 4 * hidden)), (p.b, (4 * hidden,))]
    for t, shape in expect:
        if tuple(t.shape) != shape:
            raise ValueError(f"expected shape {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"the kernels take float32 tensors, got {t.dtype}")
        if t.device != y0.device:
            raise ValueError(f"tensors on {t.device} and {y0.device}")
    if y0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the kernels run on cpu or cuda, not {y0.device}")
    return ctx_dim


def _check_res(res: Residuals, layers, batch, t_len, hidden, device):
    rdt = res.hs[0].dtype
    if rdt not in RESIDUAL_DTYPES or not len(res.hs) == len(res.cs) == len(res.gs) == layers:
        raise ValueError(f"residuals of {len(res.hs)} layers in {rdt} do not match the call")
    for l in range(layers):
        for t, w in ((res.hs[l], hidden), (res.cs[l], hidden), (res.gs[l], 4 * hidden)):
            if tuple(t.shape) != (batch, t_len, w) or t.dtype != rdt or t.device != device:
                raise ValueError(f"residual {t.dtype} {tuple(t.shape)} on {t.device} does not match the call")
    return rdt


def _expect_f32(expect, params, d_in0: int, hidden: int, dev):
    """Raise unless every (tensor, shape) of ``expect``, and every layer's W
    (layer 0 takes ``d_in0`` inputs), is an f32 tensor of that shape on
    ``dev``."""
    expect = expect + [(p.w, ((d_in0 if l == 0 else hidden) + hidden, 4 * hidden))
                       for l, p in enumerate(params)]
    for t, shape in expect:
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"expected f32 {shape} on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _ctx_ok(ctx_dim: int):
    if ctx_dim % 4:
        raise ValueError(f"the kernels read the context as 16-byte rows: ctx_dim % 4 == 0, got {ctx_dim}")


def _raise_on(err: int, name: str):
    if err:
        raise RuntimeError(
            f"{name} kernel launch failed: "
            f"{_library().lstm_ss_error_string(err).decode()} (cuda error {err})"
        )


def _stream():
    # the current device's current stream as its raw handle: what
    # torch.cuda.current_stream().cuda_stream gives, without building a
    # Stream object (4.6 µs a call on the card's host, the dproj call's
    # largest host cost after its launches)
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


def ss_fwd(
    params: Sequence[LSTMParams], proj_w, proj_b, h0, c0, y0, teacher_tm, coins,
    context: Optional[torch.Tensor], residual_dtype: torch.dtype = torch.float32,
    compute_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, Residuals]:
    """Forward recurrence → (ys (B, T, D) f32, the residuals)."""
    _check(params, proj_w, proj_b, h0, c0, y0, teacher_tm, coins, context, residual_dtype)
    check_compute(compute_dtype)
    if y0.device.type == "cpu":
        return _forward_reference(params, proj_w, proj_b, h0, c0, y0, teacher_tm, coins,
                                  context, residual_dtype, compute_dtype)
    out = fwd_launch(_library().ss_fwd, "ss_fwd", params, proj_w, proj_b, h0, c0, y0, teacher_tm, coins,
                     context, residual_dtype, compute_dtype, step_ctx=False)
    count_launch(ss_fwd, compute_dtype)
    return out


def fwd_launch(fn, name, params, proj_w, proj_b, h0, c0, y0, teacher_tm, coins, context,
               residual_dtype, compute_dtype, *, step_ctx):
    """Launch a forward recurrence kernel (``fn``: ``ss_fwd`` here, or with
    ``step_ctx`` ``ops.lstm_align``'s per-step-context instance, which takes
    the same arguments) on checked CUDA tensors → (ys, residuals): the block
    from ``lstm_train.fwd_block``, W packed once a call
    (``lstm_train.fwd_weights``)."""
    ctx_dim = 0 if context is None else context.shape[-1]
    _ctx_ok(ctx_dim)
    t_len, batch, d = teacher_tm.shape
    hidden, layers = proj_w.shape[0], len(params)
    geo = fwd_block(hidden, layers, d, batch, compute_dtype, ctx_dim=ctx_dim, mode="step" if step_ctx else "static")
    dev = y0.device

    def empty(width):
        return [torch.empty((batch, t_len, width), device=dev, dtype=residual_dtype) for _ in params]

    res = Residuals(empty(hidden), empty(hidden), empty(4 * hidden))
    ys = torch.empty((batch, t_len, d), device=dev)
    w = fwd_weights(params, d, ctx_dim, compute_dtype)
    bs = [p.b for p in params]
    (proj_wt,) = in_compute([proj_w.t()], compute_dtype)  # (D, H), as the projection reads it
    c_glob = c_buffer(geo, batch, layers, hidden, dev)
    extra = ([] if context is None else [context]) + ([] if c_glob is None else [c_glob])
    _check_card([w, proj_wt, proj_b, h0, c0, y0, teacher_tm, coins, *bs, *res.hs, *res.cs, *res.gs, ys, *extra])
    with torch.cuda.device(dev):
        err = fn(
            w.data_ptr(), _ptrs(bs), _ptrs(res.hs), _ptrs(res.cs), _ptrs(res.gs), h0.data_ptr(), c0.data_ptr(),
            y0.data_ptr(), teacher_tm.data_ptr(), coins.data_ptr(), None if context is None else context.data_ptr(),
            proj_wt.data_ptr(), proj_b.data_ptr(), ys.data_ptr(), None if c_glob is None else c_glob.data_ptr(),
            batch, t_len, d, ctx_dim, hidden, layers, geo.rp, geo.warps,
            int(residual_dtype == torch.bfloat16), int(compute_dtype == torch.bfloat16), _stream(),
        )
    _raise_on(err, name)
    return ys, res


ss_fwd.launches = ss_fwd.launches_bf16 = 0


class SsBwdGeom(NamedTuple):
    """A block of the backward recurrence on the tensor cores
    (``csrc/lstm_common.cuh`` ss_bwd_kernel): ``rows`` batch rows (one or
    two m16 tiles) in ``warps`` warps (one or two unit blocks of 8 each),
    each warp's ring of W's pieces ``stages`` k-pairs deep (W read ``stages -
    1`` k-pairs ahead of the mma), and the block's dynamic shared memory in
    bytes; the kernel's template parameters, which its launcher picks as
    this does (``ssb_block``)."""
    rows: int
    warps: int
    stages: int
    smem: int


_BWD_MAX_D = 8  # SSB_MAX_D: coordinates a token
_BWD_MAX_HIDDEN = 256  # two unit blocks a warp, 16 warps


# the W ring's depths in the order preferred (ssb_block): 4 k-pairs hide W's
# L2 latency; 2 only where a deeper stack's carries leave no room, and in the
# 16-row blocks
_BWD_STAGES = (4, 2)


def _bwd_smem(hidden: int, layers: int, ctx_dim: int, step_ctx: bool, stages: int, f32: bool, rows: int = 32,
              unit_blocks: int = 1) -> int:
    """``ssb_smem_bytes``: the A buffer of ``rows`` rows x (4H + a 16-byte
    pad) of dgates in the tier's type, the carried dh and dc of every layer
    (f32), the static context's dctx sums, dy_t of the rows, the warps'
    partials of dx and each warp's ring of ``stages`` k-pairs of two
    n-tiles (1 KB a k-pair); hidden / (8 · ``unit_blocks``) warps."""
    e, warps = (4 if f32 else 2), hidden // (8 * unit_blocks)
    return (e * rows * (4 * hidden + 16 // e) + 8 * layers * rows * hidden
            + (0 if step_ctx else 4 * rows * ctx_dim) + 4 * rows * _BWD_MAX_D * (1 + warps)
            + 1024 * stages * warps)


def bwd_block(hidden: int, layers: int, d: int, ctx_dim: int, compute_dtype=torch.float32,
              step_ctx: bool = False) -> SsBwdGeom:
    """The block of the backward recurrence: up to hidden 128, 32 rows in
    hidden / 8 warps (a unit block of 8 each) with the deepest W ring of
    ``_BWD_STAGES`` that fits beside every layer's carries; where none does,
    and above hidden 128 (two unit blocks a warp, hidden / 16 warps), 16 rows
    with a ring of 2. Raises for shapes the kernel does not take: hidden not
    a multiple of 32 up to 256, more than 8 layers, d outside 1..8, a context
    not of whole n8 tiles up to hidden (one dctx n-tile a unit block), or a
    block of 16 rows past shared memory."""
    if hidden % 32 or not 32 <= hidden <= _BWD_MAX_HIDDEN:
        raise ValueError(f"the backward recurrence takes hidden a multiple of 32 up to {_BWD_MAX_HIDDEN} (a warp "
                         f"one or two unit blocks of 8, at most 16 warps), got hidden={hidden}")
    if not 1 <= layers <= 8:
        raise ValueError(f"the backward recurrence takes 1..8 layers, got {layers}")
    if not 1 <= d <= _BWD_MAX_D:
        raise ValueError(f"the backward recurrence takes 1 <= d <= {_BWD_MAX_D} coordinates a token, got d={d}")
    if ctx_dim % 8 or not 0 <= ctx_dim <= hidden:
        raise ValueError(f"the backward recurrence takes ctx_dim a multiple of 8 up to hidden (one dctx n-tile a "
                         f"unit block), got ctx_dim={ctx_dim}, hidden={hidden}")
    f32 = compute_dtype != torch.bfloat16
    ub = 2 if hidden > 128 else 1
    if ub == 1:
        for stages in _BWD_STAGES:
            smem = _bwd_smem(hidden, layers, ctx_dim, step_ctx, stages, f32)
            if smem <= _SMEM_LIMIT:
                return SsBwdGeom(32, hidden // 8, stages, smem)
    smem = _bwd_smem(hidden, layers, ctx_dim, step_ctx, 2, f32, rows=16, unit_blocks=ub)
    if smem <= _SMEM_LIMIT:
        return SsBwdGeom(16, hidden // (8 * ub), 2, smem)
    raise ValueError(
        f"layers={layers}, hidden={hidden}, ctx_dim={ctx_dim}: the backward recurrence's block of 16 rows keeps every "
        f"layer's carried dh and dc ({8 * layers * 16 * hidden} bytes) beside an A buffer of dgates in "
        f"{'f32' if f32 else 'bf16'} and rings of W, {smem} bytes of shared memory, more than {_SMEM_LIMIT}"
    )


@functools.cache
def _bwd_pack_index(n_rows: int, hidden: int, f32: bool, device: torch.device) -> torch.Tensor:
    """Where each element of one layer's packed Wᵀ comes from: flat indices
    into its n-ordered rows Wn (n_rows x 4H; B[k][n] = Wn[n][k], k the gate
    column), in the order ``csrc/lstm_common.cuh`` ss_bwd_kernel reads it:
    n-tile after n-tile, per pair of k-steps and lane (g, t) = (lane // 4,
    lane % 4) 16 bytes, the B fragments {b0, b1} of both k-steps at column
    n = 8·tile + g. f32 (mma m16n8k8, TF32): b0 = B[t], b1 = B[t + 4] of the
    k8 step. bf16 (m16n8k16): b0 = B[2t, 2t + 1], b1 = B[2t + 8, 2t + 9]
    of the k16 step."""
    ks, ev = (8, 4) if f32 else (16, 8)
    kp = torch.arange(4 * hidden // (2 * ks)).view(1, -1, 1, 1)
    tile = torch.arange(n_rows // 8).view(-1, 1, 1, 1)
    lane = torch.arange(32).view(1, 1, -1, 1)
    e = torch.arange(ev).view(1, 1, 1, -1)
    if f32:
        k = 8 * (2 * kp + (e >> 1)) + lane % 4 + 4 * (e & 1)
    else:
        k = 16 * (2 * kp + (e >> 2)) + 2 * (lane % 4) + (e & 1) + 8 * ((e >> 1) & 1)
    n = 8 * tile + lane // 4
    return (n * 4 * hidden + k).reshape(-1).to(device)


def pack_bwd_weights(params: Sequence[LSTMParams], d: int, ctx_dim: int,
                     compute_dtype=torch.float32) -> List[torch.Tensor]:
    """Every layer's Wᵀ for the backward's ``dgates · Wᵀ``, packed once a
    call in mma's B fragment order (:func:`_bwd_pack_index`) in the tier's
    type (f32, or bf16 rounded to nearest even) → one flat tensor a layer.
    The rows of W go in the order of the product's columns (its n): layer 0
    [W[D+C:] (dh) | W[D:D+C] (dctx)] (dx, from W[:D], runs apart), layer
    l > 0 [W[H:] (dh) | W[:H] (the layer below's h)]."""
    hidden = params[0].w.shape[1] // 4
    f32 = compute_dtype != torch.bfloat16
    out = []
    for l, p in enumerate(params):
        w = torch.cat([p.w[d + ctx_dim:], p.w[d:d + ctx_dim]] if l == 0 else [p.w[hidden:], p.w[:hidden]])
        w = w.float() if f32 else w.to(torch.bfloat16)
        out.append(w.reshape(-1)[_bwd_pack_index(w.shape[0], hidden, f32, w.device)])
    return out


def ss_bwd(
    params: Sequence[LSTMParams], proj_w, c0, coins, res: Residuals, dys, ctx_dim: int,
    compute_dtype: torch.dtype = torch.float32,
):
    """Backward recurrence → (dgates per layer (B, T, 4H), dy (B, T, D),
    dteacher (T, B, D), dy0 (B, D), dh0, dc0 (L, B, H), dctx (B, C) or
    None), all f32."""
    check_bwd(params, proj_w, c0, coins, res, dys, ctx_dim)
    check_compute(compute_dtype)
    if dys.device.type == "cpu":
        return _bwd_recurrence_reference(params, proj_w, c0, coins, res, dys, ctx_dim,
                                         compute_dtype=compute_dtype)
    out = bwd_launch(_library().ss_bwd, "ss_bwd", params, proj_w, c0, coins, res, dys, ctx_dim,
                     step_ctx=False, compute_dtype=compute_dtype)
    count_launch(ss_bwd, compute_dtype)
    return out


def check_bwd(params, proj_w, c0, coins, res: Residuals, dys, ctx_dim: int):
    """Shapes, types and devices of a backward recurrence's inputs."""
    batch, t_len, d = dys.shape
    hidden, layers = proj_w.shape[0], len(params)
    dev = dys.device
    expect = [(proj_w, (hidden, d)), (c0, (layers, batch, hidden)), (coins, (t_len, batch, 1)),
              (dys, (batch, t_len, d))]
    _expect_f32(expect, params, d + ctx_dim, hidden, dev)
    _check_res(res, layers, batch, t_len, hidden, dev)


def bwd_launch(fn, name, params, proj_w, c0, coins, res: Residuals, dys, ctx_dim, *, step_ctx,
               compute_dtype):
    """Launch a backward recurrence kernel (``fn``: ``ss_bwd``, or with
    ``step_ctx`` ``ops.lstm_align``'s per-step-context instance, which
    writes dctx (B, T, C)) on checked CUDA tensors: the block from
    :func:`bwd_block`, W packed by :func:`pack_bwd_weights` once a call."""
    batch, t_len, d = dys.shape
    hidden, layers = proj_w.shape[0], len(params)
    dev = dys.device
    rdt = res.hs[0].dtype
    bwd_block(hidden, layers, d, ctx_dim, compute_dtype, step_ctx)  # raises for a shape the kernel does not take
    wt = pack_bwd_weights(params, d, ctx_dim, compute_dtype)
    w0x, proj_w = in_compute([params[0].w[:d].contiguous(), proj_w], compute_dtype)
    dgates = [torch.empty((batch, t_len, 4 * hidden), device=dev) for _ in params]
    dy = torch.empty((batch, t_len, d), device=dev)
    dteacher = torch.empty((t_len, batch, d), device=dev)
    dy0 = torch.empty((batch, d), device=dev)
    dh0 = torch.empty((layers, batch, hidden), device=dev)
    dc0 = torch.empty((layers, batch, hidden), device=dev)
    dctx = None
    if ctx_dim:
        dctx = torch.empty((batch, t_len, ctx_dim) if step_ctx else (batch, ctx_dim), device=dev)
    _check_card([proj_w, c0, coins, dys, *wt, w0x, *res.cs, *res.gs, *dgates, dy, dteacher, dy0, dh0, dc0,
                 *([] if dctx is None else [dctx])])
    with torch.cuda.device(dev):
        err = fn(
            dys.data_ptr(), c0.data_ptr(), coins.data_ptr(), _ptrs(wt), w0x.data_ptr(), proj_w.data_ptr(),
            _ptrs(res.cs), _ptrs(res.gs), _ptrs(dgates), dy.data_ptr(), dteacher.data_ptr(),
            dy0.data_ptr(), dh0.data_ptr(), dc0.data_ptr(), None if dctx is None else dctx.data_ptr(),
            batch, t_len, d, ctx_dim, hidden, layers, int(rdt == torch.bfloat16),
            int(compute_dtype == torch.bfloat16), _stream(),
        )
    _raise_on(err, name)
    return dgates, dy, dteacher, dy0, dh0, dc0, dctx


ss_bwd.launches = ss_bwd.launches_bf16 = 0


def ss_dw(
    params: Sequence[LSTMParams], h0, y0, teacher_tm, coins, context, ys,
    res: Residuals, dgates: Sequence[torch.Tensor], compute_dtype: torch.dtype = torch.float32,
    pack_layer: Optional[int] = None,
) -> List[LSTMParams]:
    """dW/db reduction → per layer ``LSTMParams(dW, db)``, f32; with
    ``pack_layer``, only that layer's pack pass (``lstm_train.dw_pack``)."""
    t_len, batch, d = teacher_tm.shape
    hidden, layers = h0.shape[-1], len(params)
    ctx_dim = 0 if context is None else context.shape[-1]
    dev = y0.device
    expect = [(h0, (layers, batch, hidden)), (y0, (batch, d)), (teacher_tm, (t_len, batch, d)),
              (coins, (t_len, batch, 1)), (ys, (batch, t_len, d))]
    expect += [(g, (batch, t_len, 4 * hidden)) for g in dgates]
    if context is not None:
        expect.append((context, (batch, ctx_dim)))
    _expect_f32(expect, params, d + ctx_dim, hidden, dev)
    if len(dgates) != layers:
        raise ValueError(f"{len(dgates)} dgates for {layers} layers")
    rdt = _check_res(res, layers, batch, t_len, hidden, dev)
    check_compute(compute_dtype)
    _check_pack_layer(pack_layer, layers)
    if dev.type == "cpu":
        if pack_layer is not None:
            return _pack_reference(_layer0_input(y0, teacher_tm, coins, context, ys), h0, res, pack_layer,
                                   d if pack_layer == 0 else 0, compute_dtype)
        return _dw_reference(params, h0, y0, teacher_tm, coins, context, ys, res, dgates,
                             compute_dtype)
    if batch * t_len >= 2**31:
        raise ValueError(f"B·T = {batch * t_len} rows do not fit the kernel's 32-bit row index")
    splits = dw_splits(batch, t_len, hidden, d + ctx_dim, _build.sm_count(dev))
    ins = [d + ctx_dim] + [hidden] * (layers - 1)
    ins = ins if pack_layer is None else [ins[pack_layer]]
    zpack = torch.empty((batch * t_len, max(dw_zld(i, hidden) for i in ins)), dtype=compute_dtype, device=dev)
    rows_max = max(d + ctx_dim + hidden, 2 * hidden if layers > 1 else 0)  # in_l + H
    partial = torch.empty((splits, rows_max + 1, 4 * hidden), device=dev)
    dws = [torch.empty_like(p.w) for p in params]
    dbs = [torch.empty_like(p.b) for p in params]
    ctx_t = [] if context is None else [context]
    _check_card([h0, y0, teacher_tm, coins, ys, *ctx_t, *res.hs, *res.cs, *res.gs, *dgates,
                 zpack, partial, *dws, *dbs])
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.ss_dw(
            h0.data_ptr(), y0.data_ptr(), teacher_tm.data_ptr(), coins.data_ptr(),
            None if context is None else context.data_ptr(), ys.data_ptr(),
            _ptrs(res.hs), _ptrs(res.cs), _ptrs(res.gs), _ptrs(dgates), zpack.data_ptr(),
            partial.data_ptr(), _ptrs(dws), _ptrs(dbs), batch, t_len, d, ctx_dim, hidden, layers,
            splits, int(rdt == torch.bfloat16), int(compute_dtype == torch.bfloat16),
            -1 if pack_layer is None else pack_layer, _stream(),
        )
    _raise_on(err, "ss_dw")
    count_launch(dw_pack, compute_dtype)
    if pack_layer is not None:
        return zpack
    count_launch(ss_dw, compute_dtype)
    return [LSTMParams(w=w, b=b) for w, b in zip(dws, dbs)]


ss_dw.launches = ss_dw.launches_bf16 = 0


def ss_dproj(hs_top: torch.Tensor, dy: torch.Tensor,
             compute_dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """dproj reduction → (dproj_w (H, D), dproj_b (D,)), f32."""
    batch, t_len, d = dy.shape
    hidden = hs_top.shape[-1]
    if dy.dtype != torch.float32 or hs_top.dtype not in RESIDUAL_DTYPES:
        raise TypeError(f"dy must be f32 and hs_top f32 or bf16, got {dy.dtype}, {hs_top.dtype}")
    if tuple(hs_top.shape) != (batch, t_len, hidden) or hs_top.device != dy.device:
        raise ValueError(f"hs_top {tuple(hs_top.shape)} on {hs_top.device} does not match dy "
                         f"{tuple(dy.shape)} on {dy.device}")
    check_compute(compute_dtype)
    if dy.device.type == "cpu":
        return _dproj_reference(hs_top, dy, compute_dtype)
    dev = dy.device
    splits = dproj_splits(batch * t_len, d, hidden, hs_top.dtype, _build.sm_count(dev))
    out = (hidden + 1) * d
    buf = torch.empty(((splits + 1) * out,), device=dev)  # dproj_w, dproj_b, then the slices' sums
    dpw, dpb = buf[: hidden * d].view(hidden, d), buf[hidden * d: out]
    _check_card([hs_top, dy])
    # the device's context only when it is not current: the call's host work
    # is most of its time at the training shapes
    with contextlib.nullcontext() if dev.index in (None, torch.cuda.current_device()) else torch.cuda.device(dev):
        err = _library().ss_dproj(
            hs_top.data_ptr(), dy.data_ptr(), buf.data_ptr() + 4 * out, dpw.data_ptr(), dpb.data_ptr(),
            batch, t_len, d, hidden, splits, int(hs_top.dtype == torch.bfloat16),
            int(compute_dtype == torch.bfloat16), _stream(),
        )
    _raise_on(err, "ss_dproj")
    count_launch(ss_dproj, compute_dtype)
    return dpw, dpb


def dproj_splits(rows: int, d: int, hidden: int, residual_dtype: torch.dtype, n_sm: int) -> int:
    """Slices of the dproj reduction's rows, a block each: four blocks an SM,
    each slice at least 64 rows. Raises for shapes the kernel does not take
    (1 <= d <= 4; a row of h_top is 16-byte pieces, a thread each, at most
    the block's 256; B·T < 2^31)."""
    per = 16 // (2 if residual_dtype == torch.bfloat16 else 4)  # units a 16-byte piece
    if not 1 <= d <= 4 or hidden % per or not per <= hidden <= 256 * per or rows >= 2**31:
        raise ValueError(f"the dproj kernel takes 1 <= D <= 4, H a multiple of {per} up to {256 * per} "
                         f"and B·T < 2^31, got D={d}, H={hidden}, B·T={rows}")
    return max(1, min(4 * n_sm, rows // 64))


ss_dproj.launches = ss_dproj.launches_bf16 = 0


# the decoder forwards' C signature (lstm_ss.cu ss_fwd, lstm_align.cu align_dec_fwd)
FWD_ARGTYPES = ([ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_void_p)] * 4 + [ctypes.c_void_p] * 10
                + [ctypes.c_int] * 10 + [ctypes.c_void_p])


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernels' library, built at first use and loaded once."""
    lib = _build.load("lstm_ss")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    arr = ctypes.POINTER(ctypes.c_void_p)
    lib.ss_fwd.argtypes = FWD_ARGTYPES
    lib.ss_fwd_smem.argtypes = [i32] * 8
    lib.ss_fwd_smem.restype = ctypes.c_longlong
    lib.train_fwd_probe_read.argtypes = [vp]
    lib.train_fwd_probe_read.restype = i32
    lib.ss_bwd.argtypes = [vp, vp, vp, arr, vp, vp, arr, arr, arr] + [vp] * 6 + [i32] * 8 + [vp]
    lib.ss_bwd_smem.argtypes = [i32] * 6 + [vp]
    lib.ss_bwd_smem.restype = ctypes.c_longlong
    lib.ss_dw.argtypes = [vp] * 6 + [arr] * 4 + [vp, vp, arr, arr] + [i32] * 10 + [vp]
    lib.ss_dproj.argtypes = [vp] * 5 + [i32] * 7 + [vp]
    for f in (lib.ss_fwd, lib.ss_bwd, lib.ss_dw, lib.ss_dproj):
        f.restype = i32
    lib.lstm_ss_error_string.argtypes = [i32]
    lib.lstm_ss_error_string.restype = ctypes.c_char_p
    return lib


# ---------------------------------------------------------------------------
# the differentiable function
# ---------------------------------------------------------------------------


class _SSDecode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, residual_dtype, compute_dtype, has_ctx, proj_w, proj_b, h0, c0, y0,
                teacher_tm, coins, context, *flat):
        params = [LSTMParams(flat[i], flat[i + 1]) for i in range(0, len(flat), 2)]
        context = context if has_ctx else None
        ys, res = ss_fwd(params, proj_w, proj_b, h0, c0, y0, teacher_tm, coins, context,
                         residual_dtype, compute_dtype)
        ctx.layers, ctx.has_ctx, ctx.compute_dtype = len(params), has_ctx, compute_dtype
        saved_ctx = [context] if has_ctx else []
        ctx.save_for_backward(proj_w, h0, c0, y0, teacher_tm, coins, ys, *saved_ctx, *flat,
                              *res.hs, *res.cs, *res.gs)
        return ys

    @staticmethod
    def backward(ctx, dys):
        n = ctx.layers
        proj_w, h0, c0, y0, teacher_tm, coins, ys, *rest = ctx.saved_tensors
        context = rest.pop(0) if ctx.has_ctx else None
        flat, rest = rest[: 2 * n], rest[2 * n:]
        params = [LSTMParams(flat[i], flat[i + 1]) for i in range(0, 2 * n, 2)]
        res = Residuals(list(rest[:n]), list(rest[n: 2 * n]), list(rest[2 * n:]))
        ctx_dim = 0 if context is None else context.shape[-1]
        cd = ctx.compute_dtype
        dgates, dy, dteacher, dy0, dh0, dc0, dctx = ss_bwd(
            params, proj_w, c0, coins, res, dys.float().contiguous(), ctx_dim, cd
        )
        dparams = ss_dw(params, h0, y0, teacher_tm, coins, context, ys, res, dgates, cd)
        dpw, dpb = ss_dproj(res.hs[-1], dy, cd)
        flat_grads = [g for p in dparams for g in (p.w, p.b)]
        # coins get no gradient; a context that is absent none either
        return (None, None, None, dpw, dpb, dh0, dc0, dy0, dteacher, None, dctx, *flat_grads)


def ss_decode(
    dec_params: Sequence[LSTMParams],
    proj_w: torch.Tensor,
    proj_b: torch.Tensor,
    h0: torch.Tensor,
    c0: torch.Tensor,
    y0: torch.Tensor,  # (B, D)
    teacher_tm: torch.Tensor,  # (T, B, D) time-major teacher inputs
    coins_ctx: tuple,  # (coins (T, B, 1), context (B, C) or None)
    residual_dtype: torch.dtype = torch.float32,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Scheduled-sampling decoder → (B, T, D) f32 predictions;
    differentiable in the params, ``proj_w``, ``proj_b``, ``h0``, ``c0``,
    ``y0``, ``teacher_tm`` and the context through the kernels' backward
    (coins get no gradient), which runs in the forward's ``compute_dtype``.
    bf16 weights are widened (``lstm_train.widen``)."""
    coins, context = coins_ctx
    dec_params = widen(dec_params)
    _check(dec_params, proj_w, proj_b, h0, c0, y0, teacher_tm, coins, context, residual_dtype)
    check_compute(compute_dtype)
    flat = [t for p in dec_params for t in (p.w, p.b)]
    has_ctx = context is not None
    # autograd needs a tensor in every slot; an absent context rides as an
    # empty tensor and gets no gradient
    ctx_arg = context if has_ctx else y0.new_empty((0,))
    return _SSDecode.apply(residual_dtype, compute_dtype, has_ctx, proj_w, proj_b, h0, c0, y0,
                           teacher_tm.contiguous(), coins.contiguous(), ctx_arg, *flat)
