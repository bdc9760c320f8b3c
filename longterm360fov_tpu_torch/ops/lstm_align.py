"""Lockstep-peer scheduled-sampling decoder for training: hand-written CUDA
forward and backward kernels, their plain PyTorch versions, and the autograd
function that joins them.

Twin of ``longterm360fov_tpu.ops.lstm_align``: :func:`aligned_ss_decode` is
``ops.lstm_ss.ss_decode`` with a per-step context. At decoder step t the K
peer encoders (one LSTM cell of hidden C, ``peer_params``, from zero state)
advance one step on their known windows ``pxs_tm[t]`` (B, K·D), and
``ctx_t = Σ_k pwt[:, k] · h_k,t`` (k = 0 .. K - 1 in order) joins layer 0's
input ``[x_t, ctx_t]``. The signature is the JAX one; coins get no gradient,
every other input does, the peer windows (dpxs) and the mask weights (dpwt)
included. ``compute_dtype`` bf16 is the JAX ``compute_dtype=bfloat16`` tier
(``ops.lstm_train``): the operands of every product rounded to bf16, the
peer gates ``[pxs_t, h_{t-1}]·Wp`` alike in the forward and in the
backward's recomputation; ``ctx_t`` is formed from the unrounded peer h and
rounded only where it enters the decoder's layer-0 product.

Inside, the peer rows are laid out (B·K, T, ·), peer row p = b·K + k. The
kernels of ``csrc/lstm_align.cu`` (whose header says what bounds them and
what their design does about it):

* :func:`peer_fwd`: the peer recurrence → the peer h and c (B·K, T, C) in
  ``residual_dtype`` and ctx (B, T, C) f32, from the f32 h; the serve
  tier's peer context body on the tensor cores (``ops.fused_lstm``'s packs
  and blocks, :func:`peer_fwd_block`) with the residual stores;
* :func:`dec_fwd`, :func:`dec_bwd`: ``ops.lstm_ss``'s recurrences with the
  per-step context; the backward writes dctx (B, T, C) per step;
* :func:`peer_bwd`: the peer backward in reverse time, with the gates
  recomputed from ``[pxs_t, h_{t-1}]`` (the residual h) → the peer dgates,
  dpxs and dpwt;
* :func:`dec_dw`: the decoder's dW/db, layer 0's context rebuilt from the
  residual peer h and pwt, as the TPU backward rebuilds it;
* :func:`peer_dw`: the peer encoder's dW/db over the B·K·T rows;
* dproj: ``ops.lstm_ss.ss_dproj``.

Each wrapper runs its plain version (``_peer_fwd_reference``,
``lstm_ss._forward_reference`` and ``lstm_ss._bwd_recurrence_reference``
with a per-step context, ``_peer_bwd_reference``, ``_dw_reference``,
``_peer_dw_reference``) on CPU tensors, and launches its kernel on CUDA
tensors or raises; it never falls back. Each counts its kernel launches in
``.launches`` (f32 compute) and ``.launches_bf16`` (bf16 compute).
:func:`aligned_ss_decode_reference` is the whole decoder as a step loop of
``cell.lstm_cell``, whose gradient torch autograd gives.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import torch

from ..models.cell import LSTMParams, lstm_cell, mm
from . import _build, lstm_ss
from .fused_lstm import TcGeom, pack_weights, pack_weights_tf32, peer_scratch, peer_tc_rows, peer_tf32_rows
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
    widen,
)

__all__ = [
    "aligned_ss_decode",
    "aligned_ss_decode_reference",
    "peer_fwd",
    "peer_fwd_block",
    "dec_fwd",
    "dec_bwd",
    "peer_bwd",
    "dec_dw",
    "peer_dw",
]

_SMEM_LIMIT = 232448  # dynamic shared memory a Hopper block may use (227 KB)


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------


def peer_rows_of(pxs_tm: torch.Tensor, n_peers: int) -> torch.Tensor:
    """(T, B, K·D) time-major peer windows → (B·K, T, D), peer row b·K + k."""
    t_len, batch, kd = pxs_tm.shape
    return pxs_tm.reshape(t_len, batch * n_peers, kd // n_peers).transpose(0, 1).contiguous()


def _time_major(dpxs: torch.Tensor, batch: int) -> torch.Tensor:
    """(B·K, T, D) → (T, B, K·D), the inverse of :func:`peer_rows_of`."""
    return dpxs.transpose(0, 1).reshape(dpxs.shape[1], batch, -1)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def aligned_ss_decode_reference(
    dec_params: Sequence[LSTMParams], proj_w, proj_b, peer_params: LSTMParams, h0, c0, y0,
    teacher_tm, pxs_tm, coins_pwt: tuple,
) -> torch.Tensor:
    """The lockstep decoder as a step loop of ``cell.lstm_cell`` in f32, with
    no residual rounding → (B, T, D); torch autograd gives its gradient."""
    coins, pwt = coins_pwt
    _no_tf32(y0, "aligned_ss_decode_reference")
    batch, k = pwt.shape
    pxs = pxs_tm.reshape(pxs_tm.shape[0], batch * k, -1)
    zero = y0.new_zeros((batch * k, peer_params.w.shape[1] // 4))
    peer = (zero, zero)
    states = [(h0[l], c0[l]) for l in range(len(dec_params))]
    y, ys = y0, []
    for t in range(teacher_tm.shape[0]):
        peer = lstm_cell(peer_params, pxs[t], peer)
        h = peer[0].reshape(batch, k, -1)
        ctx = torch.zeros_like(h[:, 0])
        for j in range(k):
            ctx = ctx + h[:, j] * pwt[:, j:j + 1]
        inp = torch.cat([torch.where(coins[t] > 0, teacher_tm[t], y), ctx], dim=-1)
        for l, p in enumerate(dec_params):
            states[l] = lstm_cell(p, inp, states[l])
            inp = states[l][0]
        y = inp @ proj_w + proj_b
        ys.append(y)
    return torch.stack(ys, dim=1)


def _gates(p: LSTMParams, x, h, compute_dtype=torch.float32):
    i, f, g, o = (mm(torch.cat([x, h], dim=-1), p.w, compute_dtype) + p.b).chunk(4, dim=-1)
    return i.sigmoid(), f.sigmoid(), g.tanh(), o.sigmoid()


def _peer_fwd_reference(peer_params: LSTMParams, pxs, pwt, residual_dtype,
                        compute_dtype=torch.float32):
    """Plain version of the peer forward kernel: (B·K, T, D) windows →
    (php, pcp (B·K, T, C) in ``residual_dtype``, ctx (B, T, C) f32 from the
    f32 h); the gate products in ``compute_dtype``."""
    _no_tf32(pxs, "peer_fwd plain version")
    rows, t_len, _ = pxs.shape
    batch, k = pwt.shape
    c_dim = peer_params.w.shape[1] // 4
    php = pxs.new_empty((rows, t_len, c_dim), dtype=residual_dtype)
    pcp = torch.empty_like(php)
    ctx = pxs.new_empty((batch, t_len, c_dim))
    h = c = pxs.new_zeros((rows, c_dim))
    for t in range(t_len):
        i, f, g, o = _gates(peer_params, pxs[:, t], h, compute_dtype)
        c = f * c + i * g
        h = o * torch.tanh(c)
        php[:, t], pcp[:, t] = h, c
        hb = h.reshape(batch, k, c_dim)
        s = torch.zeros_like(hb[:, 0])
        for j in range(k):
            s = s + hb[:, j] * pwt[:, j:j + 1]
        ctx[:, t] = s
    return php, pcp, ctx


def _rebuilt_ctx(php: torch.Tensor, pwt: torch.Tensor) -> torch.Tensor:
    """ctx_t = Σ_k pwt[:, k] · php[b·K + k, t], k in order, from the residual
    peer h, as the backward rebuilds it → (B, T, C) f32."""
    batch, k = pwt.shape
    h = php.float().reshape(batch, k, php.shape[1], php.shape[2])
    ctx = torch.zeros_like(h[:, 0])
    for j in range(k):
        ctx = ctx + h[:, j] * pwt[:, j, None, None]
    return ctx


def _dw_reference(params, h0, y0, teacher_tm, coins, pwt, php, ys, res, dgates,
                  compute_dtype=torch.float32) -> List[LSTMParams]:
    """Plain version of the decoder's dW/db reduction kernel."""
    return lstm_ss._dw_reference(params, h0, y0, teacher_tm, coins, _rebuilt_ctx(php, pwt), ys,
                                 res, dgates, compute_dtype)


def _peer_bwd_reference(peer_params: LSTMParams, pxs, pwt, php, pcp, dctx,
                        compute_dtype=torch.float32):
    """Plain version of the peer backward kernel → (dpgates (B·K, T, 4C),
    dpxs (B·K, T, D), dpwt (B, K)), all f32; the products in
    ``compute_dtype``."""
    _no_tf32(dctx, "peer_bwd plain version")
    rows, t_len, d = pxs.shape
    batch, k = pwt.shape
    c_dim = php.shape[-1]
    w = pwt.reshape(rows, 1)
    dpgates = pxs.new_empty((rows, t_len, 4 * c_dim))
    dpxs = torch.empty_like(pxs)
    dpwt = pxs.new_zeros((rows,))
    dh = dc = pxs.new_zeros((rows, c_dim))
    for t in reversed(range(t_len)):
        h_prev = php[:, t - 1].float() if t > 0 else torch.zeros_like(dh)
        c_prev = pcp[:, t - 1].float() if t > 0 else torch.zeros_like(dh)
        i, f, g, o = _gates(peer_params, pxs[:, t], h_prev, compute_dtype)
        dctx_rows = dctx[:, t].repeat_interleave(k, dim=0)
        dpwt += (dctx_rows * php[:, t].float()).sum(dim=-1)
        dh = w * dctx_rows + dh
        tanh_c = torch.tanh(pcp[:, t].float())
        dc_total = dh * o * (1.0 - tanh_c * tanh_c) + dc
        dg = torch.cat([dc_total * g * i * (1.0 - i), dc_total * c_prev * f * (1.0 - f),
                        dc_total * i * (1.0 - g * g), dh * tanh_c * o * (1.0 - o)], dim=-1)
        dpgates[:, t] = dg
        dz = mm(dg, peer_params.w.t(), compute_dtype)
        dpxs[:, t] = dz[:, :d]
        dh, dc = dz[:, d:], dc_total * f
    return dpgates, dpxs, dpwt.reshape(batch, k)


def _peer_dw_reference(peer_params: LSTMParams, pxs, php, dpgates,
                       compute_dtype=torch.float32) -> LSTMParams:
    """Plain version of the peer dW/db reduction: z = [pxs_t, h_{t-1}] (the
    residual h, zeros at t = 0)."""
    zero = pxs.new_zeros((1, pxs.shape[0], php.shape[-1]))
    return _lstm_dw_reference([peer_params], pxs, zero, Residuals([php], [], []), [dpgates],
                              compute_dtype)[0]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_peer(peer_params: LSTMParams, pxs, *tensors):
    """Shapes, types and devices of a peer kernel's inputs: f32 pxs (B·K, T,
    D), the peer cell, and ``tensors``: (tensor, shape, dtypes) → (B·K, T,
    D, C)."""
    rows, t_len, d = pxs.shape
    c_dim = peer_params.w.shape[1] // 4
    expect = [(pxs, (rows, t_len, d), (torch.float32,)),
              (peer_params.w, (d + c_dim, 4 * c_dim), (torch.float32,)),
              (peer_params.b, (4 * c_dim,), (torch.float32,))] + list(tensors)
    for t, shape, dtypes in expect:
        if tuple(t.shape) != shape or t.dtype not in dtypes or t.device != pxs.device:
            raise ValueError(f"expected {shape} in {dtypes} on {pxs.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if pxs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the kernels run on cpu or cuda, not {pxs.device}")
    if pxs.device.type == "cuda" and rows * t_len >= 2**31:
        raise ValueError(f"B·K·T = {rows * t_len} rows do not fit the kernels' 32-bit row index")
    return rows, t_len, d, c_dim


PEER_BWD_CTX = (32, 64, 96, 128)  # the peer backward's ctx_dim (an instance of its tiles for each)


def peer_bwd_warps(rows: int, c_dim: int, d: int, fits: Sequence[int], n_sm: int) -> int:
    """Warps a block of the peer backward (16 peer rows each; one block an
    SM, which its shared memory and registers fill), of ``fits``: the counts
    from 4 to 8 whose block fits shared memory (the library's
    ``peer_bwd_smem``). The fewest waves times warps, the card's time for
    the rows at one block an SM, and of those the most warps (the fewest
    passes over the weights): 28,672 rows on 132 SMs take 7 warps, 256
    blocks in two waves. Raises for shapes the kernel does not take."""
    if c_dim not in PEER_BWD_CTX:
        raise ValueError(f"the peer backward takes ctx_dim in {PEER_BWD_CTX}, got {c_dim}")
    if not 1 <= d <= 8:
        raise ValueError(f"the peer backward takes 1 <= d <= 8 window features, got {d}")
    if not fits:
        raise ValueError(f"no peer backward block of 4 to 8 warps fits shared memory at ctx_dim={c_dim}")

    def cost(w):
        blocks = -(-rows // (16 * w))
        return -(-blocks // n_sm) * w, -w

    return min(fits, key=cost)


def _pwt_spec(pwt, rows):
    """pwt's expected (B, K), from its own shape, when B·K is the peer rows."""
    batch, k = pwt.shape
    if batch * k != rows:
        raise ValueError(f"pwt {tuple(pwt.shape)} does not match {rows} peer rows")
    return (pwt, (batch, k), (torch.float32,))


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _raise_on(err: int, name: str):
    if err:
        raise RuntimeError(
            f"{name} kernel launch failed: "
            f"{_library().lstm_align_error_string(err).decode()} (cuda error {err})"
        )


def peer_fwd_block(c_dim: int, n_peers: int, d: int, compute_dtype=torch.float32) -> TcGeom:
    """The block of the peer forward: the serve tier's peer context block
    (``ops.fused_lstm``: :func:`peer_tf32_rows` in f32, 32 x 8 tiles of
    16 warps; :func:`peer_tc_rows` in bf16), all K peers of whole viewers.
    Raises for shapes it does not take, those the peer backward refuses
    too: ctx_dim outside 32, 64, 96, 128, d outside 1..8, and the
    choosers' own (K = 1..256)."""
    if c_dim not in PEER_BWD_CTX:
        raise ValueError(f"the peer forward takes ctx_dim in {PEER_BWD_CTX}, got {c_dim}")
    if not 1 <= d <= 8:
        raise ValueError(f"the peer forward takes 1 <= d <= 8 window features, got {d}")
    if compute_dtype == torch.bfloat16:
        return peer_tc_rows(c_dim, n_peers, d)
    return peer_tf32_rows(c_dim, n_peers, d)


def peer_fwd(peer_params: LSTMParams, pxs, pwt, residual_dtype=torch.float32,
             compute_dtype=torch.float32):
    """Peer forward → (php, pcp (B·K, T, C) in ``residual_dtype``, ctx
    (B, T, C) f32)."""
    if residual_dtype not in RESIDUAL_DTYPES:
        raise TypeError(f"residual_dtype must be one of {RESIDUAL_DTYPES}, got {residual_dtype}")
    check_compute(compute_dtype)
    rows, t_len, d, c_dim = _check_peer(peer_params, pxs, _pwt_spec(pwt, pxs.shape[0]))
    if pxs.device.type == "cpu":
        return _peer_fwd_reference(peer_params, pxs, pwt, residual_dtype, compute_dtype)
    # W packed once a call, the block from peer_fwd_block
    batch, k = pwt.shape
    bf16 = compute_dtype == torch.bfloat16
    geo = peer_fwd_block(c_dim, k, d, compute_dtype)
    w = pack_weights([peer_params], d) if bf16 else pack_weights_tf32([peer_params], d)
    dev = pxs.device
    php = torch.empty((rows, t_len, c_dim), device=dev, dtype=residual_dtype)
    pcp = torch.empty_like(php)
    ctx = torch.empty((batch, t_len, c_dim), device=dev)
    scratch = peer_scratch(geo, batch, k, c_dim, dev)
    _check_card([pxs, pwt, w, peer_params.b, php, pcp, ctx] + [t for t in scratch if t is not None])
    with torch.cuda.device(dev):
        err = _library().align_peer_fwd(
            pxs.data_ptr(), pwt.data_ptr(), w.data_ptr(), peer_params.b.data_ptr(), php.data_ptr(),
            pcp.data_ptr(), ctx.data_ptr(), *(None if t is None else t.data_ptr() for t in scratch), batch, k,
            t_len, d, c_dim, geo.rows_v, geo.rp, geo.mt, geo.warps, int(geo.w_res),
            int(residual_dtype == torch.bfloat16), int(bf16), _stream(),
        )
    _raise_on(err, "peer_fwd")
    count_launch(peer_fwd, compute_dtype)
    return php, pcp, ctx


peer_fwd.launches = peer_fwd.launches_bf16 = 0


def dec_fwd(params: Sequence[LSTMParams], proj_w, proj_b, h0, c0, y0, teacher_tm, coins, ctx,
            residual_dtype=torch.float32, compute_dtype=torch.float32
            ) -> Tuple[torch.Tensor, Residuals]:
    """Decoder forward with the per-step context ctx (B, T, C) → (ys
    (B, T, D) f32, the residuals)."""
    lstm_ss._check(params, proj_w, proj_b, h0, c0, y0, teacher_tm, coins, ctx, residual_dtype,
                   step_ctx=True)
    check_compute(compute_dtype)
    if y0.device.type == "cpu":
        return lstm_ss._forward_reference(params, proj_w, proj_b, h0, c0, y0, teacher_tm, coins,
                                          ctx, residual_dtype, compute_dtype)
    out = lstm_ss.fwd_launch(_library().align_dec_fwd, "dec_fwd", params, proj_w, proj_b, h0, c0,
                             y0, teacher_tm, coins, ctx, residual_dtype, compute_dtype, step_ctx=True)
    count_launch(dec_fwd, compute_dtype)
    return out


dec_fwd.launches = dec_fwd.launches_bf16 = 0


def dec_bwd(params: Sequence[LSTMParams], proj_w, c0, coins, res: Residuals, dys, ctx_dim: int,
            compute_dtype=torch.float32):
    """Decoder backward recurrence → (dgates per layer, dy, dteacher, dy0,
    dh0, dc0, dctx (B, T, C) per step), all f32."""
    lstm_ss.check_bwd(params, proj_w, c0, coins, res, dys, ctx_dim)
    check_compute(compute_dtype)
    if ctx_dim < 1:
        raise ValueError("the lockstep decoder takes a context: ctx_dim >= 1")
    if dys.device.type == "cpu":
        return lstm_ss._bwd_recurrence_reference(params, proj_w, c0, coins, res, dys, ctx_dim,
                                                 step_ctx=True, compute_dtype=compute_dtype)
    out = lstm_ss.bwd_launch(_library().align_dec_bwd, "dec_bwd", params, proj_w, c0, coins, res,
                             dys, ctx_dim, step_ctx=True, compute_dtype=compute_dtype)
    count_launch(dec_bwd, compute_dtype)
    return out


dec_bwd.launches = dec_bwd.launches_bf16 = 0


def peer_bwd(peer_params: LSTMParams, pxs, pwt, php, pcp, dctx, compute_dtype=torch.float32):
    """Peer backward recurrence → (dpgates (B·K, T, 4C), dpxs (B·K, T, D),
    dpwt (B, K)), all f32."""
    rows, t_len, _ = pxs.shape
    c_dim = peer_params.w.shape[1] // 4
    rdt = php.dtype
    _check_peer(peer_params, pxs, _pwt_spec(pwt, rows), (php, (rows, t_len, c_dim), RESIDUAL_DTYPES),
                (pcp, (rows, t_len, c_dim), (rdt,)), (dctx, (pwt.shape[0], t_len, c_dim), (torch.float32,)))
    check_compute(compute_dtype)
    if pxs.device.type == "cpu":
        return _peer_bwd_reference(peer_params, pxs, pwt, php, pcp, dctx, compute_dtype)
    out = launch_peer_bwd(_library(), peer_params, pxs, pwt, php, pcp, dctx, compute_dtype)
    count_launch(peer_bwd, compute_dtype)
    return out


def launch_peer_bwd(lib, peer_params: LSTMParams, pxs, pwt, php, pcp, dctx, compute_dtype):
    """:func:`peer_bwd`'s launch on CUDA tensors through ``lib`` (``bind``'s:
    the library, or a probe or one-pass build of it); checked inputs."""
    rows, t_len, d = pxs.shape
    c_dim = peer_params.w.shape[1] // 4
    batch, k = pwt.shape
    dev, wp = pxs.device, peer_params.w.contiguous()
    rbf, cbf = int(php.dtype == torch.bfloat16), int(compute_dtype == torch.bfloat16)
    fits = [w for w in range(4, 9) if 0 < lib.peer_bwd_smem(c_dim, w, rbf, cbf) <= _SMEM_LIMIT]
    warps = peer_bwd_warps(rows, c_dim, d, fits, _build.sm_count(dev))
    wstream = torch.empty(lib.peer_bwd_stream_bytes(c_dim, cbf), dtype=torch.uint8, device=dev)
    dpgates = torch.empty((rows, t_len, 4 * c_dim), device=dev)
    dpxs = torch.empty((rows, t_len, d), device=dev)
    dpwt = torch.empty((batch, k), device=dev)
    _check_card([pxs, pwt, wp, wstream, peer_params.b, php, pcp, dctx, dpgates, dpxs, dpwt])
    with torch.cuda.device(dev):
        err = lib.align_peer_bwd(
            pxs.data_ptr(), pwt.data_ptr(), wp.data_ptr(), wstream.data_ptr(),
            peer_params.b.data_ptr(), php.data_ptr(), pcp.data_ptr(), dctx.data_ptr(),
            dpgates.data_ptr(), dpxs.data_ptr(), dpwt.data_ptr(), batch, k, t_len, d, c_dim, warps,
            rbf, cbf, _stream(),
        )
    _raise_on(err, "peer_bwd")
    return dpgates, dpxs, dpwt


peer_bwd.launches = peer_bwd.launches_bf16 = 0


def dec_dw(params: Sequence[LSTMParams], h0, y0, teacher_tm, coins, pwt, php, ys,
           res: Residuals, dgates: Sequence[torch.Tensor],
           compute_dtype=torch.float32, pack_layer: Optional[int] = None) -> List[LSTMParams]:
    """The decoder's dW/db reduction, layer 0's context rebuilt from the
    residual peer h ``php`` (B·K, T, C) and ``pwt`` → per layer
    ``LSTMParams(dW, db)``, f32; with ``pack_layer``, only that layer's
    pack pass (``lstm_train.dw_pack``)."""
    t_len, batch, d = teacher_tm.shape
    hidden, layers = h0.shape[-1], len(params)
    k, c_dim = pwt.shape[-1], php.shape[-1]
    dev = y0.device
    expect = [(h0, (layers, batch, hidden)), (y0, (batch, d)), (teacher_tm, (t_len, batch, d)),
              (coins, (t_len, batch, 1)), (ys, (batch, t_len, d)), (pwt, (batch, k))]
    expect += [(g, (batch, t_len, 4 * hidden)) for g in dgates]
    lstm_ss._expect_f32(expect, params, d + c_dim, hidden, dev)
    if len(dgates) != layers:
        raise ValueError(f"{len(dgates)} dgates for {layers} layers")
    rdt = lstm_ss._check_res(res, layers, batch, t_len, hidden, dev)
    if tuple(php.shape) != (batch * k, t_len, c_dim) or php.dtype != rdt or php.device != dev:
        raise ValueError(f"php {php.dtype} {tuple(php.shape)} does not match the call")
    check_compute(compute_dtype)
    _check_pack_layer(pack_layer, layers)
    if dev.type == "cpu":
        if pack_layer is not None:
            x0 = lstm_ss._layer0_input(y0, teacher_tm, coins, _rebuilt_ctx(php, pwt), ys)
            return _pack_reference(x0, h0, res, pack_layer, d if pack_layer == 0 else 0, compute_dtype)
        return _dw_reference(params, h0, y0, teacher_tm, coins, pwt, php, ys, res, dgates,
                             compute_dtype)
    if batch * t_len >= 2**31:
        raise ValueError(f"B·T = {batch * t_len} rows do not fit the kernel's 32-bit row index")
    splits = dw_splits(batch, t_len, hidden, d + c_dim, _build.sm_count(dev))
    ins = [d + c_dim] + [hidden] * (layers - 1)
    ins = ins if pack_layer is None else [ins[pack_layer]]
    zpack = torch.empty((batch * t_len, max(dw_zld(i, hidden) for i in ins)), dtype=compute_dtype, device=dev)
    rows_max = max(d + c_dim + hidden, 2 * hidden if layers > 1 else 0)  # in_l + H
    partial = torch.empty((splits, rows_max + 1, 4 * hidden), device=dev)
    dws = [torch.empty_like(p.w) for p in params]
    dbs = [torch.empty_like(p.b) for p in params]
    _check_card([h0, y0, teacher_tm, coins, pwt, php, ys, *res.hs, *res.cs, *res.gs, *dgates,
                 zpack, partial, *dws, *dbs])
    with torch.cuda.device(dev):
        err = _library().align_dec_dw(
            h0.data_ptr(), y0.data_ptr(), teacher_tm.data_ptr(), coins.data_ptr(), php.data_ptr(),
            pwt.data_ptr(), ys.data_ptr(), _ptrs(res.hs), _ptrs(res.cs), _ptrs(res.gs),
            _ptrs(dgates), zpack.data_ptr(), partial.data_ptr(), _ptrs(dws), _ptrs(dbs), batch,
            t_len, d, c_dim, k, hidden, layers, splits, int(rdt == torch.bfloat16),
            int(compute_dtype == torch.bfloat16), -1 if pack_layer is None else pack_layer, _stream(),
        )
    _raise_on(err, "dec_dw")
    count_launch(dw_pack, compute_dtype)
    if pack_layer is not None:
        return zpack
    count_launch(dec_dw, compute_dtype)
    return [LSTMParams(w=w, b=b) for w, b in zip(dws, dbs)]


dec_dw.launches = dec_dw.launches_bf16 = 0


def peer_dw(peer_params: LSTMParams, pxs, php, dpgates, compute_dtype=torch.float32,
            pack_layer: Optional[int] = None) -> LSTMParams:
    """The peer encoder's dW/db reduction over the B·K·T rows, z =
    [pxs_t, h_{t-1}] → ``LSTMParams(dWp, dbp)``, f32; with ``pack_layer``
    (0: the peer cell is one layer), only the pack pass
    (``lstm_train.dw_pack``)."""
    rows, t_len, d = pxs.shape
    c_dim = peer_params.w.shape[1] // 4
    _check_peer(peer_params, pxs, (php, (rows, t_len, c_dim), RESIDUAL_DTYPES),
                (dpgates, (rows, t_len, 4 * c_dim), (torch.float32,)))
    check_compute(compute_dtype)
    _check_pack_layer(pack_layer, 1)
    if pxs.device.type == "cpu":
        if pack_layer is not None:
            zero = pxs.new_zeros((1, rows, c_dim))
            return _pack_reference(pxs, zero, Residuals([php], [], []), 0, d, compute_dtype)
        return _peer_dw_reference(peer_params, pxs, php, dpgates, compute_dtype)
    dev = pxs.device
    splits = dw_splits(rows, t_len, c_dim, d, _build.sm_count(dev))
    zero = torch.zeros((rows, c_dim), device=dev)
    zpack = torch.empty((rows * t_len, dw_zld(d, c_dim)), dtype=compute_dtype, device=dev)
    partial = torch.empty((splits, d + c_dim + 1, 4 * c_dim), device=dev)
    dw, db = torch.empty_like(peer_params.w), torch.empty_like(peer_params.b)
    _check_card([pxs, zero, php, dpgates, zpack, partial, dw, db])
    with torch.cuda.device(dev):
        err = _library().align_peer_dw(
            pxs.data_ptr(), zero.data_ptr(), php.data_ptr(), dpgates.data_ptr(), zpack.data_ptr(),
            partial.data_ptr(), dw.data_ptr(), db.data_ptr(), rows, t_len, d, c_dim, splits,
            int(php.dtype == torch.bfloat16), int(compute_dtype == torch.bfloat16),
            int(pack_layer is not None), _stream(),
        )
    _raise_on(err, "peer_dw")
    count_launch(dw_pack, compute_dtype)
    if pack_layer is not None:
        return zpack
    count_launch(peer_dw, compute_dtype)
    return LSTMParams(w=dw, b=db)


peer_dw.launches = peer_dw.launches_bf16 = 0


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernels' library, built at first use and loaded once."""
    return bind(_build.load("lstm_align"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``csrc/lstm_align.cu``: the library, or a probe
    or one-pass build of it) with its entry points typed."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    arr = ctypes.POINTER(ctypes.c_void_p)
    lib.align_peer_fwd.argtypes = [vp] * 9 + [i32] * 12 + [vp]
    lib.align_peer_fwd_smem.argtypes = [i32] * 11
    lib.align_peer_fwd_smem.restype = ctypes.c_longlong
    lib.align_dec_fwd.argtypes = lstm_ss.FWD_ARGTYPES
    lib.train_fwd_probe_read.argtypes = [vp]
    lib.train_fwd_probe_read.restype = i32
    lib.align_dec_bwd.argtypes = [vp, vp, vp, arr, vp, vp, arr, arr, arr] + [vp] * 6 + [i32] * 8 + [vp]
    lib.align_peer_bwd.argtypes = [vp] * 11 + [i32] * 8 + [vp]
    lib.peer_bwd_smem.argtypes = [i32] * 4
    lib.peer_bwd_stream_bytes.argtypes = [i32] * 2
    lib.align_dec_dw.argtypes = [vp] * 7 + [arr] * 4 + [vp, vp, arr, arr] + [i32] * 11 + [vp]
    lib.align_peer_dw.argtypes = [vp] * 8 + [i32] * 8 + [vp]
    for f in (lib.align_peer_fwd, lib.align_dec_fwd, lib.align_dec_bwd, lib.align_peer_bwd,
              lib.align_dec_dw, lib.align_peer_dw, lib.peer_bwd_smem, lib.peer_bwd_stream_bytes):
        f.restype = i32
    for f in (lib.lstm_align_probe_read, lib.ss_bwd_probe_read):
        f.argtypes = [vp]
        f.restype = i32
    lib.lstm_align_error_string.argtypes = [i32]
    lib.lstm_align_error_string.restype = ctypes.c_char_p
    return lib


# ---------------------------------------------------------------------------
# the differentiable function
# ---------------------------------------------------------------------------


class _AlignedSSDecode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, residual_dtype, compute_dtype, proj_w, proj_b, peer_w, peer_b, h0, c0, y0,
                teacher_tm, pxs_tm, coins, pwt, *flat):
        params = [LSTMParams(flat[i], flat[i + 1]) for i in range(0, len(flat), 2)]
        peer = LSTMParams(peer_w, peer_b)
        pxs = peer_rows_of(pxs_tm, pwt.shape[1])
        php, pcp, context = peer_fwd(peer, pxs, pwt, residual_dtype, compute_dtype)
        ys, res = dec_fwd(params, proj_w, proj_b, h0, c0, y0, teacher_tm, coins, context,
                          residual_dtype, compute_dtype)
        del context  # the backward rebuilds ctx from php, as the TPU backward does
        ctx.layers, ctx.compute_dtype = len(params), compute_dtype
        ctx.save_for_backward(proj_w, peer_w, peer_b, h0, c0, y0, teacher_tm, coins, pwt, pxs,
                              php, pcp, ys, *flat, *res.hs, *res.cs, *res.gs)
        return ys

    @staticmethod
    def backward(ctx, dys):
        n = ctx.layers
        (proj_w, peer_w, peer_b, h0, c0, y0, teacher_tm, coins, pwt, pxs, php, pcp, ys,
         *rest) = ctx.saved_tensors
        flat, rest = rest[: 2 * n], rest[2 * n:]
        params = [LSTMParams(flat[i], flat[i + 1]) for i in range(0, 2 * n, 2)]
        peer = LSTMParams(peer_w, peer_b)
        res = Residuals(list(rest[:n]), list(rest[n: 2 * n]), list(rest[2 * n:]))
        cd = ctx.compute_dtype
        dgates, dy, dteacher, dy0, dh0, dc0, dctx = dec_bwd(
            params, proj_w, c0, coins, res, dys.float().contiguous(), php.shape[-1], cd)
        dpgates, dpxs, dpwt = peer_bwd(peer, pxs, pwt, php, pcp, dctx, cd)
        dparams = dec_dw(params, h0, y0, teacher_tm, coins, pwt, php, ys, res, dgates, cd)
        dpeer = peer_dw(peer, pxs, php, dpgates, cd)
        dpw, dpb = lstm_ss.ss_dproj(res.hs[-1], dy, cd)
        flat_grads = [g for p in dparams for g in (p.w, p.b)]
        # coins get no gradient
        return (None, None, dpw, dpb, dpeer.w, dpeer.b, dh0, dc0, dy0, dteacher,
                _time_major(dpxs, y0.shape[0]), None, dpwt, *flat_grads)


def aligned_ss_decode(
    dec_params: Sequence[LSTMParams],
    proj_w: torch.Tensor,
    proj_b: torch.Tensor,
    peer_params: LSTMParams,  # shared peer-encoder cell (w (D + C, 4C))
    h0: torch.Tensor,
    c0: torch.Tensor,
    y0: torch.Tensor,  # (B, D)
    teacher_tm: torch.Tensor,  # (T, B, D) time-major teacher inputs
    pxs_tm: torch.Tensor,  # (T, B, K·D) time-major peer windows
    coins_pwt: tuple,  # (coins (T, B, 1), pwt (B, K) mask weights)
    residual_dtype: torch.dtype = torch.float32,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Lockstep-peer scheduled-sampling decoder → (B, T, D) f32 predictions;
    differentiable in the decoder, projection and peer-encoder params, h0,
    c0, y0, the teacher, the peer windows and the mask weights through the
    kernels' backward (coins get no gradient), which runs in the forward's
    ``compute_dtype``. bf16 weights are widened (``lstm_train.widen``)."""
    check_compute(compute_dtype)
    dec_params, (peer_params,) = widen(dec_params), widen([peer_params])
    coins, pwt = coins_pwt
    t_len, batch, d = teacher_tm.shape
    if pwt.dim() != 2 or pwt.shape[0] != batch or tuple(pxs_tm.shape) != (t_len, batch, pwt.shape[1] * d):
        raise ValueError(f"pxs_tm {tuple(pxs_tm.shape)} and pwt {tuple(pwt.shape)} do not match "
                         f"the teacher {tuple(teacher_tm.shape)}")
    flat = [t for p in dec_params for t in (p.w, p.b)]
    return _AlignedSSDecode.apply(residual_dtype, compute_dtype, proj_w, proj_b, peer_params.w,
                                  peer_params.b, h0, c0, y0, teacher_tm.contiguous(),
                                  pxs_tm.contiguous(), coins.contiguous(), pwt.contiguous(),
                                  *flat)
