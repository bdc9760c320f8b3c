"""Teacher-forced stacked LSTM for training: hand-written CUDA forward and
backward kernels, their plain PyTorch versions, and the autograd function
that joins them.

Twin of ``longterm360fov_tpu.ops.lstm_train``: :func:`lstm_seq_states` runs
a stacked LSTM over a known input sequence ``xs (B, T, D)`` from initial
states ``h0, c0 (L, B, H)`` and returns ``hs_top (B, T, H)``, ``hT`` and
``cT (L, B, H)``, all f32. Its gradient comes from the saved residuals: per
layer ``hs`` and ``cs (B, T, H)`` and the post-activation gates
``(B, T, 4H)`` (order i, f, g, o), in ``residual_dtype`` (f32 or bf16).
``compute_dtype`` bf16 is the JAX ``compute_dtype=bfloat16`` tier: both
operands of every product (the gate products ``[x, h]·W``, ``dgates·Wᵀ``
and the dW sums ``zᵀ·dgates``) are rounded to bf16 and the products summed
in f32; ``db``, the carries, gates, residuals and dgates stay unrounded.

Three kernels of ``csrc/lstm_train.cu`` carry it on the card:

* :func:`lstm_fwd`, the forward recurrence, which writes the residuals:
  the training forward on the tensor cores (``csrc/lstm_common.cuh``
  train_fwd_kernel, the serve kernel's decoder body in the teacher-forced
  mode: three-pass TF32 in f32, bf16 ``mma.sync`` in bf16), its block from
  :func:`fwd_block`, W packed once a call by ``fused_lstm.pack_weights_tf32``
  or ``pack_weights``;
* :func:`lstm_bwd`, the backward recurrence in reverse time, which carries
  ``dh`` and ``dc`` per layer and writes ``dgates``, ``dxs``, ``dh0`` and
  ``dc0``: the scheduled-sampling decoder's tensor-core body
  (``csrc/lstm_common.cuh`` ss_bwd_kernel) in its teacher-forced mode, its
  block from :func:`bwd_block`, Wᵀ packed once a call by
  ``lstm_ss.pack_bwd_weights``;
* :func:`lstm_dw`, the reduction ``dW_l = Σ_{b,t} z_{b,t}ᵀ dgates_{b,t}``
  and ``db_l = Σ dgates`` with ``z = [input_t, h_{t-1}]``: a pack pass
  writes each layer's z once in the compute type (:func:`dw_pack` runs it
  alone), a product on tensor cores (bf16) or exact FMAs (f32) sums it
  against dgates over slices of the (b, t) rows, and a second pass adds the
  slices in a fixed order: no float atomics, so two runs give the same bits.

Each wrapper runs its plain version (``_forward_reference``,
``_bwd_recurrence_reference``, ``_dw_reference``) on CPU tensors, and
launches its kernel on CUDA tensors or raises; it never falls back. Each
counts its kernel launches in ``.launches`` (f32 compute) and
``.launches_bf16`` (bf16 compute).

As in the JAX kernel, ``hT``, ``cT`` and ``hs_top`` are read back from the
residual streams, so with bf16 residuals they are bf16-rounded; the
backward rebuilds the input of layer l > 0 as ``o·tanh(c)`` of the layer
below, and reads ``h_{t-1}``, ``c_{t-1}`` from the residuals (``h0``,
``c0`` at t = 0).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..models.cell import LSTMParams, lstm_cell, mm
from . import _build

__all__ = [
    "Residuals",
    "lstm_seq_states",
    "lstm_seq",
    "lstm_seq_states_reference",
    "lstm_fwd",
    "launch_fwd",
    "lstm_bwd",
    "launch_bwd",
    "lstm_dw",
    "FwdGeom",
    "fwd_block",
    "bwd_split",
    "bwd_block",
    "dw_splits",
    "dw_zld",
    "dw_pack",
    "widen",
]

MAX_LAYERS = 8  # csrc/lstm_train.cu MAX_LAYERS
_SMEM_LIMIT = 232448  # dynamic shared memory a Hopper block may use (227 KB)
_DW_TILE = 128  # csrc/lstm_common.cuh DW_T: gate columns of a dW tile
_DW_FEATURES = 144  # DW_F: z features of a dW tile (nine 16-row mma tiles)
_DW_VEC = 8  # DW_V: the packed z's rows are whole runs of 8 values
# rows a dW slice sums at most: the tensor cores add each 16-row product
# into their f32 accumulator rounding toward zero, an error that grows with
# the run (read 4.3e-5 of max|dW| at 2.9 million peer rows in 66 slices on
# an H100; the bf16 tier's gate is 1e-4); shorter runs are added by the sum
# pass, rounding to nearest
_DW_RUN = 8192
RESIDUAL_DTYPES = (torch.float32, torch.bfloat16)
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


class Residuals(NamedTuple):
    """What the forward saves for the backward, one tensor per layer."""

    hs: List[torch.Tensor]  # (B, T, H) hidden state after step t
    cs: List[torch.Tensor]  # (B, T, H) cell state after step t
    gs: List[torch.Tensor]  # (B, T, 4H) post-activation gates i, f, g, o


def _no_tf32(t: torch.Tensor, name: str):
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            f"{name}: TF32 matmul is on; call "
            f"ops.fused_lstm.exact_f32_matmul() first"
        )


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def lstm_seq_states_reference(
    params: Sequence[LSTMParams], xs: torch.Tensor, h0: torch.Tensor,
    c0: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The stacked LSTM as a step loop of ``cell.lstm_cell`` in f32, with no
    residual rounding; torch autograd gives its gradient."""
    _no_tf32(xs, "lstm_seq_states_reference")
    states = [(h0[l], c0[l]) for l in range(len(params))]
    hs_top = []
    for t in range(xs.shape[1]):
        inp = xs[:, t]
        for l, p in enumerate(params):
            states[l] = lstm_cell(p, inp, states[l])
            inp = states[l][0]
        hs_top.append(inp)
    hT = torch.stack([s[0] for s in states])
    cT = torch.stack([s[1] for s in states])
    return torch.stack(hs_top, dim=1), hT, cT


def _forward_reference(
    params: Sequence[LSTMParams], xs: torch.Tensor, h0: torch.Tensor,
    c0: torch.Tensor, residual_dtype: torch.dtype,
    compute_dtype: torch.dtype = torch.float32,
) -> Residuals:
    """Plain version of the forward kernel: the recurrence in f32 with f32
    carries, the gate products in ``compute_dtype``, every step's h, c and
    gates stored in ``residual_dtype``."""
    _no_tf32(xs, "lstm_fwd plain version")
    batch, t_len, _ = xs.shape
    hidden = h0.shape[-1]
    res = Residuals([], [], [])
    for _ in params:
        res.hs.append(xs.new_empty((batch, t_len, hidden), dtype=residual_dtype))
        res.cs.append(xs.new_empty((batch, t_len, hidden), dtype=residual_dtype))
        res.gs.append(xs.new_empty((batch, t_len, 4 * hidden), dtype=residual_dtype))
    h = list(h0.unbind(0))
    c = list(c0.unbind(0))
    for t in range(t_len):
        inp = xs[:, t]
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
    return res


def _bwd_recurrence_reference(
    params: Sequence[LSTMParams], c0: torch.Tensor, res: Residuals,
    dhs_top: torch.Tensor, dhT: torch.Tensor, dcT: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward recurrence kernel: reverse time, per
    layer top-down, carrying (dh, dc) → (dgates per layer (B, T, 4H),
    dxs (B, T, D), dh0, dc0 (L, B, H)), all f32; ``dgates · Wᵀ`` in
    ``compute_dtype``."""
    _no_tf32(dhs_top, "lstm_bwd plain version")
    batch, t_len, hidden = dhs_top.shape
    d = params[0].w.shape[0] - hidden
    dh = list(dhT.unbind(0))
    dc = list(dcT.unbind(0))
    dgates = [dhs_top.new_empty((batch, t_len, 4 * hidden)) for _ in params]
    dxs = dhs_top.new_empty((batch, t_len, d))
    for t in reversed(range(t_len)):
        above = dhs_top[:, t]
        for l in reversed(range(len(params))):
            d_in = d if l == 0 else hidden
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
        dxs[:, t] = above
    return dgates, dxs, torch.stack(dh), torch.stack(dc)


def _layer_inputs(xs: torch.Tensor, h0: torch.Tensor, res: Residuals, l: int):
    """z = [input_t, h_{t-1}] of layer l at every (b, t), as the backward
    reads it: layer 0 takes xs; layer l > 0 takes o·tanh(c) of the layer
    below, rebuilt from the residuals; h_{t-1} comes from the residuals, and
    from h0 at t = 0."""
    hidden = h0.shape[-1]
    if l == 0:
        inp = xs
    else:
        inp = res.gs[l - 1][..., 3 * hidden:].float() * torch.tanh(res.cs[l - 1].float())
    h_prev = torch.cat([h0[l][:, None], res.hs[l][:, :-1].float()], dim=1)
    return torch.cat([inp, h_prev], dim=-1)


def _dw_reference(
    params: Sequence[LSTMParams], xs: torch.Tensor, h0: torch.Tensor,
    res: Residuals, dgates: Sequence[torch.Tensor],
    compute_dtype: torch.dtype = torch.float32,
) -> List[LSTMParams]:
    """Plain version of the dW/db reduction kernel: dW in
    ``compute_dtype``, db the sum of the unrounded dgates."""
    _no_tf32(xs, "lstm_dw plain version")
    out = []
    for l, p in enumerate(params):
        z = _layer_inputs(xs, h0, res, l).reshape(-1, p.w.shape[0])
        dg = dgates[l].reshape(-1, p.w.shape[1])
        out.append(LSTMParams(w=mm(z.t(), dg, compute_dtype), b=dg.sum(dim=0)))
    return out


def _pack_reference(xs: torch.Tensor, h0: torch.Tensor, res: Residuals, layer: int,
                    narrow: int, compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of the pack kernel: layer ``layer``'s z at every row
    b·T + t in the order the reduction packs it, ``[h_{t-1}, input[narrow:],
    input[:narrow], 1]`` padded with zeros to :func:`dw_zld` values, in
    ``compute_dtype`` → (B·T, dw_zld). ``xs`` is layer 0's input (its first
    ``narrow`` features are x_t; 0 above layer 0)."""
    hidden = h0.shape[-1]
    z = _layer_inputs(xs, h0, res, layer)
    n_in = z.shape[-1] - hidden
    inp, h_prev = z[..., :n_in], z[..., n_in:]
    packed = torch.cat([h_prev, inp[..., narrow:], inp[..., :narrow], torch.ones_like(inp[..., :1])], dim=-1)
    packed = torch.nn.functional.pad(packed, (0, dw_zld(n_in, hidden) - packed.shape[-1]))
    return packed.reshape(-1, packed.shape[-1]).to(compute_dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


class FwdGeom(NamedTuple):
    """A block of the training forward on the tensor cores
    (``csrc/lstm_common.cuh`` train_fwd_kernel): ``rp`` batch rows in warp
    tiles of 32 rows (x 8 units in f32, x 16 in bf16), ``warps`` warps, c in
    shared memory (``c_smem``) or in device memory, and the block's dynamic
    shared memory in bytes."""
    rp: int
    warps: int
    c_smem: bool
    smem: int


FWD_MODES = ("tf", "static", "step")  # teacher-forced; the decoder with a static or a per-step context
_FWD_ROWS = 32  # rows a block, one 32-row warp tile: B = 4096 makes one wave of 128 blocks on the card's 132 SMs
_FWD_MAX_HIDDEN = 256  # the backward's widest, two unit blocks a warp
_FWD_MAX_D = 8  # csrc/lstm_common.cuh SSB_MAX_D: coordinates a token of the decoder's feedback


def _fwd_smem(rp: int, d: int, ctx_dim: int, hidden: int, layers: int, c_smem: bool, mode: str, f32: bool) -> int:
    """``tfw_smem_bytes``: c (when in shared memory), z ([x padded to a
    k-step | ctx padded to a k-step | h of every layer] a row, a 16-byte pad
    more), the staging of the new h (rows of H + 8), in the tier's type (f32
    on k8 steps, bf16 on k16 steps); the per-step mode's ctx_t+1 in f32."""
    e, ks, pad = (4, 8, 4) if f32 else (2, 16, 8)
    kx, cp = -(-d // ks) * ks, -(-ctx_dim // ks) * ks
    s = 4 * layers * rp * hidden if c_smem else 0
    s += e * rp * (kx + cp + layers * hidden + pad) + e * rp * (hidden + 8)
    return s + (4 * rp * ctx_dim if mode == "step" else 0)


def fwd_block(hidden: int, layers: int, d: int, batch: int, compute_dtype=torch.float32, *, ctx_dim: int = 0,
              mode: str = "tf") -> FwdGeom:
    """The block of the training forward in ``mode`` (``FWD_MODES``):
    ``_FWD_ROWS`` rows; c in shared memory where it fits, else in device
    memory; the warps that take the block's tiles in the fewest rounds, at
    most 16. Raises a ValueError that names the shape for what
    the kernel does not take: hidden not a multiple of 32 up to 256, more
    than 8 layers, the decoder's d outside 1..8 or a context not of whole
    16-byte pieces, or a block of 32 rows past shared memory."""
    if mode not in FWD_MODES:
        raise ValueError(f"mode must be one of {FWD_MODES}, got {mode!r}")
    if hidden % 32 or not 32 <= hidden <= _FWD_MAX_HIDDEN:
        raise ValueError(f"the training forward takes hidden a multiple of 32 up to {_FWD_MAX_HIDDEN}, "
                         f"got hidden={hidden}")
    if not 1 <= layers <= MAX_LAYERS:
        raise ValueError(f"the training forward takes 1..{MAX_LAYERS} layers, got {layers}")
    if batch < 1 or d < 1 or (mode != "tf" and d > _FWD_MAX_D):
        raise ValueError(f"the training forward takes batch >= 1 and d >= 1 input columns ({_FWD_MAX_D} at most "
                         f"in the decoders), got batch={batch}, d={d}")
    if ctx_dim < 0 or ctx_dim % 4 or (mode == "tf" and ctx_dim):
        raise ValueError(f"the decoders' training forward reads the context as 16-byte rows: ctx_dim % 4 == 0 (the "
                         f"teacher-forced mode takes none), got ctx_dim={ctx_dim}")
    f32 = compute_dtype != torch.bfloat16
    for c_smem in (True, False):
        smem = _fwd_smem(_FWD_ROWS, d, ctx_dim, hidden, layers, c_smem, mode, f32)
        if smem <= _SMEM_LIMIT:
            tiles = _FWD_ROWS * hidden // (256 if f32 else 512)
            rounds = -(-tiles // 16)
            return FwdGeom(_FWD_ROWS, -(-tiles // rounds), c_smem, smem)
    raise ValueError(
        f"d={d}, ctx_dim={ctx_dim}, hidden={hidden}, layers={layers}: the training forward's block of {_FWD_ROWS} "
        f"rows keeps [x, ctx, h of every layer] and a staging row in {'f32' if f32 else 'bf16'}, {smem} bytes of "
        f"shared memory with c in device memory, more than {_SMEM_LIMIT}"
    )


def fwd_weights(params: Sequence[LSTMParams], d: int, ctx_dim: int, compute_dtype) -> torch.Tensor:
    """Every layer's W as the training forward reads it, packed once a call
    (``fused_lstm.pack_weights_tf32`` in f32, ``pack_weights`` in bf16),
    layer 0's rows [x | ctx | h] each padded to whole k-steps."""
    from .fused_lstm import pack_weights, pack_weights_tf32  # fused_lstm imports this module

    if compute_dtype == torch.bfloat16:
        return pack_weights(params, d, ctx_dim)
    return pack_weights_tf32(params, d, ctx_dim)


def c_buffer(geo: FwdGeom, batch: int, layers: int, hidden: int, device) -> Optional[torch.Tensor]:
    """The forward's c in device memory (grid x layers x rp x hidden f32)
    where it does not fit the block's shared memory, else None."""
    if geo.c_smem:
        return None
    return torch.empty(-(-batch // geo.rp) * layers * geo.rp * hidden, device=device)


_BWD_NARROW = 8  # csrc/lstm_common.cuh SSB_MAX_D: input columns the backward's dx partials take


def bwd_split(d: int) -> Tuple[int, int]:
    """Layer 0's ``d`` input columns as the backward recurrence takes them
    → (narrow, wide): up to 8 narrow columns first, whose gradient is the
    warps' ``mma.sync`` partials over their gate columns (every preset's x,
    d = 3), then the rest in whole n8 tiles of layer 0's product, one a
    warp, as the scheduled-sampling decoder's dctx (the teacher-forced
    decoder's static context, d = 3 + C)."""
    narrow = d if d <= _BWD_NARROW else (d - 1) % 8 + 1
    return narrow, d - narrow


def bwd_block(hidden: int, layers: int, d: int, compute_dtype=torch.float32):
    """The block of the backward recurrence (``csrc/lstm_common.cuh``
    ss_bwd_kernel in its teacher-forced mode): ``lstm_ss.bwd_block`` with
    layer 0's input split by :func:`bwd_split`, its wide columns taking the
    place of a per-step context → ``lstm_ss.SsBwdGeom``. Raises a
    ValueError that names the shape where the kernel does not take it:
    hidden not a multiple of 32 up to 256, more than 8 layers, more than
    hidden + 8 input columns, or a block past shared memory."""
    from .lstm_ss import bwd_block as ss_block  # lstm_ss imports this module

    if hidden % 32 or not 32 <= hidden <= 256:
        raise ValueError(f"lstm_seq_states' backward takes hidden a multiple of 32 up to 256 (a warp one or two "
                         f"unit blocks of 8, at most 16 warps), got hidden={hidden}")
    if not 1 <= layers <= MAX_LAYERS:
        raise ValueError(f"lstm_seq_states' backward takes 1..{MAX_LAYERS} layers, got {layers}")
    narrow, wide = bwd_split(d)
    if d < 1 or wide > hidden:
        raise ValueError(f"lstm_seq_states' backward takes 1..{hidden + _BWD_NARROW} input columns at "
                         f"hidden={hidden} (up to {_BWD_NARROW}, then whole n8 tiles, one a unit block), got d={d}")
    try:
        return ss_block(hidden, layers, narrow, wide, compute_dtype, step_ctx=True)
    except ValueError as e:
        raise ValueError(f"lstm_seq_states' backward at d={d} ({narrow} + {wide} input columns): {e}") from None


def dw_splits(batch: int, t_len: int, hidden: int, d: int, n_sm: int) -> int:
    """How many slices of the (b, t) rows the dW reduction is split into:
    enough that the 144-feature x 128-column dW tiles of the first layer
    alone give two blocks per SM, in whole waves of them so that no slice
    sums more than ``_DW_RUN`` rows, with at least 64 rows per slice."""
    tiles = (4 * hidden // _DW_TILE) * -(-(d + hidden + 1) // _DW_FEATURES)
    want = -(-2 * n_sm // tiles)
    want *= -(-batch * t_len // (want * _DW_RUN))
    return max(1, min(want, batch * t_len // 64))


def dw_zld(n_in: int, hidden: int) -> int:
    """Row length of a layer's packed z (``n_in + hidden + 1`` features
    rounded up to whole runs of 8)."""
    return -(-(n_in + hidden + 1) // _DW_VEC) * _DW_VEC


def check_compute(compute_dtype: torch.dtype):
    if compute_dtype not in COMPUTE_DTYPES:
        raise TypeError(f"compute_dtype must be one of {COMPUTE_DTYPES}, got {compute_dtype}")


def count_launch(fn, compute_dtype: torch.dtype):
    """One launch of ``fn``'s kernel: its f32-compute instance counts in
    ``fn.launches``, its bf16-compute instance in ``fn.launches_bf16``."""
    if compute_dtype == torch.bfloat16:
        fn.launches_bf16 += 1
    else:
        fn.launches += 1


def in_compute(ts: Sequence[torch.Tensor], compute_dtype: torch.dtype) -> List[torch.Tensor]:
    """The weights as a kernel of the ``compute_dtype`` tier reads them:
    f32 as they are, bf16 rounded once per call."""
    return [t.to(compute_dtype).contiguous() for t in ts]


def widen(params: Sequence[LSTMParams]) -> List[LSTMParams]:
    """The layers as the kernels' f32 interface takes them: a ``--bf16``
    model's W and b widened to f32, which is exact, as JAX's f32 dot widens
    a bf16 W. The kernels' backward gives the widened tensors f32 dW and db,
    the dtype JAX's custom VJPs return; at a bf16 leaf torch's engine casts
    them to bf16, so ``train.make_grad_fn`` takes the gradient at an f32
    copy of the leaf."""
    return [LSTMParams(p.w.float(), p.b.float()) for p in params]


def _check(params, xs, h0, c0, residual_dtype=torch.float32):
    if xs.dim() != 3:
        raise ValueError(f"xs must be (B, T, D), got {tuple(xs.shape)}")
    batch, t_len, d = xs.shape
    layers = len(params)
    if layers < 1 or batch < 1 or t_len < 1:
        raise ValueError(f"empty call: {layers} layers, xs {tuple(xs.shape)}")
    hidden = h0.shape[-1]
    if residual_dtype not in RESIDUAL_DTYPES:
        raise TypeError(f"residual_dtype must be one of {RESIDUAL_DTYPES}, got {residual_dtype}")
    expect = [(xs, (batch, t_len, d)), (h0, (layers, batch, hidden)),
              (c0, (layers, batch, hidden))]
    for l, p in enumerate(params):
        in_l = d if l == 0 else hidden
        expect += [(p.w, (in_l + hidden, 4 * hidden)), (p.b, (4 * hidden,))]
    for t, shape in expect:
        if tuple(t.shape) != shape:
            raise ValueError(f"expected shape {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"the kernels take float32 tensors, got {t.dtype}")
        if t.device != xs.device:
            raise ValueError(f"tensors on {t.device} and {xs.device}")
    if xs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the kernels run on cpu or cuda, not {xs.device}")


def _check_card(tensors):
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"tensor of shape {tuple(t.shape)} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError("the kernels read 16-byte vectors: tensors must be 16-byte aligned")


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def _raise_on(err: int, name: str):
    if err:
        raise RuntimeError(
            f"{name} kernel launch failed: "
            f"{_library().lstm_train_error_string(err).decode()} (cuda error {err})"
        )


def lstm_fwd(
    params: Sequence[LSTMParams], xs: torch.Tensor, h0: torch.Tensor,
    c0: torch.Tensor, residual_dtype: torch.dtype = torch.float32,
    compute_dtype: torch.dtype = torch.float32,
) -> Residuals:
    """Forward recurrence → the residuals."""
    _check(params, xs, h0, c0, residual_dtype)
    check_compute(compute_dtype)
    if xs.device.type == "cpu":
        return _forward_reference(params, xs, h0, c0, residual_dtype, compute_dtype)
    res = launch_fwd(_library(), params, xs, h0, c0, residual_dtype, compute_dtype)
    count_launch(lstm_fwd, compute_dtype)
    return res


def launch_fwd(lib, params: Sequence[LSTMParams], xs, h0, c0, residual_dtype, compute_dtype) -> Residuals:
    """Launch the forward recurrence of ``lib`` (a build of
    ``csrc/lstm_train.cu``: the kernels' own, or a probe build,
    ``-DLSTM_PROBE``) on checked CUDA tensors → the residuals; not counted.
    The block comes from :func:`fwd_block`, W is packed once a call
    (:func:`fwd_weights`)."""
    batch, t_len, d = xs.shape
    hidden, layers = h0.shape[-1], len(params)
    geo = fwd_block(hidden, layers, d, batch, compute_dtype)
    res = Residuals(
        [torch.empty((batch, t_len, hidden), device=xs.device, dtype=residual_dtype) for _ in params],
        [torch.empty((batch, t_len, hidden), device=xs.device, dtype=residual_dtype) for _ in params],
        [torch.empty((batch, t_len, 4 * hidden), device=xs.device, dtype=residual_dtype) for _ in params],
    )
    w = fwd_weights(params, d, 0, compute_dtype)
    bs = [p.b for p in params]
    c_glob = c_buffer(geo, batch, layers, hidden, xs.device)
    _check_card([w, xs, h0, c0, *bs, *res.hs, *res.cs, *res.gs, *([] if c_glob is None else [c_glob])])
    with torch.cuda.device(xs.device):
        err = lib.lstm_fwd(
            w.data_ptr(), _ptrs(bs), xs.data_ptr(), h0.data_ptr(), c0.data_ptr(),
            _ptrs(res.hs), _ptrs(res.cs), _ptrs(res.gs), None if c_glob is None else c_glob.data_ptr(),
            batch, t_len, d, hidden, layers, geo.rp, geo.warps,
            int(residual_dtype == torch.bfloat16), int(compute_dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "lstm_fwd")
    return res


lstm_fwd.launches = lstm_fwd.launches_bf16 = 0


def _check_bwd(params, res, batch, t_len, d, hidden, f32s):
    """Shapes and types of a backward kernel's inputs: f32 params and
    ``f32s`` (tensor, shape) pairs, and residuals of one type that match."""
    layers = len(params)
    expect = list(f32s)
    for l, p in enumerate(params):
        in_l = d if l == 0 else hidden
        expect += [(p.w, (in_l + hidden, 4 * hidden)), (p.b, (4 * hidden,))]
    dev = expect[0][0].device
    for t, shape in expect:
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"expected f32 {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
    rdt = res.hs[0].dtype
    if rdt not in RESIDUAL_DTYPES or not len(res.hs) == len(res.cs) == len(res.gs) == layers:
        raise ValueError(f"residuals of {len(res.hs)} layers in {rdt} do not match the call")
    for l in range(layers):
        for t, w in ((res.hs[l], hidden), (res.cs[l], hidden), (res.gs[l], 4 * hidden)):
            if tuple(t.shape) != (batch, t_len, w) or t.dtype != rdt or t.device != dev:
                raise ValueError(f"residual {t.dtype} {tuple(t.shape)} on {t.device} does not match the call")


def lstm_bwd(
    params: Sequence[LSTMParams], c0: torch.Tensor, res: Residuals,
    dhs_top: torch.Tensor, dhT: torch.Tensor, dcT: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward recurrence → (dgates per layer (B, T, 4H), dxs (B, T, D),
    dh0, dc0 (L, B, H)), all f32."""
    batch, t_len, hidden = dhs_top.shape
    layers = len(params)
    d = params[0].w.shape[0] - hidden
    _check_bwd(params, res, batch, t_len, d, hidden, [
        (dhs_top, (batch, t_len, hidden)), (dhT, (layers, batch, hidden)),
        (dcT, (layers, batch, hidden)), (c0, (layers, batch, hidden)),
    ])
    check_compute(compute_dtype)
    if dhs_top.device.type == "cpu":
        return _bwd_recurrence_reference(params, c0, res, dhs_top, dhT, dcT, compute_dtype)
    out = launch_bwd(_library(), params, c0, res, dhs_top, dhT, dcT, compute_dtype)
    count_launch(lstm_bwd, compute_dtype)
    return out


lstm_bwd.launches = lstm_bwd.launches_bf16 = 0


def launch_bwd(lib, params: Sequence[LSTMParams], c0, res: Residuals, dhs_top, dhT, dcT, compute_dtype):
    """Launch the backward recurrence of ``lib`` (a build of
    ``csrc/lstm_train.cu``: the kernels' own, or a probe build, ``-DSSB_PROBE``)
    on checked CUDA tensors → :func:`lstm_bwd`'s outputs; not counted. The
    block comes from :func:`bwd_block`, Wᵀ is packed once a call by
    ``lstm_ss.pack_bwd_weights``."""
    from .lstm_ss import pack_bwd_weights  # lstm_ss imports this module

    batch, t_len, hidden = dhs_top.shape
    layers = len(params)
    d = params[0].w.shape[0] - hidden
    rdt = res.hs[0].dtype
    bwd_block(hidden, layers, d, compute_dtype)  # raises for a shape the kernel does not take
    narrow, wide = bwd_split(d)
    dev = dhs_top.device
    wt = pack_bwd_weights(params, narrow, wide, compute_dtype)
    (w0x,) = in_compute([params[0].w[:narrow]], compute_dtype)
    dgates = [torch.empty((batch, t_len, 4 * hidden), device=dev) for _ in params]
    dxs = torch.empty((batch, t_len, d), device=dev)
    dh0 = torch.empty((layers, batch, hidden), device=dev)
    dc0 = torch.empty((layers, batch, hidden), device=dev)
    _check_card([dhs_top, dhT, dcT, c0, *wt, w0x, *res.cs, *res.gs, *dgates, dxs, dh0, dc0])
    with torch.cuda.device(dev):
        err = lib.lstm_bwd(
            dhs_top.data_ptr(), dhT.data_ptr(), dcT.data_ptr(), c0.data_ptr(), _ptrs(wt), w0x.data_ptr(),
            _ptrs(res.cs), _ptrs(res.gs), _ptrs(dgates), dxs.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
            batch, t_len, narrow, wide, hidden, layers, int(rdt == torch.bfloat16),
            int(compute_dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "lstm_bwd")
    return dgates, dxs, dh0, dc0


def lstm_dw(
    params: Sequence[LSTMParams], xs: torch.Tensor, h0: torch.Tensor,
    res: Residuals, dgates: Sequence[torch.Tensor],
    compute_dtype: torch.dtype = torch.float32, pack_layer: Optional[int] = None,
) -> List[LSTMParams]:
    """dW/db reduction → per layer ``LSTMParams(dW, db)``, f32; with
    ``pack_layer``, only that layer's pack pass (:func:`dw_pack`)."""
    batch, t_len, d = xs.shape
    hidden, layers = h0.shape[-1], len(params)
    _check_bwd(params, res, batch, t_len, d, hidden, [
        (xs, (batch, t_len, d)), (h0, (layers, batch, hidden)),
        *((g, (batch, t_len, 4 * hidden)) for g in dgates),
    ])
    if len(dgates) != layers:
        raise ValueError(f"{len(dgates)} dgates for {layers} layers")
    check_compute(compute_dtype)
    _check_pack_layer(pack_layer, layers)
    if xs.device.type == "cpu":
        if pack_layer is not None:
            return _pack_reference(xs, h0, res, pack_layer, d if pack_layer == 0 else 0, compute_dtype)
        return _dw_reference(params, xs, h0, res, dgates, compute_dtype)
    if batch * t_len >= 2**31:
        raise ValueError(f"B·T = {batch * t_len} rows do not fit the kernel's 32-bit row index")
    dev = xs.device
    splits = dw_splits(batch, t_len, hidden, d, _build.sm_count(dev))
    ins = [d] + [hidden] * (layers - 1) if pack_layer is None else [d if pack_layer == 0 else hidden]
    zpack = torch.empty((batch * t_len, max(dw_zld(i, hidden) for i in ins)), dtype=compute_dtype, device=dev)
    rows_max = max(d + hidden, 2 * hidden if layers > 1 else 0)  # in_l + H
    partial = torch.empty((splits, rows_max + 1, 4 * hidden), device=dev)
    dws = [torch.empty_like(p.w) for p in params]
    dbs = [torch.empty_like(p.b) for p in params]
    _check_card([xs, h0, *res.hs, *res.cs, *res.gs, *dgates, zpack, partial, *dws, *dbs])
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.lstm_dw(
            xs.data_ptr(), h0.data_ptr(), _ptrs(res.hs), _ptrs(res.cs), _ptrs(res.gs),
            _ptrs(dgates), zpack.data_ptr(), partial.data_ptr(), _ptrs(dws), _ptrs(dbs),
            batch, t_len, d, hidden, layers, splits, int(res.hs[0].dtype == torch.bfloat16),
            int(compute_dtype == torch.bfloat16), -1 if pack_layer is None else pack_layer,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "lstm_dw")
    count_launch(dw_pack, compute_dtype)
    if pack_layer is not None:
        return zpack
    count_launch(lstm_dw, compute_dtype)
    return [LSTMParams(w=w, b=b) for w, b in zip(dws, dbs)]


lstm_dw.launches = lstm_dw.launches_bf16 = 0


def _check_pack_layer(pack_layer: Optional[int], layers: int):
    if pack_layer is not None and not 0 <= pack_layer < layers:
        raise ValueError(f"pack_layer {pack_layer} is not one of the {layers} layers")


def dw_pack(dw, *args, layer: int = 0, compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The dW reductions' pack kernel alone (``lstm_dw_pack_kernel`` of
    ``csrc/lstm_common.cuh``): layer ``layer``'s z as the reduction ``dw``
    (:func:`lstm_dw`, ``lstm_ss.ss_dw``, ``lstm_align.dec_dw`` or
    ``lstm_align.peer_dw``) packs it from ``args``, its arguments up to the
    compute type → (B·T, :func:`dw_zld`) in ``compute_dtype``, the layout of
    :func:`_pack_reference` (the plain version, which CPU tensors get).
    ``dw_pack.launches`` (and ``launches_bf16``) count every call of the
    pack kernel, from this function and from the reductions."""
    return dw(*args, compute_dtype=compute_dtype, pack_layer=layer)


dw_pack.launches = dw_pack.launches_bf16 = 0


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernels' library, built at first use and loaded once."""
    return bind(_build.load("lstm_train"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``csrc/lstm_train.cu``: the library, or a probe
    build of it) with its entry points typed."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    arr = ctypes.POINTER(ctypes.c_void_p)
    lib.lstm_fwd.argtypes = [vp, arr, vp, vp, vp, arr, arr, arr, vp] + [i32] * 9 + [vp]
    lib.lstm_fwd_smem.argtypes = [i32] * 6
    lib.lstm_fwd_smem.restype = ctypes.c_longlong
    lib.train_fwd_probe_read.argtypes = [vp]
    lib.train_fwd_probe_read.restype = i32
    lib.lstm_bwd.argtypes = [vp, vp, vp, vp, arr, vp, arr, arr, arr, vp, vp, vp] + [i32] * 8 + [vp]
    lib.lstm_bwd_smem.argtypes = [i32] * 5 + [vp]
    lib.lstm_bwd_smem.restype = ctypes.c_longlong
    lib.lstm_bwd_probe_read.argtypes = [vp]
    lib.lstm_bwd_probe_read.restype = i32
    lib.lstm_dw.argtypes = [vp, vp, arr, arr, arr, arr, vp, vp, arr, arr] + [i32] * 9 + [vp]
    for f in (lib.lstm_fwd, lib.lstm_bwd, lib.lstm_dw):
        f.restype = i32
    lib.lstm_train_error_string.argtypes = [i32]
    lib.lstm_train_error_string.restype = ctypes.c_char_p
    return lib


# ---------------------------------------------------------------------------
# the differentiable function
# ---------------------------------------------------------------------------


class _LSTMSeqStates(torch.autograd.Function):
    @staticmethod
    def forward(ctx, residual_dtype, compute_dtype, xs, h0, c0, *flat):
        params = [LSTMParams(flat[i], flat[i + 1]) for i in range(0, len(flat), 2)]
        res = lstm_fwd(params, xs, h0, c0, residual_dtype, compute_dtype)
        ctx.layers, ctx.compute_dtype = len(params), compute_dtype
        ctx.save_for_backward(xs, h0, c0, *flat, *res.hs, *res.cs, *res.gs)
        hT = torch.stack([h[:, -1] for h in res.hs]).float()
        cT = torch.stack([c[:, -1] for c in res.cs]).float()
        return res.hs[-1].float(), hT, cT

    @staticmethod
    def backward(ctx, dhs_top, dhT, dcT):
        n = ctx.layers
        xs, h0, c0, *rest = ctx.saved_tensors
        flat, rest = rest[: 2 * n], rest[2 * n:]
        params = [LSTMParams(flat[i], flat[i + 1]) for i in range(0, 2 * n, 2)]
        res = Residuals(list(rest[:n]), list(rest[n: 2 * n]), list(rest[2 * n:]))
        dgates, dxs, dh0, dc0 = lstm_bwd(
            params, c0, res, dhs_top.float().contiguous(),
            dhT.float().contiguous(), dcT.float().contiguous(), ctx.compute_dtype,
        )
        dparams = lstm_dw(params, xs, h0, res, dgates, ctx.compute_dtype)
        flat_grads = [g for p in dparams for g in (p.w, p.b)]
        return (None, None, dxs, dh0, dc0, *flat_grads)


def lstm_seq_states(
    params: Sequence[LSTMParams],
    xs: torch.Tensor,
    h0: torch.Tensor,
    c0: torch.Tensor,
    residual_dtype: torch.dtype = torch.float32,
    compute_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stacked LSTM over a known sequence from initial states (L, B, H)
    → (hs_top (B, T, H), hT (L, B, H), cT (L, B, H)), f32; differentiable
    in params, xs, h0 and c0 through the kernels' backward, which runs in
    the forward's ``compute_dtype`` (f32, or bf16: the JAX
    ``train_compute`` tier). bf16 weights are widened (:func:`widen`)."""
    params = widen(params)
    _check(params, xs, h0, c0, residual_dtype)
    check_compute(compute_dtype)
    flat = [t for p in params for t in (p.w, p.b)]
    return _LSTMSeqStates.apply(residual_dtype, compute_dtype, xs, h0, c0, *flat)


def lstm_seq(
    params: Sequence[LSTMParams], xs: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Zero-initial-state convenience wrapper → top-layer outputs."""
    hidden = params[0].w.shape[1] // 4
    z = xs.new_zeros((len(params), xs.shape[0], hidden))
    hs_top, _, _ = lstm_seq_states(params, xs, z, z, torch.float32, compute_dtype)
    return hs_top
