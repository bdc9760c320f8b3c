"""Whole-request fused LSTM serve and whole-sequence fused encode: the
hand-written CUDA kernels and their plain PyTorch versions.

Twins of ``longterm360fov_tpu.ops.fused_lstm``:

* :func:`fused_serve`, in its no-context, static-context and lockstep-peer
  tiers, each in f32 and in the bf16 compute tier: the L-layer encoder over the past window, then the T_out-step
  autoregressive decoder with projection and feedback; with a ``context``
  (B, C) the decoder's layer-0 input is ``[y, ctx]``, with peers
  (:func:`fused_serve_peers`) ``[y, ctx_t]``, where ctx_t is the
  mask-weighted mean of K peer encoders' hidden states at step t;
* :func:`peer_context`: the lockstep tier's peer encoders, → ctx (B, T, C);
* :func:`fused_encode`: an L-layer encoder over ``(B, T, D)`` from zero
  state, returning only the final top-layer ``h`` (B, H);
* :func:`fused_decode`: the T_out-step decoder alone, from given states
  ``h0, c0`` (L, B, H) and first input ``y0`` (B, D), with an optional
  static context (``seq2seq.decode_fused``);
* :func:`fused_lstm_cell`: one LSTM step, ``(params, x, (h, c)) → (h, c)``,
  the cell of ``cfg.cell == "pallas"`` (``models.cell.get_cell_fn``), on
  f32 tensors or, on a bf16 model, bf16 ones.

``compute_dtype=torch.bfloat16`` (``fused_serve``, ``peer_context``,
``fused_encode``) is the JAX bf16 tier: W and ``proj_w`` are rounded to bf16
once per call, and every activation that enters a product (the inputs, the
stored h of every layer, the context, the fed-back y, the peers' inputs and
h) is rounded where it enters it; c, the gate sums, the biases, the lockstep
context ``ctx_t`` (summed from the unrounded peer h) and the written y stay
f32, and ``fused_encode`` returns the rounded top-layer h. Weights stored in
bf16 (a ``--bf16`` model) are widened to f32 for the f32 tier, which is
exact, as JAX's f32 dot widens them.

The kernels live in ``csrc/fused_serve.cu``, whose header says what bounds
them on Hopper and what their design does about that; the bf16 tiers of
``peer_context``, ``fused_encode`` and ``fused_serve`` run on the tensor
cores (``csrc/lstm_mma.cuh``), their W packed once a call by
:func:`pack_weights` and their blocks chosen by :func:`peer_tc_rows`,
:func:`encode_tc_rows` and :func:`serve_tc_rows`; so do the f32 tiers of
``peer_context``, ``fused_encode``, ``fused_serve`` and ``fused_decode``, in
three-pass TF32 (``Tf32Mma``), their W packed by :func:`pack_weights_tf32`
and their blocks chosen by :func:`peer_tf32_rows`, :func:`encode_tf32_rows`
and :func:`serve_tf32_rows`;
so does the cell in both tiers (f32 in three-pass TF32), W read as stored
(nothing packed: the cell is launched once a step), on a grid of row and
unit blocks of :func:`cell_block`. Each wrapper runs its
plain version (:func:`fused_serve_reference`, :func:`peer_context_reference`,
:func:`fused_encode_reference`, :func:`fused_decode_reference`, and
``models.cell.lstm_cell`` for the cell) on CPU tensors, and launches its
kernel on CUDA tensors or raises. It never falls back. ``.launches`` counts
each wrapper's kernel launches (``.launches_bf16`` those of the bf16 tier
and of the cell on bf16 tensors): ``fused_serve`` those of the no-context
and static-context tiers, ``fused_serve_peers`` and ``peer_context`` the two
of the lockstep tier. The TPU's cell and decode kernels have no VJP, so
:func:`fused_lstm_cell` and :func:`fused_decode` raise on an input that
requires grad, on both devices (:func:`refuse_grad`).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple, Sequence

import torch

from ..models.cell import LSTMParams, lstm_cell, mm, round_to
from . import _build
from .lstm_train import COMPUTE_DTYPES, check_compute, count_launch

__all__ = [
    "fused_serve",
    "fused_serve_peers",
    "fused_serve_reference",
    "peer_context",
    "peer_context_reference",
    "peer_tc_rows",
    "encode_tc_rows",
    "encode_tf32_rows",
    "serve_tc_rows",
    "serve_tf32_rows",
    "peer_tf32_rows",
    "pack_weights",
    "pack_weights_tf32",
    "fused_encode",
    "fused_encode_reference",
    "fused_decode",
    "fused_decode_reference",
    "fused_lstm_cell",
    "CellGeom",
    "cell_geom",
    "cell_block",
    "cell_grid",
    "cell_k_steps",
    "cell_w_columns",
    "exact_f32_matmul",
    "refuse_grad",
]

MAX_LAYERS = 8  # csrc/fused_serve.cu MAX_LAYERS
_SMEM_LIMIT = 232448  # dynamic shared memory a Hopper block may use (227 KB)


def exact_f32_matmul():
    """f32 matrix products and convolutions in full f32 on the card: TF32
    keeps about three decimal digits, and 60 recurrent steps amplify that.
    bf16 products accumulate in full f32 too (no reduced-precision
    reductions in cuBLAS): the transformer's bf16 serving tier rounds the
    operands of its K/V products to bf16 and sums in f32, as the JAX tier's
    ``preferred_element_type=float32`` does. Process-wide flags: entry
    points (the CLI's commands, ``chip_smoke.py``) call this once; library
    functions do not."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def fused_serve_reference(
    enc_params: Sequence[LSTMParams],
    dec_params: Sequence[LSTMParams],
    proj_w: torch.Tensor,
    proj_b: torch.Tensor,
    past_n: torch.Tensor,
    t_out: int,
    context=None,
    *,
    peer_params=None,
    peer_xs=None,
    peer_w=None,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """Plain PyTorch version of the serve kernels: (B, T_in, D) normalized
    past, and optionally a context, (B, C) or per step (B, t_out, C), or the
    lockstep peers → (B, t_out, D) normalized predictions, step by step.
    With peers, every decoder step first advances the K peer cells
    (``peer_params``, from zero state) one step on ``peer_xs``
    (B, K, t_out, D); their mask-weighted mean
    ``ctx_t = Σ_k peer_w[:, k] · h_k,t``, summed in the order k = 0 .. K - 1,
    is that step's context. ``compute_dtype`` bf16 rounds every product's
    operands (``models.cell.mm``): the inputs, every stored h, the context,
    the fed-back y, the peers' inputs and h, W and ``proj_w``; c, ctx_t and
    y stay f32. On the card it needs exact f32 products
    (:func:`exact_f32_matmul`) and raises under TF32."""
    _no_tf32(past_n, "fused_serve_reference")
    cd = compute_dtype
    peers = None if peer_xs is None else _PeerSteps(peer_params, peer_xs, peer_w, cd)
    return _decode_steps(dec_params, proj_w, proj_b, _encode_states(enc_params, past_n, cd), past_n[:, -1],
                         t_out, context, peers, cd)


def _decode_steps(dec_params, proj_w, proj_b, states, y, t_out, context, peers=None,
                  compute_dtype=torch.float32):
    """The decoder loop of the serve and decode kernels' plain versions, from
    ``states`` (an (h, c) a layer) and the first input ``y``: per step the
    layers on ``[y, ctx]``, then ``y = h_top @ proj_w + proj_b``, fed back
    → (B, t_out, D); the products in ``compute_dtype``."""
    ys = []
    for t in range(t_out):
        ctx = peers.step(t) if peers is not None else context
        if ctx is not None and ctx.dim() == 3:
            ctx = ctx[:, t]
        inp = y if ctx is None else torch.cat([y, ctx], dim=-1)
        for l, p in enumerate(dec_params):
            states[l] = lstm_cell(p, inp, states[l], compute_dtype)
            inp = states[l][0]
        y = mm(inp, proj_w.float(), compute_dtype) + proj_b.float()
        ys.append(y)
    return torch.stack(ys, dim=1)


def fused_decode_reference(dec_params: Sequence[LSTMParams], proj_w: torch.Tensor, proj_b: torch.Tensor,
                           h0: torch.Tensor, c0: torch.Tensor, y0: torch.Tensor, t_out: int,
                           context=None) -> torch.Tensor:
    """Plain PyTorch version of the decode kernel: the serve kernel's decoder
    loop from ``h0, c0`` (L, B, H) and ``y0`` (B, D), with an optional
    static ``context`` (B, C) → (B, t_out, D), step by step."""
    _no_tf32(y0, "fused_decode_reference")
    return _decode_steps(dec_params, proj_w, proj_b, list(zip(h0, c0)), y0, t_out, context)


class _PeerSteps:
    """The lockstep peer encoders, one step at a time: K cells over the
    (B·K) rows of ``peer_xs`` (B, K, T, D), from zero state, their products
    in ``compute_dtype``; ``step(t)`` advances them and returns ctx_t (B, C),
    summed from the unrounded h."""

    def __init__(self, params: LSTMParams, peer_xs: torch.Tensor, peer_w: torch.Tensor,
                 compute_dtype=torch.float32):
        b, k, t, d = peer_xs.shape
        self.params, self.w, self.k, self.cd = params, peer_w, k, compute_dtype
        self.xs = peer_xs.reshape(b * k, t, d)
        zero = peer_xs.new_zeros((b * k, params.w.shape[1] // 4))
        self.state = (zero, zero)

    def step(self, t: int) -> torch.Tensor:
        self.state = lstm_cell(self.params, self.xs[:, t], self.state, self.cd)
        h = self.state[0].reshape(self.w.shape[0], self.k, -1)
        ctx = torch.zeros_like(h[:, 0])
        for k in range(self.k):
            ctx = ctx + h[:, k] * self.w[:, k:k + 1]
        return ctx


def peer_context_reference(peer_params: LSTMParams, peer_xs: torch.Tensor,
                           peer_w: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
    """Plain version of the peer-context kernel: the lockstep peer encoders
    over ``peer_xs`` (B, K, T, D) → ctx (B, T, C) f32, step by step, the
    products in ``compute_dtype``."""
    _no_tf32(peer_xs, "peer_context_reference")
    peers = _PeerSteps(peer_params, peer_xs, peer_w, compute_dtype)
    return torch.stack([peers.step(t) for t in range(peer_xs.shape[2])], dim=1)


def _no_tf32(t: torch.Tensor, name: str):
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(f"{name}: TF32 matmul is on; call exact_f32_matmul() first")


def refuse_grad(tensors, name: str, instead: str = "models.transformer.apply"):
    """The kernel has no backward (nor has the TPU kernel): an input that
    requires grad raises on both devices, where grad is on."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward (nor has the TPU kernel): differentiate through {instead}"
        )


def _encode_states(params: Sequence[LSTMParams], xs: torch.Tensor, compute_dtype=torch.float32):
    """The stacked LSTM over xs (B, T, D) from zero state → final (h, c) per
    layer, step by step, the products in ``compute_dtype``."""
    zero = xs.new_zeros((xs.shape[0], params[0].w.shape[1] // 4))
    states = [(zero, zero) for _ in params]
    for t in range(xs.shape[1]):
        inp = xs[:, t]
        for l, p in enumerate(params):
            states[l] = lstm_cell(p, inp, states[l], compute_dtype)
            inp = states[l][0]
    return states


def fused_encode_reference(params: Sequence[LSTMParams], xs: torch.Tensor,
                           compute_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of the encode kernel: (B, T, D) → the final
    top-layer h (B, H) f32, step by step; in the bf16 ``compute_dtype`` the
    products round their operands and the h returned is rounded too."""
    _no_tf32(xs, "fused_encode_reference")
    return round_to(_encode_states(params, xs, compute_dtype)[-1][0], compute_dtype)


def _check_tensors(expect, device):
    for t, shape in expect:
        if t.shape != shape:  # torch.Size is a tuple
            raise ValueError(f"expected shape {shape}, got {tuple(t.shape)}")
        if t.dtype not in COMPUTE_DTYPES:
            raise TypeError(f"the kernels take float32 or bfloat16 tensors, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"tensors on {t.device} and {device}")
        if not t.is_contiguous():
            raise ValueError(f"tensor of shape {shape} is not contiguous")


def _check(enc_params, dec_params, proj_w, proj_b, past_n, t_out, context):
    if past_n.dim() != 3:
        raise ValueError(f"past_n must be (B, T_in, D), got {tuple(past_n.shape)}")
    batch, t_in, d = past_n.shape
    hidden = proj_w.shape[0]
    layers = len(enc_params)
    ctx_dim = 0 if context is None else context.shape[-1]
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
        expect += [(enc_params[l].w, (in_l + hidden, 4 * hidden)), (enc_params[l].b, (4 * hidden,))]
        in_l += ctx_dim if l == 0 else 0  # the decoder's layer 0 takes [y, ctx]
        expect += [(dec_params[l].w, (in_l + hidden, 4 * hidden)), (dec_params[l].b, (4 * hidden,))]
    expect += [(proj_w, (hidden, d)), (proj_b, (d,)), (past_n, (batch, t_in, d))]
    if context is not None:
        expect.append((context, (batch, ctx_dim)))
    _check_tensors(expect, past_n.device)


def _f32(t):
    """An activation or a bias as the kernels read it: f32 (a bf16 value
    widens exactly)."""
    return None if t is None else t.float().contiguous()


def _in_tier(params: Sequence[LSTMParams], compute_dtype) -> list:
    """The layers as a kernel of the ``compute_dtype`` tier reads them: W in
    that type (bf16: rounded once per call; f32: a bf16 W widened), b f32."""
    return [LSTMParams(p.w.to(compute_dtype).contiguous(), _f32(p.b)) for p in params]


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
    launch (the lockstep tier: two) → (B, t_out, D) f32 normalized
    predictions.

    Same shapes and semantics as the JAX ``fused_serve``: no context; a
    ``context`` (B, C), which fills the decoder's layer-0 input as
    ``[y, ctx]``; or the lockstep peer tier, ``peer_params`` (the shared
    peer-encoder cell), ``peer_xs`` (B, K, t_out, D) peer futures and
    ``peer_w`` (B, K) mask weights (``mask / max(Σ mask, 1)``), which
    :func:`fused_serve_peers` runs. ``compute_dtype`` is f32 or the bf16
    tier (the module's docstring), any other dtype a TypeError. The
    ``_probe`` modes raise."""
    check_compute(compute_dtype)
    if _probe:
        raise NotImplementedError(
            "fused_serve: the roofline _probe modes are not ported"
        )
    if peer_xs is not None:
        if context is not None:
            raise ValueError("pass either context or peer_xs, not both")
        return fused_serve_peers(enc_params, dec_params, proj_w, proj_b, past_n, t_out,
                                 peer_params, peer_xs, peer_w, compute_dtype=compute_dtype)
    if peer_params is not None or peer_w is not None:
        raise ValueError("peer_params and peer_w come with peer_xs")
    _check(enc_params, dec_params, proj_w, proj_b, past_n, t_out, context)
    enc, dec = _in_tier(enc_params, compute_dtype), _in_tier(dec_params, compute_dtype)
    pw, pb = proj_w.to(compute_dtype).contiguous(), _f32(proj_b)
    past_n, context = _f32(past_n), _f32(context)
    tensors = [past_n, context, pw, pb, *[t for p in enc + dec for t in p]]
    if not _on_card(past_n, [t for t in tensors if t is not None], "fused_serve"):
        return fused_serve_reference(enc, dec, pw, pb, past_n, t_out, context, compute_dtype=compute_dtype)
    out = _launch_serve(enc, dec, pw, pb, past_n, t_out, context, step_ctx=False,
                        compute_dtype=compute_dtype)
    count_launch(fused_serve, compute_dtype)
    return out


def _launch_serve(enc_params, dec_params, proj_w, proj_b, past_n, t_out, context, *, step_ctx,
                  compute_dtype):
    """Launch the serve kernel on checked CUDA tensors of the tier
    (:func:`_in_tier`): ``context`` None, (B, C), or with ``step_ctx``
    (B, t_out, C). Each phase's W is packed once a call (bf16:
    :func:`pack_weights`; f32: :func:`pack_weights_tf32`) and the block
    comes from :func:`serve_tc_rows` or :func:`serve_tf32_rows`."""
    batch, t_in, d = past_n.shape
    hidden, layers = proj_w.shape[0], len(enc_params)
    ctx_dim = 0 if context is None else context.shape[-1]
    if ctx_dim % 4:
        raise ValueError(f"the kernel reads the context as 16-byte rows: ctx_dim % 4 == 0, got {ctx_dim}")
    if compute_dtype == torch.bfloat16:
        geo = serve_tc_rows(hidden, layers, d, ctx_dim, step_ctx)
        w_enc, w_dec = [pack_weights(enc_params, d)], [pack_weights(dec_params, d)]
    else:
        geo = serve_tf32_rows(hidden, layers, d, ctx_dim, step_ctx)
        w_enc, w_dec = [pack_weights_tf32(enc_params, d)], [pack_weights_tf32(dec_params, d, ctx_dim)]
    c_glob = None if geo.c_smem else torch.empty(-(-batch // geo.rp) * layers * geo.rp * hidden,
                                                 device=past_n.device)
    out = torch.empty((batch, t_out, d), device=past_n.device, dtype=torch.float32)
    with torch.cuda.device(past_n.device):
        err = _library().fused_serve_launch(
            past_n.data_ptr(), None if context is None else context.data_ptr(), out.data_ptr(),
            _ptrs(w_enc), _ptrs([p.b for p in enc_params]), _ptrs(w_dec), _ptrs([p.b for p in dec_params]),
            proj_w.data_ptr(), proj_b.data_ptr(),
            batch, t_in, t_out, d, ctx_dim, hidden, layers, geo.rp, int(step_ctx),
            int(compute_dtype == torch.bfloat16), geo.mt, geo.warps, int(geo.w_res),
            None if c_glob is None else c_glob.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "fused_serve")
    return out


fused_serve.launches = fused_serve.launches_bf16 = 0


class TcGeom(NamedTuple):
    """A block of the bf16 kernels on the tensor cores
    (``csrc/lstm_mma.cuh``): ``rows_v`` viewers (the peer context; the
    encoder and the serve kernel: 0), ``rp`` rows in warp tiles of
    16·``mt`` rows x 32 / ``mt`` units, ``warps`` warps, the packed W
    resident in shared memory (``w_res``) or streamed from L2, c in shared
    memory (``c_smem``) or in device memory, the block's dynamic shared
    memory in bytes, and the peer context's staging of the f32 h in shared
    memory (``h_smem``) or in device memory."""
    rows_v: int
    rp: int
    mt: int
    warps: int
    w_res: bool
    c_smem: bool
    smem: int
    h_smem: bool = True


_TC_MAX_WARPS = 16  # the bf16 encoders' __launch_bounds__(512): 128 registers a thread
_SERVE_MAX_D = 4  # csrc/lstm_mma.cuh SERVE_MAX_D: coordinates a token of the bf16 serve kernel
_TC_MAX_ROWS = 256  # rows a block


def _tier(f32: bool):
    """A tier's z: (bytes an element, k-rows a k-step, z's row padding):
    bf16 on k16 steps, f32 (three-pass TF32) on k8 steps."""
    return (4, 8, 4) if f32 else (2, 16, 8)


def _tc_smem(peer: bool, rp: int, rows: int, d: int, hidden: int, layers: int, w_res: bool, c_smem: bool,
             f32: bool = False, h_smem: bool = True) -> int:
    """``lstm_mma::smem_bytes``: W (when resident), c (when in shared
    memory), z ([x padded to a k-step, h of every layer] a row, a 16-byte
    pad more; bf16 or, ``f32``, f32), and the staging (the peer context:
    f32 h of the ``rows`` real rows, when ``h_smem``, and their weights; the
    encoder: rows of H + 8)."""
    e, ks, pad = _tier(f32)
    kx = -(-d // ks) * ks
    w = sum(((kx if l == 0 else hidden) + hidden) * 4 * hidden * e for l in range(layers))
    s = (w if w_res else 0) + (4 * layers * rp * hidden if c_smem else 0) + e * rp * (kx + layers * hidden + pad)
    if peer:
        return s + (4 * rows * hidden if h_smem else 0) + -(-4 * rows // 16) * 16
    return s + e * rp * (hidden + 8)


# the layouts of a block, (W resident, c in shared memory), in the order
# they are preferred: W read from L2 once a call, not once a step for every
# 32 rows, outweighs c's rows x H x 8 bytes a layer-step
_TC_LAYOUTS = ((True, True), (True, False), (False, True), (False, False))


def _tc_choose(peer: bool, blocks, d: int, hidden: int, layers: int):
    """The first of ``blocks`` ((rows_v, rp, real rows), in the order
    preferred) in the first layout that fits; None if none does."""
    for w_res, c_smem in _TC_LAYOUTS:
        for rows_v, rp, rows in blocks:
            smem = _tc_smem(peer, rp, rows, d, hidden, layers, w_res, c_smem)
            if smem <= _SMEM_LIMIT:
                mt = 2 if rp % 32 == 0 else 1
                tiles = rp * hidden // 512
                rounds = -(-tiles // _TC_MAX_WARPS)  # tiles a warp: the fewest warps that take them in as few
                return TcGeom(rows_v, rp, mt, -(-tiles // rounds), w_res, c_smem, smem)
    return None


def _tc_top(hidden: int) -> int:
    """Rows a block aims at: 64, and up to 256 where H < 128, so that a
    block has about 16 warp tiles of 512 (row, unit) pairs."""
    return min(_TC_MAX_ROWS, max(64, 8192 // hidden))


def encode_tc_rows(hidden: int, layers: int, d: int) -> TcGeom:
    """The block of the bf16 encoder on the tensor cores: in the first
    layout that fits (``_TC_LAYOUTS``), the most rows, a power of two from
    :func:`_tc_top` down to 16. Raises for shapes the kernel does not take."""
    if hidden < 32 or hidden % 32:
        raise ValueError(f"the kernel needs hidden % 32 == 0, got {hidden}")
    if not 1 <= layers <= MAX_LAYERS:
        raise ValueError(f"the kernel takes 1..{MAX_LAYERS} layers, got {layers}")
    rps = [rp for rp in (256, 128, 64, 32, 16) if rp <= _tc_top(hidden)]
    geo = _tc_choose(False, [(0, rp, rp) for rp in rps], d, hidden, layers)
    if geo is None:
        raise ValueError(
            f"d={d}, hidden={hidden}, layers={layers}: the bf16 encoder's block of 16 rows keeps [x, h of every "
            f"layer] and a staging row in bf16, (ceil(d / 16)·16 + (layers + 1)·hidden + 8)·32 bytes, more than "
            f"{_SMEM_LIMIT} bytes of shared memory"
        )
    return geo


def peer_tc_rows(ctx_dim: int, n_peers: int, d: int) -> TcGeom:
    """The block of the bf16 peer context on the tensor cores: all K peers of
    ``rows_v`` viewers, padded up to whole tiles; in the first layout that
    fits (``_TC_LAYOUTS``), the most viewers (up to :func:`_tc_top` rows),
    32-row tiles before 16-row ones. Raises for shapes the kernel does not
    take: above 256 peers, or where one viewer's block does not fit."""
    if ctx_dim < 32 or ctx_dim % 32:
        raise ValueError(f"the peer kernels need ctx_dim % 32 == 0, got {ctx_dim}")
    if not 1 <= n_peers <= _TC_MAX_ROWS:
        raise ValueError(f"the bf16 peer context holds all K peers of a viewer in one block of at most "
                         f"{_TC_MAX_ROWS} rows: K = {n_peers} peers is more than it takes")
    blocks = [(rv, -(-rv * n_peers // tile) * tile, rv * n_peers)
              for rv in range(max(1, _tc_top(ctx_dim) // n_peers), 0, -1) for tile in (32, 16)]
    geo = _tc_choose(True, blocks, d, ctx_dim, 1)
    if geo is None:
        raise ValueError(
            f"d={d}, ctx_dim={ctx_dim}: one viewer's K = {n_peers} peers do not fit the bf16 peer context's "
            f"block of {_SMEM_LIMIT} bytes of shared memory"
        )
    return geo


def _serve_smem(rp: int, d: int, ctx_dim: int, hidden: int, layers: int, w_res: bool, c_smem: bool,
                step_ctx: bool, f32: bool = False) -> int:
    """``lstm_mma::serve_smem_bytes``: W (when resident: the larger
    phase's packed W), c (when in shared memory), z ([x or y padded to a
    k-step | ctx padded to a k-step | h of every layer] a row, a 16-byte pad
    more; bf16 or, ``f32``, f32), the staging of the new h (rows of H + 8),
    proj_w in f32 and, in the lockstep tier, ctx_t+1 in f32."""
    e, ks, pad = _tier(f32)
    kx, cp = -(-d // ks) * ks, -(-ctx_dim // ks) * ks

    def phase(k_in0):
        return (k_in0 + hidden + (layers - 1) * 2 * hidden) * 4 * hidden * e

    s = max(phase(kx), phase(kx + cp)) if w_res else 0
    s += 4 * layers * rp * hidden if c_smem else 0
    s += e * rp * (kx + cp + layers * hidden + pad) + e * rp * (hidden + 8) + 4 * d * hidden
    return s + (4 * rp * ctx_dim if step_ctx else 0)


def serve_tc_rows(hidden: int, layers: int, d: int, ctx_dim: int = 0, step_ctx: bool = False, *,
                  rows: int = 0) -> TcGeom:
    """The block of the bf16 serve kernel on the tensor cores
    (``csrc/lstm_mma.cuh`` server): the most rows, a power of two from
    :func:`_tc_top` down to 16 (``rows``: that many only), in the first
    layout that fits at that many (``_TC_LAYOUTS``: W resident, then c in
    shared memory), in warp tiles of 32 rows (16 at 16 rows: MT = 1). Rows
    come first: a block of fewer rows has fewer warps, and one block an SM
    (the encoders' chooser puts W's residency first). Raises for shapes the
    kernel does not take: hidden not a multiple of 32, more than 8 layers,
    a context not of whole k16 steps, more than 4 coordinates a token, or a
    block of the fewest rows past a block's shared memory."""
    if hidden < 32 or hidden % 32:
        raise ValueError(f"the bf16 serve kernel needs hidden % 32 == 0, got {hidden}")
    if not 1 <= layers <= MAX_LAYERS:
        raise ValueError(f"the bf16 serve kernel takes 1..{MAX_LAYERS} layers, got {layers}")
    if ctx_dim % 16:
        raise ValueError(f"the bf16 serve kernel holds the context in whole k16 steps: ctx_dim % 16 == 0, "
                         f"got {ctx_dim}")
    if not 1 <= d <= _SERVE_MAX_D:
        raise ValueError(f"the bf16 serve kernel takes 1..{_SERVE_MAX_D} coordinates a token, got d={d}")
    rps = [rows] if rows else [rp for rp in (256, 128, 64, 32, 16) if rp <= _tc_top(hidden)]
    if any(rp not in (256, 128, 64, 32, 16) for rp in rps):
        raise ValueError(f"the bf16 serve kernel takes blocks of 16, 32, 64, 128 or 256 rows, got {rows}")
    for rp in rps:
        for w_res, c_smem in _TC_LAYOUTS:
            smem = _serve_smem(rp, d, ctx_dim, hidden, layers, w_res, c_smem, step_ctx)
            if smem <= _SMEM_LIMIT:
                tiles = rp * hidden // 512
                rounds = -(-tiles // _TC_MAX_WARPS)
                return TcGeom(0, rp, 2 if rp % 32 == 0 else 1, -(-tiles // rounds), w_res, c_smem, smem)
    least = _serve_smem(min(rps), d, ctx_dim, hidden, layers, False, False, step_ctx)
    raise ValueError(
        f"d={d}, ctx_dim={ctx_dim}, hidden={hidden}, layers={layers}: the bf16 serve kernel's block of "
        f"{min(rps)} rows needs {least} bytes of shared memory with W and c in device memory, more than "
        f"{_SMEM_LIMIT}"
    )


_TF32_ROWS = (256, 128, 64, 32)  # rows a block, whole 32-row tiles


def _tf32_geom(rows_v: int, rp: int, hidden: int, c_smem: bool, smem: int, step_ctx: bool = False) -> TcGeom:
    """A block of the f32 bodies (``csrc/lstm_mma.cuh`` BodyTile): warp
    tiles of 32 rows x 8 units on up to 16 warps of 128 registers, but in
    the lockstep serve kernel (``step_ctx``) 64 rows x 8 units (32 x 16 in
    a 32-row block) on up to 8 warps of 255 registers; as few rounds of
    tiles as the warps take and no warp more; W always streamed."""
    pairs, max_warps = (512, 8) if step_ctx else (256, 16)
    tiles = rp * hidden // pairs
    rounds = -(-tiles // max_warps)
    return TcGeom(rows_v, rp, 4 if step_ctx and rp % 64 == 0 else 2, -(-tiles // rounds), False, c_smem, smem)


def serve_tf32_rows(hidden: int, layers: int, d: int, ctx_dim: int = 0, step_ctx: bool = False, *,
                    rows: int = 0) -> TcGeom:
    """The block of the f32 serve kernel on three-pass TF32
    (``csrc/lstm_mma.cuh`` server with Tf32Mma), also that of
    :func:`fused_decode`: the most rows from :func:`_tc_top` down to 32
    (``rows``: that many only), c in shared memory where it fits beside z,
    else in device memory; W streams from L2 (no phase's f32 W fits a block
    beside its state). The context is padded to whole k8 steps. Raises for
    shapes the kernel does not take: hidden not a multiple of 32, more than
    8 layers, a context not of whole 16-byte pieces, more than 4
    coordinates a token, or a block of 32 rows past a block's shared
    memory."""
    if hidden < 32 or hidden % 32:
        raise ValueError(f"the f32 serve kernel needs hidden % 32 == 0, got {hidden}")
    if not 1 <= layers <= MAX_LAYERS:
        raise ValueError(f"the f32 serve kernel takes 1..{MAX_LAYERS} layers, got {layers}")
    if ctx_dim < 0 or ctx_dim % 4:
        raise ValueError(f"the f32 serve kernel reads the context as 16-byte rows: ctx_dim % 4 == 0, got {ctx_dim}")
    if not 1 <= d <= _SERVE_MAX_D:
        raise ValueError(f"the f32 serve kernel takes 1..{_SERVE_MAX_D} coordinates a token, got d={d}")
    rps = [rows] if rows else [rp for rp in _TF32_ROWS if rp <= _tc_top(hidden)]
    if any(rp not in _TF32_ROWS for rp in rps):
        raise ValueError(f"the f32 serve kernel takes blocks of 32, 64, 128 or 256 rows, got {rows}")
    for rp in rps:
        for c_smem in (True, False):
            smem = _serve_smem(rp, d, ctx_dim, hidden, layers, False, c_smem, step_ctx, f32=True)
            if smem <= _SMEM_LIMIT:
                return _tf32_geom(0, rp, hidden, c_smem, smem, step_ctx)
    least = _serve_smem(min(rps), d, ctx_dim, hidden, layers, False, False, step_ctx, f32=True)
    raise ValueError(
        f"d={d}, ctx_dim={ctx_dim}, hidden={hidden}, layers={layers}: the f32 serve kernel's block of "
        f"{min(rps)} rows needs {least} bytes of shared memory with c in device memory, more than {_SMEM_LIMIT}"
    )


# the layouts of an f32 peer context block, (c in shared memory, the staging of
# h in shared memory), in the order they are preferred
_TF32_PEER_LAYOUTS = ((True, True), (False, True), (True, False), (False, False))
_MAX_PEERS = _TC_MAX_ROWS  # a viewer's K peers in one block of at most 256 rows


def peer_tf32_rows(ctx_dim: int, n_peers: int, d: int, *, rows: int = 0) -> TcGeom:
    """The block of the f32 peer context on three-pass TF32
    (``csrc/lstm_mma.cuh`` encoder with Tf32Mma): all K peers of
    ``rows_v`` viewers, padded up to whole 32-row tiles, the most viewers
    up to :func:`_tc_top` rows (``rows`` = 32: one tile), and past that as
    many rows as one viewer's K peers need (K = 65..256: 96 to 256 rows);
    in the first layout of ``_TF32_PEER_LAYOUTS`` that fits: c in shared
    memory where it fits, else in device memory, and the staging of the f32
    h likewise (at C = 128: c from 129 rows, the staging from 208); W streams
    from L2. Raises for shapes the kernel does not take: ctx_dim not one of
    32, 64, 96, 128, K outside 1..256, or one viewer's block past a block's
    shared memory with c and the staging in device memory."""
    if ctx_dim not in (32, 64, 96, 128):
        raise ValueError(f"the f32 peer context takes ctx_dim 32, 64, 96 or 128, got {ctx_dim}")
    if not 1 <= n_peers <= _MAX_PEERS:
        raise ValueError(f"the f32 peer context holds all K peers of a viewer in one block of at most "
                         f"{_MAX_PEERS} rows: K = {n_peers} peers is more than it takes")
    if rows not in (0, 32):
        raise ValueError(f"the f32 peer context picks its own blocks, or 32 rows, got {rows}")
    top = 32 if rows else _tc_top(ctx_dim) // 32 * 32
    for rv in range(max(1, top // n_peers), 0, -1):
        rp = -(-rv * n_peers // 32) * 32
        for c_smem, h_smem in _TF32_PEER_LAYOUTS:
            smem = _tc_smem(True, rp, rv * n_peers, d, ctx_dim, 1, False, c_smem, f32=True, h_smem=h_smem)
            if smem <= _SMEM_LIMIT:
                return _tf32_geom(rv, rp, ctx_dim, c_smem, smem)._replace(h_smem=h_smem)
    rp = -(-n_peers // 32) * 32
    raise ValueError(f"d={d}, ctx_dim={ctx_dim}: one viewer's K = {n_peers} peers need "
                     f"{_tc_smem(True, rp, n_peers, d, ctx_dim, 1, False, False, f32=True, h_smem=False)} bytes "
                     f"of shared memory in the f32 peer context's block of {rp} rows, with c and the staging in "
                     f"device memory, more than {_SMEM_LIMIT}")


def encode_tf32_rows(hidden: int, layers: int, d: int) -> TcGeom:
    """The block of the f32 encoder on three-pass TF32 (``csrc/lstm_mma.cuh``
    encoder with Tf32Mma, the f32 peer context's body without the context):
    the most rows, a power of two from :func:`_tc_top` down to 32, c in
    shared memory where it fits beside z and the staging, else in device
    memory; W streams from L2. Raises for shapes the kernel does not take:
    hidden not a multiple of 32, more than 8 layers, or a block of 32 rows
    past a block's shared memory."""
    if hidden < 32 or hidden % 32:
        raise ValueError(f"the f32 encoder needs hidden % 32 == 0, got {hidden}")
    if not 1 <= layers <= MAX_LAYERS:
        raise ValueError(f"the f32 encoder takes 1..{MAX_LAYERS} layers, got {layers}")
    if d < 1:
        raise ValueError(f"the f32 encoder needs d >= 1 coordinates a token, got d={d}")
    rps = [rp for rp in _TF32_ROWS if rp <= _tc_top(hidden)]
    for rp in rps:
        for c_smem in (True, False):
            smem = _tc_smem(False, rp, rp, d, hidden, layers, False, c_smem, f32=True)
            if smem <= _SMEM_LIMIT:
                return _tf32_geom(0, rp, hidden, c_smem, smem)
    raise ValueError(
        f"d={d}, hidden={hidden}, layers={layers}: the f32 encoder's block of 32 rows keeps [x, h of every layer] "
        f"and a staging row in f32, {_tc_smem(False, 32, 32, d, hidden, layers, False, False, f32=True)} bytes of "
        f"shared memory with c in device memory, more than {_SMEM_LIMIT}"
    )


@functools.cache
def _pack_index(k_rows: int, hidden: int, device: torch.device) -> torch.Tensor:
    """Where each element of one layer's packed W comes from: flat indices
    into its (k_rows, 4H) W (k_rows a multiple of 16), in the order
    ``csrc/lstm_mma.cuh`` reads it. mma.sync m16n8k16's B fragment of lane
    (g, t) = (lane // 4, lane % 4) is b0 = W[2t, 2t + 1] and b1 = W[2t + 8,
    2t + 9] of the k16 step at column g of the n8 tile; packed n-tile j holds
    gate j % 4's columns of unit block j // 4 (i, f, g, o of 8 units in a
    row). Per k16 step, pair p of n-tiles and lane: 8 bf16 {b0, b1 of tile
    2p, b0, b1 of tile 2p + 1}, 16 bytes."""
    ks = torch.arange(k_rows // 16).view(-1, 1, 1, 1)
    pair = torch.arange(hidden // 4).view(1, -1, 1, 1)
    lane = torch.arange(32).view(1, 1, -1, 1)
    e = torch.arange(8).view(1, 1, 1, -1)
    k = 16 * ks + 2 * (lane % 4) + (e & 1) + 8 * ((e >> 1) & 1)
    j = 2 * pair + (e >> 2)
    col = (j % 4) * hidden + 8 * (j // 4) + lane // 4
    return (k * 4 * hidden + col).reshape(-1).to(device)


def pack_weights(params: Sequence[LSTMParams], d: int, ctx_dim: int = 0) -> torch.Tensor:
    """Every layer's W, bf16, in the tensor-core kernels' B layout
    (:func:`_pack_index`), one flat array, layer after layer; layer 0's
    first ``d`` rows (x, or the serve decoder's y) padded with zero rows to
    a whole k16 step, then its ``ctx_dim`` context rows (the decoders')
    padded likewise, then h's."""
    hidden = params[0].w.shape[1] // 4
    kx, cp = -(-d // 16) * 16, -(-ctx_dim // 16) * 16
    out = []
    for l, p in enumerate(params):
        w = p.w.to(torch.bfloat16)
        if l == 0:
            zeros = w.new_zeros
            w = torch.cat([w[:d], zeros((kx - d, 4 * hidden)), w[d:d + ctx_dim], zeros((cp - ctx_dim, 4 * hidden)),
                           w[d + ctx_dim:]])
        out.append(w.reshape(-1)[_pack_index(w.shape[0], hidden, w.device)])
    return torch.cat(out)


@functools.cache
def _pack_index_tf32(k_rows: int, hidden: int, device: torch.device) -> torch.Tensor:
    """Where each element of one layer's packed W of the f32 tier comes
    from: flat indices into its (k_rows, 4H) W (k_rows a multiple of 8), in
    the order ``csrc/lstm_mma.cuh``'s product_tf32 reads it. mma.sync
    m16n8k8's TF32 B fragment of lane (g, t) = (lane // 4, lane % 4) is
    b0 = W[t] and b1 = W[t + 4] of the k8 step at column g of the n8 tile;
    packed n-tile j holds gate j % 4's columns of unit block j // 4, as in
    :func:`_pack_index`. Per k8 step, pair p of n-tiles and lane: 4 f32
    {b0, b1 of tile 2p, b0, b1 of tile 2p + 1}, 16 bytes."""
    ks = torch.arange(k_rows // 8).view(-1, 1, 1, 1)
    pair = torch.arange(hidden // 4).view(1, -1, 1, 1)
    lane = torch.arange(32).view(1, 1, -1, 1)
    e = torch.arange(4).view(1, 1, 1, -1)
    k = 8 * ks + lane % 4 + 4 * (e & 1)
    j = 2 * pair + (e >> 1)
    col = (j % 4) * hidden + 8 * (j // 4) + lane // 4
    return (k * 4 * hidden + col).reshape(-1).to(device)


def pack_weights_tf32(params: Sequence[LSTMParams], d: int, ctx_dim: int = 0) -> torch.Tensor:
    """Every layer's W, f32, in the f32 tier's B layout
    (:func:`_pack_index_tf32`), one flat array, layer after layer; layer
    0's first ``d`` rows (x, or the serve decoder's y) padded with zero rows
    to a whole k8 step, then its ``ctx_dim`` context rows (the serve
    decoder's) padded likewise, then h's."""
    hidden = params[0].w.shape[1] // 4
    kx, cp = -(-d // 8) * 8, -(-ctx_dim // 8) * 8
    out = []
    for l, p in enumerate(params):
        w = p.w.float()
        if l == 0:
            zeros = w.new_zeros
            w = torch.cat([w[:d], zeros((kx - d, 4 * hidden)), w[d:d + ctx_dim], zeros((cp - ctx_dim, 4 * hidden)),
                           w[d + ctx_dim:]])
        out.append(w.reshape(-1)[_pack_index_tf32(w.shape[0], hidden, w.device)])
    return torch.cat(out)


def peer_context(peer_params: LSTMParams, peer_xs: torch.Tensor,
                 peer_w: torch.Tensor, *, compute_dtype=torch.float32) -> torch.Tensor:
    """The lockstep tier's peer encoders in one kernel launch: the shared
    cell over the peer futures ``peer_xs`` (B, K, T, D) from zero state, and
    after every step the mask-weighted mean of the K hidden states →
    ctx (B, T, C) f32, summed from the unrounded h in both tiers; the
    products in ``compute_dtype``."""
    check_compute(compute_dtype)
    if peer_xs.dim() != 4 or min(peer_xs.shape) < 1:
        raise ValueError(f"peer_xs must be a non-empty (B, K, T, D), got {tuple(peer_xs.shape)}")
    batch, k, t_len, d = peer_xs.shape
    c = peer_params.w.shape[1] // 4
    _check_tensors([(peer_xs, (batch, k, t_len, d)), (peer_w, (batch, k)),
                    (peer_params.w, (d + c, 4 * c)), (peer_params.b, (4 * c,))], peer_xs.device)
    (peer_params,), peer_xs, peer_w = _in_tier([peer_params], compute_dtype), _f32(peer_xs), _f32(peer_w)
    if not _on_card(peer_xs, [peer_xs, peer_w, *peer_params], "peer_context"):
        return peer_context_reference(peer_params, peer_xs, peer_w, compute_dtype)
    out = launch_peer_context(_library(), peer_params, peer_xs, peer_w, compute_dtype)
    count_launch(peer_context, compute_dtype)
    return out


def peer_scratch(geo: TcGeom, batch: int, n_peers: int, ctx_dim: int, device):
    """The device memory of a peer block that does not keep c or the staging
    of h in shared memory (None where it does): c (grid x rp x C floats)
    and the staging (grid x rows_v·K x C floats), a grid of one block per
    ``rows_v`` viewers."""
    grid = -(-batch // geo.rows_v)
    c_glob = None if geo.c_smem else torch.empty(grid * geo.rp * ctx_dim, device=device)
    h_glob = None if geo.h_smem else torch.empty(grid * geo.rows_v * n_peers * ctx_dim, device=device)
    return c_glob, h_glob


def _ptr(t):
    return None if t is None else t.data_ptr()


def launch_peer_context(lib, peer_params: LSTMParams, peer_xs, peer_w, compute_dtype) -> torch.Tensor:
    """Launch the peer-context kernel of ``lib`` (a build of
    ``csrc/fused_serve.cu``: the kernels' own, or a probe build) on checked
    CUDA tensors of the tier → ctx (B, T, C); not counted. W is packed once
    a call (bf16: :func:`pack_weights`; f32: :func:`pack_weights_tf32`) and
    the block comes from :func:`peer_tc_rows` or :func:`peer_tf32_rows`."""
    batch, k, t_len, d = peer_xs.shape
    c = peer_params.w.shape[1] // 4
    if batch * k * t_len >= 2**31:
        raise ValueError(f"B·K·T = {batch * k * t_len} does not fit the kernel's 32-bit row index")
    out = torch.empty((batch, t_len, c), device=peer_xs.device, dtype=torch.float32)
    if compute_dtype == torch.bfloat16:
        geo, w = peer_tc_rows(c, k, d), pack_weights([peer_params], d)
    else:
        geo, w = peer_tf32_rows(c, k, d), pack_weights_tf32([peer_params], d)
    c_glob, h_glob = peer_scratch(geo, batch, k, c, peer_xs.device)
    with torch.cuda.device(peer_xs.device):
        err = lib.peer_context_launch(
            peer_xs.data_ptr(), peer_w.data_ptr(), out.data_ptr(), w.data_ptr(), peer_params.b.data_ptr(),
            batch, k, t_len, d, c, geo.rows_v, int(compute_dtype == torch.bfloat16), geo.rp, geo.mt, geo.warps,
            int(geo.w_res), _ptr(c_glob), _ptr(h_glob), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "peer_context")
    return out


peer_context.launches = peer_context.launches_bf16 = 0


def fused_serve_peers(
    enc_params: Sequence[LSTMParams],
    dec_params: Sequence[LSTMParams],
    proj_w: torch.Tensor,
    proj_b: torch.Tensor,
    past_n: torch.Tensor,
    t_out: int,
    peer_params: LSTMParams,
    peer_xs: torch.Tensor,  # (B, K, t_out, D) peer futures
    peer_w: torch.Tensor,  # (B, K) mask weights
    *,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """The lockstep-peer tier of :func:`fused_serve` → (B, t_out, D): on the
    card two launches, :func:`peer_context` (ctx (B, t_out, C), f32) and the
    serve kernel with that per-step context, reloaded every decoder step
    (``csrc/fused_serve.cu`` says why the tier is split in two); in the bf16
    ``compute_dtype`` both kernels' products round their operands, ctx_t
    where the decoder's product reads it."""
    check_compute(compute_dtype)
    if peer_params is None or peer_w is None:
        raise ValueError("the lockstep tier needs peer_params, peer_xs and peer_w")
    if peer_xs.dim() != 4 or peer_xs.shape[2] != t_out:
        raise ValueError(
            f"lockstep peer windows must span t_out={t_out} steps, got "
            f"{tuple(peer_xs.shape)}"
        )
    ctx_dim = peer_params.w.shape[1] // 4
    # the decoder's weights take [y, ctx]: check them against a (B, C) stand-in
    stand_in = torch.empty((past_n.shape[0], ctx_dim), device=past_n.device)
    _check(enc_params, dec_params, proj_w, proj_b, past_n, t_out, stand_in)
    enc, dec = _in_tier(enc_params, compute_dtype), _in_tier(dec_params, compute_dtype)
    pw, pb, past_n = proj_w.to(compute_dtype).contiguous(), _f32(proj_b), _f32(past_n)
    if not _on_card(past_n, [past_n, pw, pb, *[t for p in enc + dec for t in p]], "fused_serve_peers"):
        (peer,) = _in_tier([peer_params], compute_dtype)
        return fused_serve_reference(enc, dec, pw, pb, past_n, t_out, peer_params=peer,
                                     peer_xs=_f32(peer_xs), peer_w=_f32(peer_w), compute_dtype=compute_dtype)
    ctx = peer_context(peer_params, peer_xs, peer_w, compute_dtype=compute_dtype)
    out = _launch_serve(enc, dec, pw, pb, past_n, t_out, ctx, step_ctx=True, compute_dtype=compute_dtype)
    count_launch(fused_serve_peers, compute_dtype)
    return out


fused_serve_peers.launches = fused_serve_peers.launches_bf16 = 0


def fused_encode(
    params: Sequence[LSTMParams],
    xs: torch.Tensor,  # (B, T, D)
    *,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """Whole-sequence L-layer LSTM encode from zero state → the final
    top-layer hidden state (B, H) f32, in one kernel launch; nothing is
    saved per step (inference only: ``ops.lstm_train.lstm_seq`` is the
    differentiable path). Same shapes and semantics as the JAX
    ``fused_encode``: in the bf16 ``compute_dtype`` the products round their
    operands and the h returned is the rounded one, widened to f32."""
    check_compute(compute_dtype)
    if xs.dim() != 3 or min(xs.shape) < 1 or not params:
        raise ValueError(f"xs must be a non-empty (B, T, D) with >= 1 layer, got {tuple(xs.shape)}")
    batch, t_len, d = xs.shape
    hidden, layers = params[0].w.shape[1] // 4, len(params)
    expect = [(xs, (batch, t_len, d))]
    for l, p in enumerate(params):
        in_l = d if l == 0 else hidden
        expect += [(p.w, (in_l + hidden, 4 * hidden)), (p.b, (4 * hidden,))]
    _check_tensors(expect, xs.device)
    params, xs = _in_tier(params, compute_dtype), _f32(xs)
    if not _on_card(xs, [xs, *[t for p in params for t in p]], "fused_encode"):
        return fused_encode_reference(params, xs, compute_dtype)
    out = launch_encode(_library(), params, xs, compute_dtype)
    count_launch(fused_encode, compute_dtype)
    return out


def launch_encode(lib, params: Sequence[LSTMParams], xs, compute_dtype) -> torch.Tensor:
    """Launch the encode kernel of ``lib`` (as :func:`launch_peer_context`)
    on checked CUDA tensors of the tier → the final top-layer h (B, H); not
    counted. W is packed once a call (bf16: :func:`pack_weights`; f32:
    :func:`pack_weights_tf32`) and the block comes from
    :func:`encode_tc_rows` or :func:`encode_tf32_rows`."""
    batch, t_len, d = xs.shape
    hidden, layers = params[0].w.shape[1] // 4, len(params)
    out = torch.empty((batch, hidden), device=xs.device, dtype=torch.float32)
    if compute_dtype == torch.bfloat16:
        geo, w = encode_tc_rows(hidden, layers, d), pack_weights(params, d)
    else:
        geo, w = encode_tf32_rows(hidden, layers, d), pack_weights_tf32(params, d)
    c_glob = None if geo.c_smem else torch.empty(-(-batch // geo.rp) * layers * geo.rp * hidden, device=xs.device)
    with torch.cuda.device(xs.device):
        err = lib.fused_encode_launch(
            xs.data_ptr(), out.data_ptr(), _ptrs([w]), _ptrs([p.b for p in params]),
            batch, t_len, d, hidden, layers, geo.rp, int(compute_dtype == torch.bfloat16), geo.mt, geo.warps,
            int(geo.w_res), None if c_glob is None else c_glob.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "fused_encode")
    return out


fused_encode.launches = fused_encode.launches_bf16 = 0


def fused_decode(
    dec_params: Sequence[LSTMParams],
    proj_w: torch.Tensor,
    proj_b: torch.Tensor,
    h0: torch.Tensor,  # (L, B, H) encoder final hidden per layer
    c0: torch.Tensor,  # (L, B, H)
    y0: torch.Tensor,  # (B, D) last observed position
    t_out: int,
    *,
    context=None,  # (B, C) static context
) -> torch.Tensor:
    """Whole-horizon autoregressive decode from given states → (B, t_out, D)
    f32, in one kernel launch: the f32 serve kernel's decoder on three-pass
    TF32, its W packed by :func:`pack_weights_tf32` and its block from
    :func:`serve_tf32_rows`. Same shapes and
    semantics as the JAX ``fused_decode`` (its ``tile_b`` is a TPU tiling
    knob and has no counterpart); bf16 tensors (a ``--bf16`` model's
    weights) are widened to f32, as the TPU kernel's f32 dot widens them.
    No backward, as the TPU kernel has none: an input that requires grad
    raises on both devices."""
    if h0.dim() != 3 or y0.dim() != 2 or min(h0.shape) < 1 or t_out < 1:
        raise ValueError(f"expected h0, c0 (L, B, H), y0 (B, D) and t_out >= 1, got {tuple(h0.shape)}, "
                         f"{tuple(y0.shape)} and {t_out}")
    layers, batch, hidden = h0.shape
    d = y0.shape[1]
    ctx_dim = 0 if context is None else context.shape[-1]
    if len(dec_params) != layers:
        raise ValueError(f"{len(dec_params)} decoder layers and states of {layers}")
    refuse_grad([h0, c0, y0, context, proj_w, proj_b, *[t for p in dec_params for t in p]], "fused_decode",
                "models.seq2seq.apply")
    expect = [(h0, (layers, batch, hidden)), (c0, (layers, batch, hidden)), (y0, (batch, d)),
              (proj_w, (hidden, d)), (proj_b, (d,))]
    for l, p in enumerate(dec_params):
        in_l = d + ctx_dim if l == 0 else hidden
        expect += [(p.w, (in_l + hidden, 4 * hidden)), (p.b, (4 * hidden,))]
    if context is not None:
        expect.append((context, (batch, ctx_dim)))
    _check_tensors(expect, y0.device)
    dec_params = _in_tier(dec_params, torch.float32)
    h0, c0, y0, context, proj_w, proj_b = (_f32(t) for t in (h0, c0, y0, context, proj_w, proj_b))
    # the kernel reads h0, c0, the context, W and b as 8- or 16-byte vectors, y0 by element
    vectors = [h0, c0, *([] if context is None else [context]), *[t for p in dec_params for t in p]]
    if not _on_card(y0, vectors, "fused_decode"):
        return fused_decode_reference(dec_params, proj_w, proj_b, h0, c0, y0, t_out, context)
    geo = serve_tf32_rows(hidden, layers, d, ctx_dim)
    w = pack_weights_tf32(dec_params, d, ctx_dim)
    c_glob = None if geo.c_smem else torch.empty(-(-batch // geo.rp) * layers * geo.rp * hidden, device=y0.device)
    out = torch.empty((batch, t_out, d), device=y0.device, dtype=torch.float32)
    with torch.cuda.device(y0.device):
        err = _library().fused_decode_f32(
            h0.data_ptr(), c0.data_ptr(), y0.data_ptr(), None if context is None else context.data_ptr(),
            out.data_ptr(), _ptrs([w]), _ptrs([p.b for p in dec_params]), proj_w.data_ptr(), proj_b.data_ptr(),
            batch, t_out, d, ctx_dim, hidden, layers, geo.rp, geo.mt, geo.warps, int(geo.w_res),
            None if c_glob is None else c_glob.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "fused_decode")
    fused_decode.launches += 1
    return out


fused_decode.launches = 0


# csrc/lstm_mma.cuh: CELL_STAGES chunks of the ring, CELL_KC k-rows a
# chunk, CELL_ROWS rows a streamed block; CellTile's units (32 rows x 8
# units in f32, x 16 in bf16), by tier (bf16: True)
_CELL_STAGES, _CELL_KC, _CELL_ROWS = 4, 32, 128
_CELL_TILE_UNITS = {False: 8, True: 16}
# cell_block's candidate blocks with W resident, (rows, units) in the order
# tried, and the units of a block that streams W
_CELL_RESIDENT = {False: ((64, 64), (128, 32)), True: ((128, 64),)}
_CELL_STREAMED_UNITS = {False: 32, True: 64}
_CELL_MAX_UNIT_BLOCKS = 65535  # the grid's y dimension
_SM_REGS, _SM_SMEM = 65536, 233472  # an SM's registers and shared memory (1 KB of it a block's)


class CellGeom(NamedTuple):
    """A block of the cell kernel: ``rows`` x ``units`` of H (all four gates
    of each), ``warps`` warps, W's columns of the block resident in shared
    memory (``w_res``: the block takes many row tiles) or streamed with z,
    ``smem`` bytes of dynamic shared memory."""
    rows: int
    units: int
    warps: int
    w_res: bool
    smem: int


def _cell_chunks(d_in: int, hidden: int, bf16: bool) -> int:
    ks = 16 if bf16 else 8
    return -(-(-(-d_in // ks) + -(-hidden // ks)) // (_CELL_KC // ks))


def cell_geom(rows: int, units: int, w_res: bool, d_in: int, hidden: int, bf16: bool) -> CellGeom:
    """``lstm_mma::cell_geom``: a warp a tile of 32 rows x 8 (f32) or 16
    (bf16) units; shared memory the ring's stages, each z's chunk (rows x 32
    k-columns, a 16-byte pad more a row) and, W streamed, W's (32 k-rows x
    4·units, 8 elements more a row), then, W resident, W's columns of the
    block for every chunk."""
    e = 2 if bf16 else 4
    ldw = 4 * units + 8
    ring = _CELL_STAGES * (rows * (_CELL_KC + 16 // e) + (0 if w_res else _CELL_KC * ldw))
    wr = _cell_chunks(d_in, hidden, bf16) * _CELL_KC * ldw if w_res else 0
    return CellGeom(rows, units, rows // 32 * (units // _CELL_TILE_UNITS[bf16]), w_res, e * (ring + wr))


@functools.lru_cache(maxsize=256)
def cell_block(d_in: int, hidden: int, bf16: bool) -> CellGeom:
    """The cell kernel's block (``lstm_mma::cell_block``, which it mirrors):
    W's columns of the block resident in the first candidate of 16 warps
    (f32: 64 rows x 64 units, then 128 x 32; bf16: 128 x 64; units no more
    than hidden rounded up to whole warp tiles) whose shared memory holds
    them, the block then taking many row tiles (:func:`cell_grid`); else W
    streamed with z through the ring in blocks of 128 rows x 32 (f32) or 64
    (bf16) units. z streams in k-chunks, so every D_in and hidden is taken
    (a ValueError names a shape that is not)."""
    if d_in < 1 or hidden < 1:
        raise ValueError(f"the cell kernel takes D_in >= 1 and hidden >= 1, got D_in={d_in}, hidden={hidden}")
    whole = -(-hidden // _CELL_TILE_UNITS[bf16]) * _CELL_TILE_UNITS[bf16]
    for rows, units in _CELL_RESIDENT[bf16]:
        geo = cell_geom(rows, min(units, whole), True, d_in, hidden, bf16)
        if geo.smem <= _SMEM_LIMIT:
            break
    else:
        geo = cell_geom(_CELL_ROWS, min(_CELL_STREAMED_UNITS[bf16], whole), False, d_in, hidden, bf16)
    if -(-hidden // geo.units) > _CELL_MAX_UNIT_BLOCKS:
        raise ValueError(f"hidden={hidden}: more than {_CELL_MAX_UNIT_BLOCKS} unit blocks of {geo.units}")
    return geo


def cell_grid(geo: CellGeom, batch: int, hidden: int, sms: int) -> int:
    """Blocks along the batch: every row tile its own where W streams;
    with W resident, as many as the ``sms`` SMs hold at once (at 128
    registers a thread, the kernel's bound) for each unit block, each
    taking every so many row tiles."""
    tiles = -(-batch // geo.rows)
    if not geo.w_res:
        return tiles
    per_sm = min(_SM_REGS // (32 * geo.warps * 128), _SM_SMEM // (geo.smem + 1024))
    return max(1, min(tiles, sms * per_sm // -(-hidden // geo.units)))


def cell_k_steps(d_in: int, hidden: int, bf16: bool) -> list:
    """The k-steps of the cell's ring (k8 in f32, k16 in bf16; CELL_KC = 32
    k-rows, 4 or 2 steps, a chunk), in order: (the z part, "x" or "h", its
    first column, the columns it holds, W's first row). x's steps come
    first, its last one's columns past D_in zeros in the stage (as W's rows
    past them are), then h's, padded likewise; W's rows are x's, then
    D_in + h's."""
    ks = 16 if bf16 else 8
    return ([("x", ks * s, min(ks, d_in - ks * s), ks * s) for s in range(-(-d_in // ks))]
            + [("h", ks * s, min(ks, hidden - ks * s), d_in + ks * s) for s in range(-(-hidden // ks))])


def cell_w_columns(hidden: int, units: int, block: int) -> torch.Tensor:
    """W's column behind each of the 4·units columns of unit block
    ``block``'s stage (gate q of its units u at q·units + u: W's column
    q·hidden + block·units + u), -1 for a zero column (a unit past H)."""
    u = torch.arange(units) + block * units
    cols = torch.arange(4)[:, None] * hidden + u
    return torch.where(u < hidden, cols, torch.full_like(cols, -1)).flatten()


def fused_lstm_cell(params: LSTMParams, x: torch.Tensor, state):
    """Drop-in for ``models.cell.lstm_cell`` (the JAX signature: ``(params,
    x, (h, c)) → (h, c)``): one LSTM step, in one kernel launch on CUDA
    tensors, ``lstm_cell`` itself on CPU tensors. ``x, h, c, W, b`` are all
    f32 or, on a bf16 model, all bf16: then the gates and the new c are f32
    sums of exact products, and h and c are written in bf16, as the TPU
    kernel writes them in the inputs' dtypes (so the c carry is rounded,
    unlike the serve kernel's). Both tiers run on the tensor cores, f32 in
    three-pass TF32, in blocks of :func:`cell_block` on a grid of row and
    unit blocks (:func:`cell_grid`), W read as stored (:func:`cell_k_steps`,
    :func:`cell_w_columns`); any D_in and hidden. No backward, as the TPU
    kernel has none: an input that requires grad raises on both devices."""
    h, c = state
    if x.dim() != 2 or h.dim() != 2 or min(*x.shape, *h.shape) < 1:
        raise ValueError(f"expected x (B, D) and h, c (B, H), got {tuple(x.shape)} and {tuple(h.shape)}")
    batch, d_in = x.shape
    hidden = h.shape[1]
    refuse_grad([x, h, c, params.w, params.b], "fused_lstm_cell", "cell='xla' (models.cell.lstm_cell)")
    dtype = x.dtype
    if dtype not in COMPUTE_DTYPES or any(t.dtype != dtype for t in (h, c, params.w, params.b)):
        raise TypeError(f"fused_lstm_cell takes x, h, c, W and b all float32 or all bfloat16, got "
                        f"{[str(t.dtype) for t in (x, h, c, params.w, params.b)]}")
    _check_tensors([(x, (batch, d_in)), (h, (batch, hidden)), (c, (batch, hidden)),
                    (params.w, (d_in + hidden, 4 * hidden)), (params.b, (4 * hidden,))], x.device)
    bf16 = dtype == torch.bfloat16
    # the kernel reads W in 16-byte pieces, c and b as pairs; x and h in
    # 16-byte pieces where they are aligned, else by element
    if not _on_card(x, [c, params.w, params.b], "fused_lstm_cell"):
        return lstm_cell(params, x, state)
    geo = cell_block(d_in, hidden, bf16)
    grid_x = cell_grid(geo, batch, hidden, _build.sm_count(x.device))
    # h and c out in one allocation (the cell is launched once a step: its
    # host work is most of a call at serving batches)
    h_out, c_out = torch.empty((2, batch, hidden), device=x.device, dtype=dtype).unbind()
    with _on_device(x.device):
        err = _library().lstm_cell_launch(
            x.data_ptr(), h.data_ptr(), c.data_ptr(), params.w.data_ptr(), params.b.data_ptr(),
            h_out.data_ptr(), c_out.data_ptr(), batch, d_in, hidden, geo.rows, geo.units, int(geo.w_res), grid_x,
            int(bf16), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "fused_lstm_cell")
    count_launch(fused_lstm_cell, dtype)
    return h_out, c_out


fused_lstm_cell.launches = fused_lstm_cell.launches_bf16 = 0


def _on_card(x: torch.Tensor, tensors, name: str) -> bool:
    """False for CPU tensors (the caller runs the plain version); True for
    CUDA tensors the kernel can read; raises otherwise."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("the kernel reads 16-byte vectors: tensors must be 16-byte aligned")
    return True


def _on_device(device: torch.device):
    """The device guard of a launch: none where ``device`` is already the
    current one (no device switch to pay for), else torch.cuda.device."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def _raise_on(err: int, name: str):
    if err:
        raise RuntimeError(
            f"{name} kernel launch failed: "
            f"{_library().fused_serve_error_string(err).decode()} (cuda error {err})"
        )


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernels' library, built at first use and loaded once."""
    return bind(_build.load("fused_serve"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures of a build of ``csrc/fused_serve.cu`` (the
    kernels' own, or a probe build) → ``lib``."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    arr = ctypes.POINTER(ctypes.c_void_p)
    lib.fused_serve_launch.argtypes = [vp, vp, vp, arr, arr, arr, arr, vp, vp] + [i32] * 13 + [vp, vp]
    lib.fused_serve_smem_bytes.argtypes = [i32] * 8
    lib.fused_serve_smem_bytes.restype = ctypes.c_longlong
    lib.fused_encode_launch.argtypes = [vp, vp, arr, arr] + [i32] * 10 + [vp, vp]
    lib.peer_context_launch.argtypes = [vp] * 5 + [i32] * 11 + [vp, vp, vp]
    lib.fused_decode_f32.argtypes = [vp] * 5 + [arr, arr, vp, vp] + [i32] * 10 + [vp, vp]
    lib.fused_serve_tf32_smem_bytes.argtypes = [i32] * 8
    lib.fused_serve_tf32_smem_bytes.restype = ctypes.c_longlong
    lib.peer_context_smem_bytes.argtypes = [i32] * 8
    lib.peer_context_smem_bytes.restype = ctypes.c_longlong
    lib.fused_encode_smem_bytes.argtypes = [i32] * 7
    lib.fused_encode_smem_bytes.restype = ctypes.c_longlong
    lib.lstm_cell_launch.argtypes = [vp] * 7 + [i32] * 8 + [vp]
    for f in (lib.fused_serve_launch, lib.fused_encode_launch, lib.peer_context_launch, lib.fused_decode_f32,
              lib.lstm_cell_launch):
        f.restype = i32
    lib.lstm_cell_block.argtypes = [i32, i32, i32, ctypes.POINTER(ctypes.c_longlong)]
    lib.lstm_cell_block.restype = None
    lib.fused_serve_error_string.argtypes = [i32]
    lib.fused_serve_error_string.restype = ctypes.c_char_p
    lib.fused_serve_probe_read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    lib.fused_serve_probe_read.restype = i32
    return lib
