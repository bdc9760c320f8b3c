"""Transformer autoregressive decode, in its f32 and bf16 tiers: the
hand-written CUDA kernel and its plain PyTorch version.

Twin of ``longterm360fov_tpu.ops.transformer_decode.fused_ar_decode``, each
of its tiers in f32 and bf16: no peers; per-row peer memory; and
group-shared peer memory
(``peer_gmem``/``peer_gvalid``/``peer_gid``, with the per-row anchor
correction ``peer_dv``); each with ``peer_pool`` "none" (K·T_out tokens) or
"mean" (T_out tokens), with or without the peer window
``|t_k - t| <= cfg.peer_window``. The whole rollout (per step and layer:
LN, causal self-attention over the KV cache, cross-attention to the encoder
K/V, peer attention, tanh-GELU MLP; then the final LN, the output
projection and the feedback) → ``(B, T_out, D)`` f32.

* The plain version is ``models.transformer._ar_decode`` given the same
  encoder memory and peer memory (per row, or per group with the row's
  group id and δv) and the tier's ``compute_dtype``.
* :func:`fused_ar_decode`, the wrapper: on CPU tensors it runs the plain
  version; on CUDA tensors it projects the cross and peer K/V once with
  ``torch.matmul`` (JAX's ``project_kv`` runs outside the Pallas kernel
  too; grouped peers once a group): in exact f32, or in the bf16 tier from
  bf16 operands with f32 sums into bf16 K/V, the weights converted to bf16
  for the call; then it launches ``csrc/transformer_decode.cu``, whose
  header says what bounds it and what its design does about that, or
  raises: on an input that requires grad (no backward, on both devices), on
  a non-contiguous input, on a type or shape it does not take, on a group
  id outside ``[0, G)``, on TF32 products or, in the bf16 tier, on cuBLAS's
  reduced-precision bf16 reductions (``fused_lstm.exact_f32_matmul`` turns
  both off). It never falls back. ``.launches`` counts its f32 kernel
  launches in the per-row tiers, :func:`fused_ar_decode_shared`
  ``.launches`` those of the f32 shared tier, :func:`fused_ar_decode_bf16`
  ``.launches`` the bf16 launches of every tier.

The model gates peer attention per position, the TPU kernel per row; the
CUDA kernel follows the model (a position whose window holds no valid token
adds exactly 0, δv included). It keeps the K/V in device memory, so it has
no limit of its own on K·T: past what the card's memory holds, the
allocation raises. So the TPU's streamed and chunked per-row tiers, which
stage peer K/V through VMEM and compute the per-row function, have the
per-row kernel as their counterpart. The group id is read per row: any
order of ``peer_gid`` is right, where the TPU kernel reads it per 128-row
tile and needs group-pure tiles. The JAX wrapper's default
``compute_dtype`` is bf16; this one keeps f32 as the default of its own
argument, and ``transformer.serve_fused`` picks bf16 on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..models import transformer
from ..params import tree_leaves
from . import _build
from .fused_lstm import _no_tf32
from .transformer_encode import (HIDDEN, MAX_LAYERS, check_card_tensors, check_tier, layer_pointers, refuse_grad,
                                 stored_matrix)

__all__ = ["fused_ar_decode", "fused_ar_decode_shared", "fused_ar_decode_bf16", "MAX_D", "decode_rows",
           "decode_smem_bytes", "stream_chunks"]

MAX_D = 4  # csrc/transformer_decode_mma.cuh MAX_D: coordinates a token
_LDX, _LDB = HIDDEN + 4, HIDDEN + 8  # the kernel's f32 and bf16 row strides
F32_KC = 16  # csrc/transformer_decode_f32mma.cuh F32_KC: k-columns of Wᵀ a chunk of the f32 stream
_SMEM_LIMIT = 232448  # dynamic shared memory a Hopper block may use (227 KB)


def decode_rows(batch: int, n_sm: int) -> int:
    """Rows a block of either tier's body (16 warps, one block an SM): 64
    when the batch fills the card's ``n_sm`` SMs with such blocks, else 32,
    so that a smaller batch spreads over twice the SMs (the two shapes'
    times at both sides of the switch: PERF.md, rows 9 and 9c)."""
    return 64 if -(-batch // 64) >= n_sm else 32


def decode_smem_bytes(rows: int, compute_dtype=torch.bfloat16) -> int:
    """Dynamic shared memory of a block of the tier's body at ``rows`` rows.
    bf16 (csrc/transformer_decode_mma.cuh Shape<R>::SMEM): x, q, k and v in
    f32, the products' A rows in bf16, the weight stream's two stages of
    128 k-rows in bf16, the fed-back token. f32
    (csrc/transformer_decode_f32mma.cuh F32Shape<R>::SMEM): x, the A rows,
    q, k and v in f32, the weight stream's two stages of hi and lo planes of
    ``F32_KC`` k-columns, the fed-back token. Raises for a block that the
    kernel does not take, or that does not fit."""
    if rows not in (64, 32):
        raise ValueError(f"the decode bodies take blocks of 64 or 32 rows, got {rows}")
    if compute_dtype == torch.bfloat16:
        smem = 4 * rows * _LDX * 4 + (rows * _LDB + 2 * HIDDEN * _LDB) * 2 + rows * MAX_D * 4
    else:
        smem = (5 * rows * _LDX + 2 * 2 * HIDDEN * (F32_KC + 4) + rows * MAX_D) * 4
    if smem > _SMEM_LIMIT:
        raise ValueError(f"a decode block of {rows} rows needs {smem} bytes of shared memory, more than "
                         f"{_SMEM_LIMIT}")
    return smem


def stream_chunks(peers: bool, compute_dtype=torch.bfloat16) -> list:
    """The tier's weight stream over one layer-step, in the order its
    products read it: self Wq, Wk, Wv, Wo; cross Wq, Wo; peer Wq, Wo
    (``peers``); W1's four 128-column slabs; W2's four 128-row slabs. bf16:
    (DecPtr leaf as (sub, leaf), first k-row, first column) of each chunk of
    W, 128 k-rows x 128 columns. f32: the same of each chunk of Wᵀ (the
    kernel's B operand, k-contiguous), 128 rows (W's columns) x ``F32_KC``
    columns (W's k-rows): (leaf, first row of Wᵀ, first column of Wᵀ)."""
    blocks = [(("self_attn", m), 0, 0) for m in ("wq", "wk", "wv", "wo")]
    blocks += [(("cross_attn", m), 0, 0) for m in ("wq", "wo")]
    if peers:
        blocks += [(("peer_attn", m), 0, 0) for m in ("wq", "wo")]
    blocks += [(("mlp", "w1"), 0, n0) for n0 in range(0, 4 * HIDDEN, HIDDEN)]
    blocks += [(("mlp", "w2"), k0, 0) for k0 in range(0, 4 * HIDDEN, HIDDEN)]
    if compute_dtype == torch.bfloat16:
        return blocks
    return [(leaf, n0, k0 + kc) for leaf, k0, n0 in blocks for kc in range(0, HIDDEN, F32_KC)]


# the weights of a layer, for the shape checks
_DEC_WEIGHTS = tuple((sub, leaf) for sub in ("ln1", "ln2", "ln3", "ln4") for leaf in ("scale", "bias")) + tuple(
    (sub, leaf) for sub in ("self_attn", "cross_attn", "peer_attn") for leaf in ("wq", "wk", "wv", "wo")) + tuple(
    ("mlp", leaf) for leaf in ("w1", "b1", "w2", "b2"))


def _layer_tensors(layer, ck, cv, pk, pv, dtype):
    """A layer's tensors in the kernel's DecPtr order, the matrices as the
    tier's body reads them (``stored_matrix``: bf16 W, or f32 Wᵀ), with its
    projected cross K, V and peer K, V (None without peers)."""
    sa, ca, pa, m = layer["self_attn"], layer["cross_attn"], layer["peer_attn"], layer["mlp"]

    def ln(name):
        return [layer[name]["scale"], layer[name]["bias"]]

    def w(*mats):
        return [stored_matrix(t, dtype) for t in mats]

    return [*ln("ln1"), *w(sa["wq"], sa["wk"], sa["wv"], sa["wo"]), *ln("ln2"), *w(ca["wq"], ca["wo"]), ck, cv,
            *ln("ln3"), *w(pa["wq"], pa["wo"]), pk, pv, *ln("ln4"), *w(m["w1"]), m["b1"], *w(m["w2"]), m["b2"]]


def _check_groups(batch, layers, h, peer_gmem, peer_gvalid, peer_gid, peer_dv):
    """Shapes, types and the range of the group ids of the shared tier, on
    both devices."""
    if peer_gvalid is None or peer_gid is None:
        raise ValueError("peer_gmem, peer_gvalid and peer_gid come together")
    if peer_gmem.dim() != 3 or peer_gmem.shape[0] < 1 or peer_gmem.shape[1] < 1:
        raise ValueError(f"expected peer_gmem (G, KT, {h}), got {tuple(peer_gmem.shape)}")
    g, kt = peer_gmem.shape[:2]
    if tuple(peer_gvalid.shape) != (g, kt) or peer_gvalid.dtype != torch.bool:
        raise ValueError(f"expected peer_gvalid ({g}, {kt}) bool, got {tuple(peer_gvalid.shape)} "
                         f"{peer_gvalid.dtype}")
    if tuple(peer_gid.shape) != (batch,) or peer_gid.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"expected peer_gid ({batch},) int32 or int64, got {tuple(peer_gid.shape)} "
                         f"{peer_gid.dtype}")
    if peer_dv is not None and (tuple(peer_dv.shape) != (batch, layers, h) or peer_dv.dtype != torch.float32):
        raise ValueError(f"expected peer_dv ({batch}, {layers}, {h}) float32, got {tuple(peer_dv.shape)} "
                         f"{peer_dv.dtype}")
    lo, hi = peer_gid.aminmax()
    if lo.item() < 0 or hi.item() >= g:
        raise ValueError(f"peer_gid must lie in [0, {g}), got values in [{lo.item()}, {hi.item()}]")


def fused_ar_decode(params, cfg, enc_mem: torch.Tensor, y0: torch.Tensor, *, peer_mem=None,
                    peer_valid=None, peer_gmem=None, peer_gvalid=None, peer_gid=None, peer_dv=None,
                    compute_dtype=torch.float32) -> torch.Tensor:
    """Whole-horizon decode → (B, cfg.h_out, D) f32 from ``enc_mem``
    (B, T_in, H) and the last observed position ``y0`` (B, D); with per-row
    peers, ``peer_mem`` (B, KT, H) and ``peer_valid`` (B, KT) bool, as
    ``transformer._peer_tokens`` gives them; with group-shared peers,
    ``peer_gmem`` (G, KT, H), ``peer_gvalid`` (G, KT) bool, ``peer_gid``
    (B,) int row → group, and optionally ``peer_dv`` (B, L, H) f32, each
    row's anchor correction. One kernel launch on the card (the plain
    ``transformer._ar_decode`` on CPU tensors), in the tier of
    ``compute_dtype``: float32 (exact) or bfloat16. The inputs are f32 in
    both."""
    check_tier(compute_dtype, "fused_ar_decode")
    if (peer_mem is None) != (peer_valid is None):
        raise ValueError("peer_mem and peer_valid come together")
    if peer_gmem is not None and peer_mem is not None:
        raise ValueError("grouped peers (peer_gmem) replace per-row peers (peer_mem): pass one of them")
    if peer_dv is not None and peer_gmem is None:
        raise ValueError("peer_dv (the anchor correction) applies to the group-shared tier only: per-row "
                         "peers are anchored in their own tokens")
    if enc_mem.dim() != 3 or y0.dim() != 2 or y0.shape[0] != enc_mem.shape[0] or min(enc_mem.shape) < 1:
        raise ValueError(f"expected enc_mem (B, T_in, H) and y0 (B, D), got {tuple(enc_mem.shape)} "
                         f"and {tuple(y0.shape)}")
    refuse_grad([enc_mem, y0, peer_mem, peer_gmem, peer_dv, *tree_leaves(params)], "fused_ar_decode")
    grouped = peer_gmem is not None
    if grouped:
        _check_groups(enc_mem.shape[0], len(params["dec"]), enc_mem.shape[2], peer_gmem, peer_gvalid, peer_gid,
                      peer_dv)
    if enc_mem.device.type == "cpu":
        if grouped:
            return transformer._ar_decode(params, cfg, enc_mem, peer_gmem, peer_gvalid, y0,
                                          peer_gid=peer_gid.long(), peer_dv=peer_dv, compute_dtype=compute_dtype)
        return transformer._ar_decode(params, cfg, enc_mem, peer_mem, peer_valid, y0, compute_dtype=compute_dtype)
    if enc_mem.device.type != "cuda":
        raise ValueError(f"fused_ar_decode runs on cpu or cuda, not {enc_mem.device}")
    _no_tf32(enc_mem, "fused_ar_decode")
    bf16 = compute_dtype == torch.bfloat16
    if bf16 and torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction:
        raise RuntimeError("fused_ar_decode: the bf16 tier sums its K/V products in f32, and cuBLAS's "
                           "reduced-precision bf16 reductions are on; call exact_f32_matmul() first")
    batch, t_in, h = enc_mem.shape
    d, t_out, dev = y0.shape[1], cfg.h_out, enc_mem.device
    if h != HIDDEN or cfg.hidden != HIDDEN:
        raise ValueError(f"the kernel takes hidden = {HIDDEN}, got {h}")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"the kernel takes 1..{MAX_D} coordinates, got {d}")
    layers = params["dec"]
    if not 1 <= len(layers) <= MAX_LAYERS:
        raise ValueError(f"the kernel takes 1..{MAX_LAYERS} layers, got {len(layers)}")
    kt, gid = 0, None
    if grouped:
        peer_mem, peer_valid, kt = peer_gmem, peer_gvalid, peer_gmem.shape[1]
        if peer_gmem.shape[2] != h:
            raise ValueError(f"expected peer_gmem (G, KT, {h}), got {tuple(peer_gmem.shape)}")
        for t in (peer_gvalid, peer_gid):
            if t.device != dev or not t.is_contiguous():
                raise ValueError("peer_gvalid and peer_gid must be contiguous tensors on the card")
        gid = peer_gid.to(torch.int32)
    elif peer_mem is not None:
        kt = peer_mem.shape[1]
        if peer_mem.shape != (batch, kt, h) or tuple(peer_valid.shape) != (batch, kt) or kt < 1:
            raise ValueError(f"expected peer_mem ({batch}, KT, {h}) and peer_valid ({batch}, KT), got "
                             f"{tuple(peer_mem.shape)} and {tuple(peer_valid.shape)}")
        if peer_valid.dtype != torch.bool or peer_valid.device != dev or not peer_valid.is_contiguous():
            raise ValueError("peer_valid must be a contiguous bool tensor on the card")
    if (tuple(params["in_proj"].shape) != (d, h) or tuple(params["out_proj"]["w"].shape) != (h, d)
            or tuple(params["out_proj"]["b"].shape) != (d,)):
        raise ValueError(f"in_proj must be ({d}, {h}), out_proj ({h}, {d}) and ({d},)")
    weights, _ = layer_pointers(layers, _DEC_WEIGHTS, h)
    glob = [params["in_proj"], params["out_proj"]["w"], params["out_proj"]["b"],
            params["final_ln"]["scale"], params["final_ln"]["bias"]]
    check_card_tensors([enc_mem, y0, *glob] + ([peer_mem] if kt else []), dev, "fused_ar_decode",
                       vectors=weights + ([] if peer_dv is None else [peer_dv]))
    # the static cross and peer K/V, projected once for the rollout (grouped
    # peers: once a group), stored in the tier's type; in bf16 from bf16
    # operands, summed in f32 by cuBLAS and rounded once, as JAX's project_kv
    st = compute_dtype
    enc_st, peer_st = enc_mem.to(st), (peer_mem.to(st) if kt else None)
    tensors = []
    for layer in layers:
        ca, pa = layer["cross_attn"], layer["peer_attn"]
        peer_kv = (peer_st @ pa["wk"].to(st), peer_st @ pa["wv"].to(st)) if kt else (None, None)
        tensors += _layer_tensors(layer, enc_st @ ca["wk"].to(st), enc_st @ ca["wv"].to(st), *peer_kv, st)
    ptrs = (ctypes.c_void_p * len(tensors))(*[None if t is None else t.data_ptr() for t in tensors])
    pos = transformer._pos_enc(t_out, h, device=dev)
    glob[0], glob[1] = glob[0].to(st), glob[1].to(st)  # in_proj and out_proj's matrix
    self_kv = torch.empty((2, len(layers), batch, t_out, h), device=dev, dtype=st)
    out = torch.empty((batch, t_out, d), device=dev, dtype=torch.float32)
    seg = kt if cfg.peer_pool == "mean" else t_out
    lib = _library()
    rows = decode_rows(batch, _build.sm_count(dev))
    decode_smem_bytes(rows, compute_dtype)
    args = [y0.data_ptr(), peer_valid.data_ptr() if kt else None, None if gid is None else gid.data_ptr(),
            None if peer_dv is None else peer_dv.data_ptr(), self_kv.data_ptr(), out.data_ptr(),
            ptrs, *[t.data_ptr() for t in glob], pos.data_ptr(),
            batch, len(layers), t_in, t_out, d, kt, cfg.peer_window, seg, rows]
    with torch.cuda.device(dev):
        launch = lib.transformer_decode_bf16 if bf16 else lib.transformer_decode_f32
        err = launch(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(
            f"transformer_decode kernel launch failed: "
            f"{lib.transformer_decode_error_string(err).decode()} (cuda error {err})"
        )
    (fused_ar_decode_bf16 if bf16 else fused_ar_decode_shared if grouped else fused_ar_decode).launches += 1
    return out


fused_ar_decode.launches = 0


def fused_ar_decode_shared(params, cfg, enc_mem: torch.Tensor, y0: torch.Tensor, *, peer_gmem, peer_gvalid,
                           peer_gid, peer_dv=None, compute_dtype=torch.float32) -> torch.Tensor:
    """The group-shared tier: :func:`fused_ar_decode` with grouped peers.
    Its kernel launches count here, in ``.launches``; the per-row tiers'
    count on :func:`fused_ar_decode`."""
    return fused_ar_decode(params, cfg, enc_mem, y0, peer_gmem=peer_gmem, peer_gvalid=peer_gvalid,
                           peer_gid=peer_gid, peer_dv=peer_dv, compute_dtype=compute_dtype)


fused_ar_decode_shared.launches = 0


def fused_ar_decode_bf16(params, cfg, enc_mem: torch.Tensor, y0: torch.Tensor, **peers) -> torch.Tensor:
    """The bf16 tier: :func:`fused_ar_decode` with ``compute_dtype``
    bfloat16, per-row or grouped peers as ``peers`` gives them. Its kernel
    launches, in every tier, count here, in ``.launches``."""
    return fused_ar_decode(params, cfg, enc_mem, y0, compute_dtype=torch.bfloat16, **peers)


fused_ar_decode_bf16.launches = 0


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library, built at first use and loaded once."""
    return bind(_build.load("transformer_decode"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``'s C entry points typed for ctypes: a build of
    ``csrc/transformer_decode.cu``, the kernels' own or a probe build."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.transformer_decode_f32.argtypes = [vp] * 6 + [ctypes.POINTER(vp)] + [vp] * 6 + [i32] * 9 + [vp]
    lib.transformer_decode_bf16.argtypes = [vp] * 6 + [ctypes.POINTER(vp)] + [vp] * 6 + [i32] * 9 + [vp]
    for f in (lib.transformer_decode_f32, lib.transformer_decode_bf16, lib.transformer_decode_smem_bytes,
              lib.transformer_decode_probe_read):
        f.restype = i32
    lib.transformer_decode_smem_bytes.argtypes = [i32, i32]
    lib.transformer_decode_probe_read.argtypes = [vp]
    lib.transformer_decode_error_string.argtypes = [i32]
    lib.transformer_decode_error_string.restype = ctypes.c_char_p
    return lib
