"""Differentiable transformer encoder: hand-written CUDA forward, reverse and
weight-gradient kernels, their plain PyTorch versions, and the autograd
function that joins them.

Twin of ``longterm360fov_tpu.ops.transformer_encode_train``:
:func:`fused_encode_train` is ``models.transformer._encode`` (``past_n (B,
T, D)`` → ``in_proj`` + positional encoding → L pre-LN encoder layers →
``enc_mem (B, T, H)`` f32), differentiable in ``past_n``, ``in_proj`` and
every encoder weight. Three kernels of ``csrc/transformer_encode_train.cu``
carry it on the card:

* :func:`encode_train_fwd`, the forward that also writes the stash a layer
  ``[x0, x1, q, k, v, att]``, each ``(B·T, H)``: the layer input, the stream
  after the attention residual, q, k, v and the attention output before
  ``wo``;
* :func:`encode_train_bwd`, the reverse from the stash and the cotangent of
  ``enc_mem``: ``d_x`` (when asked) and each block's partial gradients of
  ``in_proj`` and every encoder weight, LN and GELU backward, attention
  backward and weight products in its body;
* :func:`encode_train_dw`, which adds the blocks' partials in block order:
  no float atomics, so two runs give the same bits.

Each wrapper runs its plain version on CPU tensors (the forward with the
stash in PyTorch; the reverse as autograd of each layer from its stashed
input, one "block" holding the whole sum; the sum of the partials) and
launches its kernel on CUDA tensors or raises; it never falls back. Each
counts its launches in ``.launches``.

With no gradient in flight the forward is the serving kernel
``fused_encode_tokens``, as in JAX. On CPU tensors :func:`fused_encode_train`
is autograd through ``transformer._encode``. It takes f32, H = 128, 1..8
layers and T <= 64 (``encode_kernel_fits``) and raises otherwise, on both
devices. JAX keeps this kernel off its training path
(``FUSED_TRAIN_ENCODER = False``, for a TPU compile that ran out of
memory); the port routes it under ``train_impl`` "auto"/"fused"
(``models.transformer.apply_fused_tf``/``apply_fused_ss``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import torch

from ..models import transformer
from . import _build
from .fused_lstm import _no_tf32
from .transformer_encode import (_ENC_LEAVES, HIDDEN, MAX_LAYERS, check_card_tensors, encode_kernel_fits,
                                 fused_encode_tokens, layer_pointers, stored_pointers)

__all__ = ["fused_encode_train", "encode_train_fwd", "encode_train_bwd", "encode_train_dw", "partial_floats",
           "split_grads"]

N_STASH = 6  # x0, x1, q, k, v, att
_H = HIDDEN
# csrc/transformer_encode_train.cu: a layer's partial gradients, at these
# offsets in the order of _ENC_LEAVES
_LAYER_SLOTS = {("attn", "wq"): (0, (_H, _H)), ("attn", "wk"): (_H * _H, (_H, _H)),
                ("attn", "wv"): (2 * _H * _H, (_H, _H)), ("attn", "wo"): (3 * _H * _H, (_H, _H)),
                ("mlp", "w1"): (4 * _H * _H, (_H, 4 * _H)), ("mlp", "w2"): (8 * _H * _H, (4 * _H, _H)),
                ("mlp", "b1"): (12 * _H * _H, (4 * _H,)), ("mlp", "b2"): (12 * _H * _H + 4 * _H, (_H,)),
                ("ln1", "scale"): (12 * _H * _H + 5 * _H, (_H,)), ("ln1", "bias"): (12 * _H * _H + 6 * _H, (_H,)),
                ("ln2", "scale"): (12 * _H * _H + 7 * _H, (_H,)), ("ln2", "bias"): (12 * _H * _H + 8 * _H, (_H,))}
_LAYER_GRAD = 12 * _H * _H + 9 * _H  # 197,760 floats


def partial_floats(layers: int, d: int) -> int:
    """Floats of one block's partial gradients: every layer's, then
    in_proj's (d, H)."""
    return layers * _LAYER_GRAD + d * _H


def split_grads(flat: torch.Tensor, layers: int, d: int) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The summed gradients (partial_floats,) → in_proj's (d, H) and every
    layer's leaves in ``_ENC_LEAVES`` order."""
    leaves = []
    for l in range(layers):
        base = l * _LAYER_GRAD
        for key in _ENC_LEAVES:
            off, shape = _LAYER_SLOTS[key]
            n = 1
            for s in shape:
                n *= s
            leaves.append(flat[base + off: base + off + n].view(shape))
    g_in = flat[layers * _LAYER_GRAD:].view(d, _H)
    return g_in, leaves


def _layers_of(leaves) -> List[dict]:
    """The flat leaves (``_ENC_LEAVES`` order, 12 a layer) → layer dicts."""
    per = len(_ENC_LEAVES)
    out = []
    for i in range(0, len(leaves), per):
        layer: dict = {}
        for (sub, leaf), t in zip(_ENC_LEAVES, leaves[i:i + per]):
            layer.setdefault(sub, {})[leaf] = t
        out.append(layer)
    return out


def _check(cfg, past_n, in_proj, leaves, compute_dtype=torch.float32):
    """What the kernels take, on both devices: f32, H = 128, 1..8 layers,
    T <= 64."""
    if compute_dtype != torch.float32:
        raise NotImplementedError(
            f"fused_encode_train has the exact f32 tier only, got compute_dtype={compute_dtype}: the "
            f"JAX training encoder has no bf16 tier (ROADMAP.md, slice I-b, divergences)"
        )
    if past_n.dim() != 3 or min(past_n.shape) < 1:
        raise ValueError(f"past_n must be a non-empty (B, T, D), got {tuple(past_n.shape)}")
    for t in [past_n, in_proj, *leaves]:
        if t.dtype != torch.float32:
            raise TypeError(f"fused_encode_train takes float32 inputs and params, got {t.dtype}")
    batch, t_len, d = past_n.shape
    if cfg.hidden != _H:
        raise ValueError(f"the kernels take hidden = {_H}, got {cfg.hidden}")
    if not encode_kernel_fits(t_len):
        raise ValueError(f"the kernels hold one viewer's tokens in a block: T <= 64, got {t_len}")
    layers = len(leaves) // len(_ENC_LEAVES)
    if not 1 <= layers <= MAX_LAYERS or len(leaves) % len(_ENC_LEAVES):
        raise ValueError(f"the kernels take 1..{MAX_LAYERS} layers, got {len(leaves) / len(_ENC_LEAVES)}")
    if not 1 <= d <= 4 or tuple(in_proj.shape) != (d, _H):
        raise ValueError(f"in_proj must be ({d}, {_H}) with 1..4 coordinates, got {tuple(in_proj.shape)}")


def _blocks(batch: int, t_len: int) -> int:
    seqs = 64 // t_len
    return (batch + seqs - 1) // seqs


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _raise_on(err: int, name: str):
    if err:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{_library().transformer_encode_train_error_string(err).decode()} (cuda error {err})")


def _card_check(tensors, weights, device, name):
    """The weights' shapes, then every tensor's type, device, contiguity and
    (the weights') 16-byte alignment."""
    layer_pointers(_layers_of(weights), _ENC_LEAVES, _H)
    check_card_tensors(tensors, device, name, vectors=weights)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _stash_reference(cfg, past_n, in_proj, leaves):
    """The forward with the stash, in PyTorch → (enc (B, T, H), stash (L, 6,
    B·T, H))."""
    batch, t_len, _ = past_n.shape
    x = past_n @ in_proj + transformer._pos_enc(t_len, _H, device=past_n.device)
    stash = []
    for layer in _layers_of(leaves):
        x0 = x
        h = transformer._ln(layer["ln1"], x0)
        a = layer["attn"]
        q, k, v = h @ a["wq"], h @ a["wk"], h @ a["wv"]
        att = transformer._merge_heads(torch.softmax(
            torch.einsum("bnqd,bnkd->bnqk", transformer._split_heads(q), transformer._split_heads(k))
            / (_H // transformer.N_HEADS) ** 0.5, dim=-1) @ transformer._split_heads(v))
        x1 = x0 + att @ a["wo"]
        x = x1 + transformer._mlp(layer["mlp"], transformer._ln(layer["ln2"], x1))
        stash.append(torch.stack([s.reshape(batch * t_len, _H) for s in (x0, x1, q, k, v, att)]))
    return x, torch.stack(stash)


def _layer(layer, x0):
    h = transformer._ln(layer["ln1"], x0)
    x1 = x0 + transformer._attention(layer["attn"], h, h)
    return x1 + transformer._mlp(layer["mlp"], transformer._ln(layer["ln2"], x1))


def _reverse_reference(past_n, in_proj, leaves, stash, g_enc, need_dx):
    """The reverse, in PyTorch: autograd of each layer from its stashed input
    x0, last layer first → (d_x or None, partials (1, partial_floats)), one
    block holding the whole sum."""
    batch, t_len, d = past_n.shape
    layers = _layers_of(leaves)
    flat = torch.zeros(partial_floats(len(layers), d), dtype=torch.float32, device=past_n.device)
    g = g_enc
    with torch.enable_grad():
        for l in reversed(range(len(layers))):
            x0 = stash[l, 0].reshape(batch, t_len, _H).detach().requires_grad_(True)
            ws = [t.detach().requires_grad_(True) for t in leaves[l * len(_ENC_LEAVES):(l + 1) * len(_ENC_LEAVES)]]
            out = _layer(_layers_of(ws)[0], x0)
            g, *gw = torch.autograd.grad(out, [x0, *ws], g)
            base = l * _LAYER_GRAD
            for key, gl in zip(_ENC_LEAVES, gw):
                off = _LAYER_SLOTS[key][0]
                flat[base + off: base + off + gl.numel()] = gl.reshape(-1)
    g_rows = g.reshape(batch * t_len, _H)
    flat[len(layers) * _LAYER_GRAD:] = (past_n.reshape(-1, d).t() @ g_rows).reshape(-1)
    d_x = (g @ in_proj.t()) if need_dx else None
    return d_x, flat[None]


def _dw_reference(partials):
    """The sum of the partials row by row in block order, as the kernel adds
    them (the same bits)."""
    out = torch.zeros_like(partials[0])
    for row in partials:
        out += row
    return out


# ---------------------------------------------------------------------------
# the kernel wrappers
# ---------------------------------------------------------------------------


def encode_train_fwd(cfg, past_n: torch.Tensor, in_proj: torch.Tensor, leaves) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward with the stash → (enc (B, T, H), stash (L, 6, B·T, H))."""
    _check(cfg, past_n, in_proj, leaves)
    if past_n.device.type == "cpu":
        return _stash_reference(cfg, past_n, in_proj, leaves)
    batch, t_len, d = past_n.shape
    layers, dev = len(leaves) // len(_ENC_LEAVES), past_n.device
    pos = transformer._pos_enc(t_len, _H, device=dev)
    _card_check([past_n, in_proj, pos], list(leaves), dev, "encode_train_fwd")
    enc = torch.empty((batch, t_len, _H), device=dev, dtype=torch.float32)
    stash = torch.empty((layers, N_STASH, batch * t_len, _H), device=dev, dtype=torch.float32)
    stored, table = stored_pointers(list(leaves), _ENC_LEAVES, torch.float32)  # the matrices transposed
    with torch.cuda.device(dev):
        err = _library().transformer_encode_train_fwd_f32(
            past_n.data_ptr(), enc.data_ptr(), stash.data_ptr(), table, in_proj.data_ptr(), pos.data_ptr(),
            batch, layers, t_len, d, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "encode_train_fwd")
    encode_train_fwd.launches += 1
    return enc, stash


encode_train_fwd.launches = 0


def encode_train_bwd(cfg, past_n, in_proj, leaves, stash, g_enc, need_dx: bool
                     ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Reverse → (d_x (B, T, D) or None, partials (blocks, partial_floats)):
    each block's partial gradients of every encoder weight and of in_proj."""
    _check(cfg, past_n, in_proj, leaves)
    batch, t_len, d = past_n.shape
    layers = len(leaves) // len(_ENC_LEAVES)
    if tuple(stash.shape) != (layers, N_STASH, batch * t_len, _H) or tuple(g_enc.shape) != (batch, t_len, _H):
        raise ValueError(f"expected stash ({layers}, {N_STASH}, {batch * t_len}, {_H}) and g_enc "
                         f"({batch}, {t_len}, {_H}), got {tuple(stash.shape)} and {tuple(g_enc.shape)}")
    if past_n.device.type == "cpu":
        return _reverse_reference(past_n, in_proj, leaves, stash, g_enc, need_dx)
    dev = past_n.device
    lib = _library()
    if lib.transformer_encode_train_partial_floats(layers, d) != partial_floats(layers, d):
        raise RuntimeError("ops.transformer_encode_train and its kernel disagree on the partials' layout")
    _card_check([past_n, in_proj, stash, g_enc], list(leaves), dev, "encode_train_bwd")
    # the transposed weight the reverse reads a layer, W1ᵀ; its other products read W
    per, w1 = len(_ENC_LEAVES), _ENC_LEAVES.index(("mlp", "w1"))
    trans = [leaves[i + w1].t().contiguous() for i in range(0, len(leaves), per)]
    d_x = torch.empty((batch, t_len, d), device=dev, dtype=torch.float32) if need_dx else None
    partials = torch.empty((_blocks(batch, t_len), partial_floats(layers, d)), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        err = lib.transformer_encode_train_bwd_f32(
            past_n.data_ptr(), stash.data_ptr(), g_enc.data_ptr(), None if d_x is None else d_x.data_ptr(),
            partials.data_ptr(), _ptrs(leaves), _ptrs(trans), in_proj.data_ptr(), batch, layers, t_len, d,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "encode_train_bwd")
    encode_train_bwd.launches += 1
    return d_x, partials


encode_train_bwd.launches = 0


def encode_train_dw(partials: torch.Tensor) -> torch.Tensor:
    """Σ of the blocks' partials (blocks, n) → (n,), in block order."""
    if partials.dim() != 2 or partials.dtype != torch.float32 or partials.shape[1] % 4:
        raise ValueError(f"expected (blocks, n) float32 partials with n a multiple of 4, got "
                         f"{tuple(partials.shape)} {partials.dtype}")
    if partials.device.type == "cpu":
        return _dw_reference(partials)
    check_card_tensors([partials], partials.device, "encode_train_dw")
    grads = torch.empty(partials.shape[1], device=partials.device, dtype=torch.float32)
    with torch.cuda.device(partials.device):
        err = _library().transformer_encode_train_dw_f32(
            partials.data_ptr(), grads.data_ptr(), partials.shape[1], partials.shape[0],
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "encode_train_dw")
    encode_train_dw.launches += 1
    return grads


encode_train_dw.launches = 0


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernels' library, built at first use and loaded once."""
    return bind(_build.load("transformer_encode_train"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``'s C entry points (this library's, or a probe build's) typed
    for ctypes."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    arr = ctypes.POINTER(vp)
    lib.transformer_encode_train_partial_floats.argtypes = [i32, i32]
    lib.transformer_encode_train_partial_floats.restype = i32
    lib.transformer_encode_train_fwd_f32.argtypes = [vp, vp, vp, arr, vp, vp] + [i32] * 4 + [vp]
    lib.transformer_encode_train_bwd_f32.argtypes = [vp, vp, vp, vp, vp, arr, arr, vp] + [i32] * 4 + [vp]
    lib.transformer_encode_train_dw_f32.argtypes = [vp, vp, i32, i32, vp]
    for f in (lib.transformer_encode_train_fwd_f32, lib.transformer_encode_train_bwd_f32,
              lib.transformer_encode_train_dw_f32):
        f.restype = i32
    lib.transformer_encode_train_error_string.argtypes = [i32]
    lib.transformer_encode_train_error_string.restype = ctypes.c_char_p
    return lib


# ---------------------------------------------------------------------------
# the differentiable function
# ---------------------------------------------------------------------------


class _EncodeTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, past_n, in_proj, *leaves):
        enc, stash = encode_train_fwd(cfg, past_n, in_proj, leaves)
        ctx.cfg = cfg
        ctx.save_for_backward(past_n, in_proj, stash, *leaves)
        return enc

    @staticmethod
    def backward(ctx, g_enc):
        past_n, in_proj, stash, *leaves = ctx.saved_tensors
        d_x, partials = encode_train_bwd(ctx.cfg, past_n, in_proj, leaves, stash, g_enc.float().contiguous(),
                                         ctx.needs_input_grad[1])
        g_in, g_leaves = split_grads(encode_train_dw(partials), len(leaves) // len(_ENC_LEAVES), past_n.shape[2])
        return (None, d_x, g_in, *g_leaves)


def fused_encode_train(params, cfg, past_n: torch.Tensor, *, compute_dtype=torch.float32) -> torch.Tensor:
    """Differentiable encoder → enc_mem (B, T, H) f32. On CUDA tensors:
    under grad, the forward-with-stash kernel, with the reverse and
    reduction kernels as its backward; with no gradient in flight, the
    serving kernel ``fused_encode_tokens``. On CPU tensors: autograd through
    ``transformer._encode``. Raises past its limits (f32, H = 128, 1..8
    layers, T <= 64) on both devices."""
    leaves = [layer[sub][leaf] for layer in params["enc"] for sub, leaf in _ENC_LEAVES]
    in_proj = params["in_proj"]
    _check(cfg, past_n, in_proj, leaves, compute_dtype)
    if past_n.device.type == "cpu":
        return transformer._encode(params, cfg, past_n)
    if past_n.device.type != "cuda":
        raise ValueError(f"fused_encode_train runs on cpu or cuda, not {past_n.device}")
    _no_tf32(past_n, "fused_encode_train")
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in [past_n, in_proj, *leaves])):
        return fused_encode_tokens(params, cfg, past_n)
    return _EncodeTrain.apply(cfg, past_n.contiguous(), in_proj, *leaves)
