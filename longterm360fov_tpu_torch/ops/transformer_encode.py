"""Transformer encoder: the hand-written CUDA kernel and its plain PyTorch
version.

Twin of ``longterm360fov_tpu.ops.transformer_encode``:
``past_n (B, T, D)`` → ``in_proj`` + positional encoding, then L pre-LN
encoder layers (4-head bidirectional self-attention over the T tokens,
tanh-GELU MLP) → ``enc_mem (B, T, H)`` f32.

* The plain version is ``models.transformer._encode``.
* :func:`fused_encode_tokens`, the wrapper: on CPU tensors it runs the plain
  version; on CUDA tensors it launches ``csrc/transformer_encode.cu``, whose
  header says what bounds it and what its design does about that, or
  raises: on an input that requires grad (the kernel has no backward; train
  through ``apply``'s parallel pass, as JAX does; this one raises on the CPU
  too), on a non-contiguous input, and on a type or shape it does not take.
  It never falls back.
  ``.launches`` counts its kernel launches.

The routing threshold :func:`encode_kernel_fits` is JAX's T <= 64, a
compile limit of the TPU toolchain, not a property of this card; the kernel
holds one viewer's tokens in one block, so it takes T <= 64 too.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..models import transformer
from ..params import tree_leaves
from . import _build

__all__ = ["fused_encode_tokens", "encode_kernel_fits", "layer_pointers", "check_card_tensors", "refuse_grad"]

MAX_LAYERS = 8  # csrc/transformer_encode.cu MAX_LAYERS
HIDDEN = 128  # the kernels take the width of every preset only
_MAX_FUSED_T = 64  # JAX's routing threshold; one block's 64 token rows


def encode_kernel_fits(t_in: int) -> bool:
    return t_in <= _MAX_FUSED_T


# a layer's tensors in the kernel's EncPtr order
_ENC_LEAVES = (("ln1", "scale"), ("ln1", "bias"), ("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
               ("attn", "wo"), ("ln2", "scale"), ("ln2", "bias"), ("mlp", "w1"), ("mlp", "b1"),
               ("mlp", "w2"), ("mlp", "b2"))


def layer_pointers(layers, leaves, h: int):
    """The listed tensors of every layer, checked (f32, contiguous, the
    shape of the H-wide model), and a ctypes array of their device
    pointers."""
    shapes = {"scale": (h,), "bias": (h,), "wq": (h, h), "wk": (h, h), "wv": (h, h), "wo": (h, h),
              "w1": (h, 4 * h), "b1": (4 * h,), "w2": (4 * h, h), "b2": (h,)}
    tensors = []
    for layer in layers:
        for sub, leaf in leaves:
            t = layer[sub][leaf]
            if tuple(t.shape) != shapes[leaf]:
                raise ValueError(f"{sub}.{leaf}: expected shape {shapes[leaf]}, got {tuple(t.shape)}")
            tensors.append(t)
    return tensors, (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def check_card_tensors(tensors, device, name: str, *, vectors=()):
    """Every tensor the kernel reads: f32, on ``device`` and contiguous;
    those of ``vectors``, which it reads as 16-byte vectors, 16-byte
    aligned too."""
    for t in [*tensors, *vectors]:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes float32 tensors, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name}: tensors on {t.device} and {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} is not contiguous")
    if any(t.data_ptr() % 16 for t in vectors):
        raise ValueError(f"{name} reads the weights as 16-byte vectors: they must be 16-byte aligned")


def refuse_grad(tensors, name: str):
    """The kernels have no backward (nor have the TPU kernels): an input that
    requires grad raises on both devices, where grad is on."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward (nor has the TPU kernel): differentiate through "
            f"models.transformer.apply"
        )


def fused_encode_tokens(params, cfg, past_n: torch.Tensor, *, compute_dtype=torch.float32) -> torch.Tensor:
    """Encoder → enc_mem (B, T, H) f32, in one kernel launch on the card (the
    plain ``transformer._encode`` on CPU tensors). The bf16 ``compute_dtype``
    raises (ROADMAP.md, slice I)."""
    if compute_dtype != torch.float32:
        raise NotImplementedError(
            f"fused_encode_tokens: only the exact f32 tier is ported, got "
            f"compute_dtype={compute_dtype} (ROADMAP.md, slice I)"
        )
    if past_n.dim() != 3 or min(past_n.shape) < 1:
        raise ValueError(f"past_n must be a non-empty (B, T, D), got {tuple(past_n.shape)}")
    refuse_grad([past_n, *tree_leaves({"in_proj": params["in_proj"], "enc": params["enc"]})],
                "fused_encode_tokens")
    if past_n.device.type == "cpu":
        return transformer._encode(params, cfg, past_n)
    if past_n.device.type != "cuda":
        raise ValueError(f"fused_encode_tokens runs on cpu or cuda, not {past_n.device}")
    batch, t, d = past_n.shape
    if cfg.hidden != HIDDEN:
        raise ValueError(f"the kernel takes hidden = {HIDDEN}, got {cfg.hidden}")
    if not encode_kernel_fits(t):
        raise ValueError(f"the kernel holds one viewer's tokens in a block: T <= {_MAX_FUSED_T}, got {t}")
    layers = params["enc"]
    if not 1 <= len(layers) <= MAX_LAYERS:
        raise ValueError(f"the kernel takes 1..{MAX_LAYERS} layers, got {len(layers)}")
    if tuple(params["in_proj"].shape) != (d, HIDDEN):
        raise ValueError(f"in_proj must be ({d}, {HIDDEN}), got {tuple(params['in_proj'].shape)}")
    tensors, ptrs = layer_pointers(layers, _ENC_LEAVES, HIDDEN)
    pos = transformer._pos_enc(t, HIDDEN, device=past_n.device)
    check_card_tensors([past_n, params["in_proj"], pos], past_n.device, "fused_encode_tokens", vectors=tensors)
    enc = torch.empty((batch, t, HIDDEN), device=past_n.device, dtype=torch.float32)
    with torch.cuda.device(past_n.device):
        err = _library().transformer_encode_f32(
            past_n.data_ptr(), enc.data_ptr(), ptrs, params["in_proj"].data_ptr(), pos.data_ptr(),
            batch, len(layers), t, d, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"transformer_encode kernel launch failed: "
            f"{_library().transformer_encode_error_string(err).decode()} (cuda error {err})"
        )
    fused_encode_tokens.launches += 1
    return enc


fused_encode_tokens.launches = 0


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library, built at first use and loaded once."""
    lib = _build.load("transformer_encode")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.transformer_encode_f32.argtypes = [vp, vp, ctypes.POINTER(vp), vp, vp] + [i32] * 4 + [vp]
    lib.transformer_encode_f32.restype = i32
    lib.transformer_encode_error_string.argtypes = [i32]
    lib.transformer_encode_error_string.restype = ctypes.c_char_p
    return lib
