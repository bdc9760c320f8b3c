"""Transformer encoder: the hand-written CUDA kernel and its plain PyTorch
version, in the f32 and bf16 tiers.

Twin of ``longterm360fov_tpu.ops.transformer_encode``:
``past_n (B, T, D)`` → ``in_proj`` + positional encoding, then L pre-LN
encoder layers (4-head bidirectional self-attention over the T tokens,
tanh-GELU MLP) → ``enc_mem (B, T, H)`` f32.

* The plain version is ``models.transformer._encode`` with the tier's
  ``compute_dtype``: in bf16 every product's two operands rounded to bf16
  and summed in f32, as the JAX tier's.
* :func:`fused_encode_tokens`, the wrapper: on CPU tensors it runs the plain
  version of the requested tier; on CUDA tensors it launches
  ``csrc/transformer_encode.cu`` (the layers' matrices transposed for the
  f32 tier's three-pass TF32 products, or converted to bf16 with in_proj
  for the bf16 tier, for the call: ``stored_matrix``), whose header says
  what bounds it and what its design does about that, or raises: on an
  input that requires grad (the kernel has no backward; train through
  ``apply``'s parallel pass, as JAX does; this one raises on the CPU too),
  on a non-contiguous input, and on a type or shape it does not take. It
  never falls back. ``.launches`` counts its f32 kernel launches,
  :func:`fused_encode_tokens_bf16` ``.launches`` the bf16 tier's.

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
from .fused_lstm import refuse_grad

__all__ = ["fused_encode_tokens", "fused_encode_tokens_bf16", "encode_kernel_fits", "layer_pointers",
           "stored_pointers", "stored_matrix", "check_card_tensors", "check_tier", "refuse_grad", "launch", "bind",
           "TIERS"]

MAX_LAYERS = 8  # csrc/transformer_encode.cu MAX_LAYERS
TIERS = (torch.float32, torch.bfloat16)  # the compute dtypes of the serving kernels
_MATRICES = ("wq", "wk", "wv", "wo", "w1", "w2")  # stored in the tier's type; LN and biases stay f32
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


def stored_matrix(w: torch.Tensor, dtype) -> torch.Tensor:
    """A weight matrix W (K, N) as the tier's kernel reads it: a bf16 copy
    of W in the bf16 tier; Wᵀ (N, K), contiguous, in the f32 tier, whose
    three-pass products stage each 128 x 128 block of their B operand
    k-contiguous (``csrc/transformer_f32mma.cuh``)."""
    return w.to(torch.bfloat16) if dtype == torch.bfloat16 else w.t().contiguous()


def stored_pointers(tensors, leaves, dtype):
    """The kernel's pointer table of ``layer_pointers``' tensors: the
    matrices as ``stored_matrix`` gives them for the tier of ``dtype``, the
    LN parameters and biases f32 as they are → (tensors, ctypes array).
    ``leaves``: the (sub, leaf) names of one layer, in the table's order."""
    names = [leaf for _, leaf in leaves] * (len(tensors) // len(leaves))
    out = [stored_matrix(t, dtype) if leaf in _MATRICES else t for t, leaf in zip(tensors, names)]
    return out, (ctypes.c_void_p * len(out))(*[t.data_ptr() for t in out])


def check_tier(compute_dtype, name: str):
    if compute_dtype not in TIERS:
        raise ValueError(f"{name} computes in float32 or bfloat16, got {compute_dtype}")


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


def fused_encode_tokens(params, cfg, past_n: torch.Tensor, *, compute_dtype=torch.float32) -> torch.Tensor:
    """Encoder → enc_mem (B, T, H) f32, in one kernel launch on the card (the
    plain ``transformer._encode`` on CPU tensors), in the tier of
    ``compute_dtype``: float32 (exact) or bfloat16. The parameters are the
    model's f32 tree in both."""
    check_tier(compute_dtype, "fused_encode_tokens")
    if past_n.dim() != 3 or min(past_n.shape) < 1:
        raise ValueError(f"past_n must be a non-empty (B, T, D), got {tuple(past_n.shape)}")
    refuse_grad([past_n, *tree_leaves({"in_proj": params["in_proj"], "enc": params["enc"]})],
                "fused_encode_tokens")
    if past_n.device.type == "cpu":
        return transformer._encode(params, cfg, past_n, compute_dtype)
    if past_n.device.type != "cuda":
        raise ValueError(f"fused_encode_tokens runs on cpu or cuda, not {past_n.device}")
    _, t, d = past_n.shape
    if cfg.hidden != HIDDEN:
        raise ValueError(f"the kernel takes hidden = {HIDDEN}, got {cfg.hidden}")
    if not encode_kernel_fits(t):
        raise ValueError(f"the kernel holds one viewer's tokens in a block: T <= {_MAX_FUSED_T}, got {t}")
    layers = params["enc"]
    if not 1 <= len(layers) <= MAX_LAYERS:
        raise ValueError(f"the kernel takes 1..{MAX_LAYERS} layers, got {len(layers)}")
    if tuple(params["in_proj"].shape) != (d, HIDDEN):
        raise ValueError(f"in_proj must be ({d}, {HIDDEN}), got {tuple(params['in_proj'].shape)}")
    tensors, _ = layer_pointers(layers, _ENC_LEAVES, HIDDEN)
    pos = transformer._pos_enc(t, HIDDEN, device=past_n.device)
    check_card_tensors([past_n, params["in_proj"], pos], past_n.device, "fused_encode_tokens", vectors=tensors)
    enc = launch(_library(), tensors, params["in_proj"], pos, past_n, compute_dtype)
    (fused_encode_tokens_bf16 if compute_dtype == torch.bfloat16 else fused_encode_tokens).launches += 1
    return enc


fused_encode_tokens.launches = 0


def launch(lib, tensors, w_in, pos, past_n, compute_dtype) -> torch.Tensor:
    """One launch of ``lib``'s kernel (``_library()``, or a probe build bound
    by :func:`bind`) in the tier of ``compute_dtype`` on checked card
    tensors: ``tensors``, ``layer_pointers``' f32 leaves, converted here as
    the tier stores them → enc (B, T, H) f32. Counts nothing."""
    batch, t, d = past_n.shape
    tensors, ptrs = stored_pointers(tensors, _ENC_LEAVES, compute_dtype)
    w_in = w_in.to(compute_dtype)
    enc = torch.empty((batch, t, HIDDEN), device=past_n.device, dtype=torch.float32)
    with torch.cuda.device(past_n.device):
        err = (lib.transformer_encode_bf16 if compute_dtype == torch.bfloat16 else lib.transformer_encode_f32)(
            past_n.data_ptr(), enc.data_ptr(), ptrs, w_in.data_ptr(), pos.data_ptr(),
            batch, len(tensors) // len(_ENC_LEAVES), t, d, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"transformer_encode kernel launch failed: "
            f"{lib.transformer_encode_error_string(err).decode()} (cuda error {err})"
        )
    return enc


def fused_encode_tokens_bf16(params, cfg, past_n: torch.Tensor) -> torch.Tensor:
    """The bf16 tier: :func:`fused_encode_tokens` with ``compute_dtype``
    bfloat16. Its kernel launches count here, in ``.launches``."""
    return fused_encode_tokens(params, cfg, past_n, compute_dtype=torch.bfloat16)


fused_encode_tokens_bf16.launches = 0


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library, built at first use and loaded once."""
    return bind(_build.load("transformer_encode"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``'s C entry points typed for ctypes."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for f in (lib.transformer_encode_f32, lib.transformer_encode_bf16):
        f.argtypes = [vp, vp, ctypes.POINTER(vp), vp, vp] + [i32] * 4 + [vp]
        f.restype = i32
    lib.transformer_encode_smem_bytes.argtypes = [i32]
    lib.transformer_encode_smem_bytes.restype = i32
    lib.transformer_encode_error_string.argtypes = [i32]
    lib.transformer_encode_error_string.restype = ctypes.c_char_p
    return lib
