"""Carry a seq2seq, cross_user, fusion or transformer parameter tree from
numpy into the port's tensors, and walk a tree in ``jax.tree_util``'s order.

``jax.random`` and ``torch.Generator`` give different numbers from the same
seed, so the port and the JAX package share weights, not seeds: the JAX
params pytree, converted to numpy (``jax.tree.map(np.asarray, params)``), or
the numpy tree of ``oracle.init_params_np``, becomes the port's params here.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from .models.cell import LSTMParams

__all__ = ["params_from_numpy", "array_to_tensor", "tensor_to_array", "walk", "tree_leaves", "tree_unflatten",
           "params_device"]


def array_to_tensor(a, device, dtype=None) -> torch.Tensor:
    """A numpy array (or array-like) → a tensor on ``device``. A bf16 array,
    ``ml_dtypes.bfloat16`` as JAX's params convert to numpy, or ``|V2`` as
    ``np.load`` reads one from an npz where ``ml_dtypes`` is not imported,
    becomes ``torch.bfloat16`` through a uint16 view of its bits (torch
    reads neither, and the card's machine has no ``ml_dtypes``). ``dtype``
    casts the result."""
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16" or (a.dtype.kind == "V" and a.dtype.itemsize == 2):
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def tensor_to_array(t: torch.Tensor) -> np.ndarray:
    """A tensor → a numpy array on the host. A bf16 tensor becomes ``|V2``
    (its raw bits), which is how ``np.savez`` writes JAX's bf16 params and
    how plain numpy reads them back; :func:`array_to_tensor` inverts it."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


_SEQ2SEQ = {"encoder", "decoder", "proj"}
# the families' extra subtrees: an LSTMParams, or a dict with these keys
_EXTRA = {
    "peer_encoder": None,  # cross_user
    "conv": {"kernels", "bias", "head_w", "head_b"},  # fusion
    "feat_proj": {"w1", "b1", "w2", "b2"},  # fusion
}
_FAMILIES = (_SEQ2SEQ, _SEQ2SEQ | {"peer_encoder"}, _SEQ2SEQ | {"conv", "feat_proj"})
# the transformer tree: its layers are dicts of these subtrees, each a dict of
# leaves
_LN, _ATTN, _MLP = {"scale", "bias"}, {"wq", "wk", "wv", "wo"}, {"w1", "b1", "w2", "b2"}
_TRANSFORMER = {"in_proj", "out_proj", "final_ln", "enc", "dec"}
_ENC_LAYER = {"ln1": _LN, "attn": _ATTN, "ln2": _LN, "mlp": _MLP}
_DEC_LAYER = {"ln1": _LN, "self_attn": _ATTN, "ln2": _LN, "cross_attn": _ATTN, "ln3": _LN,
              "peer_attn": _ATTN, "ln4": _LN, "mlp": _MLP}


def params_from_numpy(tree: Dict[str, Any], device) -> Dict[str, Any]:
    """``{"encoder": [(w, b)], "decoder": [(w, b)], "proj": {"w", "b"}}``,
    and for the cross_user family ``"peer_encoder": (w, b)``, for the fusion
    family ``"conv": {"kernels", "bias", "head_w", "head_b"}`` and
    ``"feat_proj": {"w1", "b1", "w2", "b2"}``, of numpy arrays (each layer
    any ``(w, b)`` pair, such as the JAX ``LSTMParams``) → the same
    structure of tensors on ``device``, with the port's ``LSTMParams``. The
    transformer tree (``in_proj``, ``out_proj`` {w, b}, ``final_ln`` {scale,
    bias}, and ``enc``/``dec`` lists of layer dicts) carries over as it is.
    Dtypes are kept."""

    def leaves(d, keys):
        if set(d) != keys:
            raise KeyError(f"expected keys {sorted(keys)}, got {sorted(d)}")
        return {k: array_to_tensor(d[k], device) for k in keys}

    if set(tree) == _TRANSFORMER:
        def layers(seq, spec):
            for lay in seq:
                if set(lay) != set(spec):
                    raise KeyError(f"expected layer keys {sorted(spec)}, got {sorted(lay)}")
            return [{name: leaves(lay[name], keys) for name, keys in spec.items()} for lay in seq]

        return {
            "in_proj": array_to_tensor(tree["in_proj"], device),
            "out_proj": leaves(tree["out_proj"], {"w", "b"}),
            "final_ln": leaves(tree["final_ln"], _LN),
            "enc": layers(tree["enc"], _ENC_LAYER),
            "dec": layers(tree["dec"], _DEC_LAYER),
        }
    if set(tree) not in _FAMILIES:
        raise KeyError(
            f"expected a seq2seq params tree with keys encoder, decoder, proj "
            f"(and peer_encoder for cross_user, conv and feat_proj for fusion), or "
            f"a transformer tree with keys {sorted(_TRANSFORMER)}; got {sorted(tree)}"
        )

    def layer(wb):
        w, b = wb
        return LSTMParams(w=array_to_tensor(w, device), b=array_to_tensor(b, device))

    out = {
        "encoder": [layer(p) for p in tree["encoder"]],
        "decoder": [layer(p) for p in tree["decoder"]],
        "proj": leaves(tree["proj"], {"w", "b"}),
    }
    for name, keys in _EXTRA.items():
        if name in tree:
            out[name] = layer(tree[name]) if keys is None else leaves(tree[name], keys)
    return out


def walk(tree, fn: Callable, prefix: str = ""):
    """Rebuild ``tree`` with ``fn(dotted_key, leaf)`` at every leaf, visited
    in ``jax.tree_util``'s order: dict keys sorted, sequences by index, named
    tuples by field name."""
    join = (lambda k: f"{prefix}.{k}") if prefix else str
    if isinstance(tree, dict):
        return {k: walk(tree[k], fn, join(k)) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(walk(getattr(tree, f), fn, join(f)) for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(walk(v, fn, join(i)) for i, v in enumerate(tree))
    return fn(prefix, tree)


def tree_leaves(params: Dict[str, Any]) -> list:
    """The tensors of a params tree in ``jax.tree.leaves`` order: for
    seq2seq the decoder layers (w, b), the encoder layers (w, b), proj b and
    w; cross_user adds the peer encoder (w, b) before proj; fusion adds
    conv (bias, head_b, head_w, kernels) first and feat_proj (b1, b2, w1,
    w2) before proj; the transformer's are dec, enc, final_ln, in_proj,
    out_proj, each layer's subtrees by sorted name. The optimizer state, the
    checkpoint and ``serving.flat_param_items`` rely on this order."""
    out = []
    walk(params, lambda _, leaf: out.append(leaf))
    return out


def tree_unflatten(like: Dict[str, Any], leaves) -> Dict[str, Any]:
    """Inverse of :func:`tree_leaves`, with the structure of ``like``."""
    it = iter(leaves)
    return walk(like, lambda _, __: next(it))


def params_device(params: Dict[str, Any]) -> torch.device:
    """The device of a params tree: that of its first leaf."""
    return tree_leaves(params)[0].device
