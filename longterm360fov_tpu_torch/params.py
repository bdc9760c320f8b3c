"""Carry a seq2seq parameter tree from numpy into the port's tensors.

``jax.random`` and ``torch.Generator`` give different numbers from the same
seed, so the port and the JAX package share weights, not seeds: the JAX
params pytree, converted to numpy (``jax.tree.map(np.asarray, params)``), or
the numpy tree of ``oracle.init_params_np``, becomes the port's params here.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .models.cell import LSTMParams

__all__ = ["params_from_numpy", "tree_leaves", "tree_unflatten"]


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree: Dict[str, Any], device) -> Dict[str, Any]:
    """``{"encoder": [(w, b)], "decoder": [(w, b)], "proj": {"w", "b"}}``
    of numpy arrays (each layer any ``(w, b)`` pair, such as the JAX
    ``LSTMParams``) → the same structure of tensors on ``device``, with the
    port's ``LSTMParams``. Dtypes are kept."""
    if set(tree) != {"encoder", "decoder", "proj"}:
        raise KeyError(
            f"expected a seq2seq params tree with keys encoder, decoder, "
            f"proj; got {sorted(tree)}"
        )

    def stack(layers):
        return [
            LSTMParams(w=_tensor(w, device), b=_tensor(b, device))
            for w, b in layers
        ]

    return {
        "encoder": stack(tree["encoder"]),
        "decoder": stack(tree["decoder"]),
        "proj": {
            "w": _tensor(tree["proj"]["w"], device),
            "b": _tensor(tree["proj"]["b"], device),
        },
    }


def tree_leaves(params: Dict[str, Any]) -> list:
    """The tensors of a seq2seq params tree in ``jax.tree.leaves`` order:
    decoder layers (w, b), encoder layers (w, b), then proj b, proj w
    (dict keys sorted, as JAX flattens them)."""
    out = []
    for stack in (params["decoder"], params["encoder"]):
        for p in stack:
            out += [p.w, p.b]
    return out + [params["proj"]["b"], params["proj"]["w"]]


def tree_unflatten(like: Dict[str, Any], leaves) -> Dict[str, Any]:
    """Inverse of :func:`tree_leaves`, with the structure of ``like``."""
    it = iter(leaves)

    def stack(layers):
        return [LSTMParams(w=next(it), b=next(it)) for _ in layers]

    dec = stack(like["decoder"])
    enc = stack(like["encoder"])
    b = next(it)
    return {"encoder": enc, "decoder": dec, "proj": {"w": next(it), "b": b}}
