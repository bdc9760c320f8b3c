"""Carry a seq2seq or cross_user parameter tree from numpy into the port's
tensors.

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


_SEQ2SEQ = {"encoder", "decoder", "proj"}
_CROSS_USER = _SEQ2SEQ | {"peer_encoder"}  # + one LSTMParams


def params_from_numpy(tree: Dict[str, Any], device) -> Dict[str, Any]:
    """``{"encoder": [(w, b)], "decoder": [(w, b)], "proj": {"w", "b"}}``,
    and for the cross_user family ``"peer_encoder": (w, b)``, of numpy
    arrays (each layer any ``(w, b)`` pair, such as the JAX ``LSTMParams``)
    → the same structure of tensors on ``device``, with the port's
    ``LSTMParams``. Dtypes are kept."""
    if set(tree) not in (_SEQ2SEQ, _CROSS_USER):
        raise KeyError(
            f"expected a seq2seq params tree with keys encoder, decoder, "
            f"proj (and peer_encoder for cross_user); got {sorted(tree)}"
        )

    def layer(wb):
        w, b = wb
        return LSTMParams(w=_tensor(w, device), b=_tensor(b, device))

    out = {
        "encoder": [layer(p) for p in tree["encoder"]],
        "decoder": [layer(p) for p in tree["decoder"]],
        "proj": {
            "w": _tensor(tree["proj"]["w"], device),
            "b": _tensor(tree["proj"]["b"], device),
        },
    }
    if "peer_encoder" in tree:
        out["peer_encoder"] = layer(tree["peer_encoder"])
    return out


def tree_leaves(params: Dict[str, Any]) -> list:
    """The tensors of a params tree in ``jax.tree.leaves`` order: decoder
    layers (w, b), encoder layers (w, b), the peer encoder (w, b) when there
    is one, then proj b, proj w (dict keys sorted, as JAX flattens them).
    The optimizer state, the checkpoint and ``flat_param_items`` rely on
    this order."""
    out = []
    for stack in (params["decoder"], params["encoder"]):
        for p in stack:
            out += [p.w, p.b]
    if "peer_encoder" in params:
        out += [params["peer_encoder"].w, params["peer_encoder"].b]
    return out + [params["proj"]["b"], params["proj"]["w"]]


def tree_unflatten(like: Dict[str, Any], leaves) -> Dict[str, Any]:
    """Inverse of :func:`tree_leaves`, with the structure of ``like``."""
    it = iter(leaves)

    def stack(layers):
        return [LSTMParams(w=next(it), b=next(it)) for _ in layers]

    out = {"decoder": stack(like["decoder"]), "encoder": stack(like["encoder"])}
    if "peer_encoder" in like:
        out["peer_encoder"] = LSTMParams(w=next(it), b=next(it))
    b = next(it)
    out["proj"] = {"w": next(it), "b": b}
    return out
