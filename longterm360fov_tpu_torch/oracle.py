"""Slow, obviously-correct numpy oracle of the reference semantics.

Copy of ``longterm360fov_tpu.oracle``: the seq2seq LSTM encoder–decoder,
anchor-centered windows, autoregressive decode and sphere re-projection in
plain single-threaded numpy. It is independent of both the JAX package and
this port's PyTorch code, so the machine with the card, which has no jax,
can still hold the port against it; and ``init_params_np`` gives the port
the same seeded weights as ``bench.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from .models.cell import LSTMParams
from .models.seq2seq import Seq2SeqConfig

__all__ = ["oracle_decode", "oracle_predict", "init_params_np"]


def init_params_np(seed: int, cfg: Seq2SeqConfig) -> Dict[str, Any]:
    """Pure-numpy parameter init with the same pytree structure and
    distribution family as models.seq2seq.init (glorot-uniform gates,
    forget-bias 1.0), leaves as numpy arrays. Bit-equal to the JAX
    package's ``oracle.init_params_np`` for the same seed; turn it into
    tensors with ``params.params_from_numpy``."""
    rng = np.random.default_rng(seed)

    def glorot(shape, fan_in, fan_out):
        limit = np.sqrt(6.0 / (fan_in + fan_out))
        return rng.uniform(-limit, limit, size=shape).astype(np.float32)

    enc, dec = [], []
    for l in range(cfg.layers):
        enc_in = cfg.d if l == 0 else cfg.hidden
        dec_in = (cfg.d + cfg.ctx_dim) if l == 0 else cfg.hidden
        for lst, d_in in ((enc, enc_in), (dec, dec_in)):
            w = glorot(
                (d_in + cfg.hidden, 4 * cfg.hidden),
                d_in + cfg.hidden,
                4 * cfg.hidden,
            )
            b = np.zeros((4 * cfg.hidden,), np.float32)
            b[cfg.hidden : 2 * cfg.hidden] = 1.0  # forget gate
            lst.append(LSTMParams(w=w, b=b))
    proj_w = glorot((cfg.hidden, cfg.d), cfg.hidden, cfg.d)
    return {
        "encoder": enc,
        "decoder": dec,
        "proj": {"w": proj_w, "b": np.zeros((cfg.d,), np.float32)},
    }


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _lstm_step(w, b, x, h, c, hidden):
    gates = np.concatenate([x, h], axis=-1) @ w + b
    i = _sigmoid(gates[:, :hidden])
    f = _sigmoid(gates[:, hidden : 2 * hidden])
    g = np.tanh(gates[:, 2 * hidden : 3 * hidden])
    o = _sigmoid(gates[:, 3 * hidden :])
    c = f * c + i * g
    h = o * np.tanh(c)
    return h, c


def oracle_decode(
    params: Dict[str, Any],
    cfg: Seq2SeqConfig,
    past_n: np.ndarray,
    context: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Autoregressive decode with python-loop numpy — mirrors
    models.seq2seq.decode step for step.

    past_n: (B, H_in, D) normalized windows → (B, H_out, D). ``context``
    is (B, C), or (B, H_out, C) for a per-step context (the cross_user
    ``peer_align`` tier).
    """
    params = {
        "encoder": [
            (np.asarray(p.w, np.float32), np.asarray(p.b, np.float32))
            for p in params["encoder"]
        ],
        "decoder": [
            (np.asarray(p.w, np.float32), np.asarray(p.b, np.float32))
            for p in params["decoder"]
        ],
        "proj": (
            np.asarray(params["proj"]["w"], np.float32),
            np.asarray(params["proj"]["b"], np.float32),
        ),
    }
    b_sz = past_n.shape[0]
    hid = cfg.hidden
    enc_states = [
        (np.zeros((b_sz, hid), np.float32), np.zeros((b_sz, hid), np.float32))
        for _ in range(cfg.layers)
    ]
    past_n = np.asarray(past_n, np.float32)
    for t in range(cfg.h_in):
        inp = past_n[:, t]
        for l, (w, b) in enumerate(params["encoder"]):
            h, c = _lstm_step(w, b, inp, *enc_states[l], hid)
            enc_states[l] = (h, c)
            inp = h

    dec_states = enc_states
    y = past_n[:, -1]
    proj_w, proj_b = params["proj"]
    out = np.zeros((b_sz, cfg.h_out, cfg.d), np.float32)
    for t in range(cfg.h_out):
        ctx = context if context is None or context.ndim == 2 else context[:, t]
        inp = y if ctx is None else np.concatenate([y, ctx], -1)
        for l, (w, b) in enumerate(params["decoder"]):
            h, c = _lstm_step(w, b, inp, *dec_states[l], hid)
            dec_states[l] = (h, c)
            inp = h
        y = h @ proj_w + proj_b
        out[:, t] = y
    return out


def oracle_predict(
    params: Dict[str, Any],
    cfg: Seq2SeqConfig,
    past: np.ndarray,
    context: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Full reference inference path: normalize → decode → denormalize →
    re-project to sphere. Matches infer.make_predict_fn."""
    past = np.asarray(past, np.float32)
    anchor = past[:, -1:, :]
    pred_n = oracle_decode(params, cfg, past - anchor, context)
    pred = pred_n + anchor
    n = np.linalg.norm(pred, axis=-1, keepdims=True)
    return pred / np.maximum(n, 1e-12)
