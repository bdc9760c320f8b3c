"""Model families + registry.

Every family exposes ``init(gen, cfg, *, device) -> params`` and
``apply(params, cfg, past_n, future_n=None, *, ...) -> (B, H_out, D)``, as
in ``longterm360fov_tpu.models``. The seq2seq LSTM, cross_user and fusion
families are ported.
"""

from __future__ import annotations

from . import cell, cross_user, fusion, seq2seq, transformer  # noqa: F401


def get_family(name: str):
    """Resolve a model family → module with (init, apply)."""
    if name in ("seq2seq", "lstm", "stacked"):
        return seq2seq
    if name == "cross_user":
        return cross_user
    if name == "fusion":
        return fusion
    if name == "transformer":
        return transformer
    raise KeyError(f"unknown model family {name!r}")
