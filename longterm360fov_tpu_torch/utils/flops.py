"""Analytic FLOP accounting for the model families (the dense products).

Copy of ``longterm360fov_tpu.utils.flops``, the same formulas: a
multiply-accumulate of a dense contraction counts 2 FLOPs; elementwise work
(gates, softmax, layer norms) is not counted, under 5 % of the total at
these shapes. ``H100_BF16_PEAK`` is the peak that model-FLOP utilisation is
read against: the dense bf16 tensor-core rate of an NVIDIA H100 80GB HBM3
(SXM) at its 700 W power limit, 989 TFLOP/s, the figure PERF.md §6 uses.
f32 work runs at a fraction of it, so an f32 utilisation read against the
bf16 peak understates the card's use.
"""

from __future__ import annotations

from ..config import ExperimentConfig

__all__ = [
    "lstm_decode_flops",
    "lstm_train_flops",
    "transformer_decode_flops",
    "decode_flops",
    "train_flops",
    "H100_BF16_PEAK",
]

H100_BF16_PEAK = 989e12  # FLOP/s: dense bf16, NVIDIA H100 80GB HBM3 (SXM), 700 W


def _lstm_stack_flops(cfg_m, steps: int, layer0_in: int) -> float:
    """One LSTM stack pass: `steps` timesteps over `layers` layers.

    Per step and layer the cell does one packed [x, h] @ W_(in+H, 4H)
    product: 2 * (d_in + H) * 4H FLOPs per row."""
    h = cfg_m.hidden
    total = 0.0
    for layer in range(cfg_m.layers):
        d_in = layer0_in if layer == 0 else h
        total += steps * 2.0 * (d_in + h) * 4 * h
    return total


def lstm_decode_flops(cfg: ExperimentConfig) -> float:
    """Per-trajectory serving FLOPs: encoder over h_in + AR decoder over
    h_out (+ output projection per emitted frame). The cross_user family
    additionally runs K peer futures through a ctx_dim-hidden LSTM
    encoder per target viewer (``models.cross_user.encode_peers``)."""
    m = cfg.model
    enc = _lstm_stack_flops(m, m.h_in, m.d)
    dec = _lstm_stack_flops(m, m.h_out, m.d + m.ctx_dim)
    proj = m.h_out * 2.0 * m.hidden * m.d
    total = enc + dec + proj
    if cfg.model_family == "cross_user" and cfg.n_other_users:
        c = m.ctx_dim
        total += cfg.n_other_users * m.h_out * 2.0 * (m.d + c) * 4 * c
    return total


def lstm_train_flops(cfg: ExperimentConfig) -> float:
    """Per-window training FLOPs: forward + backward ≈ 3x forward (the
    backward pass does ~2 matmuls per forward matmul)."""
    return 3.0 * lstm_decode_flops(cfg)


def transformer_decode_flops(cfg: ExperimentConfig) -> float:
    """Per-trajectory serving FLOPs for the transformer family
    (``models.transformer``): encoder self-attn stack over h_in tokens,
    then AR decode of h_out tokens with self-attn over the growing cache
    (mean T/2), cross-attn to h_in encoder tokens, and peer attention
    over K * h_out peer tokens when ctx peers are present."""
    m = cfg.model
    h, L = m.hidden, m.layers
    t_in, t_out = m.h_in, m.h_out
    k_peers = cfg.n_other_users

    def block_dense(tokens):
        # qkv + out projections (4 * 2*h^2) + MLP (2 * 2*h*4h)
        return tokens * (8.0 * h * h + 16.0 * h * h)

    def attn_scores(q_tokens, kv_tokens):
        return 2.0 * q_tokens * kv_tokens * h * 2  # QK^T + AV

    # encoder: full self-attention over t_in
    enc = L * (block_dense(t_in) + attn_scores(t_in, t_in))
    # embedding/input + output projections
    io = 2.0 * t_in * m.d * h + t_out * (2.0 * h * m.d + 2.0 * m.d * h)
    # decoder per emitted token: self over mean cache t_out/2 (qkv+out
    # and MLP are in block_dense), cross attention adds its own q and
    # OUT projections per token plus K,V projections computed once
    dec = L * (
        block_dense(t_out)
        + attn_scores(t_out, t_out / 2.0)
        + t_out * 4.0 * h * h  # cross q + out projections per token
        + attn_scores(t_out, t_in)
        + t_in * 4.0 * h * h  # cross K,V projections (once)
    )
    if k_peers:
        # the peer options shrink the peer track and attend (models.transformer):
        # peer_pool="mean" pools K tracks into one; peer_window=w
        # restricts each step's attend to the ±w temporal window
        n_tracks = 1 if m.peer_pool == "mean" else k_peers
        peer_tokens = n_tracks * t_out
        attended = (
            peer_tokens
            if m.peer_window <= 0
            else n_tracks * min(2 * m.peer_window + 1, t_out)
        )
        dec += L * (
            t_out * 4.0 * h * h  # peer q + out projections per token
            + attn_scores(t_out, attended)
            + peer_tokens * 4.0 * h * h  # peer K,V projections (once)
        )
        io += peer_tokens * 2.0 * m.d * h  # peer token embedding
    return enc + io + dec


def decode_flops(cfg: ExperimentConfig) -> float:
    if cfg.model_family == "transformer":
        return transformer_decode_flops(cfg)
    return lstm_decode_flops(cfg)


def train_flops(cfg: ExperimentConfig) -> float:
    if cfg.model_family == "transformer":
        # teacher-forced parallel pass: causal self over mean t/2
        return 3.0 * transformer_decode_flops(cfg)
    return lstm_train_flops(cfg)
