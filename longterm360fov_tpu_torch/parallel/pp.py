"""Pipeline parallelism for the transformer family: GPipe microbatches over a
``'stage'`` axis of a device grid (twin of
``longterm360fov_tpu.parallel.pp``).

The L decoder layers split into S contiguous groups of L/S, one a stage;
the batch splits into M microbatches (M = S by default). Microbatch m runs
on stage s at tick s + m, over M + S - 1 ticks, and each stage's output hops
to stage s + 1 by ``Tensor.to(device)``; the final layernorm and the head run
on the last stage. JAX's ``lax.scan`` over the ticks computes garbage where a
stage holds no live microbatch and masks it out; here those ticks are
skipped, so the result is the same function. The backward is autograd
through the hops, as JAX's is the transpose of its scan and its
``ppermute``s.

The embedding, the positions, the encoder, the peer tokens and the teacher
tokens (noise included) are prepared replicated on the device of the
inputs, as JAX prepares them before ``shard_map``. One process drives every
stage, as in :mod:`.sp`: each stage's layers are copied to its device from
the one leaf, and autograd sums the copies' gradients.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..models import transformer as T
from ..models.cell import mm
from ..models.seq2seq import Seq2SeqConfig
from ..params import walk
from .grid import DeviceGrid, device_list, grid_of

__all__ = ["make_pp_mesh", "pp_decode", "pp_apply_fn"]


def make_pp_mesh(n_stages: int, *, devices=None, device_type: str = "cuda") -> DeviceGrid:
    """A 1-D ``('stage',)`` grid over the first ``n_stages`` of ``devices``
    (default ``grid.local_devices(device_type)``)."""
    if n_stages < 2:
        raise ValueError(f"n_stages must be >= 2 (got {n_stages})")
    devices = device_list(devices, device_type)
    if n_stages > len(devices):
        raise ValueError(f"need {n_stages} devices for pp={n_stages}, have {len(devices)}")
    return grid_of(devices, (n_stages,), ("stage",))


def pp_decode(
    params: Dict,
    cfg: Seq2SeqConfig,
    mesh: DeviceGrid,
    past_n: torch.Tensor,
    future_n: torch.Tensor,
    *,
    rng: Optional[torch.Generator] = None,
    teacher_prob=1.0,
    other_future_n: Optional[torch.Tensor] = None,
    other_mask: Optional[torch.Tensor] = None,
    n_microbatches: int = 0,
) -> torch.Tensor:
    """Teacher-forced parallel decode with the decoder's layers pipelined
    over ``mesh['stage']``: ``transformer.apply`` with ``future_n`` given
    → (B, T, D) f32 on the device of ``past_n``. ``n_microbatches=0`` takes
    the stage count."""
    n_stages = mesh.shape["stage"]
    n_layers = len(params["dec"])
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} decoder layers not divisible by {n_stages} stages")
    m_micro = n_microbatches or n_stages
    b = future_n.shape[0]
    if b % m_micro:
        raise ValueError(f"batch {b} not divisible by {m_micro} microbatches")
    lps = n_layers // n_stages

    # replicated prep: the unsharded parallel pass's
    t = future_n.shape[1]
    home = past_n.device
    enc_mem = T._encode(params, cfg, past_n)
    peer_mem = peer_valid = None
    if other_future_n is not None:
        peer_mem, peer_valid = T._peer_tokens(params, cfg, other_future_n, other_mask)
    y0 = past_n[:, -1, :].to(cfg.dtype)
    tokens = T.teacher_tokens(cfg, y0, future_n, rng, teacher_prob)
    x0 = T._in_proj(params, cfg, tokens) + T._pos_enc(t, cfg.hidden, device=home)

    devs = list(mesh.devices.reshape(-1))
    stages = []
    for s, d in enumerate(devs):
        stages.append(dict(
            layers=[walk(lay, lambda _, a: a.to(d)) for lay in params["dec"][s * lps:(s + 1) * lps]],
            enc=enc_mem.to(d),
            pm=None if peer_mem is None else peer_mem.to(d),
            pv=None if peer_valid is None else peer_valid.to(d),
            causal=torch.tril(torch.ones((t, t), dtype=torch.bool, device=d))[None],
            tmask=None if peer_mem is None else T._peer_window_mask(cfg, peer_mem.shape[1], tq=t, device=d),
        ))
    bm = b // m_micro
    buf = [None] * n_stages  # the activation each stage received at the end of the last tick
    outputs = [None] * m_micro
    for tick in range(m_micro + n_stages - 1):
        nxt = [None] * n_stages
        for s, (d, st) in enumerate(zip(devs, stages)):
            mb = tick - s  # the microbatch live on stage s at this tick
            if not 0 <= mb < m_micro:
                continue
            rows = slice(mb * bm, (mb + 1) * bm)
            x = x0[rows].to(d) if s == 0 else buf[s]
            pm = None if st["pm"] is None else st["pm"][rows]
            pv = None if st["pv"] is None else st["pv"][rows]
            for lay in st["layers"]:
                x = T._decoder_block(lay, x, st["enc"][rows], pm, pv, causal_mask=st["causal"],
                                     peer_tmask=st["tmask"])
            if s == n_stages - 1:
                outputs[mb] = x
            else:
                nxt[s + 1] = x.to(devs[s + 1])  # the hop to the next stage
        buf = nxt
    last = devs[-1]
    x = T._ln(walk(params["final_ln"], lambda _, a: a.to(last)), torch.cat(outputs))
    head = walk(params["out_proj"], lambda _, a: a.to(last))
    return (mm(x, head["w"]) + head["b"]).float().to(home)


def pp_apply_fn(mesh: DeviceGrid, *, n_microbatches: int = 0):
    """Drop-in transformer ``apply_fn`` for ``train.make_train_step`` with the
    decoder's layers pipelined; the autoregressive branch (``future_n``
    None: evaluation, serving) falls back to the unsharded
    ``transformer.apply``."""

    def apply(params, cfg, past_n, future_n=None, *, rng=None, teacher_prob=1.0, other_future_n=None,
              other_mask=None, context=None):
        del context
        if future_n is None:
            return T.apply(params, cfg, past_n, other_future_n=other_future_n, other_mask=other_mask)
        return pp_decode(params, cfg, mesh, past_n, future_n, rng=rng, teacher_prob=teacher_prob,
                         other_future_n=other_future_n, other_mask=other_mask, n_microbatches=n_microbatches)

    return apply
