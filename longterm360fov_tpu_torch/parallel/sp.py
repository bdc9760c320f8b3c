"""Sequence parallelism for the transformer family: ring attention over a
``'seq'`` axis of a device grid (twin of
``longterm360fov_tpu.parallel.sp``).

What shards is the teacher-forced parallel decode, the training pass
(``models.transformer._parallel_decode``): shard i of the ``'seq'`` axis
keeps the tokens [i·Tc, (i+1)·Tc) of the horizon from end to end, and only
the K/V blocks of the causal self-attention travel the ring. The
autoregressive decode (evaluation, serving) stays unsharded, as in JAX:
:func:`sp_apply_fn` falls back to ``transformer.apply`` there.

One process drives every shard of a :class:`grid.DeviceGrid`, as JAX's one
controller drives a mesh:

* a ring hop is ``Tensor.to(device)``. Autograd differentiates it, so the
  backward of a hop is the reverse copy, the transpose of ``lax.ppermute``.
  A hop onto the same device is free;
* the params go to each distinct device of the grid by ``.to`` from one
  leaf; autograd sums the gradients of the copies, the transpose of
  replication, so no all-reduce is written;
* each shard's work launches on its own device, shard after shard.

The numerics are JAX's: Q, K and V are projected locally; shard i folds the
block of source ``(i - j) mod n`` at hop j, in JAX's order, with the causal
mask on global positions, an online softmax from ``_NEG = -1e30`` and the
``max(l, 1e-30)`` guard; ``impl="gather"`` concatenates every K and V block
and runs one masked softmax. The peer tokens and the teacher tokens (noise
included) are built on the whole batch before it is split, as JAX builds
them outside ``shard_map``, so a generator draws what the unsharded pass
draws. The encoder is sharded the same way (non-causal ring attention, then
gathered) when the past's length divides the axis, else it runs replicated
through the unsharded ``apply``'s encoder. A 2-D ``('data', 'seq')`` grid
splits the rows over its rows.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from ..models import transformer as T
from ..models.cell import mm
from ..models.seq2seq import Seq2SeqConfig
from .grid import DeviceGrid, device_list, grid_of
from .serve import replicate_params, shard_slices

__all__ = ["make_sp_mesh", "ring_self_attention", "sp_decode", "sp_apply_fn"]

_NEG = -1e30  # finite mask value: exp(_NEG - m) underflows to 0, no NaN


def ring_self_attention(ps: List[Dict], xs_ln: List[torch.Tensor], *, impl: str = "ring",
                        causal: bool = True) -> List[torch.Tensor]:
    """Multi-head self-attention over a time-sharded sequence.

    ``xs_ln``: the n shards' already layernormed (B, Tc, H) slices of the
    T = n·Tc tokens, in order, each on its shard's device; ``ps``: the
    attention's params {wq, wk, wv, wo} on each shard's device. Returns each
    shard's (B, Tc, H) output (``wo`` applied), equal to dense attention up
    to f32 rounding. ``causal=False`` is the encoder case: every block is
    valid and only the softmax's normalization spans the ring."""
    n = len(xs_ln)
    devs = [x.device for x in xs_ln]
    q = [T._split_heads(mm(x, p["wq"])) for p, x in zip(ps, xs_ln)]  # (B, N, Tc, d)
    k = [T._split_heads(mm(x, p["wk"])) for p, x in zip(ps, xs_ln)]
    v = [T._split_heads(mm(x, p["wv"])) for p, x in zip(ps, xs_ln)]
    scale = 1.0 / math.sqrt(q[0].shape[-1])
    tc = xs_ln[0].shape[1]
    q_pos = [i * tc + torch.arange(tc, device=d) for i, d in enumerate(devs)]

    def masked(logits, i, k_pos):
        if not causal:
            return logits
        valid = k_pos[None, :] <= q_pos[i][:, None]
        return torch.where(valid[None, None], logits, _NEG)

    def out(i, o):
        return mm(T._merge_heads(o), ps[i]["wo"])

    if impl == "gather":
        res = []
        for i, d in enumerate(devs):
            k_all = torch.cat([t.to(d) for t in k], dim=2)
            v_all = torch.cat([t.to(d) for t in v], dim=2)
            logits = masked(torch.einsum("bnqd,bnkd->bnqk", q[i], k_all) * scale, i,
                            torch.arange(n * tc, device=d))
            res.append(out(i, torch.einsum("bnqk,bnkd->bnqd", torch.softmax(logits, dim=-1), v_all)))
        return res
    if impl != "ring":
        raise ValueError(f"unknown sp impl {impl!r}")

    m = [torch.full(t.shape[:-1] + (1,), _NEG, device=t.device) for t in q]
    l = [torch.zeros(t.shape[:-1] + (1,), device=t.device) for t in q]
    acc = [torch.zeros_like(t) for t in q]
    k_blk, v_blk = k, v
    for j in range(n):
        for i in range(n):
            src = (i - j) % n  # origin shard of the resident block
            k_pos = src * tc + torch.arange(tc, device=devs[i])
            logits = masked(torch.einsum("bnqd,bnkd->bnqk", q[i], k_blk[i]) * scale, i, k_pos)
            # online softmax: every query row sees its diagonal at hop 0 (src
            # == i), so m is finite from the first fold on
            m_new = torch.maximum(m[i], logits.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m[i] - m_new)
            p_blk = torch.exp(logits - m_new)
            l[i] = alpha * l[i] + p_blk.sum(dim=-1, keepdim=True)
            acc[i] = alpha * acc[i] + torch.einsum("bnqk,bnkd->bnqd", p_blk, v_blk[i])
            m[i] = m_new
        if j + 1 < n:  # the hop: shard s's blocks move to shard s + 1
            k_blk = [k_blk[(i - 1) % n].to(devs[i]) for i in range(n)]
            v_blk = [v_blk[(i - 1) % n].to(devs[i]) for i in range(n)]
    return [out(i, acc[i] / torch.clamp(l[i], min=1e-30)) for i in range(n)]


def _sp_rows(on, cfg, devs, tok, enc_in, pm, pv, *, enc_sharded, impl):
    """The decode of one row of the grid: ``tok`` the row's teacher tokens
    (B_r, T, D), ``enc_in`` its raw past (sharded encoder) or its encoder
    memory, ``pm``/``pv`` its peer tokens (or None) → (B_r, T, D) on the
    device of ``tok``."""
    n = len(devs)
    ps = [on[d] for d in devs]
    if enc_sharded:
        tci = enc_in.shape[1] // n
        xe = [T._in_proj(p, cfg, enc_in[:, i * tci:(i + 1) * tci].to(d))
              + T._pos_enc(tci, cfg.hidden, i * tci, device=d) for i, (p, d) in enumerate(zip(ps, devs))]
        for li in range(len(ps[0]["enc"])):
            layers = [p["enc"][li] for p in ps]
            att = ring_self_attention([lay["attn"] for lay in layers], [T._ln(lay["ln1"], x) for lay, x in
                                                                        zip(layers, xe)], impl=impl, causal=False)
            xe = [x + a for x, a in zip(xe, att)]
            xe = [x + T._mlp(lay["mlp"], T._ln(lay["ln2"], x)) for lay, x in zip(layers, xe)]
        enc = [torch.cat([x.to(d) for x in xe], dim=1) for d in devs]  # the all_gather
    else:
        enc = [enc_in.to(d) for d in devs]
    tc = tok.shape[1] // n
    x = [T._in_proj(p, cfg, tok[:, i * tc:(i + 1) * tc].to(d)) + T._pos_enc(tc, cfg.hidden, i * tc, device=d)
         for i, (p, d) in enumerate(zip(ps, devs))]
    pms = pvs = tmasks = [None] * n
    if pm is not None:
        pms, pvs = [pm.to(d) for d in devs], [pv.to(d) for d in devs]
        tmasks = [T._peer_window_mask(cfg, pm.shape[1], tq=tc, q_offset=i * tc, device=d)
                  for i, d in enumerate(devs)]
    for li in range(len(ps[0]["dec"])):
        layers = [p["dec"][li] for p in ps]
        att = ring_self_attention([lay["self_attn"] for lay in layers],
                                  [T._ln(lay["ln1"], xi) for lay, xi in zip(layers, x)], impl=impl)
        x = [T._decoder_tail(lay, xi + a, e, pm_i, pv_i, peer_tmask=tm)
             for lay, xi, a, e, pm_i, pv_i, tm in zip(layers, x, att, enc, pms, pvs, tmasks)]
    home = tok.device
    outs = [(mm(T._ln(p["final_ln"], xi), p["out_proj"]["w"]) + p["out_proj"]["b"]).float().to(home)
            for p, xi in zip(ps, x)]
    return torch.cat(outs, dim=1)


def sp_decode(
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
    seq_axis: str = "seq",
    impl: str = "ring",
) -> torch.Tensor:
    """Teacher-forced parallel decode with the horizon sharded over
    ``mesh[seq_axis]``: ``transformer.apply`` with ``future_n`` given
    (noisy teacher forcing included: the same generator gives the same
    tokens) → (B, T, D) f32 on the device of ``past_n``."""
    n_seq = mesh.shape[seq_axis]
    t = future_n.shape[1]
    if t % n_seq:
        raise ValueError(f"horizon {t} not divisible by seq axis {n_seq}")
    enc_sharded = past_n.shape[1] % n_seq == 0
    enc_in = past_n.to(cfg.dtype) if enc_sharded else T._encode(params, cfg, past_n)
    peer_mem = peer_valid = None
    if other_future_n is not None:
        peer_mem, peer_valid = T._peer_tokens(params, cfg, other_future_n, other_mask)
    y0 = past_n[:, -1, :].to(cfg.dtype)
    tokens = T.teacher_tokens(cfg, y0, future_n, rng, teacher_prob)
    rows = mesh.rows(seq_axis)
    on = replicate_params(params, [d for r in rows for d in r])  # autograd sums the copies' gradients
    outs = []
    for devs, sl in zip(rows, shard_slices(past_n.shape[0], len(rows))):
        outs.append(_sp_rows(
            on, cfg, devs, tokens[sl], enc_in[sl], None if peer_mem is None else peer_mem[sl],
            None if peer_valid is None else peer_valid[sl], enc_sharded=enc_sharded, impl=impl,
        ))
    return torch.cat(outs)


def sp_apply_fn(mesh: DeviceGrid, *, seq_axis: str = "seq", impl: str = "ring"):
    """Drop-in transformer ``apply_fn`` for ``train.make_train_step`` with the
    horizon sequence-sharded; the autoregressive branch (``future_n`` None:
    evaluation, serving) falls back to the unsharded ``transformer.apply``."""

    def apply(params, cfg, past_n, future_n=None, *, rng=None, teacher_prob=1.0, other_future_n=None,
              other_mask=None, context=None):
        del context
        if future_n is None:
            return T.apply(params, cfg, past_n, other_future_n=other_future_n, other_mask=other_mask)
        return sp_decode(params, cfg, mesh, past_n, future_n, rng=rng, teacher_prob=teacher_prob,
                         other_future_n=other_future_n, other_mask=other_mask, seq_axis=seq_axis, impl=impl)

    return apply


def make_sp_mesh(seq_parallel: int, *, data_parallel: int = 0, devices=None,
                 device_type: str = "cuda") -> DeviceGrid:
    """A ``('seq',)`` or ``('data', 'seq')`` grid over ``devices`` (default
    ``grid.local_devices(device_type)``); ``data_parallel=0`` fills the
    ``'data'`` axis with the devices left over."""
    if seq_parallel < 1 or data_parallel < 0:
        raise ValueError(
            f"seq_parallel must be >= 1 (got {seq_parallel}) and "
            f"data_parallel >= 0 (got {data_parallel})"
        )
    devices = device_list(devices, device_type)
    if data_parallel == 0:
        data_parallel = max(len(devices) // seq_parallel, 1)
    n = data_parallel * seq_parallel
    if n > len(devices):
        raise ValueError(f"need {n} devices for dp={data_parallel} x sp={seq_parallel}, have {len(devices)}")
    if data_parallel == 1:
        return grid_of(devices, (seq_parallel,), ("seq",))
    return grid_of(devices, (data_parallel, seq_parallel), ("data", "seq"))
