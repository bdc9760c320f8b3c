"""Transformer seq2seq with cross-viewer attention.

PyTorch twin of ``longterm360fov_tpu.models.transformer``: an encoder of L
pre-LN layers (4-head bidirectional self-attention, tanh-GELU MLP) over the
observed window, and a decoder of L pre-LN layers (causal self-attention,
cross-attention to the encoder memory, optional attention over other
viewers' known futures, MLP), then a final LN and the output projection.

* Training is one parallel pass over the teacher-forced tokens
  (:func:`_parallel_decode`). Its exposure-bias curriculum is noisy teacher
  forcing: with a generator, the teacher inputs get Gaussian noise of sigma
  ``(1 - teacher_prob) · std(future)``, drawn by :func:`draw_noise`. The
  training hooks :func:`apply_fused_tf` and :func:`apply_fused_ss` run the
  same pass with the encoder on ``ops.transformer_encode_train``.
* Inference is the KV-cached autoregressive decode (:func:`_ar_decode`):
  the encoder and peer K/V are projected once, before the loop. It is the
  plain version the decode kernel (``ops.transformer_decode``) is held
  against; the serving path (:func:`serve_fused`) runs the encoder kernel
  (``ops.transformer_encode``) and the decode kernel.
* A position with no attendable peer token gates its peer-attention
  residual to exactly 0, so a row whose peers are all masked is the
  peerless model.

The numerics are JAX's: population variance and eps 1e-6 inside the rsqrt
of the LN, -1e9 (not -inf) on masked logits, the tanh GELU, ``[sin | cos]``
positional halves, f32 products. The serving functions' bf16 tier
(``compute_dtype=torch.bfloat16``: :func:`_encode`, :func:`_ar_decode`, the
plain versions of the kernels' bf16 tiers) is the JAX kernels' arithmetic:
both operands of every product rounded to bf16 (:func:`_mm`), the sums in
f32; the cross, peer and self K/V rounded to bf16 as stored; LN, softmax,
GELU, q and the residual stream in f32. :func:`serve_fused` serves in it by
default on the card, as JAX does on its accelerator.

Params are a plain dict, the JAX pytree's structure: ``in_proj``,
``out_proj`` {w, b}, ``final_ln`` {scale, bias}, ``enc`` a list of {ln1,
attn {wq, wk, wv, wo}, ln2, mlp {w1, b1, w2, b2}}, ``dec`` a list of {ln1,
self_attn, ln2, cross_attn, ln3, peer_attn, ln4, mlp}.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .. import draws
from .cell import mm as _mm, round_to as _round
from .seq2seq import Seq2SeqConfig

__all__ = ["init", "apply", "apply_fused_tf", "apply_fused_ss", "draw_noise", "teacher_tokens", "serve_fused",
           "batch_extras"]

N_HEADS = 4
MLP_MULT = 4


def _uniform(gen, shape, fan_in, fan_out, dtype, device):
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return ((torch.rand(shape, generator=gen) * 2 - 1) * limit).to(device=device, dtype=dtype)


def _init_attn(gen, h, dtype, device):
    return {k: _uniform(gen, (h, h), h, h, dtype, device) for k in ("wq", "wk", "wv", "wo")}


def _init_mlp(gen, h, dtype, device):
    return {
        "w1": _uniform(gen, (h, MLP_MULT * h), h, MLP_MULT * h, dtype, device),
        "b1": torch.zeros(MLP_MULT * h, dtype=dtype, device=device),
        "w2": _uniform(gen, (MLP_MULT * h, h), MLP_MULT * h, h, dtype, device),
        "b2": torch.zeros(h, dtype=dtype, device=device),
    }


def _init_ln(h, dtype, device):
    return {"scale": torch.ones(h, dtype=dtype, device=device),
            "bias": torch.zeros(h, dtype=dtype, device=device)}


def init(gen: torch.Generator, cfg: Seq2SeqConfig, *, device) -> Dict:
    """Glorot-uniform matrices (the JAX limits), zero biases, LN scale 1 and
    bias 0, drawn from a CPU generator and placed on ``device``."""
    h, dt = cfg.hidden, cfg.dtype
    params: Dict = {
        "in_proj": _uniform(gen, (cfg.d, h), cfg.d, h, dt, device),
        "out_proj": {"w": _uniform(gen, (h, cfg.d), h, cfg.d, dt, device),
                     "b": torch.zeros(cfg.d, dtype=dt, device=device)},
        "final_ln": _init_ln(h, dt, device),
        "enc": [],
        "dec": [],
    }
    for _ in range(cfg.layers):
        params["enc"].append({"ln1": _init_ln(h, dt, device), "attn": _init_attn(gen, h, dt, device),
                              "ln2": _init_ln(h, dt, device), "mlp": _init_mlp(gen, h, dt, device)})
    for _ in range(cfg.layers):
        params["dec"].append({
            "ln1": _init_ln(h, dt, device), "self_attn": _init_attn(gen, h, dt, device),
            "ln2": _init_ln(h, dt, device), "cross_attn": _init_attn(gen, h, dt, device),
            "ln3": _init_ln(h, dt, device), "peer_attn": _init_attn(gen, h, dt, device),
            "ln4": _init_ln(h, dt, device), "mlp": _init_mlp(gen, h, dt, device),
        })
    return params


def _ln(p, x):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)  # population variance, as jnp.var
    return (x - mu) * torch.rsqrt(var + 1e-6) * p["scale"] + p["bias"]


def _split_heads(x):
    b, t, h = x.shape
    return x.reshape(b, t, N_HEADS, h // N_HEADS).transpose(1, 2)


def _merge_heads(x):
    b, n, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, n * d)


def _attention(p, q_in, kv_in, *, mask=None, compute_dtype=torch.float32):
    """Multi-head attention. q_in (B, Tq, H), kv_in (B, Tk, H); mask
    (B, Tq, Tk) or (1, Tq, Tk) bool, True = attend."""
    q = _split_heads(_mm(q_in, p["wq"], compute_dtype))
    k = _split_heads(_mm(kv_in, p["wk"], compute_dtype))
    v = _split_heads(_mm(kv_in, p["wv"], compute_dtype))
    return _attention_qkv(p, q, k, v, mask=mask, compute_dtype=compute_dtype)


def _attention_qkv(p, q, k, v, *, mask=None, v_shift=None, compute_dtype=torch.float32):
    """Attention of split-head q, k, v, then ``wo``; ``v_shift`` (B, H) is
    subtracted from the merged heads before ``wo``: the group-shared peer
    tier's anchor correction δv (the weights sum to 1, so a V shifted by a
    constant shifts the output by it)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bnqd,bnkd->bnqk", q, k) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask[:, None], -1e9)
    w = torch.softmax(logits, dim=-1)
    out = _merge_heads(torch.einsum("bnqk,bnkd->bnqd", w, v))
    if v_shift is not None:
        out = out - v_shift[:, None, :]
    return _mm(out, p["wo"], compute_dtype)


def _pos_enc(t: int, h: int, offset: int = 0, *, device="cpu") -> torch.Tensor:
    """(t, h) f32: ``[sin | cos]`` halves, not interleaved."""
    pos = torch.arange(offset, offset + t, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(h // 2, dtype=torch.float32, device=device)[None, :]
    freq = torch.exp(-math.log(10000.0) * 2.0 * dim / h)
    ang = pos * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _mlp(p, x, compute_dtype=torch.float32):
    u = F.gelu(_mm(x, p["w1"], compute_dtype) + p["b1"], approximate="tanh")
    return _mm(u, p["w2"], compute_dtype) + p["b2"]


def _in_proj(params, cfg, x, compute_dtype=torch.float32):
    """``x @ in_proj`` in the model's dtype: JAX's dot without
    ``preferred_element_type`` returns its operands' type, so a bf16 model's
    token embeddings are rounded to bf16 (before the f32 positions are
    added)."""
    return _mm(x.to(cfg.dtype), params["in_proj"], compute_dtype).to(cfg.dtype)


def _encode(params, cfg, past_n, compute_dtype=torch.float32):
    """The encoder stack over (B, T, D) → enc_mem (B, T, H); in the bf16
    ``compute_dtype`` the plain version of the encoder kernel's bf16 tier."""
    x = _in_proj(params, cfg, past_n, compute_dtype) + _pos_enc(past_n.shape[1], cfg.hidden, device=past_n.device)
    for layer in params["enc"]:
        h = _ln(layer["ln1"], x)
        x = x + _attention(layer["attn"], h, h, compute_dtype=compute_dtype)
        x = x + _mlp(layer["mlp"], _ln(layer["ln2"], x), compute_dtype)
    return x


def _peer_tokens(params, cfg, other_future_n, other_mask):
    """(B, K, T, D) peers → peer memory tokens and their validity:
    ``peer_pool`` "none" (B, K·T, H), every peer its own track; "mean"
    (B, T, H), the K peers masked-mean pooled per step (``denom = max(Σ
    mask, 1)``, valid where any peer is)."""
    b, k, t, _ = other_future_n.shape
    x = _in_proj(params, cfg, other_future_n) + _pos_enc(
        t, cfg.hidden, device=other_future_n.device)[None, None]
    dev = other_future_n.device
    if cfg.peer_pool == "mean":
        if other_mask is None:
            return x.mean(dim=1), torch.ones((b, t), dtype=torch.bool, device=dev)
        m = other_mask.to(x.dtype)[:, :, None, None]
        denom = torch.clamp(m.sum(dim=1), min=1.0)
        valid = (other_mask > 0).any(dim=1)[:, None].expand(b, t)
        return (x * m).sum(dim=1) / denom, valid
    tokens = x.reshape(b, k * t, cfg.hidden)
    if other_mask is None:
        return tokens, torch.ones((b, k * t), dtype=torch.bool, device=dev)
    return tokens, other_mask.bool().repeat_interleave(t, dim=1)


def _peer_window_mask(cfg, kt, *, tq=None, t=None, q_offset=0, device="cpu"):
    """Temporal window of peer attention (``cfg.peer_window`` > 0): query
    step t attends only peer tokens with |t_k - t| <= w, where t_k is the
    token's index within its peer's segment (h_out long; the whole track
    when pooled). (Tq, KT) for the parallel pass, (KT,) for one step, or
    None when windowing is off."""
    if cfg.peer_window <= 0:
        return None
    seg = kt if cfg.peer_pool == "mean" else cfg.h_out
    idx = torch.arange(kt, device=device) % seg
    if t is not None:
        return (idx - t).abs() <= cfg.peer_window
    q = (q_offset + torch.arange(tq, device=device))[:, None]
    return (idx[None, :] - q).abs() <= cfg.peer_window


def _decoder_block(layer, x, enc_mem, peer_mem, peer_valid, *, causal_mask,
                   self_kv=None, cross_kv=None, peer_kv=None, peer_tmask=None, peer_dv=None,
                   compute_dtype=torch.float32):
    """One decoder layer on (B, Tq, H). With ``self_kv`` = (k, v) the self
    keys and values come from the cache; ``cross_kv``/``peer_kv`` are the
    precomputed encoder and peer K, V of the decode; ``peer_dv`` (B, H) the
    layer's anchor correction, subtracted from the peer-attend output."""
    cd = compute_dtype
    h_in = _ln(layer["ln1"], x)
    if self_kv is None:
        x = x + _attention(layer["self_attn"], h_in, h_in, mask=causal_mask, compute_dtype=cd)
    else:
        q = _split_heads(_mm(h_in, layer["self_attn"]["wq"], cd))
        x = x + _attention_qkv(layer["self_attn"], q, *self_kv, mask=causal_mask, compute_dtype=cd)
    return _decoder_tail(layer, x, enc_mem, peer_mem, peer_valid, cross_kv=cross_kv, peer_kv=peer_kv,
                         peer_tmask=peer_tmask, peer_dv=peer_dv, compute_dtype=cd)


def _decoder_tail(layer, x, enc_mem, peer_mem, peer_valid, *, cross_kv=None, peer_kv=None, peer_tmask=None,
                  peer_dv=None, compute_dtype=torch.float32):
    """A decoder layer after its self-attention residual: cross-attention,
    peer attention and the MLP, each position on its own (the sequence
    parallel pass runs it on each shard's slice of the tokens)."""
    cd = compute_dtype
    h2 = _ln(layer["ln2"], x)
    if cross_kv is None:
        x = x + _attention(layer["cross_attn"], h2, enc_mem, compute_dtype=cd)
    else:
        q = _split_heads(_mm(h2, layer["cross_attn"]["wq"], cd))
        x = x + _attention_qkv(layer["cross_attn"], q, *cross_kv, compute_dtype=cd)
    if peer_mem is not None:
        q_in = _ln(layer["ln3"], x)
        mask3 = peer_valid[:, None, :]
        if peer_tmask is not None:
            mask3 = mask3 & peer_tmask[None]  # (B, Tq, KT)
        if peer_kv is None:
            pa = _attention(layer["peer_attn"], q_in, peer_mem, mask=mask3, compute_dtype=cd)
        else:
            qp = _split_heads(_mm(q_in, layer["peer_attn"]["wq"], cd))
            pa = _attention_qkv(layer["peer_attn"], qp, *peer_kv, mask=mask3, v_shift=peer_dv, compute_dtype=cd)
        # positions with no attendable peer token gate to exactly 0
        has_peer = mask3.any(dim=-1)[..., None]
        x = x + torch.where(has_peer, pa, 0.0)
    return x + _mlp(layer["mlp"], _ln(layer["ln4"], x), cd)


def draw_noise(gen, shape) -> torch.Tensor:
    """N(0, 1) f32 noise of noisy teacher forcing, on the generator's device,
    in one call, from a ``torch.Generator`` or a data-parallel rank's rows of
    the global batch's noise (``draws.RankDraw``). ``jax.random.normal``
    gives other numbers, so parity tests patch the draw on both sides."""
    return draws.randn(gen, shape, dim=0)


def teacher_tokens(cfg, y0, future_n, rng=None, teacher_prob=1.0):
    """Teacher-forced decoder inputs: token t is the true position at t - 1,
    with, given ``rng``, noise of sigma ``(1 - teacher_prob) · std(future)``
    (the population std over the whole array; under a ``draws.RankDraw``,
    over every rank's rows)."""
    tokens = torch.cat([y0[:, None], future_n[:, :-1].to(cfg.dtype)], dim=1)
    if rng is not None:
        sigma = (1.0 - teacher_prob) * draws.batch_std(rng, future_n.float())
        tokens = tokens + (sigma * draw_noise(rng, tokens.shape)).to(tokens.dtype)
    return tokens


def _parallel_decode(params, cfg, enc_mem, peer_mem, peer_valid, y0, future_n, *, rng=None,
                     teacher_prob=1.0):
    t = future_n.shape[1]
    dev = future_n.device
    x = _in_proj(params, cfg, teacher_tokens(cfg, y0, future_n, rng, teacher_prob)) + _pos_enc(
        t, cfg.hidden, device=dev)
    causal = torch.tril(torch.ones((t, t), dtype=torch.bool, device=dev))[None]
    tmask = None if peer_mem is None else _peer_window_mask(cfg, peer_mem.shape[1], tq=t, device=dev)
    for layer in params["dec"]:
        x = _decoder_block(layer, x, enc_mem, peer_mem, peer_valid, causal_mask=causal, peer_tmask=tmask)
    x = _ln(params["final_ln"], x)
    return (_mm(x, params["out_proj"]["w"]) + params["out_proj"]["b"]).float()


def _ar_decode(params, cfg, enc_mem, peer_mem, peer_valid, y0, *, peer_gid=None, peer_dv=None,
               compute_dtype=torch.float32):
    """KV-cached decode: encoder and peer K, V projected once, before the
    loop; then one token a step through the decoder stack, its output fed
    back. The plain version of ``ops.transformer_decode.fused_ar_decode``.
    The self caches grow by one entry a step; the JAX scan's fixed-size
    caches mask the entries past t to weights of exactly 0, so the two
    compute the same function.

    Group-shared peers: with ``peer_gid`` (B,), ``peer_mem`` (G, KT, H) and
    ``peer_valid`` (G, KT) hold G peer sets; each group's K, V is projected
    once and row b attends group ``peer_gid[b]``'s, with ``peer_dv`` (B, L,
    H), when given, subtracted from layer l's peer-attend output before
    ``wo`` (the per-row anchor correction).

    In the bf16 ``compute_dtype``, the plain version of the decode kernel's
    bf16 tier: the products' operands rounded (:func:`_mm`), the cross, peer
    and self K/V rounded as stored, the rest f32. A bf16 model keeps its
    self caches in bf16 and feeds back a bf16 y, as JAX's decode."""
    cd = compute_dtype

    def kv_of(mem, w, cache=False):  # the K or V of a memory, as stored
        kv = _round(_mm(mem, w, cd), cd)
        return _split_heads(kv.to(cfg.dtype).float() if cache else kv)

    kv = []
    for layer in params["dec"]:
        ca, pa = layer["cross_attn"], layer["peer_attn"]
        ck, cv = kv_of(enc_mem, ca["wk"]), kv_of(enc_mem, ca["wv"])
        if peer_mem is not None:
            pk, pv = kv_of(peer_mem, pa["wk"]), kv_of(peer_mem, pa["wv"])
            if peer_gid is not None:
                pk, pv = pk[peer_gid], pv[peer_gid]
        else:
            pk = pv = None
        kv.append((ck, cv, pk, pv))
    if peer_gid is not None:
        peer_valid = peer_valid[peer_gid]
    pos_all = _pos_enc(cfg.h_out, cfg.hidden, device=y0.device)
    caches = [([], []) for _ in params["dec"]]
    y, ys = y0, []
    for t in range(cfg.h_out):
        x = (_in_proj(params, cfg, y, cd) + pos_all[t])[:, None, :]
        tmask = None
        if peer_mem is not None and cfg.peer_window > 0:
            tmask = _peer_window_mask(cfg, peer_mem.shape[1], t=t, device=y0.device)[None, :]
        for l, (layer, (ck, cv, pk, pv), (ks, vs)) in enumerate(zip(params["dec"], kv, caches)):
            h_in = _ln(layer["ln1"], x)
            ks.append(kv_of(h_in, layer["self_attn"]["wk"], cache=True))
            vs.append(kv_of(h_in, layer["self_attn"]["wv"], cache=True))
            x = _decoder_block(
                layer, x, enc_mem, peer_mem, peer_valid, causal_mask=None,
                self_kv=(torch.cat(ks, dim=2), torch.cat(vs, dim=2)), cross_kv=(ck, cv),
                peer_kv=None if pk is None else (pk, pv), peer_tmask=tmask,
                peer_dv=None if peer_dv is None else peer_dv[:, l], compute_dtype=cd,
            )
        x = _ln(params["final_ln"], x)
        y = (_mm(x[:, 0], params["out_proj"]["w"], cd) + params["out_proj"]["b"]).to(cfg.dtype)
        ys.append(y)
    return torch.stack(ys, dim=1).float()


def apply(
    params: Dict,
    cfg: Seq2SeqConfig,
    past_n: torch.Tensor,
    future_n: Optional[torch.Tensor] = None,
    *,
    rng: Optional[torch.Generator] = None,
    teacher_prob=1.0,
    other_future_n: Optional[torch.Tensor] = None,
    other_mask: Optional[torch.Tensor] = None,
    context: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Teacher-forced parallel pass (``future_n`` given; with ``rng``, noisy
    teacher forcing at ``teacher_prob``) or the KV-cached autoregressive
    decode (``future_n`` None) → (B, H_out, D) f32. ``context`` is accepted
    and ignored, as in JAX."""
    del context
    return _decode(params, cfg, _encode(params, cfg, past_n), past_n, future_n, rng, teacher_prob,
                   other_future_n, other_mask)


def _decode(params, cfg, enc_mem, past_n, future_n, rng, teacher_prob, other_future_n, other_mask):
    """``apply`` after its encoder: the peer tokens, then the parallel pass
    or the autoregressive decode."""
    peer_mem = peer_valid = None
    if other_future_n is not None:
        peer_mem, peer_valid = _peer_tokens(params, cfg, other_future_n, other_mask)
    y0 = past_n[:, -1, :].to(cfg.dtype)
    if future_n is not None:
        return _parallel_decode(params, cfg, enc_mem, peer_mem, peer_valid, y0, future_n, rng=rng,
                                teacher_prob=teacher_prob)
    return _ar_decode(params, cfg, enc_mem, peer_mem, peer_valid, y0)


def _train_encoder(params, cfg, past_n):
    """The training encoder of the fused hooks: ``fused_encode_train`` (its
    kernels on the card, autograd through ``_encode`` on the CPU) where
    ``encode_kernel_fits``, else ``_encode``, as the serving path routes. A
    bf16 model (``--bf16``) trains through ``_encode`` in bf16: the kernels
    are f32 only, and JAX runs no kernel in this step at all."""
    from ..ops.transformer_encode import encode_kernel_fits
    from ..ops.transformer_encode_train import fused_encode_train

    if cfg.dtype == torch.float32 and encode_kernel_fits(past_n.shape[1]):
        return fused_encode_train(params, cfg, past_n.float().contiguous())
    return _encode(params, cfg, past_n)


def apply_fused_tf(
    params: Dict,
    cfg: Seq2SeqConfig,
    past_n: torch.Tensor,
    future_n: torch.Tensor,
    *,
    other_future_n: Optional[torch.Tensor] = None,
    other_mask: Optional[torch.Tensor] = None,
    context: Optional[torch.Tensor] = None,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """Teacher-forced training forward: :func:`apply`'s parallel pass with
    the encoder on ``ops.transformer_encode_train`` (the hook
    ``train.make_grad_fn`` runs under ``train_impl`` "auto"/"fused").

    ``compute_dtype`` (``train --train-compute``) is ignored: the JAX
    transformer has no fused training hook, so its step runs in f32 under
    the flag, and so does this one."""
    del context, compute_dtype
    return _decode(params, cfg, _train_encoder(params, cfg, past_n), past_n, future_n, None, 1.0,
                   other_future_n, other_mask)


def apply_fused_ss(
    params: Dict,
    cfg: Seq2SeqConfig,
    past_n: torch.Tensor,
    future_n: torch.Tensor,
    *,
    rng: Optional[torch.Generator] = None,
    teacher_prob=1.0,
    other_future_n: Optional[torch.Tensor] = None,
    other_mask: Optional[torch.Tensor] = None,
    context: Optional[torch.Tensor] = None,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """Noisy-teacher-forcing training forward (the family's scheduled
    sampling): :func:`apply`'s parallel pass with ``rng`` at
    ``teacher_prob``, the encoder on ``ops.transformer_encode_train``;
    ``compute_dtype`` is ignored, as in :func:`apply_fused_tf`."""
    del context, compute_dtype
    return _decode(params, cfg, _train_encoder(params, cfg, past_n), past_n, future_n, rng,
                   teacher_prob, other_future_n, other_mask)


def serve_fused(
    params: Dict,
    cfg: Seq2SeqConfig,
    past_n: torch.Tensor,
    *,
    context: Optional[torch.Tensor] = None,
    other_future_n: Optional[torch.Tensor] = None,
    other_mask: Optional[torch.Tensor] = None,
    group_future_n: Optional[torch.Tensor] = None,
    group_mask: Optional[torch.Tensor] = None,
    peer_gid: Optional[torch.Tensor] = None,
    peer_anchor: Optional[torch.Tensor] = None,
    compute_dtype=None,
) -> torch.Tensor:
    """Serving decode: the encoder on the ``fused_encode_tokens`` kernel
    where ``encode_kernel_fits`` (else the plain ``_encode``), the peer
    tokens in PyTorch, then the whole rollout in one ``fused_ar_decode``
    launch: on CUDA tensors the kernels, on CPU tensors their plain
    versions. Past the kernels' own limits it raises: nothing falls back.

    Per-row peers: ``other_future_n`` (B, K, T, D) and ``other_mask``.
    Group-shared peers (the production wiring of the dedup tier):
    ``group_future_n`` (G, K, T, D) raw peer sets, ``group_mask`` (G, K),
    ``peer_gid`` (B,) row → group, in any order; the peer tokens are
    embedded and their K/V projected once a group. With ``peer_anchor``
    (B, D), each row's peers are anchored to it, as ``batch_extras`` anchors
    per-row peers: the peer-token pipeline is affine and attention is
    shift-invariant in K with weights summing to 1 over V, so the anchor
    factors out of the shared K/V exactly (in real arithmetic; f32 about
    1e-5) as δv[l] = (anchor · in_proj) · wv[l], which the decode subtracts
    from layer l's peer-attend output. JAX's fallback to per-row copies
    past the TPU's VMEM (``peer_shared_fits``) has no counterpart: the K/V
    lives in device memory, and past it the allocation raises.

    ``compute_dtype`` None resolves as JAX's does, by where the tensors
    are: bf16 on the card (the accelerator; JAX's TPU default) and f32 on
    the CPU. An explicit ``torch.float32`` keeps the exact tier on the card,
    ``torch.bfloat16`` runs the bf16 tier's plain versions on the CPU. The
    encoder runs the tier where it runs a kernel (T <= 64); the plain
    ``_encode`` past it stays f32, as in JAX. δv is f32 in both tiers.

    Raising: per-row and grouped peers together, and a ``compute_dtype``
    other than f32 and bf16."""
    del context
    from ..ops.transformer_decode import fused_ar_decode, fused_ar_decode_shared
    from ..ops.transformer_encode import encode_kernel_fits, fused_encode_tokens

    if compute_dtype is None:
        compute_dtype = torch.bfloat16 if past_n.device.type == "cuda" else torch.float32
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"transformer.serve_fused serves in float32 or bfloat16, got {compute_dtype}")
    grouped = group_future_n is not None
    if grouped and other_future_n is not None:
        raise ValueError("pass per-row peers (other_future_n) or grouped peers (group_future_n), not both")
    if grouped != (peer_gid is not None) or (not grouped and (group_mask is not None or peer_anchor is not None)):
        raise ValueError("group_future_n and peer_gid come together; group_mask and peer_anchor need them")
    if encode_kernel_fits(past_n.shape[1]):
        enc_mem = fused_encode_tokens(params, cfg, past_n, compute_dtype=compute_dtype)
    else:
        enc_mem = _encode(params, cfg, past_n)
    y0 = past_n[:, -1, :].to(cfg.dtype).contiguous()
    if grouped:
        gmem, gvalid = _peer_tokens(params, cfg, group_future_n, group_mask)
        dv = None
        if peer_anchor is not None:
            e = peer_anchor.float() @ params["in_proj"].float()
            dv = torch.stack([e @ layer["peer_attn"]["wv"].float() for layer in params["dec"]], dim=1)
        return fused_ar_decode_shared(params, cfg, enc_mem, y0, peer_gmem=gmem.float().contiguous(),
                                      peer_gvalid=gvalid.contiguous(), peer_gid=peer_gid.contiguous(),
                                      peer_dv=dv, compute_dtype=compute_dtype)
    peer_mem = peer_valid = None
    if other_future_n is not None:
        peer_mem, peer_valid = _peer_tokens(params, cfg, other_future_n, other_mask)
        peer_mem, peer_valid = peer_mem.float().contiguous(), peer_valid.contiguous()
    return fused_ar_decode(params, cfg, enc_mem, y0, peer_mem=peer_mem, peer_valid=peer_valid,
                           compute_dtype=compute_dtype)


def batch_extras(batch: Dict, anchor: torch.Tensor) -> Dict:
    """Peer futures in the target viewer's anchor frame, as cross_user's."""
    of = batch.get("other_future")
    if of is None:
        return {}
    return {"other_future_n": of - anchor[:, None], "other_mask": batch.get("other_mask")}
