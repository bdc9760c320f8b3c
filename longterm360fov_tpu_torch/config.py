"""Typed experiment configuration + named presets.

Copy of ``longterm360fov_tpu.config`` over the port's ``Seq2SeqConfig``:
the same frozen dataclasses, the same seven presets, and the same
``hash``/``model_hash``, so that both packages agree byte for byte on what
a checkpoint means (tested against the JAX values).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict

from .models.seq2seq import Seq2SeqConfig

__all__ = ["ExperimentConfig", "PRESETS", "get_preset"]

# Seq2SeqConfig fields added AFTER the last checkpoint era that hashed
# n_other_users (pre-r4). model_hash(_legacy_peers=...) pops these to
# reproduce the exact dict shape those checkpoints hashed. Append-only:
# any new model field added while legacy checkpoints remain in use
# belongs here too.
_POST_LEGACY_MODEL_FIELDS = ("peer_align",)


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str
    model: Seq2SeqConfig = Seq2SeqConfig()
    model_family: str = "seq2seq"  # seq2seq | cross_user | fusion | transformer

    # -- training ----------------------------------------------------------
    batch_size: int = 128
    lr: float = 1e-3
    warmup_steps: int = 0  # >0: linear warmup + cosine decay to lr/10
    grad_clip: float = 1.0
    steps: int = 2000
    eval_every: int = 200
    ckpt_every: int = 500
    gc_weight: float = 0.0  # blend of spherical great-circle loss
    # scheduled sampling: teacher_prob anneals ss_start → ss_end over steps
    scheduled_sampling: bool = False
    # training forward impl of the JAX package: "auto" | "xla" | "fused"
    train_impl: str = "auto"
    # matmul compute dtype inside the fused training kernels: "bfloat16"
    # (f32 accumulation, f32 carries) or "float32" (default, exact)
    train_compute: str = "float32"
    # gradient accumulation: split each batch into `accum` microbatches,
    # sum their grads, apply ONE optimizer update. Lets a logical batch
    # exceed what activations fit in device memory. batch_size must
    # divide evenly. Grads == full-batch grads to fp32 tolerance for
    # deterministic forwards (teacher forcing); under scheduled sampling
    # each microbatch draws its own Bernoulli subkey, so the stochastic
    # draw differs from the one-shot batch (documented, tested).
    accum: int = 1
    ss_start: float = 1.0
    ss_end: float = 0.0

    # -- data --------------------------------------------------------------
    rate_hz: float = 10.0
    stride: int = 1
    n_other_users: int = 4  # cross-user context size (K peers)
    seed: int = 0

    # -- parallel ----------------------------------------------------------
    data_parallel: bool = False  # shard batch over all local devices

    def hash(self) -> str:
        """Stable content hash, stored in checkpoints (SURVEY.md §5)."""
        d = dataclasses.asdict(self)
        return hashlib.sha256(
            json.dumps(d, sort_keys=True).encode()
        ).hexdigest()[:16]

    def model_hash(self, *, _legacy_peers=None) -> str:
        """Hash of the fields that define what the checkpointed params
        MEAN (architecture + family). Training hyperparameters (lr,
        steps, ...) are deliberately excluded so a checkpoint trained
        with CLI overrides still evaluates under the bare preset; a
        mismatch here means the params would be silently
        misinterpreted. n_other_users is also excluded (r4): the peer
        encoder is shared across K and the pool is mask-gated, so the
        SAME params serve any inference-time peer count — K is a
        data/serving-schema knob (--peers), not an architecture field.
        ``_legacy_peers`` reproduces the pre-r4 hash (which included
        n_other_users, and predates every field in
        ``_POST_LEGACY_MODEL_FIELDS``) so checkpoints written then
        still load (checkpoint.check_model_config)."""
        d = {
            "model": dataclasses.asdict(self.model),
            "model_family": self.model_family,
        }
        if _legacy_peers is not None:
            # The pre-r4 dict shape: model fields added since then did
            # not exist, so they must be absent from the hashed dict —
            # not merely default-valued (ADVICE r4 high).
            for f in _POST_LEGACY_MODEL_FIELDS:
                d["model"].pop(f, None)
            d["n_other_users"] = _legacy_peers
        return hashlib.sha256(
            json.dumps(d, sort_keys=True, default=str).encode()
        ).hexdigest()[:16]

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


def _presets() -> Dict[str, ExperimentConfig]:
    """One preset per BASELINE.json config row (lines 7-11), plus the
    transformer-30 extension (the matched-horizon quality recipe)."""
    return {
        # BASELINE.json:7 — 1-layer LSTM, xyz, 10-in/10-out, single viewer
        "lstm-xyz-10": ExperimentConfig(
            name="lstm-xyz-10",
            model=Seq2SeqConfig(d=3, hidden=128, layers=1, h_in=10, h_out=10),
        ),
        # BASELINE.json:8 — seq2seq encoder–decoder, 30-frame horizon,
        # teacher forcing, batched traces
        "seq2seq-tf-30": ExperimentConfig(
            name="seq2seq-tf-30",
            model=Seq2SeqConfig(d=3, hidden=128, layers=1, h_in=30, h_out=30),
        ),
        # BASELINE.json:9 — stacked LSTM + scheduled sampling,
        # multi-viewer cross-user prediction
        "stacked-ss-crossuser": ExperimentConfig(
            name="stacked-ss-crossuser",
            model=Seq2SeqConfig(
                d=3, hidden=128, layers=2, h_in=30, h_out=30, ctx_dim=128
            ),
            model_family="cross_user",
            scheduled_sampling=True,
        ),
        # The repo's 100-frame QUALITY RECORD as a named preset (r5,
        # VERDICT r4 next #3): the BASELINE.json:9 family at the
        # BASELINE.json:11 10-second horizon. K=7 TIME-ALIGNED peers —
        # decoder step t conditions on the masked mean of the peer
        # encoders' hidden states at step t (model.peer_align; the LSTM
        # analog of the transformer's windowed peer attention) — took
        # the 100-frame record in r4: 15.32±0.39 mean° / 18.66±0.28
        # final-step over 3 seeds (~3.7σ below transformer-10s).
        # experiments.jsonl kind=lstm_100f
        # name=stacked-ss-crossuser-100-align-k7.
        "stacked-ss-crossuser-10s": ExperimentConfig(
            name="stacked-ss-crossuser-10s",
            model=Seq2SeqConfig(
                d=3, hidden=128, layers=2, h_in=100, h_out=100,
                ctx_dim=128, peer_align=True,
            ),
            model_family="cross_user",
            scheduled_sampling=True,
            n_other_users=7,
            steps=4000,
        ),
        # BASELINE.json:10 — video-aware fusion: equirect saliency/conv
        # features + trajectory seq2seq
        "video-fusion": ExperimentConfig(
            name="video-fusion",
            model=Seq2SeqConfig(
                d=3, hidden=128, layers=2, h_in=30, h_out=30, ctx_dim=64
            ),
            model_family="fusion",
            scheduled_sampling=True,
        ),
        # BASELINE.json:11 — Transformer seq2seq, 10 s horizon (100 frames
        # @10 Hz), cross-viewer attention (stretch). Hyperparameters are
        # the round-2 quality recipe (RESULTS.md): 2 layers + peers +
        # annealed noisy teacher forcing took the round-1 configuration
        # from 29.65° to 16.98° mean at this horizon — and halving the
        # depth also halves the serving rollout cost.
        "transformer-10s": ExperimentConfig(
            name="transformer-10s",
            model=Seq2SeqConfig(
                d=3, hidden=128, layers=2, h_in=100, h_out=100,
                # r3: ±8-frame windowed peer attention — at the
                # 10-second horizon the temporal-locality bias both
                # improves accuracy (16.55° vs the 16.98° r2 record,
                # RESULTS.md) and cuts the peer-attention work
                peer_window=8,
            ),
            model_family="transformer",
            lr=1e-3,
            warmup_steps=300,
            steps=4000,
            scheduled_sampling=True,  # transformer: noisy teacher forcing
            ss_start=1.0,
            ss_end=0.3,
        ),
        # Matched-horizon transformer (extension beyond the BASELINE rows):
        # the recipe that beats the best LSTM config at 30 frames —
        # 2 layers, cross-viewer peers, annealed noisy teacher forcing
        # (RESULTS.md round-2 table: 6.54° vs stacked-ss-crossuser 7.20°).
        # Step-hungry: needs ~4000 steps where the LSTMs saturate by 1500.
        "transformer-30": ExperimentConfig(
            name="transformer-30",
            model=Seq2SeqConfig(d=3, hidden=128, layers=2, h_in=30, h_out=30),
            model_family="transformer",
            lr=1e-3,
            warmup_steps=300,
            steps=4000,
            scheduled_sampling=True,  # transformer: noisy teacher forcing
            ss_start=1.0,
            ss_end=0.3,
            # r3 recipe addition: spherical-loss blend measured
            # 6.25±0.36 vs 6.50±0.18 without (3 seeds, RESULTS.md) —
            # closes the gap to stacked-ss-crossuser to insignificance
            gc_weight=0.3,
        ),
    }


PRESETS: Dict[str, ExperimentConfig] = _presets()


def get_preset(name: str, **overrides) -> ExperimentConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    cfg = PRESETS[name]
    if overrides:
        model_over = {
            k[6:]: v for k, v in overrides.items() if k.startswith("model_") and k != "model_family"
        }
        top_over = {
            k: v for k, v in overrides.items() if not (k.startswith("model_") and k != "model_family")
        }
        if model_over:
            top_over["model"] = dataclasses.replace(cfg.model, **model_over)
        cfg = dataclasses.replace(cfg, **top_over)
    return cfg
