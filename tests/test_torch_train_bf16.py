"""Training in the bf16-compute tier (``train --train-compute bfloat16``)
against the JAX package, on the CPU: the four LSTM families' fused training
forwards, one train step, the CLI, and the transformer, which ignores the
flag as JAX's does.

The JAX Pallas kernels run in interpret mode with
``compute_dtype=bfloat16``; the port runs its kernels' plain bf16 versions
on CPU tensors. Widths are the presets' (H = 128, the contexts C = 128 and
64), cut in batch (8), steps (8 + 7) and peers (K = 3).

The bound of a whole model's forward and gradients is on root-mean-square
distances, not maxima: the kernels' interface tests hold maxima
(tests/test_torch_lstm_train.py), but through a model one operand that
rounds the other way after an f32 difference of an ulp is carried through
every later step and the fed-back prediction, so the largest entry of a
small leaf's gradient may stand most of that leaf's gap from JAX's, while
the bulk stands a few percent from it. So: the output within a fifth of the
RMS of JAX bf16 − JAX f32 (and its largest entry within half the largest),
the gradients, each leaf scaled by its max|g|, within a quarter of their
RMS gap, and the port's bf16 at least half the gap from its own f32 in
both: a version that forgets to round stands a whole gap away.
"""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longterm360fov_tpu import train as jax_train
from longterm360fov_tpu.config import ExperimentConfig as JaxExperimentConfig
from longterm360fov_tpu.models import cross_user as CU
from longterm360fov_tpu.models import fusion as JF
from longterm360fov_tpu.models import seq2seq as S
from longterm360fov_tpu_torch import cli, train
from longterm360fov_tpu_torch.config import ExperimentConfig
from longterm360fov_tpu_torch.models import cross_user, fusion, seq2seq, transformer
from longterm360fov_tpu_torch.ops import lstm_train
from longterm360fov_tpu_torch.params import params_from_numpy, tree_leaves

FWD_FRAC, GRAD_FRAC = 0.2, 0.25  # of the RMS gap (module docstring)
B, H_IN, H_OUT, K = 8, 8, 7, 3
DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _case(family, seed):
    """(jax cfg, port cfg, jax params, numpy inputs) of one family at the
    presets' widths."""
    kw = dict(d=3, hidden=128, layers=2, h_in=H_IN, h_out=H_OUT)
    kw.update({"seq2seq": {}, "fusion": dict(ctx_dim=64), "cross_user": dict(ctx_dim=128),
               "peer_align": dict(ctx_dim=128, peer_align=True)}[family])
    jcfg, tcfg = S.Seq2SeqConfig(**kw), seq2seq.Seq2SeqConfig(**kw)
    key = jax.random.PRNGKey(seed)
    jp = (JF.init(key, jcfg, feature_dim=32) if family == "fusion"
          else S.init(key, jcfg) if family == "seq2seq" else CU.init(key, jcfg))
    rng = np.random.default_rng(seed)
    mask = (rng.random((B, K)) < 0.6).astype(np.float32)
    mask[0] = 0.0  # a row with every peer absent
    io = dict(past=rng.normal(size=(B, H_IN, 3)).astype(np.float32) * 0.5,
              fut=rng.normal(size=(B, H_OUT, 3)).astype(np.float32) * 0.5,
              others=rng.normal(size=(B, K, H_OUT, 3)).astype(np.float32) * 0.5, mask=mask,
              features=rng.normal(size=(B, 32)).astype(np.float32),
              coins=(rng.random((H_OUT, B, 1)) < 0.5).astype(np.float32))
    return jcfg, tcfg, jp, io


def _jax_forward(family, jp, jcfg, io, cd):
    j = {k: _j(v) for k, v in io.items()}
    kw = dict(tile_b=8, residual_dtype=jnp.float32, compute_dtype=DT[cd][0])
    if family == "seq2seq":
        return S.apply_fused_tf(jp, jcfg, j["past"], j["fut"], **kw)
    if family == "peer_align":
        return CU._apply_fused_aligned(jp, jcfg, j["past"], j["fut"], other_future_n=j["others"],
                                       other_mask=j["mask"], context=None, coins=j["coins"], **kw)
    if family == "cross_user":  # the peer encoder in f32, as JAX's apply_fused_ss runs it
        ctx = CU.encode_peers(jp, jcfg, j["others"], j["mask"], use_fused_seq=True)
    else:
        ctx = JF.project_features(jp, j["features"]).astype(jcfg.dtype)
    return S.apply_fused_ss(jp, jcfg, j["past"], j["fut"], coins=j["coins"], context=ctx, **kw)


def _port_forward(family, tp, tcfg, io, cd):
    t = {k: _t(v) for k, v in io.items()}
    kw = dict(residual_dtype=torch.float32, compute_dtype=DT[cd][1])
    if family == "seq2seq":
        return seq2seq.apply_fused_tf(tp, tcfg, t["past"], t["fut"], **kw)
    if family == "fusion":
        return fusion.apply_fused_ss(tp, tcfg, t["past"], t["fut"], coins=t["coins"],
                                     features=t["features"], **kw)
    return cross_user.apply_fused_ss(tp, tcfg, t["past"], t["fut"], coins=t["coins"],
                                     other_future_n=t["others"], other_mask=t["mask"], **kw)


def _spy(seen, name, fn, at):
    """``fn`` that first records (``name``, or its second argument when
    ``name`` is None, and the compute_dtype it was given: positional
    argument ``at`` or the keyword) in ``seen``."""
    def spy(*args, **kw):
        cd = args[at] if len(args) > at else kw.get("compute_dtype", torch.float32)
        seen.append((args[1] if name is None else name, cd))
        return fn(*args, **kw)
    return spy


@pytest.mark.parametrize("family", ["seq2seq", "cross_user", "peer_align", "fusion"])
def test_fused_training_forward_bf16_compute_matches_jax(family, monkeypatch):
    """apply_fused_tf (seq2seq-tf-30) and apply_fused_ss with the same coins
    (cross_user with a static peer context, peer_align, fusion at C = 64),
    f32 residuals on both sides (bf16 residuals round the encoder's final
    states, and an f32 difference of an ulp there moves the output by as
    much as the compute tier does: tests/test_torch_lstm_train.py holds the
    bf16 residuals at the kernels' interface): the output and the gradient
    of every parameter of the mean squared error against JAX's; the bound
    is the module's.
    Every lstm_seq_states call runs bf16 compute but the static-context
    peer encoder's, which stays f32, as in JAX."""
    jcfg, tcfg, jp, io = _case(family, seed=80)
    seen = []
    monkeypatch.setattr(lstm_train, "lstm_seq_states",
                        _spy(seen, None, lstm_train.lstm_seq_states, 5))
    jax_out, ours = {}, {}
    for cd in DT:
        def jloss(p):
            out = _jax_forward(family, p, jcfg, io, cd)
            return jnp.mean((out - _j(io["fut"])) ** 2), out

        (_, jo), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
        jax_out[cd] = [jo] + jax.tree.leaves(jg)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        leaves = [x.requires_grad_(True) for x in tree_leaves(tp)]
        out = _port_forward(family, tp, tcfg, io, cd)
        torch.mean((out - _t(io["fut"])) ** 2).backward()
        # a leaf the loss does not reach (fusion's map convolution) gets
        # none: zero, as under jax.grad
        ours[cd] = [out.detach()] + [torch.zeros_like(x) if x.grad is None else x.grad
                                     for x in leaves]
    assert len(ours["bfloat16"]) == len(jax_out["bfloat16"])
    scale = [max(float(np.abs(np.asarray(x)).max()), 1e-30) for x in jax_out["float32"]]

    def flat(outs, idx):
        return np.concatenate([np.asarray(outs[i], np.float32).ravel() / scale[i] for i in idx])

    rms = lambda x: float(np.sqrt(np.mean(x ** 2)))  # noqa: E731
    for idx, frac in (([0], FWD_FRAC), (range(1, len(scale)), GRAD_FRAC)):
        jb, jf = flat(jax_out["bfloat16"], idx), flat(jax_out["float32"], idx)
        ob, of = flat(ours["bfloat16"], idx), flat(ours["float32"], idx)
        gap, err = rms(jb - jf), rms(ob - jb)
        assert err <= frac * gap, f"outputs {list(idx)}: RMS |port − JAX| {err:.3g} > {frac} × {gap:.3g}"
        assert rms(ob - of) >= 0.5 * gap, "the port's bf16 does not round"
    jb, jf, ob = (np.asarray(x[0]) for x in (jax_out["bfloat16"], jax_out["float32"], ours["bfloat16"]))
    assert np.abs(ob - jb).max() <= 0.5 * np.abs(jb - jf).max()
    bf16_calls = [xs.shape[0] for xs, cd in seen if cd == torch.bfloat16]
    f32_calls = [xs.shape[0] for xs, cd in seen if cd == torch.float32]
    # per run: the encoder (and, teacher-forced, the decoder) on B rows;
    # cross_user's peer encoder on B·K rows in f32 in both runs
    assert bf16_calls and set(bf16_calls) == {B}
    assert (B * K in f32_calls) == (family == "cross_user")


def _step_cfgs(**kw):
    model = dict(d=3, hidden=128, layers=1, h_in=6, h_out=6)
    top = dict(name="bf16-step", batch_size=16, steps=1, lr=3e-3, train_impl="fused", **kw)
    jcfg = JaxExperimentConfig(model=S.Seq2SeqConfig(**model), **top)
    tcfg = ExperimentConfig(model=seq2seq.Seq2SeqConfig(**model), **top)
    return jcfg, tcfg


def test_train_step_bf16_compute_matches_jax():
    """One make_train_step step under train_compute="bfloat16" (the fused
    teacher-forced path, bf16 residuals) against JAX's with the same params
    and batch (tests/test_lstm_train.py's step): the loss within 1e-5
    relative (f32 sums in another order) and about the f32 step's (JAX's
    bound, 1e-2); the updated parameters within 2e-6, except where a
    gradient near zero takes the other sign, which Adam's first step turns
    into 2·lr: at most 0.5 % of the entries."""
    rng = np.random.default_rng(0)
    batch = {"past": rng.normal(size=(16, 6, 3)).astype(np.float32),
             "future": rng.normal(size=(16, 6, 3)).astype(np.float32)}
    losses = {}
    for tc in ("float32", "bfloat16"):
        jcfg, tcfg = _step_cfgs(train_compute=tc)
        jopt, topt = jax_train.make_optimizer(jcfg), train.make_optimizer(tcfg)
        jstate = jax_train.init_state(jcfg, S.init, jopt)
        tparams = params_from_numpy(jax.tree.map(np.asarray, jstate.params), "cpu")
        tstate = train.TrainState(tparams, topt.init(tparams), 0, torch.Generator())
        jstep = jax_train.make_train_step(jcfg, S.apply, jopt, fused_tf_fn=S.apply_fused_tf)
        tstep = train.make_train_step(tcfg, seq2seq.apply, topt, fused_tf_fn=seq2seq.apply_fused_tf)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tstep(tstate, batch)
        losses[tc] = float(tm["loss"])
        assert losses[tc] == pytest.approx(float(jm["loss"]), rel=1e-5)
        diff = np.concatenate([np.abs(a.numpy() - np.asarray(b)).ravel()
                               for a, b in zip(tree_leaves(tstate.params), jax.tree.leaves(jstate.params))])
        assert diff.max() <= 2 * tcfg.lr + 2e-6
        assert np.mean(diff > 2e-6) <= 0.005
    assert abs(losses["bfloat16"] - losses["float32"]) < 1e-2
    assert losses["bfloat16"] != losses["float32"]


@pytest.mark.parametrize("preset", ["seq2seq-tf-30", "stacked-ss-crossuser"])
def test_cli_train_bf16_compute_on_cpu(preset, tmp_path, capsys, monkeypatch):
    """``train --train-compute bfloat16 --device cpu`` trains two steps
    (on a small synthetic store, with K = 4 peer futures) through the
    kernels' plain bf16 versions: every lstm_seq_states call runs bf16
    compute but the stacked-ss-crossuser peer encoder's, and the
    scheduled-sampling decoder does."""
    from longterm360fov_tpu_torch.ops import lstm_ss

    win = str(tmp_path / "win.npz")
    cli.main(["prepare-data", "--out", win, "--n-users", "5", "--n-videos", "1", "--n-frames", "320",
              "--stride", "4", "--n-other-users", "4"])
    seen = []
    for mod, name, at in ((lstm_train, "lstm_seq_states", 5), (lstm_ss, "ss_decode", 9)):
        monkeypatch.setattr(mod, name, _spy(seen, name, getattr(mod, name), at))
    cli.main(["train", "--preset", preset, "--data", win, "--steps", "2", "--batch-size", "4",
              "--device", "cpu", "--train-compute", "bfloat16"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["step"] == 2 and np.isfinite(res["loss"])
    assert ("lstm_seq_states", torch.bfloat16) in seen
    if preset == "stacked-ss-crossuser":
        assert ("ss_decode", torch.bfloat16) in seen
        assert ("lstm_seq_states", torch.float32) in seen  # the peer encoder


@pytest.mark.parametrize("model", [dict(h_in=12, h_out=12), dict(h_in=12, h_out=12, peer_window=8)],
                         ids=["transformer-30", "transformer-10s"])
def test_transformer_step_ignores_train_compute(model):
    """The JAX transformer has no fused training hook, so its step runs in
    f32 under --train-compute bfloat16; the port's step under the flag
    equals its f32 step bit for bit (cut transformer-30 and -10s, peers,
    noisy teacher forcing from the same step generator)."""
    rng = np.random.default_rng(5)
    v = rng.normal(size=(8, 24, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    batch = {"past": v[:, :12].copy(), "future": v[:, 12:].copy(),
             "other_future": np.stack([v[:, 12:]] * 3, axis=1).copy(),
             "other_mask": np.ones((8, 3), np.float32)}
    out = {}
    for tc in ("float32", "bfloat16"):
        tcfg = ExperimentConfig(
            name="tf-bf16", model=seq2seq.Seq2SeqConfig(d=3, hidden=128, layers=2, **model),
            model_family="transformer", scheduled_sampling=True, ss_end=0.3, batch_size=8,
            train_compute=tc)
        opt = train.make_optimizer(tcfg)
        params = transformer.init(torch.Generator().manual_seed(0), tcfg.model, device="cpu")
        state = train.TrainState(params, opt.init(params), 0, torch.Generator())
        step = train.make_train_step(tcfg, transformer.apply, opt,
                                     extras_fn=transformer.batch_extras,
                                     fused_tf_fn=transformer.apply_fused_tf,
                                     fused_ss_fn=transformer.apply_fused_ss)
        state, m = step(state, batch)
        out[tc] = (float(m["loss"]), tree_leaves(state.params))
    assert out["bfloat16"][0] == out["float32"][0]
    for a, b in zip(out["bfloat16"][1], out["float32"][1]):
        assert torch.equal(a, b)
