"""bf16 parameters (``train --bf16``, ``model.param_dtype = "bfloat16"``)
against the JAX package, on the CPU: one train step per family in both
routes, the in-loop evaluation, the optimizer's dtype rules against optax,
the loaders of JAX's bf16 arrays, the checkpoint's mixed-dtype moments, the
config override and the CLI.

The routes: the port's "xla" (autograd through ``apply``) against JAX's
default "auto", which is XLA on the CPU; the port's "auto" (the kernels'
plain versions) against JAX's "fused" (its Pallas kernels in interpret
mode). Under bf16 params JAX gives the LSTM cells' W and b f32 gradients on
the fused route (its custom VJPs return f32 dW, db) and bf16 everywhere
else; optax then promotes those leaves' moments to f32. The presets are cut
in batch (8), window (8 in, 6 out) and peers (K = 3); widths are theirs.
The scheduled-sampling coins (one Bernoulli(0.5) column, the same at every
step) and the transformer's noise are patched in on both sides.

The bounds, read here (JAX 0.9.0, torch 2.13) after one step: the fused
route sums the same f32 products in another order, its first moments
(0.1·g) stand within 5.3e-5 of max|g| of JAX's per leaf and its loss within
1.8e-7 relative: held to 1e-3 and 2e-6. The XLA route (and the
transformer's step in both, which runs no kernel under bf16 params, as
JAX's) sums each step's bf16 gradient of a bf16 weight in bf16 in another
order, a bf16 step (2^-8 of an entry) at a time: read 1.24e-2 of max|g|,
held to 3e-2; its loss 4.5e-6 relative, held to 5e-5. A moment stored in
bf16 may stand one bf16 step of its value more (0.1·g rounds either way).
Every param is within two learning rates (an update of the other sign
where a gradient is near zero; read 2.0) plus a bf16 step of each side's
sum of JAX's; equal in 99.9 % of the entries on the fused route (read
99.995 % and up), 95 % on the XLA route (read 98.9 % and up).
"""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from longterm360fov_tpu import evaluate as jax_evaluate
from longterm360fov_tpu import serving as jax_serving
from longterm360fov_tpu import train as JT
from longterm360fov_tpu.config import get_preset as jax_preset
from longterm360fov_tpu.models import get_family as jax_family
from longterm360fov_tpu_torch import checkpoint, cli, evaluate, serving, train
from longterm360fov_tpu_torch.config import get_preset
from longterm360fov_tpu_torch.models import get_family, seq2seq, transformer
from longterm360fov_tpu_torch.params import params_from_numpy, tree_leaves

B, K, H_IN, H_OUT = 8, 3, 8, 6
GRAD_TOL = {"xla": 3e-2, "auto": 1e-3}  # of max|g| per leaf (module docstring)
LOSS_TOL = {"xla": 5e-5, "auto": 2e-6}
EQUAL = {"xla": 0.95, "auto": 0.999}


def _cfgs(preset, route, **kw):
    """The JAX and port configs of a route: the port's "auto" meets JAX's
    "fused" where the JAX family has fused hooks; the JAX transformer has
    none, so both of its impls run ``apply``, and "auto" (XLA on the CPU)
    stands for both."""
    over = dict(model_param_dtype="bfloat16", batch_size=B, model_h_in=H_IN, model_h_out=H_OUT,
                n_other_users=K, **kw)
    jfused = route == "auto" and hasattr(jax_family(jax_preset(preset).model_family), "apply_fused_tf")
    jcfg = jax_preset(preset, train_impl="fused" if jfused else "auto", **over)
    tcfg = get_preset(preset, train_impl=route, **over)
    assert jcfg.model_hash() == tcfg.model_hash()
    return jcfg, tcfg


def _unit(rng, shape):
    v = rng.normal(size=(*shape, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _batches(tcfg, rng, n=2):
    out = []
    for _ in range(n):
        d = {"past": _unit(rng, (B, H_IN)), "future": _unit(rng, (B, H_OUT))}
        if tcfg.model_family in ("cross_user", "transformer"):
            mask = (rng.random((B, K)) < 0.7).astype(np.float32)
            mask[0] = 0.0
            d.update(other_future=_unit(rng, (B, K, H_OUT)), other_mask=mask)
        if tcfg.model_family == "fusion":
            d["features"] = rng.normal(size=(B, 128)).astype(np.float32)
        out.append(d)
    return out


def _hooks(fam):
    return dict(extras_fn=getattr(fam, "batch_extras", None), fused_tf_fn=getattr(fam, "apply_fused_tf", None),
                fused_ss_fn=getattr(fam, "apply_fused_ss", None))


def _patch_draws(monkeypatch, rng):
    """The same coins and noise on both sides (module docstring)."""
    coins = rng.random((B, 1)) < 0.5
    noise = rng.normal(size=(B, H_OUT, 3)).astype(np.float32)
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p=0.5, shape=None: jnp.broadcast_to(jnp.asarray(coins), shape))
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(noise))
    monkeypatch.setattr(seq2seq, "draw_coins", lambda gen, p, t, b: torch.from_numpy(
        np.broadcast_to(coins, (t, b, 1)).astype(np.float32)))
    monkeypatch.setattr(transformer, "draw_noise", lambda gen, shape: torch.from_numpy(noise))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x).astype(np.float32)


def _dtypes(xs):
    return [str(x.dtype).replace("torch.", "") for x in xs]


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's runs by (preset, JAX impl, overrides), shared by the cases that
    meet the same one: the transformer's two routes (its family has no
    fused hooks, so JAX runs one step for both impls)."""
    return {}


@pytest.mark.parametrize("preset,route,kw", [
    (p, r, {}) for p in ("seq2seq-tf-30", "stacked-ss-crossuser", "stacked-ss-crossuser-10s", "video-fusion",
                         "transformer-30") for r in ("xla", "auto")
] + [("seq2seq-tf-30", "auto", {"accum": 2})], ids=lambda v: v if isinstance(v, str) else
    ",".join(f"{k}={x}" for k, x in v.items()) or "-")
def test_train_step_bf16_matches_jax(preset, route, kw, monkeypatch, jax_runs):
    """One make_train_step step of a bf16 model against JAX's from the same
    params and batch, and a second step's dtypes (JAX's by
    ``jax.eval_shape``: its interpret-mode kernels run once): per leaf the
    gradient's dtype (the port's make_grad_fn) and the moments' after each
    step equal JAX's; the gradient's values (the first moment, 0.1·g), the
    loss and the params after the step within the module's bounds. With
    ``accum`` 2 the microbatches' mean gradient is rounded to the params'
    dtype, as JAX's accumulation rounds it: every moment stays bf16."""
    jcfg, tcfg = _cfgs(preset, route, **kw)
    kind = "xla" if tcfg.model_family == "transformer" else route  # the bounds (module docstring)
    rng = np.random.default_rng(0)
    _patch_draws(monkeypatch, rng)
    batches = _batches(tcfg, rng)
    jfam, tfam = jax_family(jcfg.model_family), get_family(tcfg.model_family)
    key = (preset, jcfg.train_impl, tuple(sorted(kw.items())))
    if key not in jax_runs:
        jopt = JT.make_optimizer(jcfg)
        jstate = JT.init_state(jcfg, jfam.init, jopt)
        params0 = jax.tree.map(np.asarray, jstate.params)
        jstep = JT.make_train_step(jcfg, jfam.apply, jopt, **_hooks(jfam))
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batches[0].items()})
        shapes = jax.eval_shape(jstep, jstate, {k: jnp.asarray(v) for k, v in batches[1].items()})[0]
        jax_runs[key] = (params0, jstate, float(jm["loss"]), shapes)
    params0, jstate, jloss, shapes = jax_runs[key]
    topt = train.make_optimizer(tcfg)
    tparams = params_from_numpy(params0, "cpu")
    assert _dtypes(tree_leaves(tparams)) == _dtypes(jax.tree.leaves(jstate.params))
    tstep = train.make_train_step(tcfg, tfam.apply, topt, **_hooks(tfam))
    _, grads = train.make_grad_fn(tcfg, tfam.apply, **_hooks(tfam))(tparams, batches[0], torch.Generator(), 1.0)
    tstate, tm = tstep(train.TrainState(tparams, topt.init(tparams), 0, torch.Generator()), batches[0])
    assert abs(float(tm["loss"]) - jloss) <= LOSS_TOL[kind] * jloss
    jmu = jax.tree.leaves(jstate.opt_state[1][0].mu)
    assert _dtypes(tree_leaves(grads)) == _dtypes(jmu) == _dtypes(tstate.opt_state.mu)
    assert _dtypes(tstate.opt_state.nu) == _dtypes(jax.tree.leaves(jstate.opt_state[1][0].nu))
    for a, b in zip(tstate.opt_state.mu, jmu):
        step = 2.0 ** -7 * np.abs(_np(b)) if a.dtype == torch.bfloat16 else 0.0
        a, b = _np(a), _np(b)
        assert (np.abs(a - b) <= GRAD_TOL[kind] * np.abs(b).max() + step).all()
    equal, n = 0, 0
    for a, b in zip(tree_leaves(tstate.params), jax.tree.leaves(jstate.params)):
        assert a.dtype == getattr(torch, str(b.dtype))
        a, b = _np(a), _np(b)
        assert (np.abs(a - b) <= 2 * tcfg.lr + 2.0 ** -6 * np.maximum(np.abs(a), np.abs(b))).all()
        equal, n = equal + (a == b).sum(), n + a.size
    assert equal / n >= EQUAL[kind]
    tstate, _ = tstep(tstate, batches[1])
    for ours, theirs in ((tstate.opt_state.mu, shapes.opt_state[1][0].mu),
                         (tstate.opt_state.nu, shapes.opt_state[1][0].nu)):
        assert _dtypes(ours) == _dtypes(jax.tree.leaves(theirs))
    mixed = {"float32", "bfloat16"} if route == "auto" and not kw and tcfg.model_family != "transformer" else (
        {"float32", "bfloat16"} if tcfg.model_family == "fusion" else {"bfloat16"})
    assert set(_dtypes(tstate.opt_state.mu)) == mixed  # fusion's conv stack is f32 in both


@pytest.mark.parametrize("preset", ["seq2seq-tf-30", "stacked-ss-crossuser"])
def test_in_loop_eval_decodes_in_bf16_as_jax(preset):
    """A bf16 model's in-loop evaluation (``train.eval_impl``: ``apply`` in
    the params' dtype) against JAX's ``evaluate`` (``infer.predict_batch``
    through ``apply`` in bf16) on the same untrained params: the error
    curve within 1e-3 degrees per step (read 3.4e-4 and 6.2e-4; the f32
    serving kernels on the widened weights stand 1.6e-3 and 1.8e-3 away,
    so the bound tells the two apart)."""
    jcfg, tcfg = _cfgs(preset, "auto")
    fam = jax_family(jcfg.model_family)
    jp = fam.init(jax.random.PRNGKey(0), jcfg.model)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(0)
    data = {"past": _unit(rng, (40, H_IN)), "future": _unit(rng, (40, H_OUT))}
    if jcfg.model_family == "cross_user":
        data.update(other_future=_unit(rng, (40, K, H_OUT)), other_mask=np.ones((40, K), np.float32))
    want = jax_evaluate.evaluate(jp, jcfg, fam.apply, data, batch_size=16,
                                 extras_fn=getattr(fam, "batch_extras", None))
    assert train.eval_impl(tcfg) == "plain"
    got = evaluate.evaluate(tp, tcfg, data, impl=train.eval_impl(tcfg), batch_size=16)
    assert np.abs(np.array(got["error_by_step_deg"]) - np.array(want["error_by_step_deg"])).max() <= 1e-3


def test_optimizer_dtype_rules_match_optax():
    """clip_by_global_norm → adam on a bf16 leaf with an f32 gradient (its
    moments promote to f32), a bf16 leaf with a bf16 gradient and an f32
    leaf, clipping on and off, with a warmup schedule: the moments' and
    updates' dtypes are optax's and the values equal within one bf16 step
    (XLA may keep an f32 intermediate that torch rounds)."""
    rng = np.random.default_rng(3)
    shapes = [(4, 8), (8,), (3, 5)]
    params_np = [rng.normal(size=s).astype(np.float32) for s in shapes]
    p_dt = [jnp.bfloat16, jnp.bfloat16, jnp.float32]
    g_dt = [jnp.float32, jnp.bfloat16, jnp.float32]
    for clip, warm in ((1e3, 0), (0.1, 3)):
        _, tcfg = _cfgs("seq2seq-tf-30", "auto", grad_clip=clip, warmup_steps=warm, steps=10)
        jopt = JT.make_optimizer(jax_preset("seq2seq-tf-30", grad_clip=clip, warmup_steps=warm, steps=10))
        topt = train.make_optimizer(tcfg)
        jp = [jnp.asarray(p, d) for p, d in zip(params_np, p_dt)]
        tp = [torch.from_numpy(np.array(p.astype(jnp.float32))).to(getattr(torch, str(p.dtype))) for p in jp]
        jstate, tstate = jopt.init(jp), topt.init(tp)
        for step in range(3):
            gs = [rng.normal(size=s).astype(np.float32) for s in shapes]
            jg = [jnp.asarray(g, d) for g, d in zip(gs, g_dt)]
            tg = [torch.from_numpy(np.array(g.astype(jnp.float32))).to(getattr(torch, str(g.dtype))) for g in jg]
            ju, jstate = jopt.update(jg, jstate, jp)
            tu, tstate = topt.update(tg, tstate)
            jmu, jnu = jstate[1][0].mu, jstate[1][0].nu
            for ours, theirs in ((tu, ju), (tstate.mu, jmu), (tstate.nu, jnu)):
                assert _dtypes(ours) == _dtypes(theirs)
                for a, b in zip(ours, theirs):
                    a, b = _np(a), _np(b)
                    assert (np.abs(a - b) <= 2.0 ** -7 * np.abs(b) + 1e-12).all()
            jp = optax.apply_updates(jp, ju)
            tp = [(p + u).to(p.dtype) for p, u in zip(tp, tu)]
            assert _dtypes(tp) == _dtypes(jp)


def test_params_from_numpy_takes_jax_bf16_arrays():
    """JAX's bf16 params as numpy (``ml_dtypes.bfloat16``) become
    ``torch.bfloat16`` tensors with the same bits, for every family."""
    for preset in ("stacked-ss-crossuser", "video-fusion", "transformer-30"):
        cfg = jax_preset(preset, model_param_dtype="bfloat16")
        jp = jax_family(cfg.model_family).init(jax.random.PRNGKey(0), cfg.model)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
            assert a.dtype == getattr(torch, str(b.dtype))
            assert np.array_equal(_np(a), _np(b))


def test_load_exported_params_reads_a_bf16_npz(tmp_path):
    """A bf16 model's flat npz (``np.savez`` of JAX's bf16 leaves, which
    plain numpy reads back as ``|V2``) loads into the port's bf16 skeleton
    bit for bit, and widens into an f32 one."""
    cfg = jax_preset("stacked-ss-crossuser", model_param_dtype="bfloat16")
    jp = jax_family(cfg.model_family).init(jax.random.PRNGKey(1), cfg.model)
    path = str(tmp_path / "bf16.npz")
    np.savez(path, **{k: np.asarray(v) for k, v in jax_serving.flat_param_items(jp)})
    with np.load(path) as raw:
        assert {raw[k].dtype.str for k in raw.files} == {"|V2"}
    tcfg = get_preset("stacked-ss-crossuser", model_param_dtype="bfloat16")
    fam = get_family(tcfg.model_family)
    tp = serving.load_exported_params(path, tcfg, fam, device="cpu")
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        assert a.dtype == torch.bfloat16 and np.array_equal(_np(a), _np(b))
    wide = serving.load_exported_params(path, get_preset("stacked-ss-crossuser"), fam, device="cpu")
    assert all(a.dtype == torch.float32 and torch.equal(a, b.float())
               for a, b in zip(tree_leaves(wide), tree_leaves(tp)))


def test_checkpoint_keeps_the_moments_dtypes_and_resumes_bit_for_bit(tmp_path):
    """A bf16 model trained on the fused route has f32 moments for its LSTM
    cells and bf16 ones for the projection; the checkpoint restores each in
    the dtype it was saved in (orbax's restore into the fresh state would
    round the f32 ones to bf16: ROADMAP.md, known divergences), so a resumed
    step equals the uninterrupted one bit for bit."""
    _, tcfg = _cfgs("seq2seq-tf-30", "auto")
    fam = get_family("seq2seq")
    opt = train.make_optimizer(tcfg)
    step = train.make_train_step(tcfg, fam.apply, opt, **_hooks(fam))
    b1, b2 = _batches(tcfg, np.random.default_rng(2))
    state, _ = step(train.init_state(tcfg, fam.init, opt, device="cpu"), b1)
    assert set(_dtypes(state.opt_state.mu)) == {"float32", "bfloat16"}
    ck = checkpoint.Checkpointer(str(tmp_path / "ck"), tcfg)
    ck.save(state)
    back = ck.restore(train.init_state(tcfg, fam.init, opt, device="cpu"))
    assert _dtypes(back.opt_state.mu) == _dtypes(state.opt_state.mu)
    assert _dtypes(back.opt_state.nu) == _dtypes(state.opt_state.nu)
    assert _dtypes(tree_leaves(back.params)) == ["bfloat16"] * len(tree_leaves(back.params))
    full, resumed = step(state, b2)[0], step(back, b2)[0]
    for a, b in zip(tree_leaves(full.params) + full.opt_state.mu + full.opt_state.nu,
                    tree_leaves(resumed.params) + resumed.opt_state.mu + resumed.opt_state.nu):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_model_param_dtype_override():
    """``model_param_dtype`` goes through the model overrides: the params'
    dtype, and part of the model hash, JAX's included."""
    cfg = get_preset("video-fusion", model_param_dtype="bfloat16")
    assert cfg.model.param_dtype == "bfloat16" and cfg.model.dtype is torch.bfloat16
    assert cfg.model_hash() == jax_preset("video-fusion", model_param_dtype="bfloat16").model_hash()
    assert cfg.model_hash() != get_preset("video-fusion").model_hash()
    params = get_family("fusion").init(torch.Generator().manual_seed(0), cfg.model, device="cpu")
    assert {str(p.dtype) for k, p in params["feat_proj"].items()} == {"torch.bfloat16"}
    assert params["encoder"][0].w.dtype is torch.bfloat16
    assert params["conv"]["kernels"].dtype is torch.float32  # as JAX's init_conv_features


def test_cli_train_bf16_resumes_and_eval_refuses_its_checkpoint(tmp_path, capsys):
    """``train --bf16 --device cpu`` trains, checkpoints bf16 params with
    mixed-dtype moments, resumes, and logs an in-loop evaluation that
    decodes through ``apply`` in bf16 (``train.eval_impl``); ``eval`` of
    its checkpoint stops with JAX's model-hash message (``eval`` has no
    ``--bf16``, and the dtype is part of the model hash). On a small
    ``prepare-data`` store (2 users of one video, K = 4 other-user slots)."""
    ck, log, win = str(tmp_path / "ck"), str(tmp_path / "t.jsonl"), str(tmp_path / "win.npz")
    cli.main(["prepare-data", "--out", win, "--n-users", "2", "--n-videos", "1", "--n-frames", "400",
              "--n-other-users", "4"])
    args = ["train", "--preset", "stacked-ss-crossuser", "--data", win, "--batch-size", "8", "--device", "cpu",
            "--bf16", "--ckpt-dir", ck, "--log-file", log]
    cli.main(args + ["--steps", "2"])
    cli.main(args + ["--steps", "3", "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    last = json.loads(out.strip().splitlines()[-1])
    assert last["step"] == 3 and np.isfinite(last["loss"]) and np.isfinite(last["eval_great_circle_deg"])
    cfg = get_preset("stacked-ss-crossuser", model_param_dtype="bfloat16")
    assert train.eval_impl(cfg) == "plain" and train.eval_impl(get_preset("stacked-ss-crossuser")) == "fused"
    saved = torch.load(f"{ck}/3/state.pt", weights_only=True)
    assert {str(p.dtype) for p in saved["params"]} == {"torch.bfloat16"}
    assert {str(m.dtype) for m in saved["opt_mu"]} == {"torch.float32", "torch.bfloat16"}
    with pytest.raises(SystemExit, match="model-config hash mismatch"):
        cli.main(["eval", "--preset", "stacked-ss-crossuser", "--ckpt-dir", ck, "--device", "cpu"])
