"""The port's fusion family (``models.fusion``) against the JAX package on
the CPU: the params tree, the forward paths in their three context modes,
the fused serving and training paths (the kernels' plain versions here,
JAX's kernels in interpret mode), one train step's gradients, the batch
extras, the exported-weights loader, checkpoints, serving, evaluation and
the CLI's feature pipeline.

Weights cross between the packages (params_from_numpy), seeds do not; both
sides get the same numpy inputs and the same coins.
"""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)
import json
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longterm360fov_tpu import cli as jax_cli
from longterm360fov_tpu import evaluate as jax_evaluate
from longterm360fov_tpu import infer as jax_infer
from longterm360fov_tpu import losses as jax_losses
from longterm360fov_tpu import serving as jax_serving
from longterm360fov_tpu import windows as jax_windows
from longterm360fov_tpu.config import ExperimentConfig as JaxExperimentConfig
from longterm360fov_tpu.config import get_preset as jax_get_preset
from longterm360fov_tpu.models import fusion as JF
from longterm360fov_tpu.models import seq2seq as S
from longterm360fov_tpu_torch import checkpoint, cli, data, evaluate, infer, serving, train
from longterm360fov_tpu_torch.config import ExperimentConfig, get_preset
from longterm360fov_tpu_torch.models import fusion, seq2seq
from longterm360fov_tpu_torch.params import params_from_numpy, tree_leaves, tree_unflatten

ATOL = 1e-5  # the plain paths: f32 sums in another order
FUSED_TOL = 2e-5  # tests/test_fusion.py: serve_fused vs the scan
FEAT = 16  # feature width at the small size


def _model(**kw):
    base = dict(d=3, hidden=32, layers=1, h_in=5, h_out=4, ctx_dim=8)
    base.update(kw)
    return S.Seq2SeqConfig(**base), seq2seq.Seq2SeqConfig(**base)


def _setup(seed=0, b=6, **kw):
    jcfg, tcfg = _model(**kw)
    jp = JF.init(jax.random.PRNGKey(seed), jcfg, feature_dim=FEAT)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(seed)
    io = dict(past=rng.normal(size=(b, jcfg.h_in, 3)).astype(np.float32) * 0.5,
              fut=rng.normal(size=(b, jcfg.h_out, 3)).astype(np.float32) * 0.5,
              features=rng.normal(size=(b, FEAT)).astype(np.float32),
              maps=rng.random((b, 24, 40)).astype(np.float32))
    return jcfg, tcfg, jp, tp, io


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _video(io, mode):
    """The video keyword arguments of a mode."""
    return {"none": {}, "features": {"features": io["features"]}, "maps": {"maps": io["maps"]},
            "both": {"features": io["features"], "maps": io["maps"]}}[mode]


# ---------------------------------------------------------------- params


def test_init_tree_matches_jax():
    jcfg, tcfg = _model(layers=2)
    jp = JF.init(jax.random.PRNGKey(0), jcfg, feature_dim=FEAT)
    tp = fusion.init(torch.Generator().manual_seed(0), tcfg, device="cpu", feature_dim=FEAT)
    assert sorted(tp) == sorted(jp) and sorted(tp["conv"]) == sorted(jp["conv"])
    assert sorted(tp["feat_proj"]) == sorted(jp["feat_proj"])
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp), strict=True):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32 and b.dtype == jnp.float32
    hid = max(tcfg.ctx_dim, 64)
    assert tp["feat_proj"]["w1"].abs().max() <= np.sqrt(6.0 / (FEAT + hid))
    assert not tp["feat_proj"]["b2"].any() and not tp["conv"]["bias"].any()
    with pytest.raises(ValueError, match="ctx_dim"):
        fusion.init(torch.Generator(), seq2seq.Seq2SeqConfig(ctx_dim=0), device="cpu")


def test_params_from_numpy_of_a_jax_fusion_tree():
    """The JAX tree crosses leaf for leaf, and tree_leaves follows
    jax.tree.leaves: conv (bias, head_b, head_w, kernels), decoder, encoder,
    feat_proj (b1, b2, w1, w2), proj."""
    _, _, jp, tp, _ = _setup(seed=1, layers=2)
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp), strict=True):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert tree_leaves(tp)[0] is tp["conv"]["bias"] and tree_leaves(tp)[3] is tp["conv"]["kernels"]
    assert tree_leaves(tp)[-6] is tp["feat_proj"]["b1"] and tree_leaves(tp)[-1] is tp["proj"]["w"]
    back = tree_unflatten(tp, tree_leaves(tp))
    assert all(a is b for a, b in zip(tree_leaves(back), tree_leaves(tp)))
    bad = jax.tree.map(np.asarray, jp)
    bad["conv"] = {**bad["conv"], "extra": np.zeros(1)}
    with pytest.raises(KeyError):
        params_from_numpy(bad, "cpu")


# ---------------------------------------------------------------- forward paths


@pytest.mark.parametrize("mode", ["none", "features", "maps", "both", "context", "teacher-forcing"])
def test_apply_matches_jax(mode):
    """maps takes precedence over features; with neither the context is
    zeros; an explicit context wins over both."""
    jcfg, tcfg, jp, tp, io = _setup(seed=2)
    fut = io["fut"] if mode == "teacher-forcing" else None
    kw = _video(io, {"teacher-forcing": "features", "context": "both"}.get(mode, mode))
    if mode == "context":
        kw["context"] = np.random.default_rng(3).normal(size=(6, 8)).astype(np.float32)
    ref = JF.apply(jp, jcfg, _j(io["past"]), _j(fut), **{k: _j(v) for k, v in kw.items()})
    ours = fusion.apply(tp, tcfg, _t(io["past"]), _t(fut), **{k: _t(v) for k, v in kw.items()})
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL)
    if mode == "none":
        zero = seq2seq.apply(tp, tcfg, _t(io["past"]), context=torch.zeros(6, 8))
        np.testing.assert_allclose(ours.numpy(), zero.numpy(), atol=1e-6)
    if mode == "both":
        maps_only = fusion.apply(tp, tcfg, _t(io["past"]), maps=_t(io["maps"]))
        assert torch.equal(ours, maps_only)


@pytest.mark.parametrize("mode", ["features", "maps", "none"])
def test_serve_fused_matches_jax(mode):
    """At hidden 128, as tests/test_fusion.py: the fused serve path (and for
    maps the conv+resize kernel) against JAX's serve_fused (interpret mode)
    and JAX's apply, 2e-5."""
    jcfg, tcfg, jp, tp, io = _setup(seed=7, b=8, hidden=128, layers=2)
    kw = _video(io, mode)
    ref = JF.serve_fused(jp, jcfg, _j(io["past"]), tile_b=8, **{k: _j(v) for k, v in kw.items()})
    ours = fusion.serve_fused(tp, tcfg, _t(io["past"]), **{k: _t(v) for k, v in kw.items()})
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=FUSED_TOL)
    scan = JF.apply(jp, jcfg, _j(io["past"]), **{k: _j(v) for k, v in kw.items()})
    np.testing.assert_allclose(ours.numpy(), np.asarray(scan), atol=FUSED_TOL)


def _jax_context(jp, jcfg, io, mode):
    if mode == "maps":
        return JF.project_features(jp, JF.compute_map_features(jp, _j(io["maps"])))
    return JF.project_features(jp, _j(io["features"]))


@pytest.mark.parametrize("mode", ["features", "maps"])
@pytest.mark.parametrize("layers", [1, 2])
def test_apply_fused_ss_matches_jax(mode, layers):
    """The scheduled-sampling path (f32 residuals) with explicit coins
    against JAX's fused decoder given the same context and JAX's scan."""
    jcfg, tcfg, jp, tp, io = _setup(seed=5, layers=layers)
    coins = (np.random.default_rng(5).random((jcfg.h_out, 6, 1)) < 0.5).astype(np.float32)
    ours = fusion.apply_fused_ss(tp, tcfg, _t(io["past"]), _t(io["fut"]), coins=_t(coins),
                                 residual_dtype=torch.float32,
                                 **{k: _t(v) for k, v in _video(io, mode).items()})
    ctx = _jax_context(jp, jcfg, io, mode)
    ref = S.apply_fused_ss(jp, jcfg, _j(io["past"]), _j(io["fut"]), coins=_j(coins), context=ctx,
                           tile_b=8, residual_dtype=jnp.float32)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=3e-5)
    scan = S.apply(jp, jcfg, _j(io["past"]), _j(io["fut"]), coins=_j(coins), context=ctx)
    np.testing.assert_allclose(ours.numpy(), np.asarray(scan), atol=3e-5)


@pytest.mark.parametrize("mode", ["features", "maps"])
def test_apply_fused_tf_matches_jax(mode):
    jcfg, tcfg, jp, tp, io = _setup(seed=6, layers=2)
    video = _video(io, mode)
    ours = fusion.apply_fused_tf(tp, tcfg, _t(io["past"]), _t(io["fut"]), residual_dtype=torch.float32,
                                 **{k: _t(v) for k, v in video.items()})
    ctx = _jax_context(jp, jcfg, io, mode)
    ref = S.apply_fused_tf(jp, jcfg, _j(io["past"]), _j(io["fut"]), context=ctx, tile_b=8,
                           residual_dtype=jnp.float32)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=3e-5)
    scan = JF.apply(jp, jcfg, _j(io["past"]), _j(io["fut"]), **{k: _j(v) for k, v in video.items()})
    np.testing.assert_allclose(ours.numpy(), np.asarray(scan), atol=3e-5)


@pytest.mark.parametrize("mode", ["features", "maps"])
def test_train_step_gradients_match_jax(mode, monkeypatch):
    """One scheduled-sampling train step's loss and gradient: the port's
    make_grad_fn through apply_fused_ss (f32 residuals) against jax.grad of
    the same loss through JAX's fused decoder, with the same coins. Each
    leaf within 5e-4 absolute + 1e-3 relative (the lockstep tests' bound
    for f32-residual gradients); the gradient reaches feat_proj, and conv
    in the maps mode only."""
    jcfg, tcfg_m, jp, tp, io = _setup(seed=8, b=16, layers=2)
    coins = (np.random.default_rng(8).random((jcfg.h_out, 16, 1)) < 0.5).astype(np.float32)
    monkeypatch.setattr(seq2seq, "draw_coins", lambda *a: _t(coins))
    past = io["past"] / np.linalg.norm(io["past"], axis=-1, keepdims=True)
    fut = io["fut"] / np.linalg.norm(io["fut"], axis=-1, keepdims=True)
    video = _video(io, mode)

    def jloss(p):
        past_n, fut_n, _ = jax_windows.normalize_window(_j(past), _j(fut))
        ctx = _jax_context(p, jcfg, io, mode)
        pred = S.apply_fused_ss(p, jcfg, past_n, fut_n, coins=_j(coins), context=ctx, tile_b=8,
                                residual_dtype=jnp.float32)
        return jax_losses.combined_loss(pred, fut_n, None, None)

    j_loss, j_grads = jax.value_and_grad(jloss)(jp)
    tcfg = ExperimentConfig(name="fusion-step", model=tcfg_m, model_family="fusion",
                            scheduled_sampling=True, train_impl="fused")
    grad_fn = train.make_grad_fn(tcfg, fusion.apply, extras_fn=fusion.batch_extras, gc_metric=False,
                                 fused_ss_fn=partial(fusion.apply_fused_ss, residual_dtype=torch.float32))
    (loss, _), grads = grad_fn(tp, {"past": past, "future": fut, **video}, torch.Generator(), 0.5)
    assert float(loss) == pytest.approx(float(j_loss), rel=1e-5)
    for a, b in zip(tree_leaves(grads), jax.tree.leaves(j_grads), strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-4, rtol=1e-3)
    assert grads["feat_proj"]["w1"].abs().max() > 0
    assert (grads["conv"]["kernels"].abs().max() > 0) == (mode == "maps")


def test_batch_extras_matches_jax():
    _, _, _, _, io = _setup(seed=9)
    for keys in ((), ("features",), ("maps",), ("features", "maps")):
        batch = {"past": io["past"], **{k: io[k] for k in keys}}
        ref = JF.batch_extras({k: _j(v) for k, v in batch.items()}, None)
        ours = fusion.batch_extras({k: _t(v) for k, v in batch.items()}, None)
        assert sorted(ours) == sorted(ref) == sorted(keys)


# ---------------------------------------------------------------- export, checkpoint


def test_flat_param_items_and_load_exported_params(tmp_path):
    jcfg, tcfg = jax_get_preset("video-fusion"), get_preset("video-fusion")
    jp = JF.init(jax.random.PRNGKey(3), jcfg.model)
    path = str(tmp_path / "export.npz")
    np.savez(path, **{k: np.asarray(v) for k, v in jax_serving.flat_param_items(jp)})
    ours = serving.load_exported_params(path, tcfg, fusion, device="cpu")
    for a, b in zip(tree_leaves(ours), jax.tree.leaves(jp), strict=True):
        assert np.array_equal(a.numpy(), np.asarray(b))
    keys = [k for k, _ in serving.flat_param_items(ours)]
    assert keys == [k for k, _ in jax_serving.flat_param_items(jp)]
    assert "conv.kernels" in keys and "feat_proj.w1" in keys
    with np.load(path) as z:
        partial_export = {k: z[k] for k in z.files if k != "feat_proj.w2"}
    np.savez(path, **partial_export)
    with pytest.raises(KeyError, match="feat_proj.w2"):
        serving.load_exported_params(path, tcfg, fusion, device="cpu")


def _windows(n, seed, h_in=5, h_out=4, maps=False):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, h_in + h_out, 3)).astype(np.float32) * 0.3 + np.array([1.0, 0, 0], np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    out = {"past": v[:, :h_in].copy(), "future": v[:, h_in:].copy()}
    if maps:
        out["maps"] = rng.random((n, 16, 32)).astype(np.float32)
    else:
        out["features"] = rng.normal(size=(n, FEAT)).astype(np.float32)
    return out


def _train_cfg(**kw):
    _, model = _model(hidden=16, layers=2)
    top = dict(name="fusion-test", model=model, model_family="fusion", scheduled_sampling=True,
               batch_size=16, steps=6, eval_every=3, ckpt_every=3, lr=3e-3, train_impl="fused")
    top.update(kw)
    return ExperimentConfig(**top)


def _init(gen, cfg, *, device):
    return fusion.init(gen, cfg, device=device, feature_dim=FEAT)


@pytest.mark.parametrize("maps", [False, True])
def test_checkpoint_and_resume_are_exact(maps, tmp_path):
    """Training through the fused paths' plain versions: N steps straight ==
    restore the checkpoint of step k, then N - k steps; the conv leaves
    learn only in the maps mode."""
    tcfg = _train_cfg()
    d, ev = _windows(48, seed=2, maps=maps), _windows(10, seed=9, maps=maps)
    run = dict(device="cpu", eval_data=ev, extras_fn=fusion.batch_extras,
               fused_ss_fn=fusion.apply_fused_ss)
    ck_dir = str(tmp_path / "ck")
    init = train.init_state(tcfg, _init, train.make_optimizer(tcfg), device="cpu")
    full, hist = train.train_loop(tcfg, _init, fusion.apply, d, checkpoint_dir=ck_dir, **run)
    ck = checkpoint.Checkpointer(ck_dir, tcfg)
    assert ck.all_steps() == [3, 6]
    restored = ck.restore(train.init_state(tcfg, _init, train.make_optimizer(tcfg), device="cpu",
                                           gen=torch.Generator().manual_seed(5)), step=3)
    assert sorted(restored.params) == ["conv", "decoder", "encoder", "feat_proj", "proj"]
    resumed, hist2 = train.train_loop(tcfg, _init, fusion.apply, d, state=restored, **run)
    for a, b in zip(tree_leaves(full.params), tree_leaves(resumed.params)):
        assert torch.equal(a, b)
    assert hist[-1]["loss"] == hist2[-1]["loss"] and hist[-1]["teacher_prob"] < 1.0
    assert np.isfinite(hist[0]["eval_great_circle_deg"])
    moved = not torch.equal(full.params["conv"]["kernels"], init.params["conv"]["kernels"])
    assert moved == maps
    assert not torch.equal(full.params["feat_proj"]["w1"], init.params["feat_proj"]["w1"])


# ---------------------------------------------------------------- serving, evaluation


def test_batcher_requires_features_and_serves_like_the_direct_call():
    tcfg = get_preset("video-fusion", model_hidden=32, model_ctx_dim=8, model_h_in=5, model_h_out=4)
    params = fusion.init(torch.Generator().manual_seed(1), tcfg.model, device="cpu")
    fn = serving.make_serve_fn(params, tcfg, fusion, device="cpu", impl="fused")
    assert serving.extra_specs_for(tcfg) == {"features": (128,)}
    rng = np.random.default_rng(2)
    pasts = rng.normal(size=(7, 5, 3)).astype(np.float32)
    feats = rng.normal(size=(7, 128)).astype(np.float32)
    bat = serving.DynamicBatcher(fn, h_in=5, extra_specs=serving.extra_specs_for(tcfg),
                                 required=serving.required_extras_for(tcfg), max_batch=16,
                                 max_wait_ms=20.0)
    try:
        with pytest.raises(ValueError, match="requires extras"):
            bat.submit(pasts[0])
        res = [bat.predict(pasts[i], features=feats[i]) for i in range(3)]
        chunks = bat.submit_many(pasts[3:], features=feats[3:])
        for c in chunks:
            assert c.event.wait(30) and c.error is None
    finally:
        bat.stop()
    direct = fn.unpack(fn({"past": pasts, "features": feats}).numpy())
    for key in ("yaw", "pitch"):
        got = np.concatenate([np.stack([r[key] for r in res]), chunks[0].result[key]])
        np.testing.assert_allclose(got, direct[key], atol=1e-6)
    with pytest.raises(ValueError, match="consumes no peer context"):
        serving.make_grouped_serve_fn(params, tcfg, fusion, device="cpu")


@pytest.mark.parametrize("impl", ["fused", "plain"])
def test_predict_and_evaluate_with_features_match_jax(impl):
    jm, tm = _model(hidden=32, h_in=6, h_out=4, layers=2)
    jcfg = JaxExperimentConfig(name="fu", model=jm, model_family="fusion")
    tcfg = ExperimentConfig(name="fu", model=tm, model_family="fusion")
    jp = JF.init(jax.random.PRNGKey(2), jm, feature_dim=FEAT)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    d = _windows(21, seed=4, h_in=6, h_out=4)
    batch = {k: v for k, v in d.items() if k != "future"}
    ref = jax_infer.predict_batch(jp, jcfg, JF.apply, {k: _j(v) for k, v in batch.items()}, None,
                                  JF.batch_extras)
    ours = infer.make_predict_fn(tp, tcfg, device="cpu", impl=impl)(batch)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=FUSED_TOL)
    ev_ref = jax_evaluate.evaluate(jp, jcfg, JF.apply, d, batch_size=8, extras_fn=JF.batch_extras)
    ev = evaluate.evaluate(tp, tcfg, d, impl=impl, batch_size=8)
    np.testing.assert_allclose(ev["error_by_step_deg"], ev_ref["error_by_step_deg"], rtol=1e-4)


# ---------------------------------------------------------------- CLI


def _last_json(out):
    return json.loads(out.strip().splitlines()[-1])


def test_cli_prepare_data_matches_jax(tmp_path, capsys):
    """prepare-data on the synthetic store, with a features npz: the same
    packed windows as the JAX CLI writes."""
    feats = {f"video{v}": np.random.default_rng(v).normal(size=(150, 12)).astype(np.float32)
             for v in range(2)}
    np.savez(tmp_path / "f.npz", **feats)
    args = ["--h-in", "10", "--h-out", "10", "--n-users", "2", "--n-frames", "200",
            "--features", str(tmp_path / "f.npz")]
    jax_cli.main(["prepare-data", "--out", str(tmp_path / "j.npz"), *args])
    cli.main(["prepare-data", "--out", str(tmp_path / "t.npz"), *args])
    for split in ("", "_test"):
        ref, ours = data.load_packed(str(tmp_path / f"j{split}.npz")), data.load_packed(
            str(tmp_path / f"t{split}.npz"))
        assert sorted(ours) == sorted(ref) == ["features", "future", "past"]
        for k in ref:
            assert np.array_equal(ours[k], ref[k]), k
    # --traces is ported (slice C-3): a directory without a log is refused as JAX refuses it
    (tmp_path / "no_logs").mkdir()
    with pytest.raises(SystemExit) as ref:
        jax_cli.main(["prepare-data", "--out", str(tmp_path / "x.npz"), "--traces", str(tmp_path / "no_logs")])
    with pytest.raises(SystemExit) as got:
        cli.main(["prepare-data", "--out", str(tmp_path / "x.npz"), "--traces", str(tmp_path / "no_logs")])
    assert str(got.value) == str(ref.value) and "no parseable traces" in str(got.value)


def test_cli_feature_pipeline_on_cpu(tmp_path, capsys):
    """extract-features on two tiny clips → prepare-data --features → train
    video-fusion 2 steps → eval → serve-bench, all on the CPU."""
    frames = tmp_path / "frames"
    frames.mkdir()
    for v in range(2):
        clip = np.random.default_rng(v).integers(0, 255, size=(40, 24, 48, 3), dtype=np.uint8)
        np.save(frames / f"video{v}.npy", clip)
    (frames / "notes.txt").write_text("not a clip")
    feats = str(tmp_path / "feats.npz")
    cli.main(["extract-features", "--frames-dir", str(frames), "--out", feats, "--device", "cpu",
              "--max-frames", "30"])
    out = capsys.readouterr().out
    assert "video0: 30 frames -> (30, 128)" in out and "skipping notes.txt" in out
    with np.load(feats) as z:
        assert sorted(z.files) == ["video0", "video1"]
        assert all(z[k].shape == (30, 128) and np.isfinite(z[k]).all() for k in z.files)
    win = str(tmp_path / "win.npz")
    cli.main(["prepare-data", "--out", win, "--features", feats, "--n-users", "2", "--n-frames", "400"])
    assert data.load_packed(win)["features"].shape[1] == 128
    ck = str(tmp_path / "ck")
    cli.main(["train", "--preset", "video-fusion", "--data", win, "--steps", "2", "--batch-size", "8",
              "--device", "cpu", "--ckpt-dir", ck])
    res = _last_json(capsys.readouterr().out)
    assert res["step"] == 2 and np.isfinite(res["loss"]) and res["teacher_prob"] < 1.0
    assert np.isfinite(res["eval_great_circle_deg"])
    cli.main(["eval", "--preset", "video-fusion", "--ckpt-dir", ck, "--data", win, "--device", "cpu",
              "--json"])
    ev = _last_json(capsys.readouterr().out)
    assert len(ev["error_by_step_deg"]) == 30 and ev["n_windows"] > 0
    cli.main(["serve-bench", "--preset", "video-fusion", "--batch", "8", "--iters", "1",
              "--device", "cpu"])
    sb = _last_json(capsys.readouterr().out)
    assert sb["features"] == 128 and sb["horizon"] == 30 and sb["viewers_per_sec"] > 0


def test_bench_params_are_a_fusion_tree():
    cfg = get_preset("video-fusion")
    tree = cli.bench_params_np(cfg, 0)
    params = params_from_numpy(tree, "cpu")
    skeleton = fusion.init(torch.Generator().manual_seed(0), cfg.model, device="cpu")
    assert [tuple(a.shape) for a in tree_leaves(params)] == [tuple(a.shape) for a in tree_leaves(skeleton)]
    again = params_from_numpy(cli.bench_params_np(cfg, 0), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params), tree_leaves(again)))
