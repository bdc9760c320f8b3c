"""The port's training slice against the JAX package, on the CPU: losses,
the optimizer and its schedule, the N-step train trajectory, the synthetic
data path, checkpoints, evaluation, baselines and the CLI.

Weights cross between the packages (params_from_numpy), seeds do not; both
sides get the same numpy batches.
"""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)
import dataclasses
import json
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from longterm360fov_tpu import baselines as jax_baselines
from longterm360fov_tpu import checkpoint as jax_ckpt
from longterm360fov_tpu import cli as jax_cli
from longterm360fov_tpu import data as jax_data
from longterm360fov_tpu import evaluate as jax_evaluate
from longterm360fov_tpu import geometry as jax_geometry
from longterm360fov_tpu import losses as jax_losses
from longterm360fov_tpu import traces as jax_traces
from longterm360fov_tpu import train as jax_train
from longterm360fov_tpu.config import ExperimentConfig as JaxExperimentConfig
from longterm360fov_tpu.models import seq2seq as jax_seq2seq
from longterm360fov_tpu.models import transformer as jax_transformer
from longterm360fov_tpu_torch import baselines, checkpoint, cli, data, evaluate, losses, traces, train
from longterm360fov_tpu_torch.config import ExperimentConfig, get_preset
from longterm360fov_tpu_torch.models import seq2seq, transformer
from longterm360fov_tpu_torch.params import params_from_numpy, tree_leaves


def _cfgs(**kw):
    model = dict(d=3, hidden=16, layers=1, h_in=5, h_out=5)
    model.update(kw.pop("model", {}))
    top = dict(name="port-train-test", batch_size=16, steps=5, eval_every=100, lr=3e-3)
    top.update(kw)
    jcfg = JaxExperimentConfig(model=jax_seq2seq.Seq2SeqConfig(**model), **top)
    tcfg = ExperimentConfig(model=seq2seq.Seq2SeqConfig(**model), **top)
    assert jcfg.hash() == tcfg.hash()
    return jcfg, tcfg


def _windows(n, seed, h_in=5, h_out=5):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, h_in + h_out, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v = (v * 0.3 + np.array([1.0, 0.0, 0.0], np.float32))  # a cloud around +x
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return {"past": v[:, :h_in].copy(), "future": v[:, h_in:].copy()}


# ---------------------------------------------------------------- losses


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    p, q = (rng.normal(size=(6, 5, 3)).astype(np.float32) for _ in range(2))
    jp, jq, tp, tq = jnp.asarray(p), jnp.asarray(q), torch.from_numpy(p), torch.from_numpy(q)
    pairs = [
        (losses.mse_loss(tp, tq), jax_losses.mse_loss(jp, jq)),
        (losses.great_circle_loss(tp, tq), jax_losses.great_circle_loss(jp, jq)),
        (losses.great_circle_deg_metric(tp, tq), jax_losses.great_circle_deg_metric(jp, jq)),
        (losses.error_by_step(tp, tq), jax_losses.error_by_step(jp, jq)),
        (losses.combined_loss(tp, tq, tp, tq, gc_weight=0.5),
         jax_losses.combined_loss(jp, jq, jp, jq, gc_weight=0.5)),
        (losses.combined_loss(tp, tq, None, None), jax_losses.combined_loss(jp, jq, None, None)),
    ]
    for ours, ref in pairs:
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    w = rng.random(6).astype(np.float32)
    np.testing.assert_allclose(
        losses.mse_loss(tp, tq, torch.from_numpy(w)).numpy(),
        np.asarray(jax_losses.mse_loss(jp, jq, jnp.asarray(w))), rtol=1e-5)


def test_great_circle_loss_gradient_is_finite_at_zero_error():
    target = torch.tensor([[1.0, 0.0, 0.0], [0.0, 0.6, 0.8]])
    v = target.clone().requires_grad_(True)
    losses.great_circle_loss(v, target).backward()
    assert torch.isfinite(v.grad).all()


# ---------------------------------------------------------------- optimizer


@pytest.mark.parametrize("warmup,steps", [(0, 10), (5, 40), (10, 10)])
def test_learning_rate_schedule_matches_optax(warmup, steps):
    jcfg, tcfg = _cfgs(warmup_steps=warmup, steps=steps, lr=2e-3)
    # the schedule train.make_optimizer builds in the JAX package
    sched = optax.warmup_cosine_decay_schedule(
        init_value=jcfg.lr / 100.0, peak_value=jcfg.lr, warmup_steps=warmup,
        decay_steps=max(jcfg.steps, warmup + 1), end_value=jcfg.lr / 10.0,
    ) if warmup else (lambda count: jcfg.lr)
    for count in range(steps + 5):
        ref = float(sched(jnp.asarray(count, jnp.int32)))
        assert train.learning_rate(tcfg, count) == pytest.approx(ref, rel=1e-6), count


@pytest.mark.parametrize("scale", [0.01, 10.0])  # under and over grad_clip = 1
def test_optimizer_updates_match_optax(scale):
    jcfg, tcfg = _cfgs(warmup_steps=3, steps=8)
    jparams = jax_seq2seq.init(jax.random.PRNGKey(0), jcfg.model)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jopt, topt = jax_train.make_optimizer(jcfg), train.make_optimizer(tcfg)
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    rng = np.random.default_rng(1)
    for _ in range(4):
        g_np = [rng.normal(size=np.shape(x)).astype(np.float32) * scale
                for x in jax.tree.leaves(jparams)]
        jg = jax.tree.unflatten(jax.tree.structure(jparams), [jnp.asarray(g) for g in g_np])
        tg = params_from_numpy(jax.tree.map(np.asarray, jg), "cpu")
        ju, jstate = jopt.update(jg, jstate, jparams)
        tu, tstate = topt.update(tg, tstate)
        for a, b in zip(tree_leaves(tu), jax.tree.leaves(ju)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5, atol=1e-9)


# ---------------------------------------------------------------- trajectory


def _transformer_cfgs(**kw):
    """A cut transformer-30: 2 layers at hidden 32, noisy teacher forcing
    annealed 1 → 0.3, gc_weight 0.3, a warmup-cosine schedule."""
    model = dict(hidden=32, layers=2)
    model.update(kw.pop("model", {}))
    return _cfgs(model=model, model_family="transformer", scheduled_sampling=True, ss_end=0.3,
                 gc_weight=0.3, warmup_steps=2, **kw)


def _with_peers(d, seed, k=3):
    """K peer futures (unit vectors around +x) and a mask with gaps."""
    rng = np.random.default_rng(seed)
    n, h_out = d["future"].shape[:2]
    of = _windows(n * k, seed + 100, h_in=1, h_out=h_out)["future"].reshape(n, k, h_out, 3)
    mask = (rng.random((n, k)) < 0.7).astype(np.float32)
    mask[0] = 0.0
    return dict(d, other_future=of, other_mask=mask)


def _patch_noise(monkeypatch, shape):
    """The same N(0, 1) array as noisy teacher forcing's noise on both sides:
    jax.random and torch.Generator give different numbers from one seed."""
    noise = np.random.default_rng(11).normal(size=shape).astype(np.float32)
    monkeypatch.setattr(jax.random, "normal", lambda key, shp, dtype=jnp.float32: jnp.asarray(noise))
    monkeypatch.setattr(transformer, "draw_noise", lambda gen, shp: torch.from_numpy(noise))


@pytest.mark.parametrize("case", ["fused", "fused-accum2", "fused-fast", "xla-gc-warmup", "transformer",
                                  "transformer-10s"])
def test_train_trajectory_matches_jax(case, monkeypatch):
    """N steps of the port's train step against the JAX make_train_step from
    the same params on the same batch_iterator batches: the fused path with
    f32 residuals on both sides (JAX kernels in interpret mode), with
    accum=2, as the gc_metric=False fast step, and the plain ("xla") path
    with the great-circle loss and a warmup-cosine schedule; a cut
    transformer-30 with peers (autograd through the parallel pass on both
    sides) with the same noisy-teacher-forcing noise; and a cut
    transformer-10s (window 8, 12 + 12 frames). Per-step loss within 1e-5
    relative and final params within 2e-6 absolute: f32 sums in another
    order, through 5 Adam updates of lr 3e-3."""
    kw = {
        "fused": dict(train_impl="fused"),
        "fused-accum2": dict(train_impl="fused", accum=2),
        "fused-fast": dict(train_impl="fused"),
        "xla-gc-warmup": dict(train_impl="xla", gc_weight=0.3, warmup_steps=2),
    }.get(case)
    gc_metric = case != "fused-fast"
    data_np = _windows(64, seed=3)
    if case.startswith("transformer"):
        model = dict(h_in=12, h_out=12, peer_window=8) if case == "transformer-10s" else {}
        jcfg, tcfg = _transformer_cfgs(model=model)
        data_np = _with_peers(_windows(64, seed=3, h_in=tcfg.model.h_in, h_out=tcfg.model.h_out), seed=3)
        _patch_noise(monkeypatch, (tcfg.batch_size, tcfg.model.h_out, 3))
        jfam, tfam = jax_transformer, transformer
        fns_j = fns_t = {}
    else:
        jcfg, tcfg = _cfgs(**kw)
        jfam, tfam = jax_seq2seq, seq2seq
        fns_j = dict(fused_tf_fn=partial(jax_seq2seq.apply_fused_tf, residual_dtype=jnp.float32))
        fns_t = dict(fused_tf_fn=partial(seq2seq.apply_fused_tf, residual_dtype=torch.float32))
    jopt, topt = jax_train.make_optimizer(jcfg), train.make_optimizer(tcfg)
    jstate = jax_train.init_state(jcfg, jfam.init, jopt)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jstate.params), "cpu")
    tstate = train.TrainState(tparams, topt.init(tparams), 0, torch.Generator())
    jstep = jax_train.make_train_step(jcfg, jfam.apply, jopt, gc_metric=gc_metric,
                                      extras_fn=getattr(jfam, "batch_extras", None), **fns_j)
    tstep = train.make_train_step(tcfg, tfam.apply, topt, gc_metric=gc_metric,
                                  extras_fn=getattr(tfam, "batch_extras", None), **fns_t)
    it = jax_train.batch_iterator(data_np, tcfg.batch_size, tcfg.seed)
    for _ in range(tcfg.steps):
        batch = next(it)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tstep(tstate, batch)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        if gc_metric:
            assert float(tm["great_circle_deg"]) == pytest.approx(
                float(jm["great_circle_deg"]), rel=1e-4)
        else:
            assert np.isnan(float(tm["great_circle_deg"]))
    assert tstate.step == int(jstate.step) == tcfg.steps
    for a, b in zip(tree_leaves(tstate.params), jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=2e-6)


def test_unported_training_modes_raise():
    """Every training mode is ported: scheduled sampling
    (tests/test_torch_cross_user.py) and data parallelism (slice P-1,
    tests/test_torch_parallel.py). As in JAX, cfg.data_parallel changes
    nothing in the step (parallel.train_loop_dp runs it over ranks): a step
    of a data_parallel config is bit-equal to one without; an unknown
    train_impl still raises."""
    jcfg, base = _cfgs()
    _, tcfg = _cfgs(data_parallel=True)
    params = params_from_numpy(jax.tree.map(np.asarray, jax_seq2seq.init(jax.random.PRNGKey(0), jcfg.model)), "cpu")
    batch = next(train.batch_iterator(_windows(32, seed=2), 16, 0))
    outs = []
    for cfg in (base, tcfg):
        opt = train.make_optimizer(cfg)
        state, _ = train.make_train_step(cfg, seq2seq.apply, opt)(
            train.TrainState(params, opt.init(params), 0, torch.Generator()), batch)
        outs.append(tree_leaves(state.params))
    for a, b in zip(*outs, strict=True):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="train_impl"):
        train.make_train_step(base.replace(train_impl="pallas"), seq2seq.apply, train.make_optimizer(base))



# ---------------------------------------------------------------- data


@pytest.mark.parametrize("n_users,n_videos,n_frames,seed", [(8, 2, 1200, 0), (3, 1, 300, 4)])
def test_synthetic_store_matches_jax_bit_for_bit(n_users, n_videos, n_frames, seed):
    ref = jax_traces.synthetic_store(n_users=n_users, n_videos=n_videos, n_frames=n_frames, seed=seed)
    ours = traces.synthetic_store(n_users=n_users, n_videos=n_videos, n_frames=n_frames, seed=seed)
    assert ours.videos() == ref.videos() and len(ours) == len(ref)
    for a, b in zip(ours.traces, ref.traces):
        assert (a.user, a.video, a.rate_hz) == (b.user, b.video, b.rate_hz)
        assert a.xyz.dtype == b.xyz.dtype and np.array_equal(a.xyz, b.xyz)
    y, p = ours.traces[1].euler
    jy, jp = ref.traces[1].euler
    assert np.array_equal(y, jy) and np.array_equal(p, jp)


def test_euler_xyz_conversions_match_jax_bit_for_bit():
    rng = np.random.default_rng(5)
    yaw, pitch = rng.uniform(-3.1, 3.1, 2000), rng.uniform(-1.5, 1.5, 2000)
    xyz = traces.euler_to_xyz(yaw, pitch)
    assert np.array_equal(xyz, np.asarray(jax_geometry.euler_to_xyz(yaw, pitch)))
    v = rng.normal(size=(2000, 3)).astype(np.float32)
    for a, b in zip(traces.xyz_to_euler(v), jax_geometry.xyz_to_euler(v)):
        assert np.array_equal(a, np.asarray(b))


@pytest.mark.parametrize("kw", [dict(), dict(stride=3, n_other_users=2),
                                dict(video_features=(4,)), dict(video_maps=(3, 5))])
def test_windows_from_store_matches_jax_bit_for_bit(kw):
    store_j = jax_traces.synthetic_store(n_users=3, n_videos=2, n_frames=200, seed=1)
    store_t = traces.synthetic_store(n_users=3, n_videos=2, n_frames=200, seed=1)
    for key in ("video_features", "video_maps"):
        if key in kw:  # per-frame payloads of every video but the last
            kw[key] = {v: np.random.default_rng(2).normal(size=(200, *kw[key])).astype(np.float32)
                       for v in store_t.videos()[:-1]}
    ref = jax_data.windows_from_store(store_j, 10, 10, **kw)
    ours = data.windows_from_store(store_t, 10, 10, **kw)
    for r, o in zip(ref, ours):
        assert sorted(r) == sorted(o)
        for k in r:
            assert r[k].dtype == o[k].dtype and np.array_equal(r[k], o[k]), k


def test_packed_npz_round_trips_with_the_jax_writer(tmp_path):
    d = _windows(20, seed=0)
    jax_data.save_packed(str(tmp_path / "w.npz"), d)
    back = data.load_packed(str(tmp_path / "w.npz"))
    assert all(np.array_equal(back[k], d[k]) for k in d)


def test_batch_iterator_matches_jax():
    d = _windows(50, seed=1)
    ours = train.batch_iterator(d, 16, seed=3, start_step=4)
    ref = jax_train.batch_iterator(d, 16, seed=3, start_step=4)
    for _ in range(7):
        a, b = next(ours), next(ref)
        assert all(np.array_equal(a[k], b[k]) for k in b)


# ---------------------------------------------------------------- checkpoints


def test_checkpoint_roundtrip(tmp_path):
    _, tcfg = _cfgs()
    opt = train.make_optimizer(tcfg)
    state = train.init_state(tcfg, seq2seq.init, opt, device="cpu")
    state, _ = train.make_train_step(tcfg, seq2seq.apply, opt)(state, _windows(16, seed=0))
    ck = checkpoint.Checkpointer(str(tmp_path / "ck"), tcfg)
    ck.save(state)
    assert ck.latest_step() == 1 and ck.check_config()
    fresh = train.init_state(tcfg, seq2seq.init, opt, device="cpu",
                             gen=torch.Generator().manual_seed(99))
    back = ck.restore(fresh)
    assert back.step == 1 and back.opt_state.count == 1
    assert torch.equal(back.rng.get_state(), state.rng.get_state())
    for a, b in zip(tree_leaves(state.params) + state.opt_state.mu + state.opt_state.nu,
                    tree_leaves(back.params) + back.opt_state.mu + back.opt_state.nu):
        assert torch.equal(a, b)
    with open(tmp_path / "ck" / "config.json") as f:
        assert json.load(f) == {"name": tcfg.name, "hash": tcfg.hash(), "model_hash": tcfg.model_hash()}


@pytest.mark.parametrize("train_impl", ["fused", "xla", "transformer"])
def test_resume_is_deterministic(tmp_path, train_impl):
    """N steps straight == k steps, checkpoint, restore, N - k steps; the
    checkpoint and the log come from train_loop itself. The transformer case
    draws its noisy-teacher-forcing noise from (seed, step), so a resumed run
    draws the same noise."""
    d, ev = _windows(48, seed=2), _windows(10, seed=9)
    if train_impl == "transformer":
        _, tcfg = _transformer_cfgs(steps=6, eval_every=3, ckpt_every=3)
        d, ev = _with_peers(d, seed=2), _with_peers(ev, seed=9)
        fam, run = transformer, dict(extras_fn=transformer.batch_extras)
    else:
        _, tcfg = _cfgs(steps=6, eval_every=3, ckpt_every=3, train_impl=train_impl)
        fam, run = seq2seq, dict(fused_tf_fn=seq2seq.apply_fused_tf)
    full, hist = train.train_loop(tcfg, fam.init, fam.apply, d, device="cpu", eval_data=ev, **run)
    ck_dir, log = str(tmp_path / "ck"), str(tmp_path / "log.jsonl")
    # the noise anneal and the lr schedule follow cfg.steps: the transformer
    # case takes its step-3 checkpoint from a run of all 6 steps
    saved = [3, 6] if train_impl == "transformer" else [3]
    train.train_loop(tcfg.replace(steps=saved[-1]), fam.init, fam.apply, d, device="cpu",
                     eval_data=ev, checkpoint_dir=ck_dir, log_file=log, **run)
    ck = checkpoint.Checkpointer(ck_dir, tcfg)
    assert ck.all_steps() == saved
    opt = train.make_optimizer(tcfg)
    restored = ck.restore(train.init_state(tcfg, fam.init, opt, device="cpu"), step=3)
    resumed, hist2 = train.train_loop(tcfg, fam.init, fam.apply, d, device="cpu",
                                      eval_data=ev, state=restored, **run)
    for a, b in zip(tree_leaves(full.params), tree_leaves(resumed.params)):
        assert torch.equal(a, b)
    assert hist[-1]["loss"] == hist2[-1]["loss"] and hist2[-1]["step"] == 6
    with open(log) as f:
        logged = [json.loads(line) for line in f]
    assert [m["step"] for m in logged] == saved and "eval_great_circle_deg" in logged[0]
    assert logged[0]["loss"] == hist[0]["loss"]


def test_best_by_metric_retention(tmp_path):
    _, tcfg = _cfgs()
    opt = train.make_optimizer(tcfg)
    state = train.init_state(tcfg, seq2seq.init, opt, device="cpu")
    ck = checkpoint.Checkpointer(str(tmp_path / "ck"), tcfg, keep=1,
                                 best_metric="eval_great_circle_deg")
    for step, metric in ((1, 20.0), (2, 5.0), (3, 11.0)):
        ck.save(state._replace(step=step), metrics={"eval_great_circle_deg": metric})
    assert ck.best_step() == 2 and ck.all_steps() == [2]
    latest = checkpoint.Checkpointer(str(tmp_path / "ck2"), tcfg, keep=2)
    for step in (1, 2, 3):
        latest.save(state._replace(step=step))
    assert latest.all_steps() == [2, 3] and latest.best_step() == 3


def test_check_model_config_as_jax(tmp_path):
    """The cases of tests/test_checkpoint.py: a pre-r4 model hash is accepted,
    except for a peer_align config; the JAX Checkpointer agrees on the same
    config.json."""
    from tests.test_checkpoint import _pre_r4_model_hash

    jcfg, tcfg = _cfgs()
    d = tmp_path / "ck"
    checkpoint.Checkpointer(str(d), tcfg)
    with open(d / "config.json", "w") as f:
        json.dump({"name": tcfg.name, "hash": "stale", "model_hash": _pre_r4_model_hash(jcfg)}, f)
    assert checkpoint.Checkpointer(str(d), tcfg).check_model_config()
    assert not checkpoint.Checkpointer(str(d), tcfg).check_config()
    aligned = tcfg.replace(model=dataclasses.replace(tcfg.model, peer_align=True))
    assert not checkpoint.Checkpointer(str(d), aligned).check_model_config()
    other = tcfg.replace(model=dataclasses.replace(tcfg.model, hidden=32))
    assert not checkpoint.Checkpointer(str(d), other).check_model_config()
    assert jax_ckpt.Checkpointer(str(d), jcfg).check_model_config()


# ---------------------------------------------------------------- evaluation


@pytest.mark.parametrize("impl", ["fused", "plain", "transformer-fused", "transformer-plain"])
def test_evaluate_matches_jax(impl):
    d = _windows(37, seed=6, h_in=6, h_out=4)
    if impl.startswith("transformer"):
        jcfg, tcfg = _transformer_cfgs(model=dict(h_in=6, h_out=4))
        jfam, impl = jax_transformer, impl.split("-")[1]
        d = _with_peers(d, seed=6)
    else:
        jcfg, tcfg = _cfgs(model=dict(h_in=6, h_out=4))
        jfam = jax_seq2seq
    jparams = jfam.init(jax.random.PRNGKey(4), jcfg.model)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    ref = jax_evaluate.evaluate(jparams, jcfg, jfam.apply, d, batch_size=16,
                                extras_fn=getattr(jfam, "batch_extras", None))
    ours = evaluate.evaluate(tparams, tcfg, d, impl=impl, batch_size=16)
    assert ours["n_windows"] == ref["n_windows"] == 37
    np.testing.assert_allclose(ours["error_by_step_deg"], ref["error_by_step_deg"], rtol=1e-4)
    assert ours["mean_deg"] == pytest.approx(ref["mean_deg"], rel=1e-4)
    assert ours["final_step_deg"] == pytest.approx(ref["final_step_deg"], rel=1e-4)
    assert evaluate.comparison_table({"m": ours}).splitlines()[0] == \
        jax_evaluate.comparison_table({"m": ref}).splitlines()[0]


def test_baselines_and_evaluate_predictions_match_jax():
    d = _windows(12, seed=8, h_in=10, h_out=7)
    past = d["past"]
    for ours, ref in (
        (baselines.persistence(torch.from_numpy(past), 7), jax_baselines.persistence(jnp.asarray(past), 7)),
        (baselines.truncated_linreg(torch.from_numpy(past), 7, fit_len=4),
         jax_baselines.truncated_linreg(jnp.asarray(past), 7, fit_len=4)),
    ):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)
        a = evaluate.evaluate_predictions(ours, d["future"])
        b = jax_evaluate.evaluate_predictions(np.asarray(ref), d["future"])
        np.testing.assert_allclose(a["error_by_step_deg"], b["error_by_step_deg"], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------- CLI


def _last_json(out):
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def small_store(tmp_path_factory):
    """A small synthetic store from ``prepare-data`` (2 users of one video,
    400 frames, 30 + 30-frame windows), so that the CLI rehearsals below
    train and evaluate on a few windows."""
    win = str(tmp_path_factory.mktemp("store") / "win.npz")
    cli.main(["prepare-data", "--out", win, "--n-users", "2", "--n-videos", "1", "--n-frames", "400"])
    return win


def test_cli_train_then_eval_on_cpu(tmp_path, capsys, small_store):
    ck = str(tmp_path / "ck")
    cli.main(["train", "--preset", "seq2seq-tf-30", "--data", small_store, "--steps", "3", "--batch-size", "16",
              "--device", "cpu", "--ckpt-dir", ck, "--log-file", str(tmp_path / "log.jsonl")])
    res = _last_json(capsys.readouterr().out)
    assert res["step"] == 3 and np.isfinite(res["loss"]) and "eval_great_circle_deg" in res
    cli.main(["train", "--preset", "seq2seq-tf-30", "--data", small_store, "--steps", "4", "--batch-size", "16",
              "--accum", "2", "--device", "cpu", "--ckpt-dir", ck, "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and _last_json(out)["step"] == 4
    cli.main(["eval", "--preset", "seq2seq-tf-30", "--data", small_store, "--ckpt-dir", ck, "--device", "cpu",
              "--json"])
    ev = _last_json(capsys.readouterr().out)
    assert len(ev["error_by_step_deg"]) == 30 and ev["n_windows"] > 0


def test_cli_train_reads_jax_prepared_data(tmp_path, capsys):
    out = str(tmp_path / "win.npz")
    jax_cli.main(["prepare-data", "--out", out, "--h-in", "30", "--h-out", "30",
                  "--n-users", "2", "--n-videos", "1", "--n-frames", "400"])
    capsys.readouterr()
    cli.main(["train", "--preset", "seq2seq-tf-30", "--data", out, "--steps", "2",
              "--batch-size", "8", "--device", "cpu"])
    assert _last_json(capsys.readouterr().out)["step"] == 2


FAMILY_ONLY = {"--seq-parallel": "--seq-parallel applies to the transformer family only",
               "--pipeline-parallel": "--pipeline-parallel applies to the transformer family only"}


@pytest.mark.parametrize("flag,match", [
    (["--data-parallel"], None), (["--seq-parallel", "2"], "--seq-parallel"),
    (["--pipeline-parallel", "2"], "--pipeline-parallel"),
    (["--tb-dir", "tb", "--data-parallel"], None),  # a world of one, its scalars written
])
def test_cli_train_parallel_flags_on_seq2seq(flag, match, tmp_path, monkeypatch, capsys, small_store):
    """On an LSTM preset --seq-parallel and --pipeline-parallel exit with the
    JAX CLI's family message, the same text for the same argv;
    --data-parallel trains, here without a launcher in a world of one, with
    --tb-dir too."""
    monkeypatch.chdir(tmp_path)
    argv = ["train", "--preset", "seq2seq-tf-30", "--device", "cpu", "--data", small_store, *flag]
    if match is not None:
        with pytest.raises(SystemExit, match=FAMILY_ONLY[match]) as ours:
            cli.main(argv)
        with pytest.raises(SystemExit) as ref:
            jax_cli.main([a for a in argv if a not in ("--device", "cpu")])
        assert str(ours.value) == str(ref.value)
        return
    cli.main([*argv, "--steps", "2", "--batch-size", "8"])
    last = _last_json(capsys.readouterr().out)
    assert last["step"] == 2 and last["n_devices"] == 1
    assert ("--tb-dir" in flag) == (tmp_path / "tb").is_dir()


def test_cli_train_peer_align_sets_the_model_field(monkeypatch):
    """--peer-align is ported: it sets model_peer_align (part of the model
    hash), as the JAX CLI's does; on a family without peers it changes
    nothing else."""
    seen = {}

    def fake_loop(cfg, *a, **k):
        seen["cfg"] = cfg
        return None, []

    monkeypatch.setattr(train, "train_loop", fake_loop)
    cli.main(["train", "--preset", "seq2seq-tf-30", "--device", "cpu", "--peer-align", "--steps", "1"])
    assert seen["cfg"].model.peer_align
    assert seen["cfg"].model_hash() == get_preset("seq2seq-tf-30", model_peer_align=True).model_hash()
    assert seen["cfg"].model_hash() != get_preset("seq2seq-tf-30").model_hash()


def test_cli_eval_refuses_another_architecture(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    cli.main(["train", "--preset", "lstm-xyz-10", "--steps", "1", "--batch-size", "8",
              "--device", "cpu", "--ckpt-dir", ck])
    capsys.readouterr()
    with pytest.raises(SystemExit, match="model-config"):
        cli.main(["eval", "--preset", "seq2seq-tf-30", "--ckpt-dir", ck, "--device", "cpu"])
