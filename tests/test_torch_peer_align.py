"""The port's ``peer_align`` tier of the cross_user family (preset
``stacked-ss-crossuser-10s``) against the JAX package, on the CPU: the model
functions, the train trajectory, the grouped gateway, the batcher's extras
at the preset's shapes, and the CLI.

Weights cross between the packages (params_from_numpy), seeds do not; both
sides get the same numpy inputs, and the same coins where scheduled sampling
draws them (the draw is patched on each side). The JAX Pallas kernels run
in interpret mode.
"""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)
import json
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longterm360fov_tpu import serving as jax_serving
from longterm360fov_tpu import train as jax_train
from longterm360fov_tpu.config import ExperimentConfig as JaxExperimentConfig
from longterm360fov_tpu.config import get_preset as jax_get_preset
from longterm360fov_tpu.models import cross_user as CU
from longterm360fov_tpu.models import seq2seq as S
from longterm360fov_tpu_torch import cli, serving, train
from longterm360fov_tpu_torch.config import ExperimentConfig, get_preset
from longterm360fov_tpu_torch.models import cross_user, seq2seq
from longterm360fov_tpu_torch.params import params_from_numpy, tree_leaves

FWD_TOL = 2e-5  # tests/test_lstm_align.py: the aligned kernels vs the XLA path
PRESET = "stacked-ss-crossuser-10s"


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _setup(layers=2, seed=0, b=8, k=3, h_in=4, t_out=5):
    """tests/test_lstm_align.py's shapes: hidden 16, C = 8, K = 3."""
    kw = dict(d=3, hidden=16, layers=layers, h_in=h_in, h_out=t_out, ctx_dim=8, peer_align=True)
    jcfg, tcfg = S.Seq2SeqConfig(**kw), seq2seq.Seq2SeqConfig(**kw)
    jp = CU.init(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(seed)
    past = rng.normal(size=(b, h_in, 3)).astype(np.float32)
    fut = rng.normal(size=(b, t_out, 3)).astype(np.float32)
    peers = (0.2 * rng.normal(size=(b, k, t_out, 3))).astype(np.float32)
    mask = rng.integers(0, 2, size=(b, k)).astype(np.float32)
    mask[0] = 0.0  # a row with every peer absent
    coins = rng.integers(0, 2, size=(t_out, b, 1)).astype(np.float32)
    return jcfg, tcfg, jp, tp, past, fut, peers, mask, coins


@pytest.mark.parametrize("layers,masked", [(1, True), (2, True), (2, False)])
def test_apply_fused_ss_peer_align_matches_jax(layers, masked):
    """cross_user.apply_fused_ss under peer_align (the encoder on
    lstm_seq_states, peers and decoder on aligned_ss_decode, f32 residuals)
    against JAX _apply_fused_aligned and the XLA aligned path, same coins."""
    jcfg, tcfg, jp, tp, past, fut, peers, mask, coins = _setup(layers, seed=layers)
    m = mask if masked else None
    ours = cross_user.apply_fused_ss(tp, tcfg, _t(past), _t(fut), coins=_t(coins),
                                     other_future_n=_t(peers), other_mask=_t(m),
                                     residual_dtype=torch.float32)
    ref = CU._apply_fused_aligned(jp, jcfg, _j(past), _j(fut), other_future_n=_j(peers),
                                  other_mask=_j(m), context=None, coins=_j(coins), tile_b=8,
                                  residual_dtype=jnp.float32)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=FWD_TOL)
    ctx = CU.encode_peers_aligned(jp, jcfg, _j(peers), _j(m))
    scan = S.apply(jp, jcfg, _j(past), _j(fut), coins=_j(coins), context=ctx)
    np.testing.assert_allclose(ours.numpy(), np.asarray(scan), atol=FWD_TOL)


def test_apply_fused_tf_peer_align_is_ss_with_heads_coins():
    """apply_fused_tf under peer_align == the aligned kernels with every
    coin heads == JAX apply_fused_tf == the XLA teacher-forced path."""
    jcfg, tcfg, jp, tp, past, fut, peers, mask, _ = _setup(seed=2)
    ours = cross_user.apply_fused_tf(tp, tcfg, _t(past), _t(fut), other_future_n=_t(peers),
                                     other_mask=_t(mask), residual_dtype=torch.float32)
    ref = CU.apply_fused_tf(jp, jcfg, _j(past), _j(fut), other_future_n=_j(peers),
                            other_mask=_j(mask), tile_b=8)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=FWD_TOL)
    np.testing.assert_allclose(ours.numpy(), np.asarray(CU.apply(
        jp, jcfg, _j(past), _j(fut), other_future_n=_j(peers), other_mask=_j(mask))), atol=FWD_TOL)


def test_peer_align_gradients_match_jax():
    """jax.grad of the loss through JAX _apply_fused_aligned against torch
    autograd through the port's, on every params leaf, the peer windows and
    the past and future windows (f32 residuals): atol 5e-4, rtol 1e-3
    (tests/test_lstm_align.py)."""
    jcfg, tcfg, jp, tp, past, fut, peers, mask, coins = _setup(seed=1)

    def jloss(p, peers_, fut_, past_):
        out = CU._apply_fused_aligned(p, jcfg, past_, fut_, other_future_n=peers_,
                                      other_mask=_j(mask), context=None, coins=_j(coins),
                                      tile_b=8, residual_dtype=jnp.float32)
        return jnp.sum(out ** 2)

    ref = jax.tree.leaves(jax.grad(jloss, argnums=(0, 1, 2, 3))(jp, _j(peers), _j(fut), _j(past)))
    leaves = [x.clone().requires_grad_(True) for x in jax.tree.leaves(tp)]
    params = jax.tree.unflatten(jax.tree.structure(tp), leaves)
    ins = [_t(x).clone().requires_grad_(True) for x in (peers, fut, past)]
    out = cross_user.apply_fused_ss(params, tcfg, ins[2], ins[1], coins=_t(coins),
                                    other_future_n=ins[0], other_mask=_t(mask),
                                    residual_dtype=torch.float32)
    ours = torch.autograd.grad((out ** 2).sum(), leaves + ins)
    assert len(ours) == len(ref)
    for x, y in zip(ours, ref):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("fn", ["serve_fused", "apply_fused_tf", "apply_fused_ss"])
def test_peer_align_without_peers_is_the_zero_context_model(fn):
    """No peers: JAX's function, the plain model with a zero context (on
    the static-context kernels' plain versions here)."""
    jcfg, tcfg, jp, tp, past, fut, _, _, coins = _setup(seed=3)
    if fn == "serve_fused":
        ours = cross_user.serve_fused(tp, tcfg, _t(past))
        ref = CU.serve_fused(jp, jcfg, _j(past), tile_b=8)
    elif fn == "apply_fused_tf":
        ours = cross_user.apply_fused_tf(tp, tcfg, _t(past), _t(fut), residual_dtype=torch.float32)
        ref = CU.apply_fused_tf(jp, jcfg, _j(past), _j(fut), tile_b=8)
    else:
        ours = cross_user.apply_fused_ss(tp, tcfg, _t(past), _t(fut), coins=_t(coins),
                                         residual_dtype=torch.float32)
        ref = S.apply(jp, jcfg, _j(past), _j(fut), coins=_j(coins),
                      context=jnp.zeros((8, jcfg.ctx_dim)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=FWD_TOL)


def test_peer_span_other_than_the_horizon_raises():
    jcfg, tcfg, jp, tp, past, fut, peers, mask, coins = _setup(seed=4)
    short = _t(peers[:, :, :3])
    with pytest.raises(ValueError, match="span"):
        cross_user.serve_fused(tp, tcfg, _t(past), other_future_n=short)
    with pytest.raises(ValueError, match="span"):
        cross_user.apply_fused_ss(tp, tcfg, _t(past), _t(fut), coins=_t(coins), other_future_n=short)
    with pytest.raises(ValueError, match="span"):
        cross_user.apply_fused_tf(tp, tcfg, _t(past), _t(fut), other_future_n=short)
    with pytest.raises(ValueError, match="span"):
        CU.serve_fused(jp, jcfg, _j(past), other_future_n=_j(peers[:, :, :3]))


# ---------------------------------------------------------------- training


def _windows(n, seed, h_in=4, h_out=5, k=3):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 1 + k, h_in + h_out, 3)).astype(np.float32) * 0.3
    v = v + np.array([1.0, 0.0, 0.0], np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    mask = (rng.random((n, k)) < 0.7).astype(np.float32)
    return {"past": v[:, 0, :h_in].copy(), "future": v[:, 0, h_in:].copy(),
            "other_future": v[:, 1:, h_in:] * mask[:, :, None, None], "other_mask": mask}


def test_ss_train_trajectory_matches_jax(monkeypatch):
    """3 scheduled-sampling train steps under peer_align through the port's
    aligned_ss_decode (f32 residuals) against the JAX make_train_step
    through JAX _apply_fused_aligned (interpret mode), from the same params
    on the same batches, with teacher_prob annealing 1 → 1/3 and the same
    coins on both sides: per-step loss within 1e-5 relative, final params
    within 5e-6 absolute (tests/test_torch_cross_user.py's bounds)."""
    model = dict(d=3, hidden=16, layers=2, h_in=4, h_out=5, ctx_dim=8, peer_align=True)
    top = dict(name="port-align-test", model_family="cross_user", scheduled_sampling=True,
               n_other_users=3, batch_size=16, steps=3, eval_every=100, lr=3e-3, train_impl="fused")
    jcfg = JaxExperimentConfig(model=S.Seq2SeqConfig(**model), **top)
    tcfg = ExperimentConfig(model=seq2seq.Seq2SeqConfig(**model), **top)
    assert jcfg.hash() == tcfg.hash()
    u = np.random.default_rng(11).random((5, 16, 1)).astype(np.float32)
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.asarray(u) < p)
    monkeypatch.setattr(seq2seq, "draw_coins", lambda gen, p, t_out, batch: torch.from_numpy(
        (u < np.float32(p)).astype(np.float32)))

    def jax_fused_ss(params, cfg, past_n, future_n, *, rng=None, teacher_prob=1.0, **kw):
        return CU._apply_fused_aligned(params, cfg, past_n, future_n, context=None, rng=rng,
                                       teacher_prob=teacher_prob, tile_b=8,
                                       residual_dtype=jnp.float32, **kw)

    jopt, topt = jax_train.make_optimizer(jcfg), train.make_optimizer(tcfg)
    jstate = jax_train.init_state(jcfg, CU.init, jopt)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jstate.params), "cpu")
    tstate = train.TrainState(tparams, topt.init(tparams), 0, torch.Generator())
    jstep = jax_train.make_train_step(jcfg, CU.apply, jopt, extras_fn=CU.batch_extras,
                                      fused_ss_fn=jax_fused_ss)
    tstep = train.make_train_step(tcfg, cross_user.apply, topt, extras_fn=cross_user.batch_extras,
                                  fused_ss_fn=partial(cross_user.apply_fused_ss,
                                                      residual_dtype=torch.float32))
    it = jax_train.batch_iterator(_windows(48, seed=3), tcfg.batch_size, tcfg.seed)
    for i in range(tcfg.steps):
        batch = next(it)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tstep(tstate, batch)
        assert float(tm["teacher_prob"]) == pytest.approx(float(jm["teacher_prob"]), rel=1e-6)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5), i
    assert float(jm["teacher_prob"]) < 1.0
    for a, b in zip(tree_leaves(tstate.params), jax.tree.leaves(jstate.params), strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=5e-6)


# ---------------------------------------------------------------- serving


def test_group_pack_matches_jax():
    keys = ["v2", "v0", "v2", "v1", "v0", "v2", "v3"]
    for tile_b in (1, 2, 4):
        ours, ref = serving.group_pack(keys, tile_b), jax_serving.group_pack(keys, tile_b)
        for a, b in zip(ours[:3], ref[:3]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert ours[3] == ref[3]


def _grouped_case(seed):
    cfg_kw = dict(d=3, hidden=16, layers=2, h_in=4, h_out=5, ctx_dim=8, peer_align=True)
    top = dict(name="grouped-align", model_family="cross_user", n_other_users=3)
    jcfg = JaxExperimentConfig(model=S.Seq2SeqConfig(**cfg_kw), **top)
    tcfg = ExperimentConfig(model=seq2seq.Seq2SeqConfig(**cfg_kw), **top)
    jp = CU.init(jax.random.PRNGKey(seed), jcfg.model)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(seed)
    pasts = _windows(7, seed)["past"]
    keys = ["v1", "v0", "v0", "v1", "v2", "v1", "v0"]
    sets = {v: (rng.normal(size=(3, 5, 3)) * 0.1 + [1.0, 0.0, 0.0]).astype(np.float32)
            for v in ("v0", "v1", "v2")}
    sets["v2"][1:] = 0.0  # two absent peers: the default mask drops them
    masks = {"v0": np.ones(3, np.float32), "v1": np.array([1, 1, 0], np.float32),
             "v2": np.array([1, 0, 0], np.float32)}
    return jcfg, tcfg, jp, tp, pasts, keys, sets, masks


@pytest.mark.parametrize("impl,masks", [("fused", True), ("plain", True), ("fused", False)])
def test_grouped_predict_matches_jax(impl, masks):
    """grouped_predict through the port's generic tier (the lockstep
    kernels' plain versions, or the plain model) against JAX
    make_grouped_serve_fn(impl="xla"), in the caller's row order."""
    jcfg, tcfg, jp, tp, pasts, keys, sets, mk = _grouped_case(seed=5)
    mk = mk if masks else None
    ref = jax_serving.grouped_predict(jax_serving.make_grouped_serve_fn(jp, jcfg, CU, impl="xla"),
                                      pasts, keys, sets, mk)
    fn = serving.make_grouped_serve_fn(tp, tcfg, cross_user, device="cpu", impl=impl,
                                       packed=impl == "plain")
    ours = serving.grouped_predict(fn, pasts, keys, sets, mk)
    assert sorted(ours) == sorted(ref) and fn.tile_b == 1
    np.testing.assert_allclose(ours["yaw"], np.asarray(ref["yaw"]), atol=1e-5)
    np.testing.assert_allclose(ours["pitch"], np.asarray(ref["pitch"]), atol=1e-5)
    assert (ours["prefetch"] == np.asarray(ref["prefetch"])).mean() > 0.99


def test_grouped_gateway_rejects_what_it_does_not_serve():
    _, tcfg, _, tp, pasts, keys, sets, _ = _grouped_case(seed=6)
    fn = serving.make_grouped_serve_fn(tp, tcfg, cross_user, device="cpu")
    with pytest.raises(KeyError, match="v2"):
        serving.grouped_predict(fn, pasts, keys, {k: v for k, v in sets.items() if k != "v2"})
    with pytest.raises(ValueError, match="must be"):
        serving.grouped_predict(fn, pasts, keys, {**sets, "v0": sets["v0"][:, :3]})
    with pytest.raises(ValueError, match="past windows"):
        serving.grouped_predict(fn, pasts[:, :3], keys, sets)
    with pytest.raises(ValueError, match="no peer context"):
        serving.make_grouped_serve_fn(tp, get_preset("seq2seq-tf-30"), seq2seq, device="cpu")
    with pytest.raises(ValueError, match="impl must be"):
        serving.make_grouped_serve_fn(tp, get_preset("transformer-30"), seq2seq, device="cpu", impl="xla")


@pytest.mark.parametrize("case", ["default-mask", "fewer-peers", "explicit-mask"])
def test_batcher_extras_at_the_preset_shapes_match_jax(case):
    """The batcher's request extras at the preset's (7, 100, 3) and (7,)
    against JAX's."""
    specs = serving.extra_specs_for(get_preset(PRESET))
    assert specs == jax_serving.extra_specs_for(jax_get_preset(PRESET))
    assert specs == {"other_future": (7, 100, 3), "other_mask": (7,)}
    rng = np.random.default_rng(8)
    past = rng.normal(size=(100, 3)).astype(np.float32)
    of = rng.normal(size=(7, 100, 3)).astype(np.float32)
    of[3] = 0.0
    extras = {"default-mask": {"other_future": of}, "fewer-peers": {"other_future": of[:4]},
              "explicit-mask": {"other_future": of, "other_mask": np.ones(7, np.float32)}}[case]
    got = []
    for mod in (serving, jax_serving):
        bat = mod.DynamicBatcher(lambda b: None, h_in=100, extra_specs=specs, max_batch=4,
                                 max_wait_ms=50.0)
        try:
            got.append(bat.submit(past, **dict(extras)).arrays)
        finally:
            bat.stop()
    for key in got[1]:
        assert np.array_equal(got[0][key], got[1][key]), key


def test_params_from_numpy_carries_the_preset_tree():
    jcfg = jax_get_preset(PRESET)
    jp = CU.init(jax.random.PRNGKey(0), jcfg.model)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    ref = jax.tree.leaves(jp)
    assert len(tree_leaves(tp)) == len(ref) == 2 * 2 + 2 * 2 + 2 + 2
    for a, b in zip(tree_leaves(tp), ref, strict=True):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert tuple(tp["peer_encoder"].w.shape) == (3 + 128, 4 * 128)
    assert tuple(tp["decoder"][0].w.shape) == (3 + 128 + 128, 4 * 128)


# ---------------------------------------------------------------- CLI


def _last_json(out):
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def small_store(tmp_path_factory):
    """A small synthetic store from ``prepare-data``: 8 users of one video
    (K = 7 real peers), 1000 frames, 100 + 100-frame windows (one test
    window a viewer)."""
    win = str(tmp_path_factory.mktemp("store") / "win.npz")
    cli.main(["prepare-data", "--out", win, "--n-users", "8", "--n-videos", "1", "--n-frames", "1000",
              "--h-in", "100", "--h-out", "100", "--n-other-users", "7"])
    return win


def test_cli_train_eval_serve_bench_of_the_preset_on_cpu(tmp_path, capsys, small_store):
    """The preset's three subcommands at tiny batches on the CPU (the
    kernels' plain versions): 2 train steps on a small store with K = 7
    peers and 100 + 100 frames, eval of the checkpoint, serve-bench."""
    ck = str(tmp_path / "ck")
    cli.main(["train", "--preset", PRESET, "--data", small_store, "--steps", "2", "--batch-size", "8",
              "--device", "cpu", "--ckpt-dir", ck])
    res = _last_json(capsys.readouterr().out)
    assert res["step"] == 2 and np.isfinite(res["loss"]) and res["teacher_prob"] < 1.0
    assert np.isfinite(res["eval_great_circle_deg"])
    cli.main(["eval", "--preset", PRESET, "--data", small_store, "--ckpt-dir", ck, "--device", "cpu", "--json"])
    ev = _last_json(capsys.readouterr().out)
    assert len(ev["error_by_step_deg"]) == 100 and ev["n_windows"] > 0
    cli.main(["serve-bench", "--preset", PRESET, "--batch", "4", "--iters", "1", "--device", "cpu"])
    sb = _last_json(capsys.readouterr().out)
    assert sb["peers"] == 7 and sb["horizon"] == 100 and sb["viewers_per_sec"] > 0
