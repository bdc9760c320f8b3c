"""The port's cross_user family and scheduled-sampling training against the
JAX package, on the CPU: the family's forward paths, the peer encoders, the
batch extras, the scheduled-sampling train trajectory, the batcher's request
extras, the exported-weights loader, checkpoints, evaluation and the CLI.

Weights cross between the packages (params_from_numpy), seeds do not; both
sides get the same numpy inputs, and the same coins where scheduled sampling
draws them (the draw is patched on each side: jax.random's bits cannot be
reproduced in torch).
"""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)
import dataclasses
import json
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longterm360fov_tpu import evaluate as jax_evaluate
from longterm360fov_tpu import infer as jax_infer
from longterm360fov_tpu import serving as jax_serving
from longterm360fov_tpu import train as jax_train
from longterm360fov_tpu.config import ExperimentConfig as JaxExperimentConfig
from longterm360fov_tpu.config import get_preset as jax_get_preset
from longterm360fov_tpu.models import cross_user as CU
from longterm360fov_tpu.models import seq2seq as S
from longterm360fov_tpu_torch import checkpoint, cli, evaluate, infer, serving, train
from longterm360fov_tpu_torch.config import ExperimentConfig, get_preset
from longterm360fov_tpu_torch.models import cross_user, seq2seq
from longterm360fov_tpu_torch.params import params_from_numpy, tree_leaves, tree_unflatten

ATOL = 1e-5  # the plain paths: f32 sums in another order
FUSED_TOL = 2e-5  # tests/test_cross_user.py: serve_fused vs the scan


def _model(**kw):
    base = dict(d=3, hidden=32, layers=1, h_in=5, h_out=4, ctx_dim=16)
    base.update(kw)
    return S.Seq2SeqConfig(**base), seq2seq.Seq2SeqConfig(**base)


def _setup(seed=0, b=6, k=3, **kw):
    jcfg, tcfg = _model(**kw)
    jp = CU.init(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(seed)
    past = rng.normal(size=(b, jcfg.h_in, 3)).astype(np.float32) * 0.5
    fut = rng.normal(size=(b, jcfg.h_out, 3)).astype(np.float32) * 0.5
    others = rng.normal(size=(b, k, jcfg.h_out, 3)).astype(np.float32) * 0.5
    mask = (rng.random((b, k)) < 0.6).astype(np.float32)
    mask[0] = 0.0  # one row with every peer absent
    return jcfg, tcfg, jp, tp, past, fut, others, mask


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


# ---------------------------------------------------------------- the family


@pytest.mark.parametrize("mode", ["decode", "teacher-forcing", "no-mask", "no-peers", "aligned"])
def test_apply_matches_jax(mode):
    kw = dict(peer_align=True) if mode == "aligned" else {}
    jcfg, tcfg, jp, tp, past, fut, others, mask = _setup(seed=1, **kw)
    fut = fut if mode == "teacher-forcing" else None
    peers = {} if mode == "no-peers" else dict(other_future_n=others,
                                               other_mask=None if mode == "no-mask" else mask)
    ref = CU.apply(jp, jcfg, _j(past), _j(fut), **{k: _j(v) for k, v in peers.items()})
    ours = cross_user.apply(tp, tcfg, _t(past), _t(fut), **{k: _t(v) for k, v in peers.items()})
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("use_fused_seq", [False, True, "train", "serve"])
def test_encode_peers_matches_jax(use_fused_seq):
    """Every route of encode_peers against the JAX route of the same name
    (its Pallas kernels in interpret mode)."""
    jcfg, tcfg, jp, tp, _, _, others, mask = _setup(seed=2)
    ref = CU.encode_peers(jp, jcfg, _j(others), _j(mask), use_fused_seq=use_fused_seq)
    ours = cross_user.encode_peers(tp, tcfg, _t(others), _t(mask), use_fused_seq=use_fused_seq)
    assert ours.shape == (6, tcfg.ctx_dim)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=FUSED_TOL)
    assert not ours[0].any()  # every peer of row 0 is masked


def test_encode_peers_aligned_matches_jax():
    jcfg, tcfg, jp, tp, _, _, others, mask = _setup(seed=3, peer_align=True)
    ref = CU.encode_peers_aligned(jp, jcfg, _j(others), _j(mask))
    ours = cross_user.encode_peers_aligned(tp, tcfg, _t(others), _t(mask))
    assert ours.shape == (6, jcfg.h_out, tcfg.ctx_dim)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL)


def test_all_masked_peers_equals_zero_context():
    """The cross_user branch with every peer masked == plain seq2seq with a
    zero context, on the plain path and on the fused serve path."""
    _, tcfg, _, tp, past, fut, others, _ = _setup(seed=0)
    mask0 = torch.zeros(6, 3)
    zero = torch.zeros(6, tcfg.ctx_dim)
    masked = cross_user.apply(tp, tcfg, _t(past), _t(fut), other_future_n=_t(others),
                              other_mask=mask0)
    plain = seq2seq.apply(tp, tcfg, _t(past), _t(fut), context=zero)
    np.testing.assert_allclose(masked.numpy(), plain.numpy(), atol=1e-6)
    served = cross_user.serve_fused(tp, tcfg, _t(past), other_future_n=_t(others), other_mask=mask0)
    np.testing.assert_allclose(served.numpy(), seq2seq.serve_fused(tp, tcfg, _t(past), context=zero)
                               .numpy(), atol=1e-6)


def test_mask_ignores_absent_peers():
    _, tcfg, _, tp, _, _, others, _ = _setup(seed=2)
    garbage = others.copy()
    garbage[:, 2] = 1e6
    mask = np.array([[1, 1, 0]] * 6, np.float32)
    for route in (False, "serve"):
        a = cross_user.encode_peers(tp, tcfg, _t(others), _t(mask), use_fused_seq=route)
        b = cross_user.encode_peers(tp, tcfg, _t(garbage), _t(mask), use_fused_seq=route)
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


@pytest.mark.parametrize("peers", [True, False])
def test_serve_fused_matches_jax(peers):
    jcfg, tcfg, jp, tp, past, _, others, mask = _setup(seed=4, layers=2)
    kw = dict(other_future_n=others, other_mask=mask) if peers else {}
    ref = CU.serve_fused(jp, jcfg, _j(past), tile_b=8, **{k: _j(v) for k, v in kw.items()})
    ours = cross_user.serve_fused(tp, tcfg, _t(past), **{k: _t(v) for k, v in kw.items()})
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=FUSED_TOL)
    scan = CU.apply(jp, jcfg, _j(past), **{k: _j(v) for k, v in kw.items()})
    np.testing.assert_allclose(ours.numpy(), np.asarray(scan), atol=FUSED_TOL)


def _jax_fused_ss(params, cfg, past_n, future_n, *, rng=None, teacher_prob=1.0, coins=None,
                  other_future_n=None, other_mask=None):
    """JAX cross_user.apply_fused_ss (its non-peer_align branch) with f32
    residuals: the peer context through lstm_seq, then the fused decoder."""
    ctx = CU.encode_peers(params, cfg, other_future_n, other_mask, use_fused_seq=True)
    return S.apply_fused_ss(params, cfg, past_n, future_n, rng=rng, teacher_prob=teacher_prob,
                            coins=coins, context=ctx, tile_b=8, residual_dtype=jnp.float32)


@pytest.mark.parametrize("layers", [1, 2])
def test_apply_fused_ss_matches_jax(layers):
    """cross_user.apply_fused_ss (f32 residuals) against the JAX fused path
    and the JAX scan, with the same coins; and its teacher-forced twin."""
    jcfg, tcfg, jp, tp, past, fut, others, mask = _setup(seed=5, layers=layers)
    coins = (np.random.default_rng(5).random((jcfg.h_out, 6, 1)) < 0.5).astype(np.float32)
    ours = cross_user.apply_fused_ss(tp, tcfg, _t(past), _t(fut), coins=_t(coins),
                                     other_future_n=_t(others), other_mask=_t(mask),
                                     residual_dtype=torch.float32)
    ref = _jax_fused_ss(jp, jcfg, _j(past), _j(fut), coins=_j(coins), other_future_n=_j(others),
                        other_mask=_j(mask))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=3e-5)
    ctx = CU.encode_peers(jp, jcfg, _j(others), _j(mask))
    scan = S.apply(jp, jcfg, _j(past), _j(fut), coins=_j(coins), context=ctx)
    np.testing.assert_allclose(ours.numpy(), np.asarray(scan), atol=3e-5)
    # the teacher-forced twin with its default bf16 residuals: the decoder
    # starts from the encoder's bf16-rounded final states, so 2e-2 (the
    # bound the JAX suite and chip_smoke.py give bf16 residuals)
    tf = cross_user.apply_fused_tf(tp, tcfg, _t(past), _t(fut), other_future_n=_t(others),
                                   other_mask=_t(mask))
    np.testing.assert_allclose(tf.numpy(), np.asarray(CU.apply(
        jp, jcfg, _j(past), _j(fut), other_future_n=_j(others), other_mask=_j(mask))), atol=2e-2)


@pytest.mark.parametrize("fn", ["serve_fused", "apply_fused_tf", "apply_fused_ss"])
def test_peer_align_fused_tiers_match_jax(fn):
    """The lockstep tiers run (the kernels' plain versions here) and match
    the JAX fused tier of the same name and the XLA aligned path."""
    jcfg, tcfg, jp, tp, past, fut, others, mask = _setup(seed=0, peer_align=True)
    peers = dict(other_future_n=_t(others), other_mask=_t(mask))
    jpeers = dict(other_future_n=_j(others), other_mask=_j(mask))
    coins = np.ones((jcfg.h_out, 6, 1), np.float32)
    if fn == "serve_fused":
        ours = cross_user.serve_fused(tp, tcfg, _t(past), **peers)
        ref = CU.serve_fused(jp, jcfg, _j(past), tile_b=8, **jpeers)
        scan = CU.apply(jp, jcfg, _j(past), **jpeers)
    elif fn == "apply_fused_tf":
        ours = cross_user.apply_fused_tf(tp, tcfg, _t(past), _t(fut), residual_dtype=torch.float32,
                                         **peers)
        ref = CU.apply_fused_tf(jp, jcfg, _j(past), _j(fut), tile_b=8, **jpeers)
        scan = CU.apply(jp, jcfg, _j(past), _j(fut), **jpeers)
    else:
        ours = cross_user.apply_fused_ss(tp, tcfg, _t(past), _t(fut), coins=_t(coins),
                                         residual_dtype=torch.float32, **peers)
        ref = CU._apply_fused_aligned(jp, jcfg, _j(past), _j(fut), context=None, coins=_j(coins),
                                      tile_b=8, residual_dtype=jnp.float32, **jpeers)
        scan = CU.apply(jp, jcfg, _j(past), _j(fut), **jpeers)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=FUSED_TOL)
    np.testing.assert_allclose(ours.numpy(), np.asarray(scan), atol=FUSED_TOL)


def test_batch_extras_matches_jax():
    rng = np.random.default_rng(6)
    batch = {"past": rng.normal(size=(4, 5, 3)).astype(np.float32),
             "other_future": rng.normal(size=(4, 2, 4, 3)).astype(np.float32),
             "other_mask": np.array([[1, 0], [1, 1], [0, 0], [1, 1]], np.float32)}
    anchor = batch["past"][:, -1:]
    ref = CU.batch_extras({k: _j(v) for k, v in batch.items()}, _j(anchor))
    ours = cross_user.batch_extras({k: _t(v) for k, v in batch.items()}, _t(anchor))
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), atol=1e-7)
    assert cross_user.batch_extras({"past": _t(batch["past"])}, _t(anchor)) == {}


# ---------------------------------------------------------------- params


def test_params_tree_order_and_init():
    jcfg, tcfg, jp, tp, *_ = _setup(seed=7, layers=2)
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp), strict=True):
        assert np.array_equal(a.numpy(), np.asarray(b))
    back = tree_unflatten(tp, tree_leaves(tp))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back), tree_leaves(tp)))
    fresh = cross_user.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert [tuple(t.shape) for t in tree_leaves(fresh)] == [tuple(np.shape(x)) for x in
                                                           jax.tree.leaves(jp)]
    assert torch.equal(fresh["peer_encoder"].b[16:32], torch.ones(16))
    with pytest.raises(ValueError, match="ctx_dim"):
        cross_user.init(torch.Generator(), dataclasses.replace(tcfg, ctx_dim=0), device="cpu")
    with pytest.raises(KeyError, match="peer_encoder"):
        params_from_numpy({**jax.tree.map(np.asarray, jp), "extra": 1}, "cpu")


def test_load_exported_params_of_a_jax_cross_user_export(tmp_path):
    jcfg = jax_get_preset("stacked-ss-crossuser")
    tcfg = get_preset("stacked-ss-crossuser")
    jp = CU.init(jax.random.PRNGKey(3), jcfg.model)
    path = str(tmp_path / "export.npz")
    np.savez(path, **{k: np.asarray(v) for k, v in jax_serving.flat_param_items(jp)})
    ours = serving.load_exported_params(path, tcfg, cross_user, device="cpu")
    for a, b in zip(tree_leaves(ours), jax.tree.leaves(jp), strict=True):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert [k for k, _ in serving.flat_param_items(ours)] == \
        [k for k, _ in jax_serving.flat_param_items(jp)]
    ref = jax_serving.load_exported_params(path, jcfg, CU)
    assert len(jax.tree.leaves(ref)) == len(tree_leaves(ours))


def test_checkpoint_roundtrip_cross_user(tmp_path):
    tcfg = get_preset("stacked-ss-crossuser", model_hidden=32, model_ctx_dim=16, batch_size=8)
    opt = train.make_optimizer(tcfg)
    state = train.init_state(tcfg, cross_user.init, opt, device="cpu")
    assert len(state.opt_state.mu) == len(tree_leaves(state.params)) == 2 * 2 + 2 * 2 + 2 + 2
    ck = checkpoint.Checkpointer(str(tmp_path / "ck"), tcfg)
    ck.save(state._replace(step=3))
    back = ck.restore(train.init_state(tcfg, cross_user.init, opt, device="cpu",
                                       gen=torch.Generator().manual_seed(9)))
    assert back.step == 3 and "peer_encoder" in back.params
    for a, b in zip(tree_leaves(back.params), tree_leaves(state.params)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- training


def _windows(n, seed, h_in=5, h_out=4, k=2):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 1 + k, h_in + h_out, 3)).astype(np.float32)
    v = v * 0.3 + np.array([1.0, 0.0, 0.0], np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    mask = (rng.random((n, k)) < 0.7).astype(np.float32)
    return {"past": v[:, 0, :h_in].copy(), "future": v[:, 0, h_in:].copy(),
            "other_future": v[:, 1:, h_in:] * mask[:, :, None, None], "other_mask": mask}


def _train_cfgs(family, **kw):
    model = dict(d=3, hidden=16, layers=2, h_in=5, h_out=4, ctx_dim=8 if family == "cross_user" else 0)
    top = dict(name="port-ss-test", model_family=family, scheduled_sampling=True, n_other_users=2,
               batch_size=16, steps=5, eval_every=100, lr=3e-3)
    top.update(kw)
    jcfg = JaxExperimentConfig(model=S.Seq2SeqConfig(**model), **top)
    tcfg = ExperimentConfig(model=seq2seq.Seq2SeqConfig(**model), **top)
    assert jcfg.hash() == tcfg.hash()
    return jcfg, tcfg


@pytest.mark.parametrize("case", ["cross_user-fused", "cross_user-fused-fast", "seq2seq-xla"])
def test_ss_train_trajectory_matches_jax(monkeypatch, case):
    """N scheduled-sampling train steps of the port against the JAX
    make_train_step from the same params on the same batches, with
    teacher_prob annealing 1 → 0.2 over the 5 steps. Both sides draw the
    same coins (u < teacher_prob for one fixed numpy u; the JAX scan's
    per-step draw gets step 0's row of u at every step). The fused cases
    (cross_user, peers through lstm_seq, the decoder through ss_decode, f32
    residuals; JAX kernels in interpret mode), the second as the
    gc_metric=False fast step; the plain case through autograd of the
    family's apply. Per-step loss within 1e-5 relative and final params
    within 5e-6 absolute: f32 sums in another order over 5 Adam updates of
    lr 3e-3."""
    family, impl = case.split("-")[:2]
    gc_metric = not case.endswith("fast")
    jcfg, tcfg = _train_cfgs(family, train_impl=impl)
    u = np.random.default_rng(11).random((jcfg.model.h_out, 16, 1)).astype(np.float32)

    def jax_bernoulli(key, p, shape):
        return jnp.asarray(u if len(shape) == 3 else u[0]) < p

    def port_coins(gen, p, t_out, batch):
        assert isinstance(gen, torch.Generator)
        return torch.from_numpy((u < np.float32(p)).astype(np.float32))

    if impl == "xla":  # the scan draws (B, 1) at every step: the same row u[0]
        u[:] = u[0]
    monkeypatch.setattr(jax.random, "bernoulli", jax_bernoulli)
    monkeypatch.setattr(seq2seq, "draw_coins", port_coins)
    jfam, tfam = (CU, cross_user) if family == "cross_user" else (S, seq2seq)
    jopt, topt = jax_train.make_optimizer(jcfg), train.make_optimizer(tcfg)
    jstate = jax_train.init_state(jcfg, jfam.init, jopt)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jstate.params), "cpu")
    tstate = train.TrainState(tparams, topt.init(tparams), 0, torch.Generator())
    jkw = dict(extras_fn=getattr(jfam, "batch_extras", None), gc_metric=gc_metric)
    tkw = dict(extras_fn=getattr(tfam, "batch_extras", None), gc_metric=gc_metric)
    if impl == "fused":
        jkw["fused_ss_fn"] = _jax_fused_ss
        tkw["fused_ss_fn"] = partial(cross_user.apply_fused_ss, residual_dtype=torch.float32)
    jstep = jax_train.make_train_step(jcfg, jfam.apply, jopt, **jkw)
    tstep = train.make_train_step(tcfg, tfam.apply, topt, **tkw)
    data = _windows(48, seed=3)
    if family != "cross_user":
        data = {k: data[k] for k in ("past", "future")}
    it = jax_train.batch_iterator(data, tcfg.batch_size, tcfg.seed)
    for i in range(tcfg.steps):
        batch = next(it)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tstep(tstate, batch)
        assert float(tm["teacher_prob"]) == pytest.approx(float(jm["teacher_prob"]), rel=1e-6)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5), i
    assert float(jm["teacher_prob"]) < 1.0
    for a, b in zip(tree_leaves(tstate.params), jax.tree.leaves(jstate.params), strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=5e-6)


def test_step_coins_are_a_function_of_seed_and_step():
    _, tcfg = _train_cfgs("cross_user")
    a = seq2seq.draw_coins(train.step_generator(tcfg, 7, "cpu"), 0.5, 4, 16)
    b = seq2seq.draw_coins(train.step_generator(tcfg, 7, "cpu"), 0.5, 4, 16)
    c = seq2seq.draw_coins(train.step_generator(tcfg, 8, "cpu"), 0.5, 4, 16)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_ss_resume_is_deterministic(tmp_path):
    """Scheduled sampling through the kernels' plain versions: N steps
    straight == restore the checkpoint of step k, then N - k steps, coins
    included (they are drawn from (seed, step), with no saved generator).
    The checkpoint comes from the same run: a shorter run would anneal
    teacher_prob over its own step count."""
    _, tcfg = _train_cfgs("cross_user", steps=6, eval_every=3, ckpt_every=3, train_impl="fused")
    d, ev = _windows(48, seed=2), _windows(10, seed=9)
    run = dict(device="cpu", eval_data=ev, extras_fn=cross_user.batch_extras,
               fused_ss_fn=cross_user.apply_fused_ss)
    ck_dir = str(tmp_path / "ck")
    full, hist = train.train_loop(tcfg, cross_user.init, cross_user.apply, d,
                                  checkpoint_dir=ck_dir, **run)
    ck = checkpoint.Checkpointer(ck_dir, tcfg)
    assert ck.all_steps() == [3, 6]
    restored = ck.restore(train.init_state(tcfg, cross_user.init, train.make_optimizer(tcfg),
                                           device="cpu"), step=3)
    resumed, hist2 = train.train_loop(tcfg, cross_user.init, cross_user.apply, d, state=restored,
                                      **run)
    for a, b in zip(tree_leaves(full.params), tree_leaves(resumed.params)):
        assert torch.equal(a, b)
    assert hist[-1]["loss"] == hist2[-1]["loss"] and hist[-1]["teacher_prob"] < 1.0
    assert np.isfinite(hist[0]["eval_great_circle_deg"])


# ---------------------------------------------------------------- serving


def test_extra_specs_match_jax():
    for name in ("seq2seq-tf-30", "stacked-ss-crossuser", "stacked-ss-crossuser-10s",
                 "video-fusion", "transformer-30"):
        for k in (0, 4):
            jcfg, tcfg = jax_get_preset(name, n_other_users=k), get_preset(name, n_other_users=k)
            assert serving.extra_specs_for(tcfg) == jax_serving.extra_specs_for(jcfg)
            assert serving.required_extras_for(tcfg) == jax_serving.required_extras_for(jcfg)


def _echo(batch):
    raise RuntimeError("stub: only the queued arrays are compared")


@pytest.mark.parametrize("case", ["missing", "default-mask", "explicit-mask", "fewer-peers",
                                  "bulk-default-mask", "bulk-fewer-peers"])
def test_batcher_request_extras_match_jax(case):
    """The arrays a request becomes in the port's DynamicBatcher and in
    JAX's: zero fill, the default mask "valid where a peer row is nonzero",
    and an explicit mask that wins over it (an all-zero one included)."""
    specs = {"other_future": (3, 4, 3), "other_mask": (3,)}
    rng = np.random.default_rng(8)
    past = rng.normal(size=(5, 3)).astype(np.float32)
    of = rng.normal(size=(3, 4, 3)).astype(np.float32)
    of[1] = 0.0  # an absent peer
    bulk = case.startswith("bulk")
    if bulk:
        past, of = np.stack([past] * 2), np.stack([of, of * 2])
    extras = {
        "missing": {},
        "default-mask": {"other_future": of},
        "explicit-mask": {"other_future": of, "other_mask": np.zeros(3, np.float32)},
        "fewer-peers": {"other_future": of[:2]},
        "bulk-default-mask": {"other_future": of},
        "bulk-fewer-peers": {"other_future": of[:, :2]},
    }[case]
    got = []
    for mod in (serving, jax_serving):
        bat = mod.DynamicBatcher(_echo, h_in=5, extra_specs=specs, max_batch=8, max_wait_ms=50.0)
        try:
            p = bat.submit_many(past, **extras)[0] if bulk else bat.submit(past, **extras)
            got.append(p.arrays)
        finally:
            bat.stop()
    ours, ref = got
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].shape == ref[k].shape and np.array_equal(ours[k], ref[k]), k
    if case == "explicit-mask":
        assert not ours["other_mask"].any()
    if case == "default-mask":
        assert ours["other_mask"].tolist() == [[1.0, 0.0, 1.0]]


def test_batcher_rejects_bad_extras():
    bat = serving.DynamicBatcher(_echo, h_in=5, extra_specs={"features": (4,)},
                                 required=frozenset({"features"}))
    try:
        with pytest.raises(ValueError, match="requires extras"):
            bat.submit(np.zeros((5, 3)))
        with pytest.raises(ValueError, match="must have shape"):
            bat.submit(np.zeros((5, 3)), features=np.zeros(3))
        with pytest.raises(ValueError, match="unknown extras"):
            bat.submit(np.zeros((5, 3)), features=np.zeros(4), other=np.zeros(1))
    finally:
        bat.stop()


def test_batcher_serves_peers_like_the_direct_call():
    """Single requests with K peers, fewer peers and none, and one bulk
    request, through the batcher in front of the fused serve program (the
    kernels' plain versions here): every answer equals the direct call."""
    tcfg = get_preset("stacked-ss-crossuser", model_hidden=32, model_ctx_dim=16, model_h_in=5,
                      model_h_out=4, n_other_users=3)
    params = cross_user.init(torch.Generator().manual_seed(1), tcfg.model, device="cpu")
    fn = serving.make_serve_fn(params, tcfg, cross_user, device="cpu", impl="fused")
    specs = serving.extra_specs_for(tcfg)
    rng = np.random.default_rng(2)
    pasts = rng.normal(size=(7, 5, 3)).astype(np.float32)
    others = rng.normal(size=(7, 3, 4, 3)).astype(np.float32)
    bat = serving.DynamicBatcher(fn, h_in=5, extra_specs=specs, max_batch=16, max_wait_ms=20.0)
    try:
        res = [bat.predict(pasts[0], other_future=others[0]),
               bat.predict(pasts[1], other_future=others[1, :2]),
               bat.predict(pasts[2])]
        chunks = bat.submit_many(pasts[3:], other_future=others[3:])
        for c in chunks:
            assert c.event.wait(30) and c.error is None
    finally:
        bat.stop()
    of = others.copy()
    of[1, 2] = 0.0
    of[2] = 0.0
    mask = (np.abs(of).max(axis=(2, 3)) > 0).astype(np.float32)
    direct = fn.unpack(fn({"past": pasts, "other_future": of, "other_mask": mask}).numpy())
    for key in ("yaw", "pitch"):
        got = np.concatenate([np.stack([r[key] for r in res]), chunks[0].result[key]])
        np.testing.assert_allclose(got, direct[key], atol=1e-6)


@pytest.mark.parametrize("impl", ["fused", "plain"])
def test_predict_and_evaluate_with_peers_match_jax(impl):
    jcfg_m, tcfg_m = _model(hidden=32, h_in=6, h_out=4, ctx_dim=16, layers=2)
    jcfg = JaxExperimentConfig(name="cu", model=jcfg_m, model_family="cross_user", n_other_users=3)
    tcfg = ExperimentConfig(name="cu", model=tcfg_m, model_family="cross_user", n_other_users=3)
    jp = CU.init(jax.random.PRNGKey(2), jcfg_m)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    d = _windows(21, seed=4, h_in=6, h_out=4, k=3)
    batch = {k: v for k, v in d.items() if k != "future"}
    ref = jax_infer.predict_batch(jp, jcfg, CU.apply, {k: _j(v) for k, v in batch.items()}, None,
                                  CU.batch_extras)
    ours = infer.make_predict_fn(tp, tcfg, device="cpu", impl=impl)(batch)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=FUSED_TOL)
    ev_ref = jax_evaluate.evaluate(jp, jcfg, CU.apply, d, batch_size=8, extras_fn=CU.batch_extras)
    ev = evaluate.evaluate(tp, tcfg, d, impl=impl, batch_size=8)
    np.testing.assert_allclose(ev["error_by_step_deg"], ev_ref["error_by_step_deg"], rtol=1e-4)


# ---------------------------------------------------------------- CLI


def _last_json(out):
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def small_store(tmp_path_factory):
    """A small synthetic store from ``prepare-data`` (2 users of one video,
    400 frames, K = 4 other-user slots: 1 real peer, the rest masked), so
    that the CLI rehearsals below train and evaluate on a few windows."""
    win = str(tmp_path_factory.mktemp("store") / "win.npz")
    cli.main(["prepare-data", "--out", win, "--n-users", "2", "--n-videos", "1", "--n-frames", "400",
              "--n-other-users", "4"])
    return win


def test_cli_train_eval_serve_bench_of_the_preset_on_cpu(tmp_path, capsys, small_store):
    ck = str(tmp_path / "ck")
    cli.main(["train", "--preset", "stacked-ss-crossuser", "--data", small_store, "--steps", "3",
              "--batch-size", "16", "--device", "cpu", "--ckpt-dir", ck])
    res = _last_json(capsys.readouterr().out)
    assert res["step"] == 3 and np.isfinite(res["loss"]) and res["teacher_prob"] < 1.0
    assert np.isfinite(res["eval_great_circle_deg"])
    cli.main(["eval", "--preset", "stacked-ss-crossuser", "--data", small_store, "--ckpt-dir", ck,
              "--device", "cpu", "--json", "--peers", "2"])
    ev = _last_json(capsys.readouterr().out)
    assert len(ev["error_by_step_deg"]) == 30 and ev["n_windows"] > 0
    cli.main(["serve-bench", "--preset", "stacked-ss-crossuser", "--batch", "8", "--iters", "1",
              "--device", "cpu", "--peers", "3"])
    sb = _last_json(capsys.readouterr().out)
    assert sb["peers"] == 3 and sb["horizon"] == 30 and sb["viewers_per_sec"] > 0


@pytest.mark.parametrize("cmd", ["eval", "serve-bench", "train"])
def test_cli_peer_align(cmd, tmp_path, capsys, small_store):
    """--peer-align sets model_peer_align, as the JAX CLI does: train runs
    the lockstep tier, serve-bench serves through it, and eval refuses a
    checkpoint trained without it (the model hash differs) and reads one
    trained with it."""
    base = ["--preset", "stacked-ss-crossuser", "--device", "cpu"]
    if cmd == "serve-bench":
        cli.main(["serve-bench", *base, "--peer-align", "--batch", "4", "--iters", "1"])
        sb = _last_json(capsys.readouterr().out)
        assert sb["peers"] == 4 and sb["horizon"] == 30 and sb["viewers_per_sec"] > 0
        return
    ck = str(tmp_path / "ck")
    base += ["--data", small_store]
    flags = [] if cmd == "eval" else ["--peer-align"]
    cli.main(["train", *base, *flags, "--steps", "1", "--batch-size", "8", "--ckpt-dir", ck])
    res = _last_json(capsys.readouterr().out)
    assert res["step"] == 1 and np.isfinite(res["loss"])
    ev_flags = ["--peer-align"] if cmd == "eval" else []
    if cmd == "eval":  # trained without --peer-align: the model hash refuses the load
        with pytest.raises(SystemExit, match="model-config"):
            cli.main(["eval", *base, "--ckpt-dir", ck, *ev_flags])
        return
    cli.main(["eval", *base, "--ckpt-dir", ck, "--peer-align", "--json"])
    assert _last_json(capsys.readouterr().out)["n_windows"] > 0
    with pytest.raises(SystemExit, match="model-config"):
        cli.main(["eval", *base, "--ckpt-dir", ck])
