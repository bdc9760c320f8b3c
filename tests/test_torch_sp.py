"""Sequence parallelism of the port (``parallel.sp``) on the CPU, every case
of JAX's ``tests/test_sp.py``: the time-sharded transformer pass on a grid of
8 CPU entries (JAX's 8 virtual devices) against JAX's single-device
``transformer.apply`` (forward, noisy teacher, gradients, the encoder's
fallback, the autoregressive fallback, a 3-step trajectory) and against
JAX's ``sp_decode`` on its 8 CPU devices, at JAX's tolerances. Weights cross
as numpy (params_from_numpy); the noise draw is patched on both sides."""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longterm360fov_tpu import train as jax_train
from longterm360fov_tpu.config import ExperimentConfig as JaxExperimentConfig
from longterm360fov_tpu.models import transformer as JT
from longterm360fov_tpu.models.seq2seq import Seq2SeqConfig as JaxSeq2SeqConfig
from longterm360fov_tpu.parallel import sp as jax_sp
from longterm360fov_tpu_torch import train
from longterm360fov_tpu_torch.config import ExperimentConfig
from longterm360fov_tpu_torch.models import transformer
from longterm360fov_tpu_torch.models.seq2seq import Seq2SeqConfig
from longterm360fov_tpu_torch.params import params_from_numpy, tree_leaves, tree_unflatten
from longterm360fov_tpu_torch.parallel import grid, sp

H_OUT = 16
B = 4
FWD_TOL = 2e-5


def _mcfg(**kw):
    base = dict(d=3, hidden=32, layers=2, h_in=8, h_out=H_OUT)
    base.update(kw)
    return Seq2SeqConfig(**base), JaxSeq2SeqConfig(**base)


@pytest.fixture(autouse=True)
def eight_devices(monkeypatch):
    """The port's local devices: 8 CPU entries, as JAX's 8 virtual devices."""
    monkeypatch.setattr(grid, "local_devices", lambda kind="cuda": [torch.device("cpu")] * 8)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return {
        "past": rng.normal(size=(B, 8, 3)).astype(np.float32),
        "future": rng.normal(size=(B, H_OUT, 3)).astype(np.float32),
        "peers": rng.normal(size=(B, 2, H_OUT, 3)).astype(np.float32),
        "pmask": np.array([[1, 1], [1, 0], [0, 0], [1, 1]], np.float32),
    }


@pytest.fixture(scope="module")
def params():
    """JAX's params and the port's copy of them."""
    jp = JT.init(jax.random.PRNGKey(0), _mcfg(peer_window=3)[1])
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _kw(data, peers, to):
    return dict(other_future_n=to(data["peers"]), other_mask=to(data["pmask"])) if peers else {}


@pytest.fixture(scope="module")
def jax_sharded(data, params):
    """JAX's own sp_decode (ring, with peers) on its 8 CPU devices."""
    cfg, mesh = _mcfg(peer_window=3)[1], jax_sp.make_sp_mesh(8)
    run = jax.jit(lambda p, past, fut, kw: jax_sp.sp_decode(p, cfg, mesh, past, fut, **kw))
    return np.asarray(run(params[0], jnp.asarray(data["past"]), jnp.asarray(data["future"]),
                          _kw(data, True, jnp.asarray)))


@pytest.mark.parametrize("impl", ["ring", "gather"])
@pytest.mark.parametrize("peers", [False, True])
def test_sp_forward_parity(data, params, impl, peers, jax_sharded):
    cfg, jcfg = _mcfg(peer_window=3)
    ref = JT.apply(params[0], jcfg, jnp.asarray(data["past"]), jnp.asarray(data["future"]),
                   **_kw(data, peers, jnp.asarray))
    mesh = sp.make_sp_mesh(8)
    assert mesh.axis_names == ("seq",) and mesh.shape == {"seq": 8}
    out = sp.sp_decode(params[1], cfg, mesh, torch.from_numpy(data["past"]), torch.from_numpy(data["future"]),
                       impl=impl, **_kw(data, peers, torch.from_numpy))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FWD_TOL)
    if peers and impl == "ring":
        np.testing.assert_allclose(out.numpy(), jax_sharded, atol=FWD_TOL)


def test_sp_dp_compose_and_noise(data, params, monkeypatch):
    """('data', 'seq') grid and noisy teacher forcing: the tokens and the
    noise are built on the whole batch, so the same draw gives the same
    predictions."""
    cfg, jcfg = _mcfg(peer_window=3)
    noise = np.random.default_rng(9).normal(size=(B, H_OUT, 3)).astype(np.float32)
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(noise))
    monkeypatch.setattr(transformer, "draw_noise", lambda gen, shape: torch.from_numpy(noise))
    ref = JT.apply(params[0], jcfg, jnp.asarray(data["past"]), jnp.asarray(data["future"]),
                   rng=jax.random.PRNGKey(7), teacher_prob=0.6)
    mesh = sp.make_sp_mesh(4, data_parallel=2)
    assert mesh.axis_names == ("data", "seq") and mesh.devices.shape == (2, 4)
    out = sp.sp_decode(params[1], cfg, mesh, torch.from_numpy(data["past"]), torch.from_numpy(data["future"]),
                       rng=torch.Generator().manual_seed(7), teacher_prob=0.6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FWD_TOL)


def _grads_vs_jax(jp, tp, cfg, jcfg, data, sharded):
    def loss_ref(p):
        pred = JT.apply(p, jcfg, jnp.asarray(data["past"]), jnp.asarray(data["future"]),
                        **_kw(data, True, jnp.asarray))
        return jnp.mean((pred - jnp.asarray(data["future"])) ** 2)

    ga = jax.tree.leaves(jax.jit(jax.grad(loss_ref))(jp))
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tp)]
    pred = sharded(tree_unflatten(tp, leaves), torch.from_numpy(data["past"]), torch.from_numpy(data["future"]),
                   **_kw(data, True, torch.from_numpy))
    gb = torch.autograd.grad(((pred - torch.from_numpy(data["future"])) ** 2).mean(), leaves)
    assert len(ga) == len(gb)
    for a, b in zip(ga, gb):
        scale = max(float(jnp.max(jnp.abs(a))), 1e-6)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=3e-5 * max(scale, 1.0))


def test_sp_grads_match_single_device(data, params):
    """Autograd through the hops and the params' copies: the gradients of the
    one set of leaves equal JAX's single-device gradient."""
    cfg, jcfg = _mcfg(peer_window=3)
    mesh = sp.make_sp_mesh(8)
    _grads_vs_jax(*params, cfg, jcfg, data, lambda p, past, fut, **kw: sp.sp_decode(p, cfg, mesh, past, fut, **kw))


def test_sp_encoder_fallback_nondivisible_past():
    """A past of 6 frames does not divide 4 shards: the encoder runs
    replicated."""
    cfg, jcfg = _mcfg(h_in=6)
    rng = np.random.default_rng(3)
    past = rng.normal(size=(B, 6, 3)).astype(np.float32)
    future = rng.normal(size=(B, H_OUT, 3)).astype(np.float32)
    jp = JT.init(jax.random.PRNGKey(0), jcfg)
    ref = JT.apply(jp, jcfg, jnp.asarray(past), jnp.asarray(future))
    out = sp.sp_decode(params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"), cfg, sp.make_sp_mesh(4),
                       torch.from_numpy(past), torch.from_numpy(future))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FWD_TOL)


def test_sp_horizon_not_divisible_raises(data, params):
    cfg, _ = _mcfg()
    with pytest.raises(ValueError) as ours:
        sp.sp_decode(params[1], cfg, sp.make_sp_mesh(8), torch.from_numpy(data["past"]),
                     torch.from_numpy(data["future"][:, :H_OUT - 4]))  # 12 % 8 != 0
    with pytest.raises(ValueError) as ref:
        jax_sp.sp_decode(params[0], _mcfg()[1], jax_sp.make_sp_mesh(8), jnp.asarray(data["past"]),
                         jnp.asarray(data["future"][:, :H_OUT - 4]))
    assert str(ours.value) == str(ref.value) == "horizon 12 not divisible by seq axis 8"


@pytest.mark.parametrize("args,kw", [((0,), {}), ((-2,), {}), ((16,), {}), ((4,), {"data_parallel": 4}),
                                     ((2,), {"data_parallel": -1})])
def test_make_sp_mesh_validates(args, kw):
    with pytest.raises(ValueError) as ours:
        sp.make_sp_mesh(*args, **kw)
    with pytest.raises(ValueError) as ref:
        jax_sp.make_sp_mesh(*args, **kw)
    assert str(ours.value) == str(ref.value)
    assert ("seq_parallel" if args[0] < 1 or kw.get("data_parallel", 0) < 0 else "need") in str(ours.value)


def test_make_sp_mesh_fills_data_and_takes_explicit_devices():
    assert sp.make_sp_mesh(2).shape == {"data": 4, "seq": 2}
    mesh = sp.make_sp_mesh(2, devices=["cpu", "cpu"])
    assert mesh.axis_names == ("seq",) and list(mesh.devices) == [torch.device("cpu")] * 2


def _trajectory_cfgs():
    cfg, jcfg = _mcfg()
    kw = dict(name="sp-test", batch_size=B, steps=3, lr=1e-3, warmup_steps=0)
    return ExperimentConfig(model=cfg, **kw), JaxExperimentConfig(model=jcfg, **kw)


def test_sp_train_step_trajectory(data):
    """sp_apply_fn in train.make_train_step: 3 steps match JAX's
    single-device steps."""
    cfg, jcfg = _trajectory_cfgs()
    jopt = jax_train.make_optimizer(jcfg)
    jstate = jax_train.init_state(jcfg, JT.init, jopt)
    params = params_from_numpy(jax.tree.map(np.asarray, jstate.params), "cpu")
    opt = train.make_optimizer(cfg)
    state = train.TrainState(params, opt.init(params), 0, torch.Generator())
    batch = {"past": data["past"], "future": data["future"]}
    single = jax_train.make_train_step(jcfg, JT.apply, jopt)
    sharded = train.make_train_step(cfg, sp.sp_apply_fn(sp.make_sp_mesh(8)), opt)
    for _ in range(3):
        jstate, m_a = single(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m_b = sharded(state, batch)
        assert float(m_b["loss"]) == pytest.approx(float(m_a["loss"]), rel=2e-4)
    for a, b in zip(jax.tree.leaves(jstate.params), tree_leaves(state.params), strict=True):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=5e-5)


def test_sp_apply_fn_ar_fallback(data, params):
    """Evaluation (future_n None) runs the unsharded autoregressive decode:
    the port's transformer.apply, to 1e-6 as in JAX's test, which is JAX's
    rollout to the bound of the port's rollout parity (APPLY_TOL of
    tests/test_torch_transformer.py: f32 sums in another order, 16 steps
    fed back)."""
    cfg, jcfg = _mcfg()
    past = torch.from_numpy(data["past"])
    out = sp.sp_apply_fn(sp.make_sp_mesh(8))(params[1], cfg, past)
    np.testing.assert_allclose(out.numpy(), transformer.apply(params[1], cfg, past).numpy(), atol=1e-6)
    ref = JT.apply(params[0], jcfg, jnp.asarray(data["past"]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5)
