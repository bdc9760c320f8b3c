"""Pipeline parallelism of the port (``parallel.pp``) on the CPU, every case
of JAX's ``tests/test_pp.py``: the GPipe-pipelined transformer pass on a
grid of CPU entries (JAX's 8 virtual devices) against JAX's single-device
``transformer.apply`` (forward at three stage x microbatch shapes with and
without peers, noisy teacher, gradients, a 3-step trajectory) and against
JAX's ``pp_decode`` on its 8 CPU devices, at JAX's tolerances. Weights cross
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
from longterm360fov_tpu.parallel import pp as jax_pp
from longterm360fov_tpu_torch import train
from longterm360fov_tpu_torch.config import ExperimentConfig
from longterm360fov_tpu_torch.models import transformer
from longterm360fov_tpu_torch.models.seq2seq import Seq2SeqConfig
from longterm360fov_tpu_torch.params import params_from_numpy, tree_leaves, tree_unflatten
from longterm360fov_tpu_torch.parallel import grid, pp

H_OUT = 12
B = 8
FWD_TOL = 2e-5


def _mcfg(**kw):
    base = dict(d=3, hidden=32, layers=4, h_in=8, h_out=H_OUT)
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
        "pmask": rng.integers(0, 2, size=(B, 2)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def params():
    """JAX's params and the port's copy of them."""
    jp = JT.init(jax.random.PRNGKey(0), _mcfg(peer_window=3)[1])
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _kw(data, peers, to):
    return dict(other_future_n=to(data["peers"]), other_mask=to(data["pmask"])) if peers else {}


@pytest.fixture(scope="module")
def jax_pipelined(data, params):
    """JAX's own pp_decode (4 stages, 8 microbatches, with peers) on its 8 CPU
    devices."""
    cfg, mesh = _mcfg(peer_window=3)[1], jax_pp.make_pp_mesh(4)
    run = jax.jit(lambda p, past, fut, kw: jax_pp.pp_decode(p, cfg, mesh, past, fut, n_microbatches=8, **kw))
    return np.asarray(run(params[0], jnp.asarray(data["past"]), jnp.asarray(data["future"]),
                          _kw(data, True, jnp.asarray)))


@pytest.mark.parametrize("stages,micro", [(2, 2), (2, 4), (4, 8)])
@pytest.mark.parametrize("peers", [False, True])
def test_pp_forward_parity(data, params, stages, micro, peers, jax_pipelined):
    cfg, jcfg = _mcfg(peer_window=3)
    ref = JT.apply(params[0], jcfg, jnp.asarray(data["past"]), jnp.asarray(data["future"]),
                   **_kw(data, peers, jnp.asarray))
    mesh = pp.make_pp_mesh(stages)
    assert mesh.axis_names == ("stage",) and mesh.shape == {"stage": stages}
    out = pp.pp_decode(params[1], cfg, mesh, torch.from_numpy(data["past"]), torch.from_numpy(data["future"]),
                       n_microbatches=micro, **_kw(data, peers, torch.from_numpy))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FWD_TOL)
    if peers and stages == 4:
        np.testing.assert_allclose(out.numpy(), jax_pipelined, atol=FWD_TOL)


def test_pp_noise_parity(data, params, monkeypatch):
    cfg, jcfg = _mcfg(peer_window=3)
    noise = np.random.default_rng(5).normal(size=(B, H_OUT, 3)).astype(np.float32)
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(noise))
    monkeypatch.setattr(transformer, "draw_noise", lambda gen, shape: torch.from_numpy(noise))
    ref = JT.apply(params[0], jcfg, jnp.asarray(data["past"]), jnp.asarray(data["future"]),
                   rng=jax.random.PRNGKey(5), teacher_prob=0.7)
    out = pp.pp_decode(params[1], cfg, pp.make_pp_mesh(2), torch.from_numpy(data["past"]),
                       torch.from_numpy(data["future"]), rng=torch.Generator().manual_seed(5), teacher_prob=0.7)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FWD_TOL)


def test_pp_grads_match_single_device(data, params):
    """The backward pipeline is autograd through the hops and the stages'
    copies: the gradients of the one set of leaves equal JAX's
    single-device gradient."""
    cfg, jcfg = _mcfg(peer_window=3)
    jp, tp = params
    past, fut = data["past"], data["future"]

    def loss_ref(p):
        pred = JT.apply(p, jcfg, jnp.asarray(past), jnp.asarray(fut), **_kw(data, True, jnp.asarray))
        return jnp.mean((pred - jnp.asarray(fut)) ** 2)

    ga = jax.tree.leaves(jax.jit(jax.grad(loss_ref))(jp))
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tp)]
    pred = pp.pp_decode(tree_unflatten(tp, leaves), cfg, pp.make_pp_mesh(4), torch.from_numpy(past),
                        torch.from_numpy(fut), **_kw(data, True, torch.from_numpy))
    gb = torch.autograd.grad(((pred - torch.from_numpy(fut)) ** 2).mean(), leaves)
    assert len(ga) == len(gb)
    for a, b in zip(ga, gb):
        scale = max(float(jnp.max(jnp.abs(a))), 1e-6)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=3e-5 * max(scale, 1.0))


def _same_error(ours, theirs):
    with pytest.raises(ValueError) as a:
        ours()
    with pytest.raises(ValueError) as b:
        theirs()
    assert str(a.value) == str(b.value)
    return str(a.value)


def test_pp_validation(data, params):
    cfg, jcfg = _mcfg()
    assert "n_stages" in _same_error(lambda: pp.make_pp_mesh(1), lambda: jax_pp.make_pp_mesh(1))
    assert "need" in _same_error(lambda: pp.make_pp_mesh(16), lambda: jax_pp.make_pp_mesh(16))
    tpast, tfut = torch.from_numpy(data["past"]), torch.from_numpy(data["future"])
    jpast, jfut = jnp.asarray(data["past"]), jnp.asarray(data["future"])
    msg = _same_error(lambda: pp.pp_decode(params[1], cfg, pp.make_pp_mesh(3), tpast, tfut),
                      lambda: jax_pp.pp_decode(params[0], jcfg, jax_pp.make_pp_mesh(3), jpast, jfut))
    assert msg == "4 decoder layers not divisible by 3 stages"
    msg = _same_error(lambda: pp.pp_decode(params[1], cfg, pp.make_pp_mesh(2), tpast, tfut, n_microbatches=3),
                      lambda: jax_pp.pp_decode(params[0], jcfg, jax_pp.make_pp_mesh(2), jpast, jfut,
                                               n_microbatches=3))
    assert msg == "batch 8 not divisible by 3 microbatches"


def test_pp_apply_fn_ar_fallback(data, params):
    """Evaluation (future_n None) runs the unsharded autoregressive decode."""
    cfg, _ = _mcfg(peer_window=3)
    past = torch.from_numpy(data["past"])
    out = pp.pp_apply_fn(pp.make_pp_mesh(2))(params[1], cfg, past)
    assert torch.equal(out, transformer.apply(params[1], cfg, past))


def test_pp_train_step_trajectory(data):
    """pp_apply_fn in train.make_train_step: 3 steps match JAX's
    single-device steps."""
    mcfg, jmcfg = _mcfg()
    kw = dict(name="pp-test", batch_size=B, steps=3, lr=1e-3, warmup_steps=0)
    cfg, jcfg = ExperimentConfig(model=mcfg, **kw), JaxExperimentConfig(model=jmcfg, **kw)
    jopt = jax_train.make_optimizer(jcfg)
    jstate = jax_train.init_state(jcfg, JT.init, jopt)
    params = params_from_numpy(jax.tree.map(np.asarray, jstate.params), "cpu")
    opt = train.make_optimizer(cfg)
    state = train.TrainState(params, opt.init(params), 0, torch.Generator())
    batch = {"past": data["past"], "future": data["future"]}
    single = jax_train.make_train_step(jcfg, JT.apply, jopt)
    piped = train.make_train_step(cfg, pp.pp_apply_fn(pp.make_pp_mesh(4)), opt)
    for _ in range(3):
        jstate, m_a = single(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m_b = piped(state, batch)
        assert float(m_b["loss"]) == pytest.approx(float(m_a["loss"]), rel=2e-4)
    for a, b in zip(jax.tree.leaves(jstate.params), tree_leaves(state.params), strict=True):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=5e-5)
