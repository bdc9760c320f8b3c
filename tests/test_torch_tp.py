"""Tensor parallelism of the port (``parallel.tp``) on the CPU, every case of
JAX's ``tests/test_tp.py``: JAX's specs leaf for leaf, the column- and
row-parallel seq2seq decode on 4 model entries against JAX's ``decode``, the
gradients on a (4 data, 2 model) grid against ``jax.grad``, and the
``dp x tp`` step of ``seq2seq-tf-30`` (``__graft_entry__.py``) at a small
batch against JAX's single-device step. Weights cross as numpy
(params_from_numpy)."""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longterm360fov_tpu import parallel as jax_parallel
from longterm360fov_tpu import train as jax_train
from longterm360fov_tpu.config import get_preset as jax_get_preset
from longterm360fov_tpu.models import cross_user as jax_cross_user
from longterm360fov_tpu.models import seq2seq as JS
from longterm360fov_tpu.models import transformer as jax_transformer
from longterm360fov_tpu.parallel import tp as jax_tp
from longterm360fov_tpu_torch import parallel, train
from longterm360fov_tpu_torch.config import get_preset
from longterm360fov_tpu_torch.models import seq2seq
from longterm360fov_tpu_torch.models.cell import Shards
from longterm360fov_tpu_torch.params import params_from_numpy, tree_leaves, tree_unflatten
from longterm360fov_tpu_torch.parallel import tp

CPU8 = ["cpu"] * 8


def _setup():
    base = dict(d=3, hidden=32, layers=2, h_in=5, h_out=6)
    cfg, jcfg = seq2seq.Seq2SeqConfig(**base), JS.Seq2SeqConfig(**base)
    jp = JS.init(jax.random.PRNGKey(0), jcfg)
    past = (np.random.default_rng(0).normal(size=(8, 5, 3)).astype(np.float32) * 0.1)
    return cfg, jcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"), past


def _tree(kind):
    """A JAX params tree of each kind the spec rules see."""
    key = jax.random.PRNGKey(1)
    if kind == "transformer":
        return jax_transformer.init(key, JS.Seq2SeqConfig(d=3, hidden=32, layers=2, h_in=8, h_out=8))
    if kind == "cross_user":
        return jax_cross_user.init(key, jax_get_preset("stacked-ss-crossuser").model)
    hidden = {"seq2seq": 32, "seq2seq-h6": 6}[kind]
    return JS.init(key, JS.Seq2SeqConfig(d=3, hidden=hidden, layers=2, h_in=5, h_out=6))


@pytest.mark.parametrize("kind", ["seq2seq", "seq2seq-h6", "cross_user", "transformer"])
@pytest.mark.parametrize("mp", [2, 4])
def test_tp_shardings_match_jax_leaf_for_leaf(kind, mp):
    """Each leaf's spec tuple equals JAX's on the same tree, dropped specs
    (hidden 6: the projection's 6 rows over 4 shards) included."""
    jtree = _tree(kind)
    ref = jax_tp.tp_param_shardings(jtree, jax_parallel.make_mesh(model_parallel=mp))
    ours = tp.tp_param_shardings(params_from_numpy(jax.tree.map(np.asarray, jtree), "cpu"),
                                 parallel.make_mesh("cpu", model_parallel=mp, devices=CPU8))
    got, want = [tuple(s) for s in tree_leaves(ours)], [tuple(s.spec) for s in jax.tree.leaves(ref)]
    assert got == want and len(got) == len(jax.tree.leaves(jtree))


def test_tp_shardings_shapes():
    cfg, _, _, params, _ = _setup()
    sh = tp.tp_param_shardings(params, parallel.make_mesh("cpu", model_parallel=2, devices=CPU8))
    assert tuple(sh["encoder"][0].w) == (None, "model")  # gate weights column-parallel
    assert tuple(sh["proj"]["w"]) == ("model", None)  # projection row-parallel
    placed = tp.apply_tp_shardings(params, parallel.make_mesh("cpu", model_parallel=2, devices=CPU8))
    w = placed.rows[0]["encoder"][0].w
    assert len(placed.rows) == 4 and isinstance(w, Shards) and w.axis == 1
    assert [tuple(p.shape) for p in w.parts] == [(3 + 32, 64)] * 2


def test_tp_decode_matches_unsharded():
    cfg, jcfg, jp, params, past = _setup()
    ref = np.asarray(JS.decode(jp, jcfg, jnp.asarray(past)))
    mesh = parallel.make_mesh("cpu", model_parallel=4, devices=CPU8)  # (2 data, 4 model)
    out = tp.tp_apply(tp.apply_tp_shardings(params, mesh), cfg, torch.from_numpy(past))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_tp_plus_dp_grads_match():
    """(4 data, 2 model): rows over 'data', params over 'model'; the
    gradients of the one set of leaves equal JAX's single-device ones."""
    cfg, jcfg, jp, params, past = _setup()
    fut = np.random.default_rng(1).normal(size=(8, 6, 3)).astype(np.float32) * 0.1

    def loss(p):
        return jnp.mean((JS.apply(p, jcfg, jnp.asarray(past), jnp.asarray(fut)) - jnp.asarray(fut)) ** 2)

    g_ref = jax.tree.leaves(jax.jit(jax.grad(loss))(jp))
    mesh = parallel.make_mesh("cpu", model_parallel=2, devices=CPU8)
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(params)]
    pred = tp.tp_apply_fn(mesh)(tree_unflatten(params, leaves), cfg, torch.from_numpy(past), torch.from_numpy(fut))
    g_tp = torch.autograd.grad(((pred - torch.from_numpy(fut)) ** 2).mean(), leaves)
    assert len(g_ref) == len(g_tp)
    for a, b in zip(g_ref, g_tp):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-5)


def test_dp_x_tp_step_of_the_preset_matches_the_single_device_step():
    """The dp x tp step of seq2seq-tf-30 (a (4, 2) grid, 8 rows) against
    JAX's single-device train step on the same batch."""
    cfg, jcfg = get_preset("seq2seq-tf-30", batch_size=8), jax_get_preset("seq2seq-tf-30", batch_size=8)
    rng = np.random.default_rng(4)
    xyz = rng.normal(size=(8, 60, 3)).astype(np.float32)
    xyz /= np.linalg.norm(xyz, axis=-1, keepdims=True)
    batch = {"past": xyz[:, :30], "future": xyz[:, 30:]}
    jopt = jax_train.make_optimizer(jcfg)
    jstate = jax_train.init_state(jcfg, JS.init, jopt)
    jstate, m_ref = jax_train.make_train_step(jcfg, JS.apply, jopt)(jstate, {k: jnp.asarray(v) for k, v in
                                                                            batch.items()})
    params = params_from_numpy(jax.tree.map(np.asarray, jax_train.init_state(jcfg, JS.init, jopt).params), "cpu")
    opt = train.make_optimizer(cfg)
    state = train.TrainState(params, opt.init(params), 0, torch.Generator())
    mesh = parallel.make_mesh("cpu", model_parallel=2, devices=CPU8)
    state, m = train.make_train_step(cfg, tp.tp_apply_fn(mesh), opt)(state, batch)
    assert np.isfinite(float(m["loss"])) and float(m["loss"]) == pytest.approx(float(m_ref["loss"]), rel=2e-4)
    for a, b in zip(jax.tree.leaves(jstate.params), tree_leaves(state.params), strict=True):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=5e-5)


def test_tp_refuses_a_family_it_does_not_partition():
    jtree = _tree("transformer")
    params = params_from_numpy(jax.tree.map(np.asarray, jtree), "cpu")
    mesh = parallel.make_mesh("cpu", model_parallel=2, devices=CPU8)
    with pytest.raises(ValueError, match="the transformer family is not partitioned"):
        tp.tp_apply(tp.apply_tp_shardings(params, mesh), seq2seq.Seq2SeqConfig(hidden=32, h_in=8, h_out=8),
                    torch.zeros(8, 8, 3))
