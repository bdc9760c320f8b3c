"""The port's seq2seq model against the JAX seq2seq, with the JAX weights
carried across by params_from_numpy, and against the numpy oracle."""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longterm360fov_tpu.models import cell as jax_cell
from longterm360fov_tpu.models import seq2seq as jax_seq2seq
from longterm360fov_tpu_torch import infer, oracle
from longterm360fov_tpu_torch.config import get_preset
from longterm360fov_tpu_torch.models import cell, get_family, seq2seq
from longterm360fov_tpu_torch.params import params_from_numpy

ATOL = 2e-5


def _setup(seed=0, **kw):
    jcfg = jax_seq2seq.Seq2SeqConfig(**{"d": 3, "hidden": 16, "h_in": 5, "h_out": 4, **kw})
    tcfg = seq2seq.Seq2SeqConfig(**dataclasses.asdict(jcfg))
    jparams = jax_seq2seq.init(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _windows(cfg, batch, seed):
    rng = np.random.default_rng(seed)
    past = rng.normal(size=(batch, cfg.h_in, cfg.d)).astype(np.float32) * 0.1
    fut = rng.normal(size=(batch, cfg.h_out, cfg.d)).astype(np.float32) * 0.1
    return past, fut


def test_lstm_cell_matches_jax():
    rng = np.random.default_rng(0)
    p = jax.tree.map(np.asarray, jax_cell.init_lstm(jax.random.PRNGKey(1), 3, 16))
    x, h, c = (rng.normal(size=(6, n)).astype(np.float32) for n in (3, 16, 16))
    ref = jax_cell.lstm_cell(p, jnp.asarray(x), (jnp.asarray(h), jnp.asarray(c)))
    ours = cell.lstm_cell(
        cell.LSTMParams(torch.tensor(p.w), torch.tensor(p.b)),
        torch.from_numpy(x), (torch.from_numpy(h), torch.from_numpy(c)),
    )
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-6)


@pytest.mark.parametrize("mode", ["ar", "teacher", "coins"])
@pytest.mark.parametrize("layers", [1, 2])
def test_apply_matches_jax(mode, layers):
    jcfg, tcfg, jparams, tparams = _setup(layers=layers)
    past, fut = _windows(jcfg, 7, seed=layers)
    coins = (np.random.default_rng(9).random((jcfg.h_out, 7, 1)) < 0.5).astype(np.float32)
    jkw, tkw = {}, {}
    if mode != "ar":
        jkw["future_n"], tkw["future_n"] = jnp.asarray(fut), torch.from_numpy(fut)
    if mode == "coins":
        jkw["coins"], tkw["coins"] = jnp.asarray(coins), torch.from_numpy(coins)
    ref = jax_seq2seq.apply(jparams, jcfg, jnp.asarray(past), **jkw)
    ours = seq2seq.apply(tparams, tcfg, torch.from_numpy(past), **tkw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("per_step", [False, True])
def test_apply_with_context_matches_jax(per_step):
    jcfg, tcfg, jparams, tparams = _setup(ctx_dim=4)
    past, _ = _windows(jcfg, 5, seed=3)
    shape = (5, jcfg.h_out, 4) if per_step else (5, 4)
    ctx = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    ref = jax_seq2seq.decode(jparams, jcfg, jnp.asarray(past), context=jnp.asarray(ctx))
    ours = seq2seq.decode(tparams, tcfg, torch.from_numpy(past), context=torch.from_numpy(ctx))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL)


def test_rng_scheduled_sampling_is_not_ported():
    """The rng mode is ported as a torch draw (jax.random's bits cannot be
    reproduced): it equals the explicit-coins mode with the coins that
    draw_coins takes from a generator of the same seed, and a JAX key is
    refused."""
    _, tcfg, _, tparams = _setup()
    past, fut = _windows(tcfg, 2, seed=0)
    x, f = torch.from_numpy(past), torch.from_numpy(fut)
    out = seq2seq.apply(tparams, tcfg, x, f, rng=torch.Generator().manual_seed(3), teacher_prob=0.5)
    coins = seq2seq.draw_coins(torch.Generator().manual_seed(3), 0.5, tcfg.h_out, 2)
    assert coins.shape == (tcfg.h_out, 2, 1) and set(coins.unique().tolist()) <= {0.0, 1.0}
    assert torch.equal(out, seq2seq.apply(tparams, tcfg, x, f, coins=coins))
    with pytest.raises(TypeError, match="torch.Generator"):
        seq2seq.apply(tparams, tcfg, x, f, rng=np.zeros(2, np.uint32), teacher_prob=0.5)


def test_full_width_decode_matches_jax_xla():
    """seq2seq-tf-30 at its full width (hidden 128, 30 + 30 steps), B=8,
    against JAX's XLA scan decode."""
    cfg = get_preset("seq2seq-tf-30").model
    jcfg = jax_seq2seq.Seq2SeqConfig(**dataclasses.asdict(cfg))
    jparams = jax_seq2seq.init(jax.random.PRNGKey(5), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    past, _ = _windows(cfg, 8, seed=5)
    ref = jax.jit(lambda p, x: jax_seq2seq.decode(p, jcfg, x))(jparams, jnp.asarray(past))
    x = torch.from_numpy(past)
    for ours in (seq2seq.decode(tparams, cfg, x), seq2seq.serve_fused(tparams, cfg, x)):
        assert ours.shape == (8, 30, 3)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("impl", ["fused", "plain"])
def test_predict_matches_numpy_oracle(impl):
    cfg = get_preset("seq2seq-tf-30").replace(
        model=seq2seq.Seq2SeqConfig(d=3, hidden=32, layers=2, h_in=6, h_out=5)
    )
    params_np = oracle.init_params_np(11, cfg.model)
    rng = np.random.default_rng(11)
    past = rng.normal(size=(9, 6, 3)).astype(np.float32)
    past /= np.linalg.norm(past, axis=-1, keepdims=True)
    serve = infer.make_predict_fn(
        params_from_numpy(params_np, "cpu"), cfg, device="cpu", impl=impl
    )
    np.testing.assert_allclose(
        serve(past).numpy(), oracle.oracle_predict(params_np, cfg.model, past),
        atol=ATOL,
    )


def test_init_layout_and_device():
    cfg = seq2seq.Seq2SeqConfig(hidden=16, layers=2, ctx_dim=4)
    p = seq2seq.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert [tuple(q.w.shape) for q in p["encoder"]] == [(19, 64), (32, 64)]
    assert [tuple(q.w.shape) for q in p["decoder"]] == [(23, 64), (32, 64)]
    assert tuple(p["proj"]["w"].shape) == (16, 3)
    b = p["encoder"][0].b
    assert torch.equal(b[16:32], torch.ones(16)) and not b[:16].any()
    limit = np.sqrt(6.0 / (19 + 64))
    assert p["encoder"][0].w.abs().max() <= limit
    again = seq2seq.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert torch.equal(again["decoder"][1].w, p["decoder"][1].w)


def test_get_family():
    from longterm360fov_tpu_torch.models import cross_user, fusion, transformer

    assert get_family("seq2seq") is seq2seq
    assert get_family("cross_user") is cross_user
    assert get_family("fusion") is fusion
    assert get_family("transformer") is transformer
    with pytest.raises(KeyError):
        get_family("nope")
