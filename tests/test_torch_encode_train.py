"""The differentiable transformer encoder of the port on the CPU:
``ops.transformer_encode_train.fused_encode_train`` (autograd through
``transformer._encode`` on CPU tensors) against the JAX
``fused_encode_train`` (interpret mode) and ``jax.grad`` through the JAX
``_encode``; the three kernel wrappers' plain versions chained (forward
with the stash, reverse, block-order reduction, the partials' layout)
against autograd; what it refuses; and the training hook, whose step equals
plain autograd's.

The CUDA kernels are held against these plain versions on the card
(tests/test_torch_kernel_cuda.py, chip_smoke.py).
"""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longterm360fov_tpu.models import transformer as TR
from longterm360fov_tpu.models.seq2seq import Seq2SeqConfig as JaxConfig
from longterm360fov_tpu.ops.transformer_encode_train import fused_encode_train as jax_fused_encode_train
from longterm360fov_tpu_torch import train
from longterm360fov_tpu_torch.config import get_preset
from longterm360fov_tpu_torch.models import transformer
from longterm360fov_tpu_torch.models.seq2seq import Seq2SeqConfig
from longterm360fov_tpu_torch.ops import transformer_encode_train as et
from longterm360fov_tpu_torch.params import params_from_numpy, tree_leaves

FWD_TOL = 3e-5  # tests/test_transformer_encode.py:116
GRAD_TOL = 2e-4  # · max(|g|, 1), tests/test_transformer_encode.py:130


def _setup(layers, h_in, b, seed):
    """Both frameworks' encoders at hidden 128 (LN scales and biases moved
    off 1 and 0 so that their gradients count), pasts and a cotangent."""
    base = dict(d=3, hidden=128, layers=layers, h_in=h_in, h_out=4)
    jcfg, tcfg = JaxConfig(**base), Seq2SeqConfig(**base)
    rng = np.random.default_rng(seed)
    jp = jax.tree.map(np.asarray, TR.init(jax.random.PRNGKey(seed), jcfg))
    for layer in jp["enc"]:
        for sub in ("ln1", "ln2"):
            for leaf in ("scale", "bias"):
                layer[sub][leaf] = layer[sub][leaf] + rng.normal(size=128).astype(np.float32) * 0.1
    past = rng.normal(size=(b, h_in, 3)).astype(np.float32) * 0.3
    cot = rng.normal(size=(b, h_in, 128)).astype(np.float32)
    return jcfg, tcfg, jp, params_from_numpy(jp, "cpu"), past, cot


def _port_grads(fn, tp, tcfg, past, cot):
    """The output and the gradients of Σ fn(params, past) · cot with respect
    to past and every encoder leaf (in_proj first)."""
    x = torch.from_numpy(past).requires_grad_(True)
    leaves = [tp["in_proj"]] + [layer[sub][leaf] for layer in tp["enc"] for sub, leaf in et._ENC_LEAVES]
    for t in leaves:
        t.requires_grad_(True)
    out = fn(tp, tcfg, x)
    return out.detach(), torch.autograd.grad((out * torch.from_numpy(cot)).sum(), [x, *leaves])


def _jax_grads(fn, jp, jcfg, past, cot):
    enc = {"in_proj": jp["in_proj"], "enc": jp["enc"]}

    def loss(e, x):
        return jnp.sum(fn({**jp, **e}, jcfg, x) * cot)

    g_e, g_x = jax.grad(loss, argnums=(0, 1))(enc, jnp.asarray(past))
    flat = [g_e["in_proj"]] + [g_e["enc"][l][sub][leaf] for l in range(len(jp["enc"]))
                               for sub, leaf in et._ENC_LEAVES]
    return fn(jp, jcfg, jnp.asarray(past)), [g_x, *flat]


def _assert_grads(got, want):
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=GRAD_TOL * max(np.abs(b).max(), 1.0))


def test_fused_encode_train_matches_the_jax_kernel():
    """L = 1, h_in 4, B = 8: the port's function (autograd through _encode
    on the CPU) against the JAX kernels' forward and custom VJP in
    interpret mode."""
    jcfg, tcfg, jp, tp, past, cot = _setup(1, 4, 8, seed=11)
    want_out, want = _jax_grads(jax_fused_encode_train, jp, jcfg, past, cot)
    out, got = _port_grads(et.fused_encode_train, tp, tcfg, past, cot)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=0, atol=FWD_TOL)
    _assert_grads(got, want)


def test_fused_encode_train_matches_jax_grad_of_encode():
    """L = 2, h_in 6, B = 16 against jax.grad through the JAX _encode."""
    jcfg, tcfg, jp, tp, past, cot = _setup(2, 6, 16, seed=12)
    want_out, want = _jax_grads(TR._encode, jp, jcfg, past, cot)
    out, got = _port_grads(et.fused_encode_train, tp, tcfg, past, cot)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=0, atol=FWD_TOL)
    _assert_grads(got, want)


@pytest.mark.parametrize("layers,h_in,b", [(1, 4, 8), (2, 13, 5)])
def test_kernel_wrappers_plain_chain_matches_autograd(layers, h_in, b):
    """The three wrappers' plain versions as the autograd function chains
    them on the card: the forward with its stash (x0, x1, q, k, v, att a
    layer), the reverse into the partials' layout, the block-order
    reduction and split_grads, against autograd through _encode."""
    jcfg, tcfg, jp, tp, past, cot = _setup(layers, h_in, b, seed=13)
    leaves = [layer[sub][leaf] for layer in tp["enc"] for sub, leaf in et._ENC_LEAVES]
    x = torch.from_numpy(past)
    enc, stash = et.encode_train_fwd(tcfg, x, tp["in_proj"], leaves)
    assert stash.shape == (layers, et.N_STASH, b * h_in, 128)
    np.testing.assert_allclose(enc.numpy(), transformer._encode(tp, tcfg, x).numpy(), rtol=0, atol=FWD_TOL)
    # the first layer's stashed input is the embedding
    np.testing.assert_allclose(stash[0, 0].numpy(), (x @ tp["in_proj"] + transformer._pos_enc(h_in, 128))
                               .reshape(-1, 128).numpy(), rtol=0, atol=1e-6)
    d_x, parts = et.encode_train_bwd(tcfg, x, tp["in_proj"], leaves, stash, torch.from_numpy(cot), True)
    assert parts.shape == (1, et.partial_floats(layers, 3))
    g_in, g_leaves = et.split_grads(et.encode_train_dw(parts), layers, 3)
    _, want = _port_grads(transformer._encode, tp, tcfg, past, cot)
    _assert_grads([d_x, g_in, *g_leaves], want)


def test_block_order_reduction_is_the_row_sum():
    parts = torch.from_numpy(np.random.default_rng(0).normal(size=(5, 8)).astype(np.float32))
    np.testing.assert_allclose(et.encode_train_dw(parts).numpy(), parts.numpy().sum(0), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="multiple of 4"):
        et.encode_train_dw(parts[:, :6])


def test_fused_encode_train_refuses_what_the_kernels_do_not_take():
    """The kernels' limits raise on the CPU as on the card: T > 64, bf16, a
    non-f32 tree, a width other than 128."""
    _, tcfg, _, tp, past, _ = _setup(1, 4, 2, seed=1)
    with pytest.raises(ValueError, match="T <= 64"):
        et.fused_encode_train(tp, tcfg, torch.zeros(2, 65, 3))
    with pytest.raises(NotImplementedError, match="slice I"):
        et.fused_encode_train(tp, tcfg, torch.from_numpy(past), compute_dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        et.fused_encode_train(tp, tcfg, torch.from_numpy(past).double())
    tp["enc"][0]["mlp"]["w1"] = tp["enc"][0]["mlp"]["w1"].double()
    with pytest.raises(TypeError, match="float32"):
        et.fused_encode_train(tp, tcfg, torch.from_numpy(past))
    narrow = Seq2SeqConfig(d=3, hidden=32, layers=1, h_in=4, h_out=4)
    with pytest.raises(ValueError, match="hidden = 128"):
        et.fused_encode_train(transformer.init(torch.Generator().manual_seed(0), narrow, device="cpu"), narrow,
                              torch.from_numpy(past))


@pytest.mark.parametrize("preset", ["transformer-30", "transformer-10s"])
def test_fused_train_step_equals_plain_on_cpu(preset):
    """A train step with train_impl "fused" (the family's hook: the encoder
    on fused_encode_train where T <= 64, _encode at transformer-10s's
    T = 100) gives the gradients of "xla" (autograd through apply), with the
    same noisy-teacher-forcing generator; transformer-10s's horizon cut to
    12 frames (window 8 kept), B = 8."""
    cut = {"model_h_out": 12} if preset == "transformer-10s" else {}
    cfg = get_preset(preset, batch_size=8, train_impl="fused", **cut)
    m = cfg.model
    params = transformer.init(torch.Generator().manual_seed(0), m, device="cpu")
    rng = np.random.default_rng(0)

    def unit(shape):
        v = rng.normal(size=(*shape, 3)).astype(np.float32)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    batch = {"past": unit((8, m.h_in)), "future": unit((8, m.h_out)), "other_future": unit((8, 4, m.h_out)),
             "other_mask": (rng.random((8, 4)) < 0.7).astype(np.float32)}
    out = {}
    for impl in ("fused", "xla"):
        grad_fn = train.make_grad_fn(cfg.replace(train_impl=impl), transformer.apply,
                                     extras_fn=transformer.batch_extras, fused_tf_fn=transformer.apply_fused_tf,
                                     fused_ss_fn=transformer.apply_fused_ss)
        out[impl] = grad_fn(params, batch, torch.Generator().manual_seed(5), 0.6)
    (l_f, _), g_f = out["fused"]
    (l_x, _), g_x = out["xla"]
    assert l_f.item() == pytest.approx(l_x.item(), rel=1e-6)
    for a, b in zip(tree_leaves(g_f), tree_leaves(g_x)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6 * max(b.abs().max().item(), 1.0))
