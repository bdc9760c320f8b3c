"""The widths and depths the port's training recurrences take on the card,
on the CPU: the port's lstm_seq_states and ss_decode (their plain forward
and backward versions, the contract of the CUDA kernels) against the JAX
package's (its Pallas kernels in interpret mode) at hidden 256 and at 4
layers, forward and gradients; and the blocks of the training forward
(``ops.lstm_train.fwd_block``, csrc/lstm_common.cuh train_fwd_kernel) and
backward (``bwd_block``, ss_bwd_kernel) at those shapes. Same weights, same
numpy inputs; one JAX result a case, shared by a module-scoped fixture.
Tolerances are the existing parity tests': lstm_seq_states forward 2e-5,
gradients 2e-4·scale + 1e-7 (tests/test_torch_lstm_train.py); ss_decode
forward 3e-5, gradients 4e-4·scale + 1e-7 (tests/test_torch_ss_decode.py).
"""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longterm360fov_tpu.models import cell as jax_cell
from longterm360fov_tpu.ops import lstm_ss as jax_ss
from longterm360fov_tpu.ops import lstm_train as jax_lt
from longterm360fov_tpu_torch.models.cell import LSTMParams
from longterm360fov_tpu_torch.ops import lstm_ss, lstm_train

B, T, D = 4, 3, 3
CASES = {"hidden256": (256, 2), "layers4": (32, 4)}  # (hidden, layers)
SS_CTX = 8  # the decoder's static context: one dctx n-tile
BF = torch.bfloat16
SMEM = 232448


def _close(ours, ref, rel, abs_=1e-7, msg=""):
    ref = np.asarray(ref, np.float32)
    scale = max(float(np.abs(ref).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=0, atol=rel * scale + abs_, err_msg=msg)


def _layers(key, d_in0, hidden, layers):
    keys = jax.random.split(key, layers)
    return [jax_cell.init_lstm(keys[l], d_in0 if l == 0 else hidden, hidden) for l in range(layers)]


def _torch(jp):
    return [LSTMParams(torch.tensor(np.asarray(p.w), requires_grad=True),
                       torch.tensor(np.asarray(p.b), requires_grad=True)) for p in jp]


@pytest.fixture(scope="module", params=list(CASES))
def seq_case(request):
    """lstm_seq_states at one of CASES: the inputs, and JAX's outputs and
    gradients of sum(outputs · upstream)."""
    hidden, layers = CASES[request.param]
    rng = np.random.default_rng(hidden + layers)
    jp = _layers(jax.random.PRNGKey(hidden + layers), D, hidden, layers)
    a = {"xs": rng.normal(size=(B, T, D)).astype(np.float32) * 0.3,
         "h0": rng.normal(size=(layers, B, hidden)).astype(np.float32) * 0.3,
         "c0": rng.normal(size=(layers, B, hidden)).astype(np.float32) * 0.3}
    up = [rng.normal(size=s).astype(np.float32) for s in ((B, T, hidden), (layers, B, hidden), (layers, B, hidden))]
    ins = [jnp.asarray(a[k]) for k in ("xs", "h0", "c0")]
    out = jax_lt.lstm_seq_states(jp, *ins, B)

    def f(p, x, h, c):
        return sum(jnp.sum(o * u) for o, u in zip(jax_lt.lstm_seq_states(p, x, h, c, B), up))

    grads = jax.grad(f, argnums=(0, 1, 2, 3))(jp, *ins)
    return dict(jp=jp, a=a, up=up, out=out, grads=grads, layers=layers)


def test_lstm_seq_states_forward_matches_jax_at_the_widths_taken(seq_case):
    ours = lstm_train.lstm_seq_states([LSTMParams(p.w.detach(), p.b.detach()) for p in _torch(seq_case["jp"])],
                                      *(torch.from_numpy(seq_case["a"][k]) for k in ("xs", "h0", "c0")))
    for o, r in zip(ours, seq_case["out"]):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=2e-5)


def test_lstm_seq_states_grads_match_jax_at_the_widths_taken(seq_case):
    tp = _torch(seq_case["jp"])
    ins = [torch.tensor(seq_case["a"][k], requires_grad=True) for k in ("xs", "h0", "c0")]
    out = lstm_train.lstm_seq_states(tp, *ins)
    sum((o * torch.from_numpy(u)).sum() for o, u in zip(out, seq_case["up"])).backward()
    jg = seq_case["grads"]
    for l in range(seq_case["layers"]):
        _close(tp[l].w.grad, jg[0][l].w, 2e-4, msg=f"dW layer {l}")
        _close(tp[l].b.grad, jg[0][l].b, 2e-4, msg=f"db layer {l}")
    for t, g, name in zip(ins, jg[1:], ("dxs", "dh0", "dc0")):
        _close(t.grad, g, 2e-4, msg=name)


@pytest.fixture(scope="module", params=list(CASES))
def ss_case(request):
    """ss_decode at one of CASES with a static context of SS_CTX and
    bernoulli coins: the inputs, and JAX's outputs and gradients of sum(ys ·
    upstream) in the decoder's W and b, proj_w, proj_b, h0, c0, y0, the
    teacher and the context."""
    hidden, layers = CASES[request.param]
    rng = np.random.default_rng(10 + hidden + layers)
    key = jax.random.PRNGKey(10 + hidden + layers)
    jp = _layers(key, D + SS_CTX, hidden, layers)
    a = {"proj_w": rng.normal(size=(hidden, D)).astype(np.float32) * 0.1,
         "proj_b": rng.normal(size=(D,)).astype(np.float32) * 0.1,
         "h0": rng.normal(size=(layers, B, hidden)).astype(np.float32) * 0.3,
         "c0": rng.normal(size=(layers, B, hidden)).astype(np.float32) * 0.3,
         "y0": rng.normal(size=(B, D)).astype(np.float32) * 0.3,
         "teacher": rng.normal(size=(T, B, D)).astype(np.float32) * 0.3,
         "ctx": rng.normal(size=(B, SS_CTX)).astype(np.float32) * 0.5}
    coins = (rng.random((T, B, 1)) < 0.5).astype(np.float32)
    up = rng.normal(size=(B, T, D)).astype(np.float32)
    names = ("proj_w", "proj_b", "h0", "c0", "y0", "teacher", "ctx")

    def f(p, pw, pb, h, c, y, tch, ctx):
        ys = jax_ss.ss_decode(p, pw, pb, h, c, y, tch, (jnp.asarray(coins), ctx), B)
        return jnp.sum(ys * up), ys

    (_, ys), grads = jax.value_and_grad(f, argnums=tuple(range(8)), has_aux=True)(
        jp, *(jnp.asarray(a[k]) for k in names))
    return dict(jp=jp, a=a, names=names, coins=coins, up=up, ys=ys, grads=grads, layers=layers)


def _ss_port(case, requires_grad):
    tp = _torch(case["jp"])
    ins = {k: torch.tensor(case["a"][k], requires_grad=requires_grad) for k in case["names"]}
    ys = lstm_ss.ss_decode(tp, ins["proj_w"], ins["proj_b"], ins["h0"], ins["c0"], ins["y0"], ins["teacher"],
                           (torch.from_numpy(case["coins"]), ins["ctx"]))
    return tp, ins, ys


def test_ss_decode_forward_matches_jax_at_the_widths_taken(ss_case):
    _, _, ys = _ss_port(ss_case, False)
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(ss_case["ys"]), atol=3e-5)


def test_ss_decode_grads_match_jax_at_the_widths_taken(ss_case):
    tp, ins, ys = _ss_port(ss_case, True)
    (ys * torch.from_numpy(ss_case["up"])).sum().backward()
    jg = ss_case["grads"]
    for l in range(ss_case["layers"]):
        _close(tp[l].w.grad, jg[0][l].w, 4e-4, msg=f"dW layer {l}")
        _close(tp[l].b.grad, jg[0][l].b, 4e-4, msg=f"db layer {l}")
    for name, g in zip(ss_case["names"], jg[1:]):
        _close(ins[name].grad, g, 4e-4, msg=name)


# ------------------------------------------------------------ the blocks


@pytest.mark.parametrize("cd", [torch.float32, BF])
@pytest.mark.parametrize("mode,d,ctx_dim", [("tf", 3, 0), ("tf", 131, 0), ("static", 3, 128), ("step", 3, 128)])
@pytest.mark.parametrize("batch", [4096, 8192, 16384, 1, 8127])
def test_fwd_block_fills_the_card_at_the_training_batch(batch, mode, d, ctx_dim, cd):
    """32 rows a block at every batch: at the training batch B = 4096, 128
    blocks, one wave on the card's 132 SMs; the warps take the block's
    32-row tiles (32 x 8 units in f32, x 16 in bf16) in the fewest rounds,
    at most 16."""
    geo = lstm_train.fwd_block(128, 2, d, batch, cd, ctx_dim=ctx_dim, mode=mode)
    assert geo.rp == 32 and geo.smem <= SMEM
    assert -(-batch // geo.rp) >= min(128, batch)
    tiles = 32 * 128 // (256 if cd == torch.float32 else 512)
    assert geo.warps == min(16, tiles)
    assert geo.smem == lstm_train._fwd_smem(32, d, ctx_dim, 128, 2, geo.c_smem, mode, cd == torch.float32)


@pytest.mark.parametrize("cd", [torch.float32, BF])
@pytest.mark.parametrize("mode", ["tf", "static", "step"])
def test_fwd_block_takes_every_shape_the_backward_takes(mode, cd):
    """No path trains forward-only on the card: every (hidden, layers,
    input, context) the backward's block takes, the forward's takes, at the
    training batch."""
    taken = 0
    for hidden in range(32, 257, 32):
        for layers in range(1, 9):
            ds = [3, 8, 9, 3 + hidden // 2, hidden + 8] if mode == "tf" else [1, 3, 8]
            for d in ds:
                for c in ([0] if mode == "tf" else [0, 8, hidden // 2, hidden]):
                    try:
                        if mode == "tf":
                            lstm_train.bwd_block(hidden, layers, d, cd)
                        else:
                            lstm_ss.bwd_block(hidden, layers, d, c, cd, mode == "step")
                    except ValueError:
                        continue
                    geo = lstm_train.fwd_block(hidden, layers, d, 4096, cd, ctx_dim=c, mode=mode)
                    assert geo.smem <= SMEM
                    taken += 1
    assert taken > 200


@pytest.mark.parametrize("args,kw,match", [
    ((288, 1, 3, 64), {}, "hidden a multiple of 32 up to 256, got hidden=288"),
    ((48, 1, 3, 64), {}, "hidden a multiple of 32 up to 256, got hidden=48"),
    ((128, 9, 3, 64), {}, "1..8 layers, got 9"),
    ((128, 1, 9, 64), {"mode": "static"}, "got batch=64, d=9"),
    ((128, 1, 0, 64), {}, "got batch=64, d=0"),
    ((128, 1, 3, 0), {}, "got batch=0, d=3"),
    ((128, 1, 3, 64), {"mode": "static", "ctx_dim": 6}, "ctx_dim % 4 == 0 .*got ctx_dim=6"),
    ((128, 1, 3, 64), {"ctx_dim": 8}, "teacher-forced mode takes none.*got ctx_dim=8"),
    ((128, 1, 3, 64), {"mode": "peer"}, "mode must be one of"),
    ((256, 8, 3, 64), {}, r"layers=8: the training forward's block of 32 rows .* more than 232448"),
])
def test_fwd_block_refuses_what_the_kernel_does_not_take(args, kw, match):
    with pytest.raises(ValueError, match=match):
        lstm_train.fwd_block(*args, **kw)


@pytest.mark.parametrize("cd", [torch.float32, BF])
@pytest.mark.parametrize("hidden,layers,rows,warps,stages", [
    (160, 2, 16, 10, 2), (192, 2, 16, 12, 2), (256, 2, 16, 16, 2),  # two unit blocks a warp
    (128, 8, 16, 16, 2),  # the deepest stack: one m16 tile of rows
    (128, 1, 32, 16, 4),  # seq2seq-tf-30: today's instance
])
def test_bwd_instance_at_the_widths_taken(hidden, layers, rows, warps, stages, cd):
    """The backward instance picked for hidden 160, 192, 256 and for 8
    layers at hidden 128, in both modes of the decoder and the
    teacher-forced one."""
    for step in (False, True):
        geo = lstm_ss.bwd_block(hidden, layers, 3, 128, cd, step)
        assert (geo.rows, geo.warps, geo.stages) == (rows, warps, stages)
    geo = lstm_train.bwd_block(hidden, layers, 3 + 128, cd)
    assert (geo.rows, geo.warps, geo.stages) == (rows, warps, stages)
