"""The port's lstm_seq_states and apply_fused_tf against the JAX package.

The JAX side runs its Pallas kernels in interpret mode on the CPU, as
tests/test_lstm_train.py does; the port's autograd function runs its plain
forward and backward versions (the residual contract of the CUDA kernels) on
CPU tensors. Same weights (params_from_numpy), same numpy inputs.
Tolerances are the JAX suite's own: forward 2e-5, gradients against the
custom VJP 2e-4·scale + 1e-7, apply_fused_tf 3e-5 and 3e-4·scale with f32
residuals and 2e-2·scale with bf16 residuals.

The bf16-compute tier (``compute_dtype=bfloat16``, ``train --train-compute
bfloat16``) is held to the gap it opens: at the presets' width H = 128, each
forward output of the port's plain bf16 version stands within a fifth of
max|JAX bf16 − JAX f32| of JAX's interpret-mode bf16 kernel, each gradient
within a quarter of its own gap (one operand that rounds the other way
after an f32 difference of an ulp moves a dW entry by a bf16 step of that
term), and the port's bf16 differs from its own f32 by at least half the
gap: a version that forgets to round fails both.
"""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longterm360fov_tpu.models import cell as jax_cell
from longterm360fov_tpu.models import seq2seq as jax_seq2seq
from longterm360fov_tpu.ops import lstm_train as jax_lt
from longterm360fov_tpu_torch.models import get_family, seq2seq
from longterm360fov_tpu_torch.models.cell import LSTMParams
from longterm360fov_tpu_torch.ops import lstm_train as lt
from longterm360fov_tpu_torch.params import params_from_numpy, tree_leaves

B, T, D, H = 16, 5, 3, 16
RD = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _case(layers, seed):
    rng = np.random.default_rng(seed)
    keys = jax.random.split(jax.random.PRNGKey(seed), layers)
    jp = [jax_cell.init_lstm(keys[l], D if l == 0 else H, H) for l in range(layers)]
    arrays = {
        "xs": rng.normal(size=(B, T, D)).astype(np.float32) * 0.3,
        "h0": rng.normal(size=(layers, B, H)).astype(np.float32) * 0.3,
        "c0": rng.normal(size=(layers, B, H)).astype(np.float32) * 0.3,
        "up": [rng.normal(size=s).astype(np.float32)
               for s in ((B, T, H), (layers, B, H), (layers, B, H))],
    }
    return jp, arrays


def _torch_params(jp, requires_grad=False):
    return [LSTMParams(torch.tensor(np.asarray(p.w), requires_grad=requires_grad),
                       torch.tensor(np.asarray(p.b), requires_grad=requires_grad)) for p in jp]


def _close(ours, ref, rel, abs_=1e-7, msg=""):
    ref = np.asarray(ref, np.float32)
    scale = max(float(np.abs(ref).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=0, atol=rel * scale + abs_, err_msg=msg)


@pytest.mark.parametrize("rd", ["float32", "bfloat16"])
@pytest.mark.parametrize("layers", [1, 2])
def test_lstm_seq_states_forward_matches_jax(layers, rd):
    jp, a = _case(layers, seed=layers)
    ref = jax_lt.lstm_seq_states(jp, jnp.asarray(a["xs"]), jnp.asarray(a["h0"]),
                                 jnp.asarray(a["c0"]), B, RD[rd][0])
    ours = lt.lstm_seq_states(_torch_params(jp), *(torch.from_numpy(a[k]) for k in ("xs", "h0", "c0")),
                              RD[rd][1])
    for o, r in zip(ours, ref):
        assert o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=2e-5)


@pytest.mark.parametrize("rd", ["float32", "bfloat16"])
@pytest.mark.parametrize("layers", [1, 2])
def test_lstm_seq_states_grads_match_jax_custom_vjp(layers, rd):
    """d(sum of outputs · upstream)/d(params, xs, h0, c0), with upstream
    gradients on hs_top, hT and cT, against jax.grad through the Pallas
    kernels' custom VJP; bf16 residuals at the JAX suite's bf16 bound."""
    jp, a = _case(layers, seed=10 + layers)
    up = a["up"]

    def f(p, x, h, c):
        out = jax_lt.lstm_seq_states(p, x, h, c, B, RD[rd][0])
        return sum(jnp.sum(o * u) for o, u in zip(out, up))

    jg = jax.grad(f, argnums=(0, 1, 2, 3))(jp, *(jnp.asarray(a[k]) for k in ("xs", "h0", "c0")))
    tp = _torch_params(jp, requires_grad=True)
    tx, th, tc = (torch.tensor(a[k], requires_grad=True) for k in ("xs", "h0", "c0"))
    out = lt.lstm_seq_states(tp, tx, th, tc, RD[rd][1])
    sum((o * torch.from_numpy(u)).sum() for o, u in zip(out, up)).backward()
    rel = 2e-4 if rd == "float32" else 2e-2
    for l in range(layers):
        _close(tp[l].w.grad, jg[0][l].w, rel, msg=f"dW layer {l}")
        _close(tp[l].b.grad, jg[0][l].b, rel, msg=f"db layer {l}")
    for t, g, name in ((tx, jg[1], "dxs"), (th, jg[2], "dh0"), (tc, jg[3], "dc0")):
        _close(t.grad, g, rel, msg=name)


@pytest.mark.parametrize("layers", [1, 2, 3])
def test_kernel_backward_matches_autograd_of_the_step_loop(layers):
    """With f32 residuals the autograd function's backward (the kernels'
    plain versions) equals torch autograd through the lstm_cell step loop."""
    jp, a = _case(layers, seed=20 + layers)
    grads = {}
    for name, fn in (("fused", lt.lstm_seq_states), ("loop", lt.lstm_seq_states_reference)):
        tp = _torch_params(jp, requires_grad=True)
        ins = [torch.tensor(a[k], requires_grad=True) for k in ("xs", "h0", "c0")]
        out = fn(tp, *ins)
        sum((o * torch.from_numpy(u)).sum() for o, u in zip(out, a["up"])).backward()
        grads[name] = [t.grad for p in tp for t in p] + [t.grad for t in ins]
    for g, r in zip(grads["fused"], grads["loop"]):
        _close(g, r.numpy(), 2e-5)


def test_backward_split_equals_its_parts():
    """The backward's two kernels, the recurrence and the dW reduction, make
    up the plain backward: dW from the reduction over the recurrence's dgates
    equals the autograd gradient of the forward's own residual computation."""
    jp, a = _case(2, seed=30)
    p = _torch_params(jp)
    xs, h0, c0 = (torch.from_numpy(a[k]) for k in ("xs", "h0", "c0"))
    res = lt.lstm_fwd(p, xs, h0, c0, torch.float32)
    dgates, dxs, dh0, dc0 = lt.lstm_bwd(p, c0, res, *(torch.from_numpy(u) for u in a["up"]))
    dparams = lt.lstm_dw(p, xs, h0, res, dgates)
    assert [tuple(g.shape) for g in dgates] == [(B, T, 4 * H)] * 2
    assert dxs.shape == (B, T, D) and dh0.shape == dc0.shape == (2, B, H)
    tp = _torch_params(jp, requires_grad=True)
    out = lt.lstm_seq_states_reference(tp, xs, h0, c0)
    sum((o * torch.from_numpy(u)).sum() for o, u in zip(out, a["up"])).backward()
    for ours, ref in zip(dparams, tp):
        _close(ours.w, ref.w.grad.numpy(), 2e-5)
        _close(ours.b, ref.b.grad.numpy(), 2e-5)


def test_bf16_residuals_are_rounded_like_jax():
    """hT, cT and hs_top are read back from bf16 residual streams, as the
    JAX kernel returns them: every output is a bf16 value."""
    jp, a = _case(1, seed=40)
    outs = lt.lstm_seq_states(_torch_params(jp), *(torch.from_numpy(a[k]) for k in ("xs", "h0", "c0")),
                              torch.bfloat16)
    for o in outs:
        assert torch.equal(o, o.to(torch.bfloat16).float())


def test_cpu_tensors_launch_no_kernel():
    jp, a = _case(1, seed=0)
    before = (lt.lstm_fwd.launches, lt.lstm_bwd.launches, lt.lstm_dw.launches)
    tp = _torch_params(jp, requires_grad=True)
    out = lt.lstm_seq(tp, torch.from_numpy(a["xs"]))
    out.sum().backward()
    assert (lt.lstm_fwd.launches, lt.lstm_bwd.launches, lt.lstm_dw.launches) == before


def test_unported_options_raise():
    jp, a = _case(1, seed=0)
    args = (_torch_params(jp), *(torch.from_numpy(a[k]) for k in ("xs", "h0", "c0")))
    with pytest.raises(TypeError, match="compute_dtype"):
        lt.lstm_seq_states(*args, torch.float32, torch.float16)
    with pytest.raises(TypeError, match="residual_dtype"):
        lt.lstm_seq_states(*args, torch.float16)
    with pytest.raises(ValueError, match="hidden a multiple of 32 up to 256, got hidden=48"):
        lt.fwd_block(48, 1, 3, 4096)


FWD_FRAC, GRAD_FRAC = 0.2, 0.25  # of the JAX bf16-vs-f32 gap, per output
HB, TB = 128, 8  # the bf16-compute cases: the presets' width, T = 8


def bf16_parity(names, jax_bf, jax_f32, ours_bf, ours_f32, n_fwd):
    """The bf16-compute bound (module docstring) on each named output: the
    first ``n_fwd`` are forward outputs, the rest gradients."""
    for i, name in enumerate(names):
        jb, jf = np.asarray(jax_bf[i], np.float32), np.asarray(jax_f32[i], np.float32)
        ob, of = np.asarray(ours_bf[i], np.float32), np.asarray(ours_f32[i], np.float32)
        gap = float(np.abs(jb - jf).max())
        err = float(np.abs(ob - jb).max())
        frac = FWD_FRAC if i < n_fwd else GRAD_FRAC
        assert err <= frac * gap, f"{name}: |port − JAX| {err:.3g} > {frac} × gap {gap:.3g}"
        assert float(np.abs(ob - of).max()) >= 0.5 * gap, f"{name}: the port's bf16 does not round"


@pytest.mark.parametrize("rd", ["float32", "bfloat16"])
@pytest.mark.parametrize("layers", [1, 2])
def test_lstm_seq_states_bf16_compute_matches_jax(layers, rd):
    """compute_dtype=bfloat16: hs_top, hT, cT and the gradients dW, db, dxs,
    dh0, dc0 (upstream on all three outputs) of the port's plain bf16
    version against jax.grad through JAX's bf16 kernels, at H = 128."""
    rng = np.random.default_rng(50 + layers)
    keys = jax.random.split(jax.random.PRNGKey(50 + layers), layers)
    jp = [jax_cell.init_lstm(keys[l], D if l == 0 else HB, HB) for l in range(layers)]
    ins = [rng.normal(size=s).astype(np.float32) * 0.3
           for s in ((B, TB, D), (layers, B, HB), (layers, B, HB))]
    up = [rng.normal(size=s).astype(np.float32) for s in ((B, TB, HB), (layers, B, HB), (layers, B, HB))]
    jax_out, ours = {}, {}
    for cd in ("float32", "bfloat16"):
        def f(p, x, h, c):
            out = jax_lt.lstm_seq_states(p, x, h, c, B, RD[rd][0], RD[cd][0])
            return sum(jnp.sum(o * u) for o, u in zip(out, up)), out

        (_, jo), jg = jax.value_and_grad(f, argnums=(0, 1, 2, 3), has_aux=True)(
            jp, *map(jnp.asarray, ins))
        jax_out[cd] = list(jo) + [g for q in jg[0] for g in (q.w, q.b)] + list(jg[1:])
        tp = _torch_params(jp, requires_grad=True)
        tin = [torch.tensor(a, requires_grad=True) for a in ins]
        out = lt.lstm_seq_states(tp, *tin, RD[rd][1], RD[cd][1])
        sum((o * torch.from_numpy(u)).sum() for o, u in zip(out, up)).backward()
        ours[cd] = [o.detach() for o in out] + [t.grad for q in tp for t in q] + [t.grad for t in tin]
    names = ["hs_top", "hT", "cT"] + [f"{n}{l}" for l in range(layers) for n in ("dW", "db")]
    bf16_parity(names + ["dxs", "dh0", "dc0"], jax_out["bfloat16"], jax_out["float32"],
                ours["bfloat16"], ours["float32"], 3)


def _seq2seq_case(layers, seed):
    jcfg = jax_seq2seq.Seq2SeqConfig(d=3, hidden=H, layers=layers, h_in=5, h_out=6)
    tcfg = seq2seq.Seq2SeqConfig(**dataclasses.asdict(jcfg))
    jparams = jax_seq2seq.init(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    past = rng.normal(size=(8, 5, 3)).astype(np.float32) * 0.3
    fut = rng.normal(size=(8, 6, 3)).astype(np.float32) * 0.3
    return jcfg, tcfg, jparams, past, fut


@pytest.mark.parametrize("rd", ["float32", "bfloat16"])
@pytest.mark.parametrize("layers", [1, 2])
def test_apply_fused_tf_matches_jax(layers, rd):
    """Values and parameter gradients of the teacher-forced training forward
    against the JAX apply_fused_tf (interpret-mode kernels), which chains
    the encoder's final-state gradients through the decoder's dh0/dc0."""
    jcfg, tcfg, jparams, past, fut = _seq2seq_case(layers, seed=layers)
    jrd, trd = RD[rd]
    jp, jf = jnp.asarray(past), jnp.asarray(fut)

    def jloss(p):
        out = jax_seq2seq.apply_fused_tf(p, jcfg, jp, jf, tile_b=8, residual_dtype=jrd)
        return jnp.mean((out - jf) ** 2), out

    (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    leaves = [t.requires_grad_(True) for t in tree_leaves(tparams)]
    tp, tf = torch.from_numpy(past), torch.from_numpy(fut)
    out = get_family("seq2seq").apply_fused_tf(tparams, tcfg, tp, tf, residual_dtype=trd)
    torch.mean((out - tf) ** 2).backward()
    fwd_tol, grad_rel = (3e-5, 3e-4) if rd == "float32" else (2e-2, 2e-2)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=fwd_tol)
    for t, g in zip(leaves, jax.tree.leaves(jg)):
        _close(t.grad, g, grad_rel)


def test_apply_fused_tf_matches_plain_teacher_forcing():
    """With f32 residuals, apply_fused_tf equals the port's own apply in
    teacher-forcing mode (values and gradients)."""
    _, tcfg, jparams, past, fut = _seq2seq_case(2, seed=7)
    grads = {}
    for name in ("fused", "plain"):
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
        leaves = [t.requires_grad_(True) for t in tree_leaves(tparams)]
        tp, tf = torch.from_numpy(past), torch.from_numpy(fut)
        if name == "fused":
            out = seq2seq.apply_fused_tf(tparams, tcfg, tp, tf, residual_dtype=torch.float32)
        else:
            out = seq2seq.apply(tparams, tcfg, tp, tf)
        torch.mean((out - tf) ** 2).backward()
        grads[name] = (out.detach(), [t.grad for t in leaves])
    np.testing.assert_allclose(grads["fused"][0].numpy(), grads["plain"][0].numpy(), atol=3e-5)
    for a, b in zip(grads["fused"][1], grads["plain"][1]):
        _close(a, b.numpy(), 3e-4)


def test_apply_fused_tf_raises_on_unported_tiers():
    _, tcfg, jparams, past, fut = _seq2seq_case(1, seed=0)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    tp, tf = torch.from_numpy(past), torch.from_numpy(fut)
    # a static (B, C) context is ported; the per-step (B, T, C) context of
    # the cross_user peer_align tier is not
    with pytest.raises(NotImplementedError, match="cross_user"):
        seq2seq.apply_fused_tf(tparams, tcfg, tp, tf, context=torch.zeros(8, tcfg.h_out, 4))
    with pytest.raises(TypeError, match="compute_dtype"):
        seq2seq.apply_fused_tf(tparams, tcfg, tp, tf, compute_dtype=torch.float16)
