"""Training runtime: the train step and the loop around it.

PyTorch twin of ``longterm360fov_tpu.train``. The step normalizes the batch,
runs the model forward, takes the loss and its gradient, and applies the
optimizer: optax's ``clip_by_global_norm`` then ``adam`` with an optional
warmup-cosine schedule, written out here with optax's formulas and
defaults. The step runs where the params are; batches are moved there.

``cfg.train_impl`` keeps the JAX values (they are part of
``ExperimentConfig.hash``): ``"xla"`` is plain PyTorch autograd through the
family's ``apply``; ``"auto"`` and ``"fused"`` run ``fused_tf_fn`` (the
family's ``apply_fused_tf``) or, with ``scheduled_sampling``,
``fused_ss_fn`` (its ``apply_fused_ss``), whose kernels run where their
tensors are: CUDA kernels on the card, their plain versions on the CPU.
Nothing is routed on ``torch.cuda.is_available()``.

Scheduled sampling draws the coins of step i (the transformer family: its
noisy-teacher-forcing noise) on the params' device from a generator seeded
from ``(cfg.seed, i)`` (:func:`step_generator`), as :func:`batch_iterator`
seeds its epochs, so a resumed run draws the same coins with no saved
generator state. The transformer's hooks run ``apply``'s parallel pass
with the encoder on ``ops.transformer_encode_train`` (its kernels on the
card) where the window fits it (T <= 64); JAX keeps that kernel off its
step (``FUSED_TRAIN_ENCODER = False``), so under "xla" and in JAX the step
is autograd through ``apply``.

Data parallelism (``parallel.train_loop_dp``) runs this step and this loop
with a ``mesh`` (``parallel.mesh.DataMesh``): each rank takes the gradient of
its rows of the global batch, and one ``all_reduce`` averages the gradients,
the loss and the great-circle metric before the optimizer runs, as JAX's
``pmean`` over ``'data'``; ``cfg.data_parallel`` itself changes nothing here,
as in JAX.

A ``--bf16`` model (``model.param_dtype`` "bfloat16") trains as JAX's
does: the optimizer follows optax's dtype rules leaf by leaf
(:func:`make_optimizer`), and on the fused route the LSTM cells' W and b,
which the kernels train, get f32 gradients, the dtype of JAX's custom VJPs
(:func:`make_grad_fn`); every other leaf's gradient is in its own dtype.
"""

from __future__ import annotations

import contextlib
import json
import math
import time
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import losses, windows
from .config import ExperimentConfig
from .params import params_device, tree_leaves, tree_unflatten, walk

__all__ = [
    "TrainState",
    "AdamState",
    "Optimizer",
    "learning_rate",
    "make_optimizer",
    "teacher_prob_at",
    "default_extras",
    "step_generator",
    "make_grad_fn",
    "make_train_step",
    "init_state",
    "batch_iterator",
    "eval_impl",
    "train_loop",
]

TRAIN_IMPLS = ("auto", "xla", "fused")
_B1, _B2, _EPS = 0.9, 0.999, 1e-8  # optax.adam defaults (eps_root = 0)
# the subtrees of the seq2seq families' LSTM cells, whose W and b the fused
# route trains on the kernels
_CELLS = ("encoder", "decoder", "peer_encoder")


class AdamState(NamedTuple):
    count: int  # updates applied so far
    mu: List[torch.Tensor]  # first moments, in tree_leaves order
    nu: List[torch.Tensor]  # second moments


class TrainState(NamedTuple):
    params: Any
    opt_state: AdamState
    step: int
    rng: torch.Generator  # CPU generator: drew the initial params


class Optimizer(NamedTuple):
    init: Callable  # params -> AdamState
    update: Callable  # (grads, AdamState) -> (updates, AdamState)


def learning_rate(cfg: ExperimentConfig, count: int) -> float:
    """Learning rate of update ``count`` (0-based): ``cfg.lr``, or with
    ``warmup_steps`` > 0 optax's ``warmup_cosine_decay_schedule`` as the
    JAX ``make_optimizer`` builds it: linear from lr/100 to lr over the
    warmup, then cosine decay to lr/10 at step ``max(steps, warmup + 1)``.
    Evaluated in float32 with optax's operations, as optax evaluates it."""
    if cfg.warmup_steps <= 0:
        return cfg.lr
    f32 = np.float32
    init, peak, end = cfg.lr / 100.0, cfg.lr, cfg.lr / 10.0
    warmup = cfg.warmup_steps
    if count < warmup:  # optax.linear_schedule
        frac = f32(1) - f32(min(max(count, 0), warmup)) / f32(warmup)
        return float(f32(init - peak) * frac + f32(peak))
    decay_steps = max(cfg.steps, warmup + 1) - warmup  # optax.cosine_decay_schedule
    alpha = end / peak
    t = f32(min(count - warmup, decay_steps))
    cosine = f32(0.5) * (f32(1) + f32(math.cos(f32(math.pi) * t / f32(decay_steps))))
    return float(f32(peak) * (f32(1 - alpha) * cosine + f32(alpha)))


def _weak(x: float, t: torch.Tensor) -> float:
    """The Python scalar ``x`` as JAX applies it to an array like ``t``: a
    weakly typed scalar takes the array's dtype, so it is rounded to it
    (torch computes a bf16 op with the scalar in f32 instead)."""
    return x if t.dtype == torch.float32 else float(torch.tensor(x, dtype=t.dtype))


def make_optimizer(cfg: ExperimentConfig) -> Optimizer:
    """``clip_by_global_norm(cfg.grad_clip)`` then ``adam`` at
    :func:`learning_rate`, with optax's formulas: the clip scales by
    ``max_norm / ‖g‖`` only when ``‖g‖ >= max_norm``, with no epsilon
    (``torch.nn.utils.clip_grad_norm_`` adds 1e-6).

    And with optax's dtypes, leaf by leaf: the moments start in the param's
    dtype and each update promotes them by the gradient's (a bf16 moment of
    an f32 gradient becomes f32); each leaf's squared sum for the norm is
    taken in its own dtype and the leaves' sums promote as they add; the
    bias corrections, learning rate and other constants are rounded to the
    dtype of the array they scale. The update is in the moments' dtype;
    :func:`make_train_step` adds it to the param and rounds the sum to the
    param's dtype, as ``optax.apply_updates``."""

    def init(params) -> AdamState:
        leaves = tree_leaves(params)
        return AdamState(
            0, [torch.zeros_like(p) for p in leaves], [torch.zeros_like(p) for p in leaves]
        )

    @torch.no_grad()
    def update(grads, state: AdamState):
        g = tree_leaves(grads)
        g_norm = torch.sqrt(sum(torch.sum(x * x) for x in g))
        keep = g_norm < cfg.grad_clip
        g = [torch.where(keep, x, (x / g_norm.to(x.dtype)) * _weak(cfg.grad_clip, x)) for x in g]
        mu = [_weak(1 - _B1, x) * x + _weak(_B1, m) * m for x, m in zip(g, state.mu)]
        nu = [_weak(1 - _B2, x) * (x * x) + _weak(_B2, v) * v for x, v in zip(g, state.nu)]
        count = state.count + 1
        one = torch.tensor(1.0, dtype=torch.float32)
        bc1 = (one - torch.tensor(_B1, dtype=torch.float32) ** count).item()
        bc2 = (one - torch.tensor(_B2, dtype=torch.float32) ** count).item()
        step_size = -learning_rate(cfg, state.count)
        updates = [
            _weak(step_size, m) * ((m / _weak(bc1, m)) / (torch.sqrt(v / _weak(bc2, v)) + _weak(_EPS, v)))
            for m, v in zip(mu, nu)
        ]
        return tree_unflatten(grads, updates), AdamState(count, mu, nu)

    return Optimizer(init, update)


def teacher_prob_at(cfg: ExperimentConfig, step: int) -> float:
    """Linear anneal ss_start → ss_end over the run; 1 without scheduled
    sampling."""
    if not cfg.scheduled_sampling:
        return 1.0
    frac = min(max(step / max(cfg.steps, 1), 0.0), 1.0)
    return cfg.ss_start + (cfg.ss_end - cfg.ss_start) * frac


def default_extras(batch: Dict, anchor) -> Dict:
    """Model-family batch hook: extra ``apply`` keyword arguments from the
    raw batch and the normalization anchor. Families override it with their
    ``batch_extras`` (cross_user re-anchors the peer futures)."""
    if batch.get("context") is not None:
        return {"context": batch["context"]}
    return {}


def step_generator(cfg: ExperimentConfig, step: int, device) -> torch.Generator:
    """The generator that draws step ``step``'s scheduled-sampling coins (or
    noisy-teacher-forcing noise), on ``device``, seeded from
    ``(cfg.seed, step)``."""
    seed = int(np.random.default_rng([cfg.seed, step]).integers(2**63))
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def _check_impl(cfg: ExperimentConfig):
    if cfg.train_impl not in TRAIN_IMPLS:
        raise ValueError(f"train_impl must be one of {TRAIN_IMPLS}, got {cfg.train_impl!r}")


def make_grad_fn(
    cfg: ExperimentConfig,
    apply_fn: Callable,
    *,
    extras_fn: Optional[Callable] = None,
    fused_tf_fn: Optional[Callable] = None,
    fused_ss_fn: Optional[Callable] = None,
    gc_metric: bool = True,
) -> Callable:
    """``grad_fn(params, batch, gen=None, teacher_prob=1.0) -> ((loss,
    gc_deg), grads)``: the mean loss of the batch and its gradient (a params
    tree), over ``cfg.accum`` equal microbatches when ``accum`` > 1.
    ``batch`` = {"past": (B, H_in, D) raw, "future": (B, H_out, D) raw, and
    the family's extras}, arrays or tensors, moved to the params' device;
    ``extras_fn(batch, anchor)`` (default :func:`default_extras`) turns the
    extras into keyword arguments of the forward. With scheduled sampling,
    ``gen`` draws the coins (microbatch after microbatch) at
    ``teacher_prob``. ``gc_metric=False`` skips the great-circle metric
    (reported as NaN) unless the loss needs it.

    Each leaf's gradient is in its dtype but on the fused route, where a
    bf16 LSTM cell's W and b (the kernels' weights) get f32 gradients, as
    JAX's custom VJPs give them: their gradient is taken at an f32 copy of
    the leaf, which the kernels' wrappers take as it is. A leaf the loss
    does not reach gets zeros in its own dtype, as under ``jax.grad``. With
    ``accum`` > 1 the microbatches' gradients are summed in f32 and the
    mean rounded to each param's dtype, as JAX's accumulation does."""
    _check_impl(cfg)
    extras = extras_fn or default_extras
    impl_on = cfg.train_impl in ("auto", "fused")
    use_fused = fused_tf_fn is not None and not cfg.scheduled_sampling and impl_on
    use_fused_ss = fused_ss_fn is not None and cfg.scheduled_sampling and impl_on
    fused_kw = (
        {} if cfg.train_compute == "float32"
        else {"compute_dtype": getattr(torch, cfg.train_compute)}
    )

    def loss_fn(params, batch, gen, teacher_prob):
        past_n, future_n, anchor = windows.normalize_window(batch["past"], batch["future"])
        kwargs = extras(batch, anchor)
        if use_fused:
            pred_n = fused_tf_fn(params, cfg.model, past_n, future_n, **fused_kw, **kwargs)
        elif use_fused_ss:
            pred_n = fused_ss_fn(params, cfg.model, past_n, future_n, rng=gen,
                                 teacher_prob=teacher_prob, **fused_kw, **kwargs)
        else:
            pred_n = apply_fn(params, cfg.model, past_n, future_n,
                              rng=gen if cfg.scheduled_sampling else None,
                              teacher_prob=teacher_prob, **kwargs)
        true_xyz = batch["future"]
        pred_xyz = None
        if gc_metric or cfg.gc_weight:
            pred_xyz = windows.denormalize_window(pred_n, anchor, to_sphere=True)
        loss = losses.combined_loss(pred_n, future_n, pred_xyz, true_xyz, gc_weight=cfg.gc_weight)
        with torch.no_grad():
            gc_deg = (
                losses.great_circle_deg_metric(pred_xyz, true_xyz)
                if gc_metric else torch.tensor(float("nan"))
            )
        return loss, gc_deg

    def one(params, batch, gen, teacher_prob):
        orig, cells = tree_leaves(params), []
        walk(params, lambda key, _: cells.append((use_fused or use_fused_ss) and key.split(".")[0] in _CELLS))
        leaves = [(p.detach().float() if cell else p.detach()).requires_grad_(True) for p, cell in zip(orig, cells)]
        loss, gc_deg = loss_fn(tree_unflatten(params, leaves), batch, gen, teacher_prob)
        # a leaf the loss does not reach (the peer encoder under an explicit
        # context) gets a zero gradient, as under jax.grad
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return (loss.detach(), gc_deg), [torch.zeros_like(p) if g is None else g for g, p in zip(grads, orig)]

    def grad_fn(params, batch, gen=None, teacher_prob=1.0):
        device = params_device(params)
        batch = {
            k: torch.as_tensor(v, device=device) for k, v in batch.items() if v is not None
        }
        if cfg.accum == 1:
            (loss, gc_deg), grads = one(params, batch, gen, teacher_prob)
            return (loss, gc_deg), tree_unflatten(params, grads)
        b = batch["past"].shape[0]
        if b % cfg.accum:
            raise ValueError(f"batch size {b} not divisible by accum={cfg.accum}")
        size = b // cfg.accum
        gsum = [torch.zeros_like(p, dtype=torch.float32) for p in tree_leaves(params)]
        lsum = gcsum = 0.0
        for i in range(cfg.accum):
            micro = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            (l, g), grads = one(params, micro, gen, teacher_prob)
            gsum = [s + x for s, x in zip(gsum, grads)]
            lsum, gcsum = lsum + l, gcsum + g
        inv = 1.0 / cfg.accum
        grads = [(s * inv).to(p.dtype) for s, p in zip(gsum, tree_leaves(params))]
        return (lsum * inv, gcsum * inv), tree_unflatten(params, grads)

    return grad_fn


def make_train_step(
    cfg: ExperimentConfig,
    apply_fn: Callable,
    optimizer: Optimizer,
    *,
    extras_fn: Optional[Callable] = None,
    fused_tf_fn: Optional[Callable] = None,
    fused_ss_fn: Optional[Callable] = None,
    gc_metric: bool = True,
    mesh=None,
) -> Callable:
    """``step(state, batch) -> (state, metrics)``: one optimizer update from
    :func:`make_grad_fn`'s gradient, with scheduled sampling at
    :func:`teacher_prob_at` and coins from :func:`step_generator`.
    ``metrics`` holds 0-d tensors (read them only where the host needs
    them: each read waits for the device). ``gc_metric=False`` builds the
    fast step the loop runs between logged steps; its parameter updates are
    the same.

    With ``mesh`` (``parallel.mesh.DataMesh``) ``batch`` is this rank's
    rows of the global batch: the coins are the rank's rows of the global
    batch's (``mesh.draw``), and the gradients, the loss and the metric are
    averaged over the ranks (``mesh.pmean``) before the update."""
    grad_fn = make_grad_fn(cfg, apply_fn, extras_fn=extras_fn, fused_tf_fn=fused_tf_fn,
                           fused_ss_fn=fused_ss_fn, gc_metric=gc_metric)

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        tp = teacher_prob_at(cfg, state.step)
        gen = (step_generator(cfg, state.step, params_device(state.params))
               if cfg.scheduled_sampling else None)
        if mesh is not None and gen is not None:
            gen = mesh.draw(gen)
        (loss, gc_deg), grads = grad_fn(state.params, batch, gen, tp)
        if mesh is not None:
            loss, gc_deg, grads = mesh.pmean(loss, gc_deg, grads)
        updates, opt_state = optimizer.update(grads, state.opt_state)
        with torch.no_grad():
            params = tree_unflatten(state.params, [
                (p + u).to(p.dtype)
                for p, u in zip(tree_leaves(state.params), tree_leaves(updates))
            ])
        metrics = {"loss": loss, "great_circle_deg": gc_deg, "teacher_prob": tp}
        return TrainState(params, opt_state, state.step + 1, state.rng), metrics

    return step


def init_state(
    cfg: ExperimentConfig,
    init_fn: Callable,
    optimizer: Optimizer,
    *,
    device,
    gen: Optional[torch.Generator] = None,
) -> TrainState:
    """Fresh params from ``init_fn(gen, cfg.model, device=)``; ``gen``
    defaults to a CPU generator seeded with ``cfg.seed``."""
    gen = torch.Generator().manual_seed(cfg.seed) if gen is None else gen
    params = init_fn(gen, cfg.model, device=torch.device(device))
    return TrainState(params, optimizer.init(params), 0, gen)


def batch_iterator(
    data: Dict[str, np.ndarray],
    batch_size: int,
    seed: int = 0,
    start_step: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Endless shuffled minibatch stream over packed window arrays (host
    numpy, copied from the JAX package; the ragged tail of an epoch is
    dropped). Each epoch's permutation is seeded
    from ``(seed, epoch)``, so the stream at any global step is a pure
    function of (seed, step): a resumed run positions itself with
    ``start_step`` and consumes the batches the uninterrupted run would."""
    n = len(data["past"])
    if batch_size > n:
        raise ValueError(f"batch_size {batch_size} > dataset size {n}")
    bpe = (n - batch_size) // batch_size + 1  # full batches per epoch
    epoch, pos = divmod(start_step, bpe)
    while True:
        order = np.random.default_rng([seed, epoch]).permutation(n)
        for b in range(pos, bpe):
            idx = order[b * batch_size : (b + 1) * batch_size]
            yield {k: v[idx] for k, v in data.items() if v is not None}
        pos = 0
        epoch += 1


def eval_impl(cfg: ExperimentConfig) -> str:
    """The in-loop evaluation's impl: "fused", the family's ``serve_fused``
    (its serving kernels on the card), for an f32 model; "plain", the
    family's ``apply`` in the params' dtype, for a bf16 one, whose decode
    then runs in bf16 as JAX's ``infer.predict_batch`` runs it."""
    return "fused" if cfg.model.param_dtype == "float32" else "plain"


def train_loop(
    cfg: ExperimentConfig,
    init_fn: Callable,
    apply_fn: Callable,
    data: Dict[str, np.ndarray],
    *,
    device,
    eval_data: Optional[Dict[str, np.ndarray]] = None,
    log_file: Optional[str] = None,
    tb_dir: Optional[str] = None,
    checkpoint_dir: Optional[str] = None,
    state: Optional[TrainState] = None,
    extras_fn: Optional[Callable] = None,
    fused_tf_fn: Optional[Callable] = None,
    fused_ss_fn: Optional[Callable] = None,
    mesh=None,
) -> Tuple[TrainState, list]:
    """Single-device training loop → (final state, metrics history).

    Runs the fast step between logged steps and the full step (with the
    great-circle metric) on every ``eval_every``-th and the last step; a
    logged step also evaluates ``eval_data`` through ``evaluate.evaluate``
    with :func:`eval_impl`'s impl, appends a JSON line to ``log_file`` and
    writes the numeric metrics to ``tb_dir`` as TensorBoard scalars
    (``utils.profiling.TensorBoardWriter``). Checkpoints every ``ckpt_every`` steps and at the end. Resumable: pass
    a restored ``state`` to continue from its step.

    ``mesh`` (``parallel.mesh.DataMesh``; use ``parallel.train_loop_dp``,
    which sizes the batch and makes the ranks' states agree) runs the
    data-parallel loop: every rank draws the same global batches and steps
    on its rows, only rank 0 writes the log, the TensorBoard scalars and the
    checkpoints (the ranks wait for each save), and every rank returns the
    same history, with ``n_devices`` and the slowest rank's
    ``steps_per_sec``."""
    optimizer = make_optimizer(cfg)
    fns = dict(extras_fn=extras_fn, fused_tf_fn=fused_tf_fn, fused_ss_fn=fused_ss_fn, mesh=mesh)
    step_fn = make_train_step(cfg, apply_fn, optimizer, **fns)
    step_fast = make_train_step(cfg, apply_fn, optimizer, gc_metric=False, **fns)
    if state is None:
        state = init_state(cfg, init_fn, optimizer, device=device)
    it = batch_iterator(data, cfg.batch_size, cfg.seed, start_step=state.step)
    if mesh is not None:
        rows = mesh.rows(cfg.batch_size)
        it = ({k: v[rows] for k, v in batch.items()} for batch in it)
    writer = mesh is None or mesh.rank == 0
    history = []
    ckpt = None
    if checkpoint_dir and writer:
        from .checkpoint import Checkpointer

        ckpt = Checkpointer(checkpoint_dir, cfg)
    start_step = state.step
    t0 = time.time()
    tb = contextlib.nullcontext()
    if tb_dir and writer:
        from .utils.profiling import TensorBoardWriter

        tb = TensorBoardWriter(tb_dir)
    with open(log_file, "a") if log_file and writer else contextlib.nullcontext() as log_fh, tb:
        for i in range(start_step, cfg.steps):
            logged = (i + 1) % cfg.eval_every == 0 or i + 1 == cfg.steps
            state, metrics = (step_fn if logged else step_fast)(state, next(it))
            if logged:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = i + 1
                elapsed = time.time() - t0
                if mesh is not None:
                    elapsed = mesh.slowest(elapsed)
                m["steps_per_sec"] = (i + 1 - start_step) / max(elapsed, 1e-9)
                if mesh is not None:
                    m["n_devices"] = mesh.world
                if eval_data is not None:
                    from .evaluate import evaluate

                    eres = evaluate(state.params, cfg, eval_data, impl=eval_impl(cfg))
                    m["eval_great_circle_deg"] = eres["mean_deg"]
                history.append(m)
                if log_fh:
                    log_fh.write(json.dumps(m) + "\n")
                    log_fh.flush()
                if tb_dir and writer:
                    tb.write(**m)
            if checkpoint_dir and ((i + 1) % cfg.ckpt_every == 0 or i + 1 == cfg.steps):
                if ckpt:
                    ckpt.save(state, metrics=history[-1] if history else None)
                if mesh is not None:
                    mesh.barrier()  # no rank goes on before the save is whole
    return state, history
