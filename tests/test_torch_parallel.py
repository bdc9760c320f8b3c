"""Data-parallel training of the port (``parallel.mesh``) on the CPU: gloo
worlds of 1, 2 and 4 ranks against the single-device loop, and the port's
sharded step against JAX's ``make_sharded_train_step`` on its 8-device CPU
mesh.

Each world starts once for the module (the ``worlds`` fixture): its ranks,
which import only the port, run every case and return their params. The
single-device references run here. Weights cross between the packages as
numpy (params_from_numpy).
"""

import dataclasses
import textwrap
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longterm360fov_tpu import parallel as jax_parallel
from longterm360fov_tpu import train as jax_train
from longterm360fov_tpu.config import ExperimentConfig as JaxExperimentConfig
from longterm360fov_tpu.models import seq2seq as jax_seq2seq
from longterm360fov_tpu_torch import parallel, train
from longterm360fov_tpu_torch.config import ExperimentConfig
from longterm360fov_tpu_torch.models import cross_user, get_family, seq2seq
from longterm360fov_tpu_torch.params import array_to_tensor, params_from_numpy, tensor_to_array, tree_leaves, walk
from longterm360fov_tpu_torch.parallel import launch, multihost

WORLD_TIMEOUT = 180.0  # seconds a world may take: a hung rank fails the fixture, not the run

WORKER = textwrap.dedent('''
    import torch
    from longterm360fov_tpu_torch import train
    from longterm360fov_tpu_torch.models import get_family
    from longterm360fov_tpu_torch.params import params_from_numpy, tensor_to_array, tree_leaves, walk
    from longterm360fov_tpu_torch.parallel import replicate_state, train_loop_dp


    def run(mesh, cases):
        out = {}
        for name, case in cases.items():
            cfg = case["cfg"]
            fam = get_family(cfg.model_family)
            params = params_from_numpy(case["params"], mesh.device)
            if case.get("skew"):  # every rank but 0 starts elsewhere: replicate_state undoes it
                params = walk(params, lambda _, t: t + mesh.rank)
            opt = train.make_optimizer(cfg)
            state = train.TrainState(params, opt.init(params), 0, torch.Generator())
            replicated = replicate_state(mesh, state)
            state, history = train_loop_dp(cfg, fam.init, fam.apply, case["data"], mesh=mesh, state=state,
                                           extras_fn=getattr(fam, "batch_extras", None), **case["fns"])
            owned = tree_leaves(replicated.params) + replicated.opt_state.mu + replicated.opt_state.nu
            out[name] = {"replicated": [tensor_to_array(t) for t in tree_leaves(replicated.params)],
                         "aligned": all(t.data_ptr() % 16 == 0 for t in owned),
                         "params": [tensor_to_array(t) for t in tree_leaves(state.params)],
                         "history": history, "world": mesh.world, "rank": mesh.rank}
        return out
''')


def _windows(n, seed, h_in=5, h_out=5, k=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, h_in + h_out, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v = v * 0.3 + np.array([1.0, 0.0, 0.0], np.float32)  # a cloud around +x
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    d = {"past": v[:, :h_in].copy(), "future": v[:, h_in:].copy()}
    if k:
        of = rng.normal(size=(n, k, h_out, 3)).astype(np.float32) * 0.3 + np.float32([1, 0, 0])
        d["other_future"] = of / np.linalg.norm(of, axis=-1, keepdims=True)
        mask = (rng.random((n, k)) < 0.7).astype(np.float32)
        mask[0] = 0.0
        d["other_mask"] = mask
    return d


def _cfg(family="seq2seq", model=None, **kw):
    m = dict(d=3, hidden=16, layers=1, h_in=5, h_out=5)
    m.update(model or {})
    top = dict(name="port-dp-test", model_family=family, batch_size=16, steps=3, eval_every=2, lr=3e-3)
    top.update(kw)
    return ExperimentConfig(model=seq2seq.Seq2SeqConfig(**m), **top)


def _numpy_params(cfg, seed=0):
    tree = get_family(cfg.model_family).init(torch.Generator().manual_seed(seed), cfg.model, device="cpu")
    return walk(tree, lambda _, t: tensor_to_array(t))


_F32 = dict(residual_dtype=torch.float32)


def _cases():
    """name -> (config, fused hooks): the fused teacher-forced step, with
    accum=2, scheduled sampling on the kernels' plain versions (seq2seq and
    cross_user with K = 3 peers), noisy teacher forcing (the transformer,
    on autograd through its apply, whose noise scale takes the deviation
    over every rank's rows), the
    plain autograd route from skewed starts and with accum=2, and a bf16
    model."""
    return {
        "fused": (_cfg(train_impl="fused"), dict(fused_tf_fn=partial(seq2seq.apply_fused_tf, **_F32))),
        "accum2": (_cfg(train_impl="fused", accum=2), dict(fused_tf_fn=partial(seq2seq.apply_fused_tf, **_F32))),
        "ss": (_cfg(scheduled_sampling=True), dict(fused_ss_fn=partial(seq2seq.apply_fused_ss, **_F32))),
        "cross_user": (_cfg("cross_user", model=dict(layers=2, ctx_dim=16), scheduled_sampling=True,
                            n_other_users=3),
                       dict(fused_ss_fn=partial(cross_user.apply_fused_ss, **_F32))),
        "transformer": (_cfg("transformer", model=dict(hidden=32, layers=2), scheduled_sampling=True, ss_end=0.3,
                             gc_weight=0.3, n_other_users=3), {}),
        "skew": (_cfg(train_impl="xla"), {}),
        "xla_accum2": (_cfg(train_impl="xla", accum=2), {}),
        "bf16": (_cfg(train_impl="fused", model=dict(param_dtype="bfloat16")),
                 dict(fused_tf_fn=partial(seq2seq.apply_fused_tf, **_F32))),
    }


def _data(cfg):
    k = cfg.n_other_users if cfg.model_family != "seq2seq" else 0
    return _windows(64, seed=3, h_in=cfg.model.h_in, h_out=cfg.model.h_out, k=k)


def _payload():
    out = {}
    for name, (cfg, fns) in _cases().items():
        params = _numpy_params(cfg)
        out[name] = {"cfg": cfg, "params": params, "data": _data(cfg), "fns": fns, "skew": name == "skew"}
    return out


def _single(name):
    """The single-device loop of case ``name`` from the same params → its
    final params (tensors) and history."""
    cfg, fns = _cases()[name]
    fam = get_family(cfg.model_family)
    params = params_from_numpy(_numpy_params(cfg), "cpu")
    opt = train.make_optimizer(cfg)
    state = train.TrainState(params, opt.init(params), 0, torch.Generator())
    state, history = train.train_loop(cfg, fam.init, fam.apply, _data(cfg), device="cpu", state=state,
                                      extras_fn=getattr(fam, "batch_extras", None), **fns)
    return state.params, history


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """world size -> every rank's results, each world started once."""
    root = tmp_path_factory.mktemp("dp")
    worker = root / "dp_worker.py"
    worker.write_text(WORKER)
    payload = _payload()
    return {w: launch.run_world(f"{worker}:run", w, payload, workdir=str(root / f"world{w}"),
                                timeout=WORLD_TIMEOUT)
            for w in (1, 2, 4)}


@pytest.fixture(scope="module")
def singles():
    return {name: _single(name) for name in _cases()}


def _gap(ours, ref):
    return max(float(np.abs(np.asarray(a, np.float64) - b.double().numpy()).max())
               for a, b in zip(ours, tree_leaves(ref), strict=True))


@pytest.mark.parametrize("name", sorted(_cases()))
def test_world_one_is_bit_equal_to_the_single_device_loop(worlds, singles, name):
    """One rank of a gloo group: the all_reduce of one rank and the division
    by 1 change no bit; the histories agree but for the time."""
    (res,) = worlds[1]
    params, history = singles[name]
    for a, b in zip(res[name]["params"], tree_leaves(params), strict=True):
        assert torch.equal(array_to_tensor(a, "cpu"), b), name
    strip = [{k: v for k, v in m.items() if k not in ("steps_per_sec", "n_devices")} for m in res[name]["history"]]
    assert strip == [{k: v for k, v in m.items() if k != "steps_per_sec"} for m in history]
    assert all(m["n_devices"] == 1 for m in res[name]["history"])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["fused", "ss", "cross_user", "transformer", "skew"])
def test_dp_matches_the_single_device_loop(worlds, singles, world, name):
    """3 Adam steps of lr 3e-3 on each rank's rows against the single-device
    loop on the global batch: within 2e-6, the bound of JAX's own test
    (tests/test_parallel.py); scheduled sampling too, since every rank draws
    the global batch's coins (the transformer: its noise, and the noise
    scale's deviation over every rank's rows) and keeps its rows."""
    params, history = singles[name]
    for res in worlds[world]:
        assert _gap(res[name]["params"], params) < 2e-6, (name, res[name]["rank"])
        assert res[name]["history"][-1]["loss"] == pytest.approx(history[-1]["loss"], rel=1e-5)
        assert res[name]["history"][-1]["n_devices"] == world


@pytest.mark.parametrize("world", [2, 4])
def test_dp_accum_matches_the_full_batch(worlds, singles, world):
    """accum=2 on each rank's rows (microbatches of the shard, as JAX's
    accum_grads per shard) against the single-device full batch without
    accumulation: 3e-6 absolute, 3e-5 relative, JAX's bound."""
    params, _ = singles["fused"]
    for res in worlds[world]:
        for a, b in zip(res["accum2"]["params"], tree_leaves(params), strict=True):
            np.testing.assert_allclose(a, b.numpy(), atol=3e-6, rtol=3e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_hold_bit_equal_states(worlds, world):
    """After replicate_state every rank holds rank 0's params, though the
    ranks started apart ("skew"), each leaf a 16-byte aligned tensor of its
    own, as the kernels' wrappers require; after the steps the ranks agree
    bit for bit in every case, and so do their histories but for the
    time."""
    ranks = worlds[world]
    assert all(r[name]["aligned"] for r in ranks for name in _cases())
    skew0 = _numpy_params(_cases()["skew"][0])
    for a, b in zip(ranks[0]["skew"]["replicated"], tree_leaves(params_from_numpy(skew0, "cpu")), strict=True):
        assert np.array_equal(a, b.numpy())
    for res in ranks[1:]:
        for name in _cases():
            for a, b in zip(res[name]["replicated"] + res[name]["params"],
                            ranks[0][name]["replicated"] + ranks[0][name]["params"], strict=True):
                assert a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8)), name
            strip = [[{k: v for k, v in m.items() if k != "steps_per_sec"} for m in r[name]["history"]]
                     for r in (res, ranks[0])]
            assert strip[0] == strip[1]
            assert [m["steps_per_sec"] for m in res[name]["history"]] == [
                m["steps_per_sec"] for m in ranks[0][name]["history"]]


@pytest.mark.parametrize("world", [2, 4])
def test_dp_bf16_model_keeps_its_dtypes(worlds, singles, world):
    """A bf16 model: the LSTM cells' gradients are f32 and the projection's
    bf16, each reduced in its own dtype; the params stay bf16 and within
    one bf16 step of the single-device loop."""
    params, _ = singles["bf16"]
    for res in worlds[world]:
        for a, b in zip(res["bf16"]["params"], tree_leaves(params), strict=True):
            ours = array_to_tensor(a, "cpu")
            assert b.dtype == ours.dtype == torch.bfloat16
            ours = ours.float()
            assert float((ours - b.float()).abs().max()) <= 2 ** -7 * max(float(b.float().abs().max()), 1.0)


def test_world_one_without_a_process_group():
    """train_loop_dp with no process group (a world of one, the CLI's
    --data-parallel without a launcher) is the single-device loop, bit for
    bit, with n_devices 1."""
    cfg, fns = _cases()["ss"]
    params = params_from_numpy(_numpy_params(cfg), "cpu")
    opt = train.make_optimizer(cfg)
    mesh = parallel.make_mesh("cpu")
    assert (mesh.world, mesh.rank, mesh.group, mesh.axis_names) == (1, 0, None, ("data",))
    state, history = parallel.train_loop_dp(cfg, None, seq2seq.apply, _data(cfg), mesh=mesh,
                                            state=train.TrainState(params, opt.init(params), 0, torch.Generator()),
                                            **fns)
    ref, _ = _single("ss")
    for a, b in zip(tree_leaves(state.params), tree_leaves(ref), strict=True):
        assert torch.equal(a, b)
    assert history[-1]["n_devices"] == 1


def _jax_sharded(jcfg, data, params_np):
    opt = jax_train.make_optimizer(jcfg)
    state = jax_train.init_state(jcfg, jax_seq2seq.init, opt)
    state = state._replace(params=jax.tree.map(jnp.asarray, params_np))
    state = state._replace(opt_state=opt.init(state.params))
    mesh = jax_parallel.make_mesh()
    assert mesh.devices.size == 8
    step = jax_parallel.make_sharded_train_step(jcfg, jax_seq2seq.apply, opt, mesh)
    state = jax_parallel.mesh.replicate_state(mesh, state)
    it = jax_train.batch_iterator(data, jcfg.batch_size, jcfg.seed)
    for _ in range(jcfg.steps):
        state, _ = step(state, jax_parallel.shard_batch(mesh, {k: jnp.asarray(v) for k, v in next(it).items()}))
    return state.params


@pytest.mark.parametrize("name", ["skew", "xla_accum2"])
def test_dp_step_matches_jax_sharded_step(worlds, name):
    """The port's 4-rank run (rank 0's params, replicated) against JAX's
    sharded step over its 8 CPU devices (2 rows a shard), from the same
    numpy weights on the same batches, through plain autograd (JAX's fused
    custom VJP does not trace inside its shard_map): within 2e-6, the bound
    of the single-device trajectory test (tests/test_torch_train.py)."""
    cfg, _ = _cases()[name]
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "model"}
    jcfg = JaxExperimentConfig(model=jax_seq2seq.Seq2SeqConfig(**dataclasses.asdict(cfg.model)), **fields)
    assert jcfg.hash() == cfg.hash()
    jparams = _jax_sharded(jcfg, _data(cfg), _numpy_params(cfg))
    for res in worlds[4]:
        for a, b in zip(res[name]["params"], jax.tree.leaves(jparams), strict=True):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=2e-6)


def test_batch_is_rounded_to_the_world_and_accum_checked_per_shard():
    """train_loop_dp rounds the batch down to a multiple of the world and
    refuses one below it, with JAX's message; the accumulation check runs on
    a shard's rows, with JAX's message (tests here build a mesh of 8 ranks
    with no process group: the check comes before any collective)."""
    cfg, _ = _cases()["fused"]
    mesh8 = parallel.DataMesh(torch.device("cpu"), world=8, rank=0)
    with pytest.raises(ValueError, match=r"^batch_size 4 < mesh size 8$"):
        parallel.train_loop_dp(cfg.replace(batch_size=4), seq2seq.init, seq2seq.apply, _data(cfg), mesh=mesh8)
    acfg = cfg.replace(accum=4)
    step = parallel.make_sharded_train_step(acfg, seq2seq.apply, train.make_optimizer(acfg), mesh8)
    params = params_from_numpy(_numpy_params(cfg), "cpu")
    state = train.TrainState(params, train.make_optimizer(acfg).init(params), 0, torch.Generator())
    batch = parallel.shard_batch(mesh8, {k: v[:16] for k, v in _data(cfg).items()})  # 2 rows a shard
    with pytest.raises(ValueError) as ours:
        step(state, batch)
    jcfg_fields = {f.name: getattr(acfg, f.name) for f in dataclasses.fields(acfg) if f.name != "model"}
    jcfg = JaxExperimentConfig(model=jax_seq2seq.Seq2SeqConfig(**dataclasses.asdict(acfg.model)), **jcfg_fields)
    jopt = jax_train.make_optimizer(jcfg)
    jstep = jax_parallel.make_sharded_train_step(jcfg, jax_seq2seq.apply, jopt, jax_parallel.make_mesh())
    jstate = jax_train.init_state(jcfg, jax_seq2seq.init, jopt)
    with pytest.raises(ValueError) as ref:
        jstep(jstate, {k: jnp.asarray(v[:16]) for k, v in _data(cfg).items()})
    assert str(ours.value) == str(ref.value) == "batch size 2 not divisible by accum=4"


def test_the_mesh_refuses_model_parallel_naming_slice_p3():
    with pytest.raises(NotImplementedError, match="slice P-3"):
        parallel.make_mesh("cpu", model_parallel=2)


def test_the_default_device_is_the_card_of_the_local_rank(monkeypatch):
    """No device given: cuda:{LOCAL_RANK}, which must exist; nothing falls
    back to the CPU."""
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r"cuda:3, but torch sees no CUDA device"):
        parallel.make_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match=r"device cuda:3 \(LOCAL_RANK 3\), but torch sees 2 CUDA device"):
        multihost.local_device()
    assert multihost.local_device("cuda:1") == torch.device("cuda:1")
