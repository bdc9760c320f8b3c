"""The port's TCP daemon against the JAX package's on the CPU: the JAX
daemon tests' cases run against the port's ``FovServer`` (push sessions,
concurrent coalescing, hot reload, bulk, error replies that keep the
connection, grouped bulk against per row, live peer context, LRU sessions,
the peer pool), and the two sides talk to each other: JAX's ``FovClient``
against the port's server and the port's client against JAX's
``serve_daemon``, on both wires, with the same weights. Replies to the same
requests agree within 1e-5 rad (``tests/test_torch_serve_slice.py``'s bound)
and their prefetch tiles are equal but for tiles whose centre lies within
1e-4 degrees of the field of view's edge."""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)
import dataclasses
import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from longterm360fov_tpu import config as jax_config
from longterm360fov_tpu import serving as jax_serving
from longterm360fov_tpu.models import get_family as jax_get_family
from longterm360fov_tpu_torch import geometry, infer, serving
from longterm360fov_tpu_torch.config import ExperimentConfig
from longterm360fov_tpu_torch.models import get_family
from longterm360fov_tpu_torch.models.seq2seq import Seq2SeqConfig
from longterm360fov_tpu_torch.params import params_from_numpy

ANGLE_TOL = 1e-5  # rad
EDGE_TOL_DEG = 1e-4


def tiny_cfg(family="seq2seq"):
    """tests/test_serving.py's tiny configs: hidden 16, 5 + 4 frames, K = 2
    (the cross_user context 16); the transformer hidden 128, 5 + 6."""
    if family == "transformer":
        model = Seq2SeqConfig(d=3, hidden=128, layers=1, h_in=5, h_out=6)
    else:
        model = Seq2SeqConfig(d=3, hidden=16, layers=1, h_in=5, h_out=4,
                              ctx_dim=16 if family == "cross_user" else 0)
    return ExperimentConfig(name=f"tiny-{family}", model=model, model_family=family, n_other_users=2)


def jax_twin(cfg):
    return jax_config.ExperimentConfig(
        name=cfg.name, model=jax_config.Seq2SeqConfig(**dataclasses.asdict(cfg.model)),
        model_family=cfg.model_family, n_other_users=cfg.n_other_users)


def random_past(rng, n=1, h_in=5):
    v = rng.normal(size=(n, h_in, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return v if n > 1 else v[0]


def _start(server):
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def _stop(server):
    server.shutdown()
    server.server_close()
    server.batcher.stop()


class Pair:
    """One family's config and weights, served by both daemons."""

    def __init__(self, family, seed=0, **kw):
        self.cfg, self.jcfg = tiny_cfg(family), jax_twin(tiny_cfg(family))
        self.fam, self.jfam = get_family(family), jax_get_family(family)
        self.jparams = self.jfam.init(jax.random.PRNGKey(seed), self.jcfg.model)
        self.params = params_from_numpy(jax.tree.map(np.asarray, self.jparams), "cpu")
        opts = dict(host="127.0.0.1", port=0, max_batch=8, max_wait_ms=10.0, warmup=False, **kw)
        self.ours = _start(serving.serve_daemon(self.params, self.cfg, self.fam, device="cpu", **opts))
        self.ref = _start(jax_serving.serve_daemon(self.jparams, self.jcfg, self.jfam, **opts))

    def client(self, side="ours", wire="json", lib=serving):
        host, port = (self.ours if side == "ours" else self.ref).server_address
        return lib.FovClient(host, port, timeout=120.0, wire=wire)

    def close(self):
        _stop(self.ours)
        _stop(self.ref)


@pytest.fixture(scope="module")
def s2s():
    pair = Pair("seq2seq")
    yield pair
    pair.close()


@pytest.fixture(scope="module")
def crossuser():
    pair = Pair("cross_user")
    yield pair
    pair.close()


@pytest.fixture(scope="module")
def tfm():
    pair = Pair("transformer", seed=5)
    yield pair
    pair.close()


def _xyz(yaw, pitch):
    yaw, pitch = np.asarray(yaw, np.float64), np.asarray(pitch, np.float64)
    return np.stack([np.cos(pitch) * np.cos(yaw), np.cos(pitch) * np.sin(yaw), np.sin(pitch)], -1)


def _edge_gap(yaw, pitch, rows=6, cols=12):
    """Per tile, the least distance (degrees) over the horizon between the
    predicted directions (rows of (T,) or (N, T)) and the tile's prefetch
    threshold."""
    centers = infer.tile_centers(rows, cols, device="cpu").double().numpy()
    ang = np.degrees(np.arccos(np.clip(_xyz(yaw, pitch) @ centers.T, -1.0, 1.0)))
    thr = 45.0 + 0.5 * math.degrees(math.hypot(math.pi / rows, 2 * math.pi / cols))
    return np.abs(ang - thr).min(axis=-2)


def same_reply(a, b):
    """Two replies to the same request: the same keys; pitch and the
    great-circle angle within ANGLE_TOL (yaw alone is ill-conditioned at the
    poles); tiles equal away from the edge (JSON index lists or u8 masks)."""
    assert "error" not in a and "error" not in b, (a, b)
    assert a.keys() - {"id"} == b.keys() - {"id"}
    if "pending" in a:  # a push whose window is not full yet
        assert a["pending"] == b["pending"]
        return
    ya, pa, yb, pb = (np.asarray(x, np.float64) for x in (a["yaw"], a["pitch"], b["yaw"], b["pitch"]))
    assert ya.shape == yb.shape
    assert np.abs(pa - pb).max() <= ANGLE_TOL
    cos = np.clip((_xyz(ya, pa) * _xyz(yb, pb)).sum(-1), -1.0, 1.0)
    assert np.arccos(cos).max() <= ANGLE_TOL + 2e-6  # arccos near 1 adds f64 noise
    if "prefetch" in a:
        def masks(p, lead):
            if isinstance(p, np.ndarray):
                return p.astype(bool).reshape(lead + (-1,))
            rows = p if lead else [p]
            out = np.zeros((len(rows), 72), bool)
            for i, r in enumerate(rows):
                out[i, r] = True
            return out if lead else out[0]
        lead = ya.shape[:-1]
        differ = masks(a["prefetch"], lead) != masks(b["prefetch"], lead)
        assert not (differ & (_edge_gap(ya, pa) >= EDGE_TOL_DEG)).any()
    for key in ("pending", "peers", "dropped", "reloaded"):
        assert a.get(key) == b.get(key)


# ----------------------------------------------------------------- the JAX daemon tests' cases on the port


def test_server_predict_matches_direct_and_jax(s2s):
    rng = np.random.default_rng(2)
    past = random_past(rng)
    c = s2s.client()
    try:
        resp = c.predict(past.tolist())
        assert len(resp["yaw"]) == s2s.cfg.model.h_out
        direct = infer.predict_batch(s2s.params, s2s.cfg, s2s.fam.apply, past[None])
        yaw, pitch = (t.numpy()[0] for t in geometry.xyz_to_euler(direct))
        np.testing.assert_allclose(resp["yaw"], yaw, atol=1e-5)
        np.testing.assert_allclose(resp["pitch"], pitch, atol=1e-5)
        mask = infer.tiles_for_fov(direct).numpy()[0].any(axis=0)
        assert resp["prefetch"] == list(np.nonzero(mask)[0])
        ref = s2s.client("ref")
        same_reply(resp, ref.predict(past.tolist()))
        ref.close()
    finally:
        c.close()


@pytest.mark.parametrize("wire", ["json", "binary"])
def test_server_push_session_flow(s2s, wire):
    h_in = s2s.cfg.model.h_in
    ours, ref = s2s.client(wire=wire), s2s.client("ref", wire=wire, lib=jax_serving)
    viewer = f"viewer-7-{wire}"
    try:
        for i in range(h_in - 1):
            r = ours.push(viewer, [0.01 * i, 0.0])
            assert r["pending"] == h_in - 1 - i
            assert ref.push(viewer, [0.01 * i, 0.0])["pending"] == r["pending"]
        for pose in ([0.05, 0.0], [0.06, 0.0], [1.0, 0.2, 0.1]):  # rolling window: every push answers
            r = ours.push(viewer, pose)
            assert len(r["yaw"]) == s2s.cfg.model.h_out
            same_reply(r, ref.push(viewer, pose))
        assert ours.stats()["sessions"] >= 1
        assert ours.request({"op": "drop", "viewer": viewer})["dropped"] is True
        assert ours.push(viewer, [0.0, 0.0])["pending"] == h_in - 1
    finally:
        ours.close()
        ref.close()


def test_server_concurrent_clients_coalesce(s2s):
    rng = np.random.default_rng(3)
    pasts = random_past(rng, 6)
    before = s2s.ours.batcher.stats()
    barrier = threading.Barrier(6)
    out = [None] * 6

    def worker(i):
        c = s2s.client()
        try:
            barrier.wait()
            out[i] = c.predict(pasts[i].tolist())
        finally:
            c.close()

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    after = s2s.ours.batcher.stats()
    assert after["requests"] - before["requests"] == 6
    assert after["batches"] - before["batches"] < 6, "concurrent requests must coalesce into fewer batches"
    fn = serving.make_serve_fn(s2s.params, s2s.cfg, s2s.fam, device="cpu")
    direct = fn.unpack(fn({"past": pasts}).numpy())
    for i, o in enumerate(out):
        np.testing.assert_allclose(o["yaw"], direct["yaw"][i], atol=1e-6)


def test_server_hot_reload(s2s, tmp_path):
    """reload: a JAX-exported npz of other weights changes the answers to
    those of the new weights (here and on the JAX daemon); a mismatched npz
    errors and the current params keep serving."""
    rng = np.random.default_rng(8)
    past = random_past(rng)
    ours, ref = s2s.client(), s2s.client("ref")
    try:
        before = ours.predict(past.tolist())
        params2 = s2s.jfam.init(jax.random.PRNGKey(99), s2s.jcfg.model)
        npz = tmp_path / "new.npz"
        np.savez(npz, **{k: np.asarray(v) for k, v in jax_serving.flat_param_items(params2)})
        r = ours.request({"op": "reload", "path": str(npz)})
        assert r.get("reloaded") is True and r["version"] == s2s.ours.reload_ctx[0].version
        assert ref.request({"op": "reload", "path": str(npz)})["reloaded"] is True
        after = ours.predict(past.tolist())
        assert not np.allclose(before["yaw"], after["yaw"])
        same_reply(after, ref.predict(past.tolist()))
        np.savez(tmp_path / "bad.npz", nonsense=np.zeros(3))
        bad = ours.request({"op": "reload", "path": str(tmp_path / "bad.npz")})
        bad_ref = ref.request({"op": "reload", "path": str(tmp_path / "bad.npz")})
        assert bad["error"] == bad_ref["error"]
        np.testing.assert_allclose(ours.predict(past.tolist())["yaw"], after["yaw"], atol=1e-6)
    finally:
        s2s.ours.reload_ctx[0].swap(s2s.params)
        s2s.ref.reload_ctx[0].swap(s2s.jparams)
        ours.close()
        ref.close()


@pytest.mark.parametrize("wire", ["json", "binary"])
def test_server_predict_batch_bulk(s2s, wire):
    rng = np.random.default_rng(12)
    pasts = random_past(rng, 5)
    ours, ref = s2s.client(wire=wire), s2s.client("ref", wire=wire)
    arg = pasts if wire == "binary" else pasts.tolist()
    try:
        bulk = ours.request({"op": "predict_batch", "past": arg})
        assert len(bulk["yaw"]) == 5 and len(bulk["prefetch"]) == 5
        same_reply(bulk, ref.request({"op": "predict_batch", "past": arg}))
        for i in range(5):
            single = ours.predict(arg[i])
            np.testing.assert_allclose(bulk["yaw"][i], single["yaw"], atol=1e-5)
        bad = ours.request({"op": "predict_batch", "past": [[1, 0, 0]]})
        assert bad["error"] == ref.request({"op": "predict_batch", "past": [[1, 0, 0]]})["error"]
    finally:
        ours.close()
        ref.close()


@pytest.mark.parametrize("wire", ["json", "binary"])
def test_server_error_reply_keeps_connection(s2s, wire):
    ours, ref = s2s.client(wire=wire), s2s.client("ref", wire=wire)
    try:
        for req in ({"op": "predict", "past": [[1, 0, 0]]}, {"op": "nonsense"}, {"op": "push", "viewer": "x"}):
            r, r_ref = ours.request(dict(req)), ref.request(dict(req))
            assert r["error"] == r_ref["error"]
        assert "requests" in ours.stats()
    finally:
        ours.close()
        ref.close()


def test_binary_decode_error_answers_and_closes(s2s):
    import socket

    host, port = s2s.ours.server_address
    with socket.create_connection((host, port), timeout=30) as sock:
        sock.sendall(b"FoVX\x00\x00\x00\x00")
        reply = serving.read_frame(sock.makefile("rb"))
        assert reply["id"] is None and "magic" in reply["error"]
        assert sock.recv(1) == b""  # the server closed the stream


def test_server_grouped_bulk_matches_per_row(tfm):
    """The transformer's grouped gateway (the shared tier with δv) against
    the per-row bulk path on the same sets (JAX's bound, 1e-3), on both
    wires; "stats" shows the grouped block; the JAX daemon answers the
    grouped request the same."""
    rng = np.random.default_rng(5)
    pasts = random_past(rng, n=5, h_in=5)
    keys = ["v0", "v1", "v0", "v1", "v0"]
    sets = {v: (rng.normal(size=(2, 6, 3)) * 0.1).astype(np.float32) for v in ("v0", "v1")}
    assert tfm.ours.grouped_fn is not None
    ours, ours_b, ref = tfm.client(), tfm.client(wire="binary"), tfm.client("ref")
    try:
        r_g = ours.request({"op": "predict_batch", "past": pasts.tolist(), "group_key": keys,
                            "group_sets": {k: v.tolist() for k, v in sets.items()}})
        r_r = ours.request({"op": "predict_batch", "past": pasts.tolist(),
                            "other_future": np.stack([sets[k] for k in keys]).tolist()})
        np.testing.assert_allclose(r_g["yaw"], r_r["yaw"], atol=1e-3)
        np.testing.assert_allclose(r_g["pitch"], r_r["pitch"], atol=1e-3)
        assert r_g["prefetch"] == r_r["prefetch"]
        r_b = ours_b.predict_group(pasts, keys, sets)
        np.testing.assert_allclose(r_b["yaw"], r_g["yaw"], atol=1e-5)
        same_reply(r_g, ref.request({"op": "predict_batch", "past": pasts.tolist(), "group_key": keys,
                                     "group_sets": {k: v.tolist() for k, v in sets.items()}}))
        g = ours.stats()["grouped"]
        assert g["requests"] >= 2 and g["windows"] >= 10 and g["rejected"] == 0 and "latency_ms_p50" in g
    finally:
        for c in (ours, ours_b, ref):
            c.close()


def test_grouped_path_validation_and_admission(crossuser):
    rng = np.random.default_rng(9)
    k, t = crossuser.cfg.n_other_users, crossuser.cfg.model.h_out
    sets = {"v": rng.normal(size=(k, t, 3)).astype(np.float32)}
    c = crossuser.client(wire="binary")
    server = crossuser.ours
    sem, timeout = server._grouped_sem, server.request_timeout
    try:
        assert "error" not in c.predict_group(random_past(rng, 3), ["v"] * 3, sets)
        bad = c.predict_group(random_past(rng, 3, h_in=7), ["v"] * 3, sets)
        assert "past windows" in bad["error"]
        bad2 = c.predict_group(random_past(rng, 3), ["w"] * 3,
                               {"w": rng.normal(size=(k, t + 2, 3)).astype(np.float32)})
        assert "group_sets" in bad2["error"]
        rejected = c.request({"op": "stats"})["grouped"]["rejected"]
        server._grouped_sem, server.request_timeout = threading.BoundedSemaphore(0), 0.1
        rej = c.predict_group(random_past(rng, 2), ["v"] * 2, sets)
        assert "overloaded" in rej["error"]
        assert c.request({"op": "stats"})["grouped"]["rejected"] == rejected + 1
    finally:
        server._grouped_sem, server.request_timeout = sem, timeout
        c.close()


def test_push_with_live_peer_context(crossuser):
    """A viewer behind another on the same video predicts with the
    ahead-viewer's observed path as peer futures: equal to a direct serve
    call with that context, and to the JAX daemon's answer."""
    cfg, params, fam = crossuser.cfg, crossuser.params, crossuser.fam
    ours, ref = crossuser.client(), crossuser.client("ref")
    try:
        a_poses = [[0.03 * f, 0.01 * np.sin(f / 3.0)] for f in range(20)]
        for f, p in enumerate(a_poses):
            ours.push("A", p)  # no video → sessions only
            for c in (ours, ref):
                c.request({"op": "push", "viewer": "A2", "pose": p, "video": "v", "frame": f})
        b_poses = [[0.5 - 0.02 * f, -0.2 + 0.01 * f] for f in range(5)]
        for f, p in enumerate(b_poses[:-1]):
            assert "pending" in ours.request({"op": "push", "viewer": "B", "pose": p, "video": "v", "frame": f})
            ref.request({"op": "push", "viewer": "B", "pose": p, "video": "v", "frame": f})
        last = {"op": "push", "viewer": "B", "pose": b_poses[-1], "video": "v", "frame": 4}
        r = ours.request(dict(last))
        assert r.get("peers") == 1, r
        same_reply(r, ref.request(dict(last)))
        window = np.stack([serving.pose_to_xyz(p) for p in b_poses])
        other = np.zeros((2, 4, 3), np.float32)
        other[0] = np.stack([serving.pose_to_xyz(p) for p in a_poses])[5:9]
        fn = serving.make_serve_fn(params, cfg, fam, device="cpu")
        direct = fn.unpack(fn({"past": window[None], "other_future": other[None],
                               "other_mask": np.array([[1.0, 0.0]], np.float32)}).numpy())
        np.testing.assert_allclose(r["yaw"], direct["yaw"][0], atol=1e-5)
        assert not np.allclose(r["yaw"], ours.predict(window.tolist())["yaw"])
        assert ours.stats()["peer_pool"]["tracked_viewers"] == 2
    finally:
        ours.close()
        ref.close()


def test_sessions_lru_eviction_as_jax():
    ops = [("a", [0.0, 0.0]), ("b", [0.0, 0.0]), ("c", [0.0, 0.0]), ("a", [0.1, 0.0]), ("d", [0.0, 0.0]),
           ("a", [0.2, 0.0]), ("b", [0.3, 0.1]), ("e", [1.0, 0.0, 0.0])]
    s, j = serving.ViewerSessions(h_in=2, max_viewers=3), jax_serving.ViewerSessions(h_in=2, max_viewers=3)
    for viewer, pose in ops:
        a, b = s.push(viewer, pose), j.push(viewer, pose)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
        assert len(s) == len(j) and s.n_evicted == j.n_evicted
        assert [s.missing(v) for v in "abcde"] == [j.missing(v) for v in "abcde"]
    assert s.n_evicted == 3
    with pytest.raises(ValueError, match="zero-norm"):
        s.push("z", [0.0, 0.0, 0.0])
    with pytest.raises(ValueError, match="pose must be"):
        s.push("z", [0.0])


def test_pose_to_xyz_equals_jax():
    rng = np.random.default_rng(7)
    for pose in list(rng.uniform(-1.5, 1.5, (16, 2))) + list(rng.normal(size=(16, 3))):
        np.testing.assert_array_equal(serving.pose_to_xyz(pose), jax_serving.pose_to_xyz(pose))
    yaw, pitch = rng.uniform(-np.pi, np.pi, 64), rng.uniform(-np.pi / 2, np.pi / 2, 64)
    from longterm360fov_tpu.geometry import euler_to_xyz

    np.testing.assert_allclose(geometry.euler_to_xyz_np(yaw, pitch),
                               np.asarray(euler_to_xyz(jnp.asarray(yaw), jnp.asarray(pitch))), atol=1e-6)


def test_peer_pool_coverage_and_reset_as_jax():
    pools = (serving.PeerPool(h_out=4, k=2, max_history=10), jax_serving.PeerPool(h_out=4, k=2, max_history=10))
    rng = np.random.default_rng(9)
    events = [("vid", "A", None, rng.normal(size=3).astype(np.float32)) for _ in range(12)]
    events += [("vid", "C", 2, rng.normal(size=3).astype(np.float32)), ("vid", "C", 3, rng.normal(size=3))]
    for ev in events:
        assert pools[0].observe(*ev) == pools[1].observe(*ev)

    def peers(pool, *q):
        got = pool.peers_for(*q)
        return None if got is None else (got[0].tolist(), got[1].tolist())

    for q in (("vid", "B", 3), ("vid", "B", 9), ("vid", "A", 3), ("vid", "B", 0), ("vid", "B", 1),
              ("other", "B", 3)):
        assert peers(pools[0], *q) == peers(pools[1], *q)
    fut, mask = pools[0].peers_for("vid", "B", 3)
    assert fut.shape == (2, 4, 3) and list(mask) == [1.0, 0.0]
    for pool in pools:
        pool.observe("vid", "A", 100, np.ones(3, np.float32))  # a seek resets the history
    assert peers(pools[0], "vid", "B", 3) == peers(pools[1], "vid", "B", 3) is None
    assert pools[0].stats() == pools[1].stats() == {"videos": 1, "tracked_viewers": 2}


def test_serve_daemon_grouped_warmup_and_its_refusal():
    cfg, fam = tiny_cfg("cross_user"), get_family("cross_user")
    params = params_from_numpy(jax.tree.map(np.asarray, jax_get_family("cross_user").init(
        jax.random.PRNGKey(0), jax_twin(cfg).model)), "cpu")
    server = serving.serve_daemon(params, cfg, fam, device="cpu", port=0, max_batch=4, warmup=True,
                                  grouped_warmup=[(4, 2)])
    try:
        assert server.grouped_fn is not None and server.peers is not None
    finally:
        server.server_close()
        server.batcher.stop()
    scfg = tiny_cfg()
    sparams = params_from_numpy(jax.tree.map(np.asarray, jax_get_family("seq2seq").init(
        jax.random.PRNGKey(0), jax_twin(scfg).model)), "cpu")
    with pytest.raises(ValueError, match="no grouped path"):
        serving.serve_daemon(sparams, scfg, get_family("seq2seq"), device="cpu", port=0, max_batch=8,
                             warmup=False, grouped_warmup=[(4, 2)])
    with pytest.raises(ValueError, match="impl must be one of"):
        serving.serve_daemon(sparams, scfg, get_family("seq2seq"), device="cpu", port=0, impl="plain")


# ----------------------------------------------------------------- each side's client against the other's server


@pytest.mark.parametrize("wire", ["json", "binary"])
@pytest.mark.parametrize("client_lib", ["jax", "port"])
def test_clients_cross_servers(s2s, crossuser, wire, client_lib):
    """JAX's client against the port's server, the port's client against
    JAX's: predict, predict_batch, push and stats give the replies the
    client's own side gives."""
    lib = jax_serving if client_lib == "jax" else serving
    other = "ours" if client_lib == "jax" else "ref"  # the other side's server
    own = "ref" if client_lib == "jax" else "ours"
    rng = np.random.default_rng(31)
    for pair in (s2s, crossuser):
        pasts = random_past(rng, 4)
        peers = random_past(rng, pair.cfg.n_other_users, h_in=pair.cfg.model.h_out)  # (K, h_out, 3)
        arg = (lambda a: a) if wire == "binary" else (lambda a: a.tolist())
        reqs = [{"op": "predict", "past": arg(pasts[0])},
                {"op": "predict_batch", "past": arg(pasts)}]
        if pair is crossuser:
            reqs.append({"op": "predict", "past": arg(pasts[1]), "other_future": arg(peers)})
            reqs.append({"op": "predict_batch", "past": arg(pasts[:2]), "group_key": ["v", "v"],
                         "group_sets": {"v": arg(peers)}})
        x, y = pair.client(other, wire, lib), pair.client(own, wire, lib)
        try:
            for req in reqs:
                same_reply(x.request(dict(req)), y.request(dict(req)))
            for i, pose in enumerate([[0.01 * i, 0.02] for i in range(pair.cfg.model.h_in + 1)]):
                same_reply(x.push(f"cross-{client_lib}-{wire}", pose), y.push(f"cross-{client_lib}-{wire}", pose))
            st = x.stats()
            assert {"requests", "batches", "mean_batch", "sessions"} <= st.keys()
            assert ("peer_pool" in st) == (pair is crossuser)
        finally:
            x.close()
            y.close()
