"""Online serving: the device program, dynamic batching over concurrent
viewers and the TCP daemon.

PyTorch twin of ``longterm360fov_tpu.serving``:

- :func:`make_serve_fn` — the whole serve path as one callable on the
  device of the params: normalize → encode → H_out-step autoregressive
  decode → denormalize → xyz→(yaw, pitch) → horizon-union prefetch mask,
  through the fused CUDA serve kernel (``impl="fused"``) or the plain
  PyTorch path (``impl="plain"``).
- :class:`DynamicBatcher` — coalesces concurrent requests into ONE device
  dispatch (copied from the JAX package; only the readback differs), with
  the per-request extras of the family's schema (:func:`extra_specs_for`,
  :func:`required_extras_for`): the cross_user peer futures and their mask,
  zero-filled when a request has none, and the fusion features, which every
  request must carry. Padding rows are copies of a real request row and are
  sliced off before results are returned, so co-batching never changes any
  viewer's answer.
- :func:`load_exported_params` — loads the flat dotted-key ``export`` npz
  (the JAX package's or the port's) into the port's params (seq2seq,
  cross_user, fusion and transformer trees).
- the grouped gateway: :func:`group_pack`, :func:`make_grouped_serve_fn`
  (each video's peer set rides to the device once; the transformer's tier
  projects its K/V once there for the decode kernel's shared tier, the
  generic tier gathers it per row, ``gfut[gid]``, for the family's serve
  path) and :func:`grouped_predict`, the host side's pack → serve →
  unsort.
- the daemon, host-side Python copied from the JAX package:
  :class:`ViewerSessions` (per-viewer rolling pose windows, LRU eviction),
  :class:`PeerPool` (per-video trajectories → live peer futures), the
  binary wire (:func:`encode_frame`, :func:`read_frame`: byte for byte the
  JAX package's frames, so either side's client talks to either side's
  server), :class:`FovServer` (line JSON and binary frames on one port) and
  :class:`FovClient`, and :func:`serve_daemon`, which builds them around a
  :class:`ParamStore` and the packed serve program. All device work runs on
  the batcher's dispatcher thread, except grouped bulk requests, which run
  on their handler thread behind a bounded semaphore.

With a serving ``mesh`` (a list of devices, ``parallel.serve``) the serve
program splits every dispatch into equal slices, one per device, and the
batcher's buckets are multiples of the mesh's size (its ``divisor``).
"""

from __future__ import annotations

import json
import queue
import socket
import socketserver
import struct
import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import geometry, infer, windows
from .models.fusion import FEATURE_DIM
from .params import array_to_tensor, params_device, walk

__all__ = [
    "encode_frame",
    "read_frame",
    "DynamicBatcher",
    "ParamStore",
    "PeerPool",
    "ViewerSessions",
    "pose_to_xyz",
    "FovServer",
    "FovClient",
    "make_serve_fn",
    "extra_specs_for",
    "required_extras_for",
    "flat_param_items",
    "load_exported_params",
    "group_pack",
    "make_grouped_serve_fn",
    "grouped_predict",
    "serve_daemon",
]


# --------------------------------------------------------------------------
# device program
# --------------------------------------------------------------------------


class ParamStore:
    """Mutable holder for the current params: the serve program reads
    ``.params`` at every dispatch, so swapping them hot-reloads the model."""

    def __init__(self, params):
        self.params = params
        self.version = 0

    def swap(self, params):
        self.params = params  # atomic attribute store
        self.version += 1


def make_serve_fn(
    params,
    cfg,
    fam,
    *,
    device,
    with_tiles: bool = True,
    tile_rows: int = 6,
    tile_cols: int = 12,
    fov_deg: float = 90.0,
    impl: str = "fused",
    param_store: Optional[ParamStore] = None,
    mesh=None,
) -> Callable:
    """One serve program: batch dict of host arrays ("past" and the
    family's extras, see :func:`extra_specs_for`) → ONE packed
    ``(B, 2*H_out[+M])`` f32 tensor on ``device``, where the params must be:
    yaw, pitch and, with ``with_tiles``, the prefetch mask as 0/1. One
    output buffer means one device→host copy. The returned callable's
    ``.unpack`` turns the host copy into ``{"yaw", "pitch", ["prefetch"]}``
    numpy arrays; the DynamicBatcher calls it on every readback.

    ``param_store`` makes the returned callable read its params from the
    store at every dispatch instead of the ``params`` snapshot.

    With ``mesh`` (a list of devices, which may repeat one) every batch
    splits into ``len(mesh)`` equal contiguous slices, each served on its
    device with the params replicated there (again after a reload), and the
    packed results are gathered in order on ``device``; the batch size must
    then be a multiple of the mesh's size, which the DynamicBatcher
    guarantees with ``divisor=len(mesh)``. Predictions are viewer-local, so
    the slices exchange nothing.
    """
    device = torch.device(device)
    if impl not in infer.IMPLS:
        raise ValueError(f"impl must be one of {infer.IMPLS}, got {impl!r}")
    store = param_store if param_store is not None else ParamStore(params)
    h_out = cfg.model.h_out

    def packed(params, batch, dev):
        tensors = {
            k: torch.as_tensor(v, dtype=torch.float32, device=dev)
            for k, v in batch.items()
        }
        xyz = infer.predict_xyz(params, cfg, fam, tensors, impl=impl)
        yaw, pitch = geometry.xyz_to_euler(xyz)
        out = [yaw, pitch]
        if with_tiles:
            mask = infer.tiles_for_fov(
                xyz, tile_rows=tile_rows, tile_cols=tile_cols, fov_deg=fov_deg
            )  # (B, H_out, M)
            # union over the horizon = this tick's prefetch set
            out.append(mask.any(dim=1).float())
        return torch.cat(out, dim=-1)

    if mesh is None:

        @torch.inference_mode()
        def fn(batch):
            return packed(store.params, batch, device)

    else:
        from .parallel.serve import gather, mesh_devices, replicate_params, shard_slices, take_rows

        devices = mesh_devices(mesh)
        replicas = {"version": None, "params": None}

        @torch.inference_mode()
        def fn(batch):
            version = store.version  # read before the params: a swap in between re-replicates next time
            if replicas["version"] != version:
                replicas.update(version=version, params=replicate_params(store.params, devices))
            slices = shard_slices(len(batch["past"]), len(devices))
            return gather([
                packed(replicas["params"][d], {k: take_rows(v, rows) for k, v in batch.items()}, d)
                for d, rows in zip(devices, slices)
            ], device)

    def unpack(host: np.ndarray) -> Dict[str, np.ndarray]:
        out = {
            "yaw": host[..., :h_out],
            "pitch": host[..., h_out : 2 * h_out],
        }
        if with_tiles:
            out["prefetch"] = host[..., 2 * h_out :] > 0.5
        return out

    fn.unpack = unpack
    return fn


def extra_specs_for(cfg) -> Dict[str, Tuple[int, ...]]:
    """Per-request extra-array schema for the preset's model family, as the
    JAX ``serving.extra_specs_for`` gives it. Mask-gated extras (peer
    futures) may be omitted: zero-fill and a zero validity mask is exactly
    the no-context model. Extras with no validity mask (fusion's
    ``features``) are required in every request; see
    :func:`required_extras_for`."""
    fam = cfg.model_family
    if fam in ("cross_user", "transformer") and cfg.n_other_users > 0:
        k, t = cfg.n_other_users, cfg.model.h_out
        return {"other_future": (k, t, 3), "other_mask": (k,)}
    if fam == "fusion":
        return {"features": (FEATURE_DIM,)}
    return {}


def required_extras_for(cfg) -> frozenset:
    """Extras every request must carry: those without a validity mask.
    Zero-filled fusion features are not the no-context model, so omitting
    them is an error, never a silent zero-fill."""
    return frozenset(
        name for name in extra_specs_for(cfg) if name not in ("other_future", "other_mask")
    )


def flat_param_items(params):
    """(dotted-path key, leaf) pairs for a params tree — the same keys the
    JAX ``serving.flat_param_items`` gives for the same structure, which
    are the ``export`` npz's keys."""
    items = []
    walk(params, lambda k, leaf: items.append((k, leaf)))
    return items


def load_exported_params(npz_path: str, cfg, fam, *, device):
    """Rebuild the params from an ``export``-ed flat npz onto ``device``.

    Inverse of the JAX ``cli.cmd_export``: init a skeleton with the
    family's ``init`` (structure + dtypes only), then replace every leaf by
    its dotted-path key from the npz, in the skeleton's dtype: a ``--bf16``
    model's skeleton is bf16, and its npz leaves, which plain numpy reads as
    ``|V2``, are read as bf16 (``params.array_to_tensor``; JAX's loader
    cannot cast ``|V2``). Errors out on any missing/extra key or shape
    mismatch, with the JAX loader's errors — a silent partial load would
    serve garbage predictions."""
    skeleton = fam.init(torch.Generator().manual_seed(0), cfg.model, device="cpu")
    keys = set()
    with np.load(npz_path) as loaded:

        def leaf(key, like):
            if key not in loaded.files:
                raise KeyError(
                    f"exported npz {npz_path!r} is missing param {key!r} — "
                    f"was it exported for preset {cfg.name!r}?"
                )
            arr = loaded[key]
            if arr.shape != tuple(like.shape):
                raise ValueError(
                    f"param {key!r}: npz shape {arr.shape} != model shape "
                    f"{tuple(like.shape)} (wrong preset/architecture)"
                )
            keys.add(key)
            return array_to_tensor(arr, device, like.dtype)

        params = walk(skeleton, leaf)
        extra = set(loaded.files) - keys
    if extra:
        raise KeyError(f"exported npz has unknown params: {sorted(extra)}")
    return params


# --------------------------------------------------------------------------
# dynamic batcher
# --------------------------------------------------------------------------


class _Pending:
    """One queued unit of work: ``n`` request rows sharing one waiter.

    ``arrays`` values always carry a leading row axis (n, ...) so the
    dispatcher can concatenate single-viewer and bulk entries into one
    device batch with no per-row Python work. ``n == 1`` entries get
    their results delivered squeezed (per-row arrays), bulk entries get
    the (n, ...) slice."""

    __slots__ = ("arrays", "n", "event", "result", "error", "t_submit")

    def __init__(self, arrays, n=1):
        self.arrays = arrays
        self.n = n
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.t_submit = time.monotonic()


class DynamicBatcher:
    """Coalesce concurrent single-viewer requests into bucketed batches.

    One dispatcher thread owns the device: it drains the queue, waits up
    to ``max_wait_ms`` for co-arrivals (classic latency/throughput
    knob), pads the batch up the power-of-two bucket ladder, runs
    ``serve_fn`` once, and distributes per-row results. Padding
    replicates row 0 (real data → no NaN/denormal risk) and is sliced
    off before delivery.

    Dispatch is PIPELINED: CUDA launches are asynchronous, so the
    dispatcher only *launches* the serve program and hands the output
    tensors to a completion thread, which blocks on the device→host
    readback (``.cpu()``) and delivers per-row results. Up to
    ``pipeline_depth`` batches may be awaiting readback while the
    dispatcher forms and launches the next one — this overlaps host
    stacking work with device compute. ``pipeline_depth=1`` still
    permits one launch while one readback is in flight; the completion
    queue's bound provides backpressure so device work cannot pile up
    unboundedly."""

    def __init__(
        self,
        serve_fn: Callable,
        *,
        h_in: int,
        extra_specs: Optional[Dict[str, Tuple[int, ...]]] = None,
        required: frozenset = frozenset(),
        max_batch: int = 256,
        max_wait_ms: float = 2.0,
        divisor: int = 1,
        max_queue: Optional[int] = None,
        pipeline_depth: int = 4,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if divisor < 1 or max_batch % divisor:
            raise ValueError(
                f"max_batch {max_batch} must be a positive multiple of "
                f"divisor {divisor} (= mesh data size for sharded serving)"
            )
        self._serve = serve_fn
        self.h_in = int(h_in)
        self.extra_specs = dict(extra_specs or {})
        self.required = frozenset(required)
        self.divisor = int(divisor)
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        # admission control: a bounded queue turns overload into an
        # immediate "overloaded" rejection instead of unbounded latency
        # (default depth: 8 saturated batches of headroom)
        self.max_queue = int(max_queue) if max_queue else 8 * self.max_batch
        self._q: "queue.Queue[Optional[_Pending]]" = queue.Queue(
            maxsize=self.max_queue + 1  # +1 slot reserved for the sentinel
        )
        # admission is counted in ROWS (a bulk entry is n rows of device
        # work), tracked here because Queue.qsize counts entries
        self._queued_rows = 0
        self._lock = threading.Lock()
        # metrics
        self.n_requests = 0
        self.n_batches = 0
        self.n_rejected = 0
        self.rows_padded = 0
        self.rows_total = 0
        self._latencies = deque(maxlen=2048)
        # launched-but-not-read-back batches; the bound is the
        # pipelining backpressure (dispatcher blocks on put when full)
        self.pipeline_depth = max(1, int(pipeline_depth))
        self._inflight: "queue.Queue" = queue.Queue(
            maxsize=self.pipeline_depth
        )
        self._stopped = False
        # one completer per pipeline slot: concurrent device→host
        # readbacks overlap each other's latency
        self._completers = [
            threading.Thread(
                target=self._complete_loop,
                name=f"fov-completer-{i}",
                daemon=True,
            )
            for i in range(self.pipeline_depth)
        ]
        for t in self._completers:
            t.start()
        self._thread = threading.Thread(
            target=self._loop, name="fov-batcher", daemon=True
        )
        self._thread.start()

    # -- client side --------------------------------------------------

    def _extras(self, arrays, extras, lead: Tuple[int, ...]):
        """Fill ``arrays`` with the extras of ``extra_specs``, each with the
        leading shape ``lead`` (() for one request, (n,) for a bulk one):
        missing → zeros; fewer peers than the preset's K → zero rows; the
        default mask, only when the caller gave none, is "valid where a peer
        row is nonzero" (an explicit all-zero mask means "present but
        disabled" and is kept)."""
        supplied = {k for k, v in extras.items() if v is not None}
        missing_req = self.required - supplied
        if missing_req:
            raise ValueError(
                f"this daemon's model family requires extras "
                f"{sorted(missing_req)} in every request (they have no "
                f"validity mask, so zero-fill would be wrong, not 'absent')"
            )
        for name, shape in self.extra_specs.items():
            given = extras.pop(name, None)
            if given is None:
                arrays[name] = np.zeros(lead + shape, np.float32)
                continue
            given = np.asarray(given, np.float32)
            peers = len(lead)  # the K axis of other_future
            if name == "other_future" and given.ndim == len(lead) + 3 and (
                given.shape[peers] < shape[0]
            ):  # fewer peers than the preset's K → pad; the mask gates them
                pad = np.zeros(lead + (shape[0] - given.shape[peers],) + shape[1:], np.float32)
                given = np.concatenate([given, pad], axis=peers)
            if given.shape != lead + shape:
                raise ValueError(
                    f"extra {name!r} must have shape {lead + shape}, got {given.shape}"
                )
            arrays[name] = given
        if extras:
            raise ValueError(f"unknown extras: {sorted(extras)}")
        if ("other_mask" in self.extra_specs and "other_mask" not in supplied
                and "other_future" in supplied):
            axes = tuple(range(len(lead) + 1, len(lead) + 3))
            arrays["other_mask"] = (
                np.abs(arrays["other_future"]).max(axis=axes) > 0
            ).astype(np.float32)
        return arrays

    def submit(self, past: np.ndarray, **extras) -> _Pending:
        """Queue one request. ``past`` is (h_in, 3) xyz; extras follow
        ``extra_specs`` (missing → zeros, and the mask, when the schema has
        one, stays zero so the model sees "no context")."""
        past = np.asarray(past, np.float32)
        if past.shape != (self.h_in, 3):
            raise ValueError(
                f"past must be ({self.h_in}, 3) xyz, got {past.shape}"
            )
        arrays = self._extras({"past": past}, extras, ())
        p = _Pending({k: v[None] for k, v in arrays.items()})
        self._enqueue(p)
        return p

    def submit_many(self, pasts: np.ndarray, **extras) -> list:
        """Queue N windows as bulk entries (the gateway `predict_batch`
        path): ONE waiter per ≤``max_batch`` chunk instead of one per
        window, so a 4096-window request costs a handful of queue and
        dispatch operations rather than 4096 Python round trips through
        the coalescing loop. Extras follow ``extra_specs`` with a leading N
        axis. Returns the list of pending chunks in row order; each result
        holds the ``(chunk_rows, ...)`` output slice."""
        pasts = np.ascontiguousarray(np.asarray(pasts, np.float32))
        if pasts.ndim != 3 or pasts.shape[1:] != (self.h_in, 3):
            raise ValueError(
                f"pasts must be (N, {self.h_in}, 3) xyz, got {pasts.shape}"
            )
        n = pasts.shape[0]
        if n == 0:
            raise ValueError("empty bulk request")
        arrays = self._extras({"past": pasts}, extras, (n,))
        pendings = []
        for ofs in range(0, n, self.max_batch):
            chunk = {k: v[ofs:ofs + self.max_batch] for k, v in arrays.items()}
            p = _Pending(chunk, n=chunk["past"].shape[0])
            self._enqueue(p)
            pendings.append(p)
        return pendings

    def _enqueue(self, p: _Pending):
        if self._stopped:
            raise RuntimeError("batcher is stopped")
        with self._lock:
            if self._queued_rows + p.n > self.max_queue:
                self.n_rejected += p.n
                raise RuntimeError(
                    f"overloaded: {self._queued_rows} rows already queued "
                    f"of {self.max_queue} max (retry with backoff)"
                )
            self._queued_rows += p.n
        try:
            self._q.put_nowait(p)
        except queue.Full:  # sentinel slot contention — treat as overload
            with self._lock:
                self._queued_rows -= p.n
                self.n_rejected += p.n
            raise RuntimeError(
                f"overloaded: {self.max_queue} rows already queued "
                f"(retry with backoff)"
            ) from None

    def predict(self, past: np.ndarray, timeout: float = 30.0, **extras):
        """submit + wait: → dict of per-request numpy arrays."""
        p = self.submit(past, **extras)
        if not p.event.wait(timeout):
            raise TimeoutError("prediction timed out")
        if p.error is not None:
            raise p.error
        return p.result

    # -- dispatcher ----------------------------------------------------

    def _bucket(self, n: int) -> int:
        b = self.divisor  # ladder: divisor, 2·divisor, 4·divisor, ...
        while b < n:
            b *= 2
        return min(b, self.max_batch)

    def _take(self, timeout=None):
        """Dequeue one entry (or the sentinel), maintaining the row
        count the admission check reads."""
        p = (
            self._q.get()
            if timeout is None
            else self._q.get(timeout=timeout)
        )
        if p is not None:
            with self._lock:
                self._queued_rows -= p.n
        return p

    def _loop(self):
        carry = None
        while True:
            first = carry if carry is not None else self._take()
            carry = None
            if first is None:
                return
            batch = [first]
            rows = first.n
            deadline = time.monotonic() + self.max_wait_s
            while rows < self.max_batch:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    nxt = self._take(timeout=left)
                except queue.Empty:
                    break
                if nxt is None:
                    self._launch(batch)
                    return
                if rows + nxt.n > self.max_batch:
                    carry = nxt  # would burst the bucket cap → next batch
                    break
                batch.append(nxt)
                rows += nxt.n
            self._launch(batch)

    def _launch(self, batch):
        """Stack + launch the serve program (async) and enqueue its
        output tensors for the completion thread. Blocks only when
        ``pipeline_depth`` batches are already awaiting readback."""
        n = sum(p.n for p in batch)
        b = self._bucket(n)
        try:
            stacked = {}
            for key in batch[0].arrays:
                blocks = [p.arrays[key] for p in batch]
                if b > n:  # pad with copies of row 0 (sliced off below)
                    row0 = blocks[0][:1]
                    blocks.append(
                        np.broadcast_to(row0, (b - n,) + row0.shape[1:])
                    )
                stacked[key] = (
                    np.concatenate(blocks)
                    if len(blocks) > 1
                    else np.ascontiguousarray(blocks[0])
                )
            out = self._serve(stacked)
        except Exception as e:  # noqa: BLE001 — deliver to all waiters
            self._deliver_error(batch, b, e)
            return
        self._inflight.put((batch, b, out))

    def _complete_loop(self):
        while True:
            item = self._inflight.get()
            if item is None:
                return
            batch, b, out = item
            try:
                # the packed output: ONE device→host fetch
                host = self._serve.unpack(out.cpu().numpy())
                ofs = 0
                for p in batch:
                    if p.n == 1:  # single request: per-row arrays
                        p.result = {k: v[ofs] for k, v in host.items()}
                    else:  # bulk chunk: the (n, ...) slice
                        p.result = {
                            k: v[ofs:ofs + p.n] for k, v in host.items()
                        }
                    ofs += p.n
                    p.event.set()
            except Exception as e:  # noqa: BLE001 — device-side failure
                self._deliver_error(batch, b, e)
                continue
            self._account(batch, b)

    def _deliver_error(self, batch, b, e):
        for p in batch:
            p.error = e
            p.event.set()
        self._account(batch, b)

    def _account(self, batch, b):
        now = time.monotonic()
        rows = sum(p.n for p in batch)
        with self._lock:
            self.n_requests += rows
            self.n_batches += 1
            self.rows_total += b
            self.rows_padded += b - rows
            for p in batch:
                self._latencies.append(now - p.t_submit)

    def stats(self) -> Dict:
        with self._lock:
            lat = sorted(self._latencies)
            pct = (
                lambda q: round(lat[min(int(q * len(lat)), len(lat) - 1)] * 1e3, 3)
                if lat
                else None
            )
            return {
                "requests": self.n_requests,
                "rejected": self.n_rejected,
                "queue_depth": self._queued_rows,
                "inflight": self._inflight.qsize(),
                "batches": self.n_batches,
                "mean_batch": round(self.n_requests / max(self.n_batches, 1), 2),
                "pad_fraction": round(
                    self.rows_padded / max(self.rows_total, 1), 4
                ),
                "latency_ms_p50": pct(0.50),
                "latency_ms_p95": pct(0.95),
                "latency_ms_p99": pct(0.99),
            }

    def stop(self):
        if not self._stopped:
            self._stopped = True
            self._q.put(None)
            self._thread.join(timeout=10)
            # dispatcher is done launching; flush the completion pipeline
            for _ in self._completers:
                self._inflight.put(None)
            for t in self._completers:
                t.join(timeout=30)
            # a submit() racing past the _stopped check can land behind
            # the sentinel — fail those fast instead of letting their
            # waiters sit out the full timeout
            while True:
                try:
                    p = self._q.get_nowait()
                except queue.Empty:
                    break
                if p is not None:
                    p.error = RuntimeError("batcher is stopped")
                    p.event.set()


# --------------------------------------------------------------------------
# peer-group packing and the grouped gateway
# --------------------------------------------------------------------------


def group_pack(group_keys, tile_b: int = 128):
    """Arrange batch rows into group-pure ``tile_b`` tiles (copied from the
    JAX package). ``group_keys``: length-B hashables (e.g. video ids); rows
    with equal keys share one peer set. Returns ``(perm, gid, inv, uniq)``:

    * ``perm`` (B_packed,) int32: indices into the original rows (gather
      inputs with ``past[perm]``); each group's segment is padded to a
      multiple of ``tile_b`` by repeating the group's first row;
    * ``gid`` (B_packed,) int32: packed row → group index;
    * ``inv`` (B,) int32: original row i's position in the packed batch
      (un-sort outputs with ``out_packed[inv]``);
    * ``uniq``: the group keys in gid order."""
    keys = list(group_keys)
    uniq: list = []
    index: dict = {}
    rows_by_group: list = []
    for i, k in enumerate(keys):
        g = index.get(k)
        if g is None:
            g = index[k] = len(uniq)
            uniq.append(k)
            rows_by_group.append([])
        rows_by_group[g].append(i)
    perm, gid = [], []
    inv = np.empty(len(keys), np.int32)
    for g, rows in enumerate(rows_by_group):
        for r in rows:
            inv[r] = len(perm)
            perm.append(r)
        pad = (-len(rows)) % tile_b
        perm.extend([rows[0]] * pad)
        gid.extend([g] * (len(rows) + pad))
    return np.asarray(perm, np.int32), np.asarray(gid, np.int32), inv, uniq


def make_grouped_serve_fn(
    params,
    cfg,
    fam,
    *,
    device,
    with_tiles: bool = True,
    tile_rows: int = 6,
    tile_cols: int = 12,
    fov_deg: float = 90.0,
    param_store: Optional[ParamStore] = None,
    packed: bool = False,
    impl: str = "fused",
) -> Callable:
    """Group-shared peer serving program: ``fn(past, group_future,
    group_mask, gid) → {"yaw", "pitch"[, "prefetch"]}`` (or, with
    ``packed``, one (B, 2·H_out[+M]) tensor and ``fn.unpack``), where each
    video's peer set reaches the device once instead of once per viewer.
    ``with_tiles``, ``tile_rows``, ``tile_cols``, ``fov_deg`` and
    ``param_store`` mean what they mean in :func:`make_serve_fn`: the
    prefetch mask, and the store the program reads its params from at every
    call (the daemon's "reload" op swaps them).

    Inputs are the :func:`group_pack` layout: ``past`` (B_packed, h_in, 3)
    raw xyz, ``group_future`` (G, K, h_out, 3) raw shared peer sets in group
    order, ``group_mask`` (G, K) validity, ``gid`` (B_packed,) row → group;
    arrays or tensors, moved to ``device``.

    Two tiers, as in the JAX ``make_grouped_serve_fn``:

    * the transformer with ``impl="fused"``: ``serve_fused`` on the raw
      group sets with each row's group id and anchor, so each group's peer
      K/V is projected once and the decode kernel's shared tier attends it,
      the per-row anchoring carried by the δv correction;
    * every other case, the generic tier: the per-row peer tensor is
      gathered on the device (``gfut[gid]``), then the family's
      ``batch_extras`` (each row's anchor) and its serve path run
      unchanged: ``serve_fused`` for ``impl="fused"`` (the lockstep-peer
      kernels under ``peer_align``), ``apply`` for ``"plain"``.

    Same math as per-row serving. Both read the group id per row, so no
    tile purity is needed (``fn.tile_b = 1``) and no group is padded."""
    from .train import default_extras

    device = torch.device(device)
    if impl not in infer.IMPLS:
        raise ValueError(f"impl must be one of {infer.IMPLS}, got {impl!r}")
    shared_kv = cfg.model_family == "transformer" and impl == "fused"
    extras_fn = getattr(fam, "batch_extras", None) or default_extras
    # behaviour probe, not cfg.n_other_users (K is a serving-time knob): a
    # family that ignores "other_future" would serve every request peerless
    probe = extras_fn(
        {"other_future": torch.zeros((1, 1, 1, 3)), "other_mask": torch.ones((1, 1))},
        torch.zeros((1, 1, 3)),
    )
    if not probe:
        raise ValueError(
            f"preset {cfg.name!r} ({cfg.model_family!r}) consumes no peer context — grouped "
            f"serving has nothing to share; use make_serve_fn"
        )
    h_out = cfg.model.h_out
    store = param_store if param_store is not None else ParamStore(params)

    @torch.inference_mode()
    def fn(past, gfut, gmask, gid):
        params = store.params
        past, gfut, gmask = (torch.as_tensor(x, dtype=torch.float32, device=device)
                             for x in (past, gfut, gmask))
        gid = torch.as_tensor(gid, dtype=torch.long, device=device)
        past_n, _, anchor = windows.normalize_window(past)
        if shared_kv:
            pred_n = fam.serve_fused(params, cfg.model, past_n.contiguous(), group_future_n=gfut,
                                     group_mask=gmask, peer_gid=gid, peer_anchor=anchor[:, 0])
        elif impl == "fused":
            kw = extras_fn({"other_future": gfut[gid], "other_mask": gmask[gid]}, anchor)
            pred_n = fam.serve_fused(params, cfg.model, past_n.contiguous(), **kw)
        else:
            kw = extras_fn({"other_future": gfut[gid], "other_mask": gmask[gid]}, anchor)
            pred_n = fam.apply(params, cfg.model, past_n, None, **kw)
        xyz = windows.denormalize_window(pred_n, anchor, to_sphere=True)
        yaw, pitch = geometry.xyz_to_euler(xyz)
        out = {"yaw": yaw, "pitch": pitch}
        if with_tiles:
            out["prefetch"] = infer.tiles_for_fov(
                xyz, tile_rows=tile_rows, tile_cols=tile_cols, fov_deg=fov_deg).any(dim=1)
        if packed:
            return torch.cat([v.float() for v in out.values()], dim=-1)
        return out

    fn.tile_b = 1
    # the input contract grouped_predict checks on the host
    fn.h_in = cfg.model.h_in
    fn.peer_span = h_out
    if packed:
        def unpack(host: np.ndarray) -> Dict[str, np.ndarray]:
            out = {"yaw": host[..., :h_out], "pitch": host[..., h_out:2 * h_out]}
            if with_tiles:
                out["prefetch"] = host[..., 2 * h_out:] > 0.5
            return out

        fn.unpack = unpack
    return fn


def grouped_predict(
    fn: Callable,
    pasts: np.ndarray,
    group_keys,
    group_sets: Dict,
    group_masks: Optional[Dict] = None,
) -> Dict[str, np.ndarray]:
    """Host side of grouped serving, as the JAX ``grouped_predict``:
    :func:`group_pack` the batch, pad the packed rows and the group count up
    power-of-two ladders, run ``fn`` (a :func:`make_grouped_serve_fn`
    program), and un-sort the outputs to the caller's row order.

    ``pasts`` (N, h_in, 3) raw xyz; ``group_keys`` length-N hashables;
    ``group_sets``: key → (K, h_out, 3) raw shared peer windows;
    ``group_masks``: key → (K,) validity (default: peers with any nonzero
    frame). Row padding repeats the last packed row; group padding appends
    zero-mask sets no row points at."""
    pasts = np.ascontiguousarray(np.asarray(pasts, np.float32))
    keys = list(group_keys)
    if len(keys) != pasts.shape[0]:
        raise ValueError(f"{pasts.shape[0]} windows but {len(keys)} group keys")
    h_in = getattr(fn, "h_in", None)
    if h_in is not None and pasts.shape[1:] != (h_in, 3):
        raise ValueError(f"past windows must be (N, {h_in}, 3), got {pasts.shape}")
    span = getattr(fn, "peer_span", None)
    if span is not None:
        for k, v in group_sets.items():
            v = np.asarray(v)
            if v.ndim != 3 or v.shape[1] != span or v.shape[2] != 3:
                raise ValueError(f"group_sets[{k!r}] must be (K, {span}, 3), got {v.shape}")
    tile_b = getattr(fn, "tile_b", 128)
    perm, gid, inv, uniq = group_pack(keys, tile_b)
    missing = [k for k in uniq if k not in group_sets]
    if missing:
        raise KeyError(f"group_sets missing peer sets for {missing}")
    gfut = np.stack([np.asarray(group_sets[k], np.float32) for k in uniq])  # (G, K, T, 3)
    if group_masks is None:
        gmask = (np.abs(gfut).max(axis=(2, 3)) > 0).astype(np.float32)
    else:
        gmask = np.stack([np.asarray(group_masks[k], np.float32) for k in uniq])
    past_p = pasts[perm]
    # batch bucket ladder: padded rows extend the last group's segment
    bp = past_p.shape[0]
    bucket = tile_b
    while bucket < bp:
        bucket *= 2
    if bucket > bp:
        past_p = np.concatenate([past_p, np.broadcast_to(past_p[-1:], (bucket - bp,) + past_p.shape[1:])])
        gid = np.concatenate([gid, np.full(bucket - bp, gid[-1], np.int32)])
    # group bucket ladder: zero-mask sets no row's gid reaches
    g = gfut.shape[0]
    gb = 1
    while gb < g:
        gb *= 2
    if gb > g:
        gfut = np.concatenate([gfut, np.zeros((gb - g,) + gfut.shape[1:], np.float32)])
        gmask = np.concatenate([gmask, np.zeros((gb - g, gmask.shape[1]), np.float32)])
    out = fn(past_p, gfut, gmask, gid)
    unpack = getattr(fn, "unpack", None)
    if unpack is not None:
        host = unpack(out.cpu().numpy())
    else:
        host = {k: v.cpu().numpy() for k, v in out.items()}
    return {k: v[inv] for k, v in host.items()}


# --------------------------------------------------------------------------
# per-viewer session state (host-side numpy, copied from the JAX package)
# --------------------------------------------------------------------------


def pose_to_xyz(pose) -> np.ndarray:
    """[yaw, pitch] radians or [x, y, z] (renormalized) → unit xyz."""
    pose = np.asarray(pose, np.float32)
    if pose.shape == (2,):
        return geometry.euler_to_xyz_np(float(pose[0]), float(pose[1]))
    if pose.shape == (3,):
        n = float(np.linalg.norm(pose))
        if n < 1e-6:
            raise ValueError("zero-norm xyz pose")
        return pose / n
    raise ValueError(
        f"pose must be [yaw, pitch] or [x, y, z], got shape {pose.shape}"
    )


class ViewerSessions:
    """Rolling (h_in, 3) pose windows keyed by viewer id.

    ``push`` accepts a pose as xyz ([x, y, z], renormalized) or as
    radians ([yaw, pitch]) and returns the full window once h_in poses
    have arrived, else None. Host-side numpy only — no device traffic
    until a window is complete. At ``max_viewers`` live sessions the
    least-recently-active one is evicted (viewers churn; disconnected
    clients never send "drop", so a hard table-full error would lock
    new viewers out of a long-running daemon forever)."""

    def __init__(self, h_in: int, max_viewers: int = 100_000):
        self.h_in = int(h_in)
        self.max_viewers = int(max_viewers)
        self.n_evicted = 0
        self._lock = threading.Lock()
        self._buf: "OrderedDict[str, deque]" = OrderedDict()

    def push(self, viewer: str, pose) -> Optional[np.ndarray]:
        xyz = pose_to_xyz(pose)
        with self._lock:
            dq = self._buf.get(viewer)
            if dq is None:
                while len(self._buf) >= self.max_viewers:
                    self._buf.popitem(last=False)  # evict LRU
                    self.n_evicted += 1
                dq = deque(maxlen=self.h_in)
                self._buf[viewer] = dq
            else:
                self._buf.move_to_end(viewer)
            dq.append(xyz)
            if len(dq) < self.h_in:
                return None
            return np.stack(tuple(dq))

    def missing(self, viewer: str) -> int:
        with self._lock:
            dq = self._buf.get(viewer)
            return self.h_in - (len(dq) if dq else 0)

    def drop(self, viewer: str):
        with self._lock:
            self._buf.pop(viewer, None)

    def __len__(self):
        with self._lock:
            return len(self._buf)


class PeerPool:
    """Online cross-user context: with on-demand video, other viewers
    watching the same title ahead of you have already traced the frames you
    are about to see — their observed head paths over your prediction
    horizon are the "peer futures" the cross_user and transformer families
    condition on. This pool indexes every viewer's observed trajectory per
    video and answers "who covers frames [t+1, t+h_out] right now?" so the
    daemon can attach real peer context to live requests.

    Host-side numpy only; bounded memory via per-viewer history caps
    (oldest frames drop) and LRU viewer eviction per video."""

    def __init__(
        self,
        h_out: int,
        k: int,
        *,
        max_history: int = 8192,
        max_viewers_per_video: int = 4096,
    ):
        self.h_out = int(h_out)
        self.k = int(k)
        self.max_history = int(max_history)
        self.max_viewers_per_video = int(max_viewers_per_video)
        self._lock = threading.Lock()
        # video -> OrderedDict(viewer -> [start_frame, list[xyz rows]])
        self._videos: Dict[str, "OrderedDict"] = {}

    def observe(
        self, video: str, viewer: str, frame: Optional[int], xyz: np.ndarray
    ) -> int:
        """Record that ``viewer`` looked at ``xyz`` on ``video``'s frame
        ``frame`` (None = next contiguous frame). Contiguous frames
        append; a gap or rewind restarts the viewer's history at the new
        position (seeks are normal in VoD). Returns the frame recorded."""
        with self._lock:
            vid = self._videos.setdefault(video, OrderedDict())
            ent = vid.get(viewer)
            if ent is None:
                while len(vid) >= self.max_viewers_per_video:
                    vid.popitem(last=False)
                ent = [0 if frame is None else int(frame), []]
                vid[viewer] = ent
            else:
                vid.move_to_end(viewer)
            start, rows = ent
            frame = start + len(rows) if frame is None else int(frame)
            if frame != start + len(rows):  # gap or rewind → restart
                ent[0] = frame
                rows.clear()
            rows.append(np.asarray(xyz, np.float32))
            if len(rows) > self.max_history:
                drop = len(rows) - self.max_history
                del rows[:drop]
                ent[0] += drop
            return frame

    def peers_for(
        self, video: str, viewer: str, frame: int
    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Peer futures for ``viewer`` about to watch frames
        [frame+1, frame+h_out] of ``video`` → (other_future (K, h_out, 3),
        other_mask (K,)), or None when nobody covers the span."""
        lo, span = int(frame) + 1, self.h_out
        fut = np.zeros((self.k, span, 3), np.float32)
        mask = np.zeros((self.k,), np.float32)
        found = 0
        with self._lock:
            vid = self._videos.get(video)
            if not vid:
                return None
            for other, (start, rows) in vid.items():
                if other == viewer:
                    continue
                a = lo - start
                if a < 0 or a + span > len(rows):
                    continue
                fut[found] = rows[a:a + span]
                mask[found] = 1.0
                found += 1
                if found == self.k:
                    break
        return (fut, mask) if found else None

    def stats(self) -> Dict:
        with self._lock:
            return {
                "videos": len(self._videos),
                "tracked_viewers": sum(len(v) for v in self._videos.values()),
            }


# --------------------------------------------------------------------------
# binary wire frames, the bulk path's fast wire (the JAX package's format)
# --------------------------------------------------------------------------
#
#   frame   := b"FoVB" | u32 header_len | header | payload
#   header  := UTF-8 JSON of the request/reply dict, with every ndarray
#              value replaced by a manifest entry under "__bin__":
#              [{"path": [key, ...], "dtype": "<f4", "shape": [...]}, ...]
#   payload := the arrays' raw bytes, concatenated in manifest order
#
# Both wire forms are served on the same port and may interleave on one
# connection: the handler sniffs the first byte ('{' = JSON line, 'F' =
# binary frame). Binary requests get binary replies (yaw/pitch f32,
# prefetch as a u8 tile mask instead of index lists).

_BIN_MAGIC = b"FoVB"
_BIN_HDR = struct.Struct("<I")
_BIN_MAX_HEADER = 16 << 20  # 16 MB of JSON header
_BIN_MAX_PAYLOAD = 1 << 30  # 1 GB of array payload per frame
# dtype allow-list: fixed-width little-endian numerics only (never object
# or structured dtypes — a hostile manifest must not be able to allocate
# arbitrary Python objects)
_BIN_DTYPES = ("<f4", "<f8", "<i4", "<i8", "|u1", "|b1")


def _strip_arrays(node, path, manifest, chunks):
    """Replace ndarray leaves with manifest entries; return the JSON node."""
    if isinstance(node, np.ndarray):
        arr = np.ascontiguousarray(node)
        if arr.dtype.str not in _BIN_DTYPES:
            if arr.dtype == np.bool_:
                arr = arr.astype(np.uint8)
            elif np.issubdtype(arr.dtype, np.floating):
                arr = arr.astype("<f4")
            elif np.issubdtype(arr.dtype, np.integer):
                arr = arr.astype("<i4")
            else:
                raise TypeError(f"cannot wire dtype {arr.dtype} at {path}")
        manifest.append(
            {"path": path, "dtype": arr.dtype.str, "shape": list(arr.shape)}
        )
        chunks.append(arr.tobytes())
        return None  # placeholder; decode re-attaches by path
    if isinstance(node, dict):
        return {
            k: _strip_arrays(v, path + [k], manifest, chunks)
            for k, v in node.items()
        }
    return node


def encode_frame(obj: Dict) -> bytes:
    """Encode a request/reply dict (ndarray values allowed anywhere in
    the nested-dict structure) as one binary wire frame."""
    manifest: list = []
    chunks: list = []
    clean = _strip_arrays(obj, [], manifest, chunks)
    clean["__bin__"] = manifest
    header = json.dumps(clean).encode()
    return b"".join(
        [_BIN_MAGIC, _BIN_HDR.pack(len(header)), header, *chunks]
    )


def _read_exact(rfile, n: int) -> bytes:
    buf = rfile.read(n)
    if len(buf) != n:
        raise ConnectionError(
            f"stream ended mid-frame ({len(buf)}/{n} bytes)"
        )
    return buf


def read_frame(rfile, first: bytes = b"") -> Dict:
    """Read one binary frame from a buffered stream and rebuild the dict
    (arrays re-attached at their manifest paths as numpy views). ``first``
    carries magic bytes a protocol sniffer already consumed."""
    magic = first + _read_exact(rfile, len(_BIN_MAGIC) - len(first))
    if magic != _BIN_MAGIC:
        raise ValueError(f"bad frame magic {magic!r}")
    (hlen,) = _BIN_HDR.unpack(_read_exact(rfile, _BIN_HDR.size))
    if hlen > _BIN_MAX_HEADER:
        raise ValueError(f"frame header {hlen} bytes exceeds the cap")
    obj = json.loads(_read_exact(rfile, hlen))
    manifest = obj.pop("__bin__", [])
    total = 0
    for ent in manifest:
        if ent["dtype"] not in _BIN_DTYPES:
            raise ValueError(f"dtype {ent['dtype']!r} not on the wire whitelist")
        shape = ent["shape"]
        if not all(isinstance(d, int) and 0 <= d <= _BIN_MAX_PAYLOAD
                   for d in shape):
            # a negative dim would make the payload length negative and
            # turn the exact read into a read-to-EOF (handler hang)
            raise ValueError(f"bad shape {shape} in frame manifest")
        n = 1
        for d in shape:  # Python ints: no silent int64 overflow
            n *= d
        total += n * np.dtype(ent["dtype"]).itemsize
        if total > _BIN_MAX_PAYLOAD:
            raise ValueError(
                f"frame payload {total} bytes exceeds the cap"
            )
    payload = _read_exact(rfile, total)
    off = 0
    for ent in manifest:
        dt = np.dtype(ent["dtype"])
        shape = tuple(ent["shape"])
        n = 1
        for d in shape:
            n *= d
        arr = np.frombuffer(payload, dt, count=n, offset=off).reshape(shape)
        off += n * dt.itemsize
        node = obj
        *parents, leaf = ent["path"]
        for key in parents:
            nxt = node.get(key)
            if not isinstance(nxt, dict):
                nxt = {}
                node[key] = nxt
            node = nxt
        node[leaf] = arr
    return obj


# --------------------------------------------------------------------------
# transport: line-delimited JSON and binary frames over TCP
# --------------------------------------------------------------------------


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        srv: "FovServer" = self.server  # type: ignore[assignment]
        while True:
            first = self.rfile.read(1)
            if not first:
                break
            if first in (b"\n", b"\r", b" "):
                continue
            if first == _BIN_MAGIC[:1]:
                # binary frame (fast wire). A frame that fails to DECODE
                # desyncs the byte stream, so answer and close; a request
                # that fails to DISPATCH leaves the stream clean, so
                # answer and keep serving (same contract as JSON lines).
                try:
                    req = read_frame(self.rfile, first=first)
                except Exception as e:  # noqa: BLE001 — the reply carries it
                    self.wfile.write(encode_frame(
                        {"id": None,
                         "error": f"{type(e).__name__}: {e}"}
                    ))
                    self.wfile.flush()
                    break
                try:
                    resp = srv.dispatch_op(req, raw_arrays=True)
                except Exception as e:  # noqa: BLE001 — the reply carries it
                    resp = {
                        "id": req.get("id"),
                        "error": f"{type(e).__name__}: {e}",
                    }
                self.wfile.write(encode_frame(resp))
                self.wfile.flush()
                continue
            raw = (first + self.rfile.readline()).strip()
            if not raw:
                continue
            try:
                req = json.loads(raw)
                resp = srv.dispatch_op(req)
            except Exception as e:  # noqa: BLE001 — protocol errors answer inline
                rid = None
                try:
                    rid = json.loads(raw).get("id")
                except Exception:  # noqa: BLE001
                    pass
                resp = {"id": rid, "error": f"{type(e).__name__}: {e}"}
            self.wfile.write((json.dumps(resp) + "\n").encode())
            self.wfile.flush()


class FovServer(socketserver.ThreadingTCPServer):
    """Line-JSON and binary-frame TCP front end over a
    :class:`DynamicBatcher`, with the JAX package's ops (one request a line
    or frame, echoing "id"):

      {"op": "predict", "id", "past": [[x,y,z] × h_in],
       "other_future"?: [[...] × K], "other_mask"?: [K],
       "features"?: [F]}                        → yaw/pitch (+ prefetch)
      {"op": "push", "id", "viewer", "pose": [yaw,pitch]|[x,y,z],
       "video"?: str, "frame"?: int}            → a prediction once the
                                                  viewer's window fills,
                                                  else {"pending": k}; with
                                                  "video" (peer-consuming
                                                  families) the pose also
                                                  feeds the PeerPool and the
                                                  answer conditions on the
                                                  viewers ahead in that
                                                  video ("peers": how many)
      {"op": "predict_batch", "id", "past": [[[x,y,z] × h_in] × N],
       extras? batched likewise}                → N predictions in one
                                                  round trip (the windows
                                                  still coalesce in the
                                                  shared batcher)
      … with "group_key": [key × N],
       "group_sets": {key: [[...] × K]},
       "group_masks"?: {key: [K]}               → group-shared peer serving:
                                                  one peer copy per video
                                                  crosses the wire and the
                                                  host-to-device copy
      {"op": "stats", "id"}                     → batcher + session stats
      {"op": "drop", "id", "viewer"}            → forget a session
      {"op": "reload", "id", "path": npz}       → hot-swap params from an
                                                  `export` npz (checked
                                                  against the preset's
                                                  architecture first)
    """

    daemon_threads = True
    allow_reuse_address = True
    # the stdlib's listen backlog is 5: a burst of simultaneous connects
    # (64 closed-loop clients arriving together) would overflow it and the
    # kernel would reset the excess connections
    request_queue_size = 128

    def __init__(
        self,
        addr: Tuple[str, int],
        batcher: DynamicBatcher,
        *,
        request_timeout: float = 30.0,
        reload_ctx: Optional[Tuple[ParamStore, object, object]] = None,
        grouped_fn: Optional[Callable] = None,
        grouped_inflight: int = 4,
    ):
        super().__init__(addr, _Handler)
        self.batcher = batcher
        self.sessions = ViewerSessions(batcher.h_in)
        self.request_timeout = request_timeout
        self.reload_ctx = reload_ctx  # (param_store, cfg, fam) or None
        # grouped requests dispatch on the handler thread (they bypass the
        # DynamicBatcher: group composition varies per request): bound how
        # many run at once so a burst cannot stack unbounded device work or
        # stalled threads, and account them for "stats"
        self._grouped_sem = threading.BoundedSemaphore(grouped_inflight)
        self._grouped_lock = threading.Lock()
        self._grouped_requests = 0
        self._grouped_windows = 0
        self._grouped_rejected = 0
        self._grouped_lat = deque(maxlen=1024)
        self.grouped_fn = grouped_fn
        # live cross-user context: when the family consumes peer futures,
        # push requests carrying a "video" feed the pool and viewers behind
        # others on the same video predict with real peer context
        self.peers: Optional[PeerPool] = None
        if "other_future" in batcher.extra_specs:
            k, h_out = batcher.extra_specs["other_future"][:2]
            self.peers = PeerPool(h_out, k)
        self.t_start = time.monotonic()

    # -- ops ------------------------------------------------------------
    # (named dispatch_op, not handle_request: BaseServer.handle_request()
    # is an inherited zero-argument stdlib API)

    def dispatch_op(self, req: Dict, *, raw_arrays: bool = False) -> Dict:
        op = req.get("op", "predict")
        rid = req.get("id")
        if op == "predict":
            extras = {
                k: req[k]
                for k in self.batcher.extra_specs
                if req.get(k) is not None
            }
            res = self.batcher.predict(
                np.asarray(req["past"], np.float32),
                timeout=self.request_timeout,
                **extras,
            )
            return self._prediction(rid, res, raw=raw_arrays)
        if op == "predict_batch":
            return self._predict_batch(req, rid, raw_arrays)
        if op == "push":
            viewer = str(req["viewer"])
            xyz = pose_to_xyz(req["pose"])
            window = self.sessions.push(viewer, xyz)
            frame = None
            if self.peers is not None and req.get("video") is not None:
                frame = self.peers.observe(
                    str(req["video"]), viewer, req.get("frame"), xyz
                )
            if window is None:
                return {"id": rid, "pending": self.sessions.missing(viewer)}
            extras = {}
            n_peers = 0
            if frame is not None:
                got = self.peers.peers_for(str(req["video"]), viewer, frame)
                if got is not None:
                    extras = {"other_future": got[0], "other_mask": got[1]}
                    n_peers = int(got[1].sum())
            res = self.batcher.predict(
                window, timeout=self.request_timeout, **extras
            )
            out = self._prediction(rid, res, raw=raw_arrays)
            if self.peers is not None:
                out["peers"] = n_peers
            return out
        if op == "stats":
            return self._stats(rid)
        if op == "drop":
            self.sessions.drop(str(req["viewer"]))
            return {"id": rid, "dropped": True}
        if op == "reload":
            if self.reload_ctx is None:
                raise ValueError(
                    "this server was built without reload support "
                    "(serve_daemon wires it automatically)"
                )
            store, cfg, fam = self.reload_ctx
            # checks structure and shapes before the swap: a bad npz errors
            # here and the old params keep serving
            new_params = load_exported_params(
                str(req["path"]), cfg, fam, device=params_device(store.params)
            )
            store.swap(new_params)
            return {"id": rid, "reloaded": True, "version": store.version}
        raise ValueError(f"unknown op {op!r}")

    def _predict_batch(self, req: Dict, rid, raw: bool) -> Dict:
        """The bulk path: one request carries N windows (and optional
        per-window extras, or group-shared peer sets), one reply carries N
        predictions. Per-row windows ride the shared batcher, so bulk and
        single-viewer traffic coalesce together."""
        pasts = np.asarray(req["past"], np.float32)
        if pasts.ndim != 3:
            raise ValueError(
                f"predict_batch past must be (N, h_in, 3), got "
                f"shape {pasts.shape}"
            )
        gkeys = req.get("group_key")
        if gkeys is not None:
            # group-shared peers: "group_key" names each row's video,
            # "group_sets" maps key → (K, h_out, 3) raw shared peer windows
            # (+ optional "group_masks")
            sets = {
                k: np.asarray(v, np.float32)
                for k, v in (req.get("group_sets") or {}).items()
            }
            masks = req.get("group_masks")
            if masks is not None:
                masks = {
                    k: np.asarray(v, np.float32)
                    for k, v in masks.items()
                }
            if self.grouped_fn is not None:
                # admission: wait up to the request timeout for a dispatch
                # slot, then reject loudly (the client can back off)
                # instead of stacking handler threads
                if not self._grouped_sem.acquire(
                    timeout=self.request_timeout
                ):
                    with self._grouped_lock:
                        self._grouped_rejected += 1
                    raise RuntimeError(
                        "grouped path overloaded; retry with backoff"
                    )
                t0 = time.monotonic()
                try:
                    host = grouped_predict(
                        self.grouped_fn, pasts, gkeys, sets, masks
                    )
                finally:
                    self._grouped_sem.release()
                with self._grouped_lock:
                    self._grouped_requests += 1
                    self._grouped_windows += pasts.shape[0]
                    self._grouped_lat.append(time.monotonic() - t0)
                return self._bulk_reply(rid, host, raw=raw)
            # a server built without the grouped program: expand the shared
            # sets to per-row extras and ride the normal bulk path (the
            # same answers, per-row transfer cost)
            missing = [k for k in dict.fromkeys(gkeys) if k not in sets]
            if missing:
                raise KeyError(
                    f"group_sets missing peer sets for {missing}"
                )
            extras_all = {
                "other_future": np.stack([sets[k] for k in gkeys])
            }
            if masks is not None:
                extras_all["other_mask"] = np.stack(
                    [masks[k] for k in gkeys]
                )
        else:
            extras_all = {
                k: np.asarray(req[k], np.float32)
                for k in self.batcher.extra_specs
                if req.get(k) is not None
            }
        pending = self.batcher.submit_many(pasts, **extras_all)
        parts = []
        deadline = time.monotonic() + self.request_timeout
        for p in pending:
            if not p.event.wait(max(deadline - time.monotonic(), 0)):
                raise TimeoutError("prediction timed out")
            if p.error is not None:
                raise p.error
            parts.append(p.result)
        host = {
            k: (
                np.concatenate([r[k] for r in parts])
                if len(parts) > 1
                else parts[0][k]
            )
            for k in parts[0]
        }
        return self._bulk_reply(rid, host, raw=raw)

    def _stats(self, rid) -> Dict:
        s = self.batcher.stats()
        s.update(
            {
                "id": rid,
                "sessions": len(self.sessions),
                "uptime_s": round(time.monotonic() - self.t_start, 1),
            }
        )
        if self.peers is not None:
            s["peer_pool"] = self.peers.stats()
        if self.grouped_fn is not None:
            # grouped traffic bypasses the batcher: without this block a
            # grouped-heavy daemon looks idle in "stats"
            with self._grouped_lock:
                lat = sorted(self._grouped_lat)
                g = {
                    "requests": self._grouped_requests,
                    "windows": self._grouped_windows,
                    "rejected": self._grouped_rejected,
                }
            if lat:
                pick = lambda q: round(  # noqa: E731
                    lat[int(q * (len(lat) - 1))] * 1e3, 3
                )
                g["latency_ms_p50"] = pick(0.50)
                g["latency_ms_p95"] = pick(0.95)
                g["latency_ms_p99"] = pick(0.99)
            s["grouped"] = g
        return s

    @staticmethod
    def _prediction(rid, res: Dict, raw: bool = False) -> Dict:
        if raw:
            # binary wire: f32 trajectories + u8 tile mask, no rounding,
            # no Python lists (encode_frame copies them out)
            out = {
                "id": rid,
                "yaw": np.asarray(res["yaw"], np.float32),
                "pitch": np.asarray(res["pitch"], np.float32),
            }
            if "prefetch" in res:
                out["prefetch"] = np.asarray(
                    res["prefetch"]
                ).astype(np.uint8)
            return out
        out = {
            "id": rid,
            "yaw": np.round(
                np.asarray(res["yaw"], np.float64), 6
            ).tolist(),
            "pitch": np.round(
                np.asarray(res["pitch"], np.float64), 6
            ).tolist(),
        }
        if "prefetch" in res:
            out["prefetch"] = np.flatnonzero(res["prefetch"]).tolist()
        return out

    @staticmethod
    def _bulk_reply(rid, host: Dict, raw: bool = False) -> Dict:
        if raw:
            out = {
                "id": rid,
                "yaw": host["yaw"].astype(np.float32, copy=False),
                "pitch": host["pitch"].astype(np.float32, copy=False),
            }
            if "prefetch" in host:
                out["prefetch"] = host["prefetch"].astype(np.uint8)
            return out
        out = {
            "id": rid,
            "yaw": np.round(host["yaw"].astype(np.float64), 6).tolist(),
            "pitch": np.round(
                host["pitch"].astype(np.float64), 6
            ).tolist(),
        }
        if "prefetch" in host:
            out["prefetch"] = [
                np.flatnonzero(row).tolist() for row in host["prefetch"]
            ]
        return out


class FovClient:
    """Blocking client (one in-flight request per connection; open
    several clients — or threads with one client each — to exercise
    server-side batching).

    ``wire="json"`` (default) speaks line-JSON; ``wire="binary"`` speaks
    the :func:`encode_frame` fast wire — request values may then be numpy
    arrays (sent as raw bytes) and replies come back with numpy arrays
    (``yaw``/``pitch`` f32, ``prefetch`` a u8 tile mask instead of index
    lists). Both wires hit the same server ops on one port."""

    def __init__(
        self,
        host: str,
        port: int,
        timeout: float = 30.0,
        wire: str = "json",
    ):
        if wire not in ("json", "binary"):
            raise ValueError(f"wire must be 'json' or 'binary', got {wire!r}")
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._rfile = self._sock.makefile("rb")
        self._lock = threading.Lock()
        self._next_id = 0
        self._wire = wire

    def request(self, obj: Dict) -> Dict:
        with self._lock:
            if "id" not in obj:
                self._next_id += 1
                obj = {**obj, "id": self._next_id}
            if self._wire == "binary":
                self._sock.sendall(encode_frame(obj))
                return read_frame(self._rfile)
            self._sock.sendall((json.dumps(obj) + "\n").encode())
            line = self._rfile.readline()
            if not line:
                raise ConnectionError("server closed the connection")
            return json.loads(line)

    def predict(self, past, **extras) -> Dict:
        return self.request({"op": "predict", "past": past, **extras})

    def predict_group(
        self, pasts, group_key, group_sets, group_masks=None
    ) -> Dict:
        """Bulk predict in the grouped wire form: each video's peer set
        crosses the wire once. ``pasts`` (N, h_in, 3), ``group_key``
        length-N video ids, ``group_sets`` id → (K, h_out, 3) raw peer
        windows. With ``wire="binary"`` pass numpy arrays; with JSON pass
        lists."""
        req = {
            "op": "predict_batch", "past": pasts,
            "group_key": list(group_key), "group_sets": dict(group_sets),
        }
        if group_masks is not None:
            req["group_masks"] = dict(group_masks)
        return self.request(req)

    def push(self, viewer: str, pose) -> Dict:
        return self.request({"op": "push", "viewer": viewer, "pose": pose})

    def stats(self) -> Dict:
        return self.request({"op": "stats"})

    def close(self):
        try:
            self._sock.close()
        finally:
            self._rfile.close()


# --------------------------------------------------------------------------
# daemon entry point (used by the CLI)
# --------------------------------------------------------------------------

# serve_daemon's impl: JAX's names. "auto" is the fused route wherever the
# tensors are (the kernels on the card, their plain versions on the CPU),
# "xla" the plain PyTorch path
DAEMON_IMPLS = ("auto", "xla", "fused")


def serve_daemon(
    params,
    cfg,
    fam,
    *,
    device,
    host: str = "127.0.0.1",
    port: int = 8360,
    max_batch: int = 256,
    max_wait_ms: float = 2.0,
    with_tiles: bool = True,
    tile_rows: int = 6,
    tile_cols: int = 12,
    fov_deg: float = 90.0,
    impl: str = "auto",
    mesh=None,
    warmup: bool = True,
    pipeline_depth: int = 4,
    grouped: bool = True,
    grouped_warmup: Optional[list] = None,
) -> FovServer:
    """Build the packed serve program, the batcher and the TCP server on
    ``device``, where ``params`` must be (not yet serving: call
    ``serve_forever()``, or serve it from a thread). With ``warmup`` every
    rung of the bucket ladder (divisor, 2·divisor, … ``max_batch``) runs
    once before the socket opens, so no live request pays a first launch
    (the kernels' build, the allocator's first blocks). ``mesh`` (a list of
    devices) splits every dispatch over its devices (:func:`make_serve_fn`),
    and the ladder's divisor is its size (1 without). The server answers
    "reload": hot-swap params from a new `export` npz through the
    :class:`ParamStore` the programs read at every dispatch.

    Peer-consuming families also get the grouped program
    (:func:`make_grouped_serve_fn`) for grouped ``predict_batch`` requests,
    when not sharded over a ``mesh``; ``grouped_warmup`` lists ``(n_rows,
    n_groups)`` pairs to run once on it before the socket opens."""
    if impl not in DAEMON_IMPLS:
        raise ValueError(f"impl must be one of {DAEMON_IMPLS}, got {impl!r}")
    impl = "plain" if impl == "xla" else "fused"
    device = torch.device(device)
    store = ParamStore(params)
    tiles = dict(with_tiles=with_tiles, tile_rows=tile_rows, tile_cols=tile_cols, fov_deg=fov_deg)
    serve_fn = make_serve_fn(params, cfg, fam, device=device, impl=impl, param_store=store, mesh=mesh, **tiles)
    specs = extra_specs_for(cfg)
    divisor = 1 if mesh is None else len(mesh)
    want_grouped = grouped and "other_future" in specs and mesh is None
    if grouped_warmup and not want_grouped:
        raise ValueError(
            "grouped_warmup given but this server has no grouped path "
            "(peerless preset, grouped=False, or mesh-sharded daemon)"
        )
    if warmup:
        h_in = cfg.model.h_in
        b = divisor
        while True:
            dummy = {"past": np.zeros((b, h_in, 3), np.float32)}
            dummy["past"][..., 0] = 1.0  # on-sphere
            for name, shape in specs.items():
                dummy[name] = np.zeros((b,) + shape, np.float32)
            serve_fn(dummy).cpu()  # packed: a single output tensor
            if b >= max_batch:
                break
            b = min(b * 2, max_batch)
    batcher = DynamicBatcher(
        serve_fn,
        h_in=cfg.model.h_in,
        extra_specs=specs,
        required=required_extras_for(cfg),
        max_batch=max_batch,
        max_wait_ms=max_wait_ms,
        divisor=divisor,
        pipeline_depth=pipeline_depth,
    )
    grouped_fn = None
    if want_grouped:
        grouped_fn = make_grouped_serve_fn(
            params, cfg, fam, device=device, param_store=store, packed=True, impl=impl, **tiles,
        )
        if grouped_warmup:
            k, t = specs["other_future"][:2]
            for n_rows, n_groups in grouped_warmup:
                pasts = np.zeros((int(n_rows), cfg.model.h_in, 3), np.float32)
                pasts[..., 0] = 1.0  # on-sphere
                peers = np.zeros((k, t, 3), np.float32)
                peers[..., 0] = 1.0
                keys = [f"_warm{i % int(n_groups)}" for i in range(int(n_rows))]
                sets = {f"_warm{i}": peers for i in range(int(n_groups))}
                grouped_predict(grouped_fn, pasts, keys, sets)
    return FovServer(
        (host, port), batcher, reload_ctx=(store, cfg, fam),
        grouped_fn=grouped_fn,
    )
