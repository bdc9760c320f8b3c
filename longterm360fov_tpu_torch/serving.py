"""Online serving: the device program and dynamic batching over concurrent
viewers.

PyTorch twin of the serve-path subset of ``longterm360fov_tpu.serving``:

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
  of the JAX package into the port's params (seq2seq, cross_user, fusion
  and transformer trees).
- the grouped gateway: :func:`group_pack`, :func:`make_grouped_serve_fn`
  (each video's peer set rides to the device once; the transformer's tier
  projects its K/V once there for the decode kernel's shared tier, the
  generic tier gathers it per row, ``gfut[gid]``, for the family's serve
  path) and :func:`grouped_predict`, the host side's pack → serve →
  unsort.

Not ported yet (ROADMAP.md): the TCP daemon, per-viewer pose windows,
hot-reload ops (slice 'the TCP daemon and CLI'), and the batcher's mesh
bucket divisor (slice 'parallelism').
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import geometry, infer, windows
from .models.fusion import FEATURE_DIM
from .params import array_to_tensor, walk

__all__ = [
    "DynamicBatcher",
    "ParamStore",
    "make_serve_fn",
    "extra_specs_for",
    "required_extras_for",
    "flat_param_items",
    "load_exported_params",
    "group_pack",
    "make_grouped_serve_fn",
    "grouped_predict",
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
    """
    device = torch.device(device)
    if impl not in infer.IMPLS:
        raise ValueError(f"impl must be one of {infer.IMPLS}, got {impl!r}")
    store = param_store if param_store is not None else ParamStore(params)
    h_out = cfg.model.h_out

    @torch.inference_mode()
    def fn(batch):
        tensors = {
            k: torch.as_tensor(v, dtype=torch.float32, device=device)
            for k, v in batch.items()
        }
        xyz = infer.predict_xyz(store.params, cfg, fam, tensors, impl=impl)
        yaw, pitch = geometry.xyz_to_euler(xyz)
        out = [yaw, pitch]
        if with_tiles:
            mask = infer.tiles_for_fov(
                xyz, tile_rows=tile_rows, tile_cols=tile_cols, fov_deg=fov_deg
            )  # (B, H_out, M)
            # union over the horizon = this tick's prefetch set
            out.append(mask.any(dim=1).float())
        return torch.cat(out, dim=-1)

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
        max_queue: Optional[int] = None,
        pipeline_depth: int = 4,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._serve = serve_fn
        self.h_in = int(h_in)
        self.extra_specs = dict(extra_specs or {})
        self.required = frozenset(required)
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
        b = 1  # ladder: 1, 2, 4, ...
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
    packed: bool = False,
    impl: str = "fused",
) -> Callable:
    """Group-shared peer serving program: ``fn(past, group_future,
    group_mask, gid) → {"yaw", "pitch", "prefetch"}`` (or, with ``packed``,
    one (B, 2·H_out + M) tensor and ``fn.unpack``), where each video's peer
    set reaches the device once instead of once per viewer. The prefetch
    mask is :func:`make_serve_fn`'s default tile grid and field of view.

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

    @torch.inference_mode()
    def fn(past, gfut, gmask, gid):
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
        out = {"yaw": yaw, "pitch": pitch, "prefetch": infer.tiles_for_fov(xyz).any(dim=1)}
        if packed:
            return torch.cat([v.float() for v in out.values()], dim=-1)
        return out

    fn.tile_b = 1
    # the input contract grouped_predict checks on the host
    fn.h_in = cfg.model.h_in
    fn.peer_span = h_out
    if packed:
        fn.unpack = lambda host: {"yaw": host[..., :h_out], "pitch": host[..., h_out:2 * h_out],
                                  "prefetch": host[..., 2 * h_out:] > 0.5}
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
