"""The host hot paths of trace ingest in C: log parsing and window copies.

Counterpart of ``longterm360fov_tpu.native``, with the semantics of its C
extension. ``csrc/fastio.c`` is plain C over caller-provided buffers (no
Python or numpy headers), compiled with the host's C compiler (``cc``,
``gcc`` or ``clang`` on PATH; ``-O3 -shared -fPIC``) at first use into
``build/host_libs/`` beside the package, under a name that carries a hash of
the source and the flags, and loaded with ``ctypes``, which releases the GIL
around each call. Where no compiler is found the first call raises and
names the compilers it looked for: nothing falls back quietly.

The numpy versions (:func:`parse_trace_plain`, :func:`window_copy_plain`,
:func:`window_fill_plain`) stay beside the C library as its plain versions;
the tests hold the two against each other and against the JAX package's.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "CC_NAMES",
    "find_cc",
    "build",
    "parse_trace_bytes",
    "parse_trace_plain",
    "window_copy",
    "window_copy_plain",
    "window_fill",
    "window_fill_plain",
]

SOURCE = Path(__file__).resolve().parent / "csrc" / "fastio.c"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "host_libs"
CC_NAMES = ("cc", "gcc", "clang")
CC_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c99")
MAX_COLS = 64
_STATUS = {
    1: "row has more than 64 numeric columns; pass n_cols",
    2: "out of memory while parsing the trace",
    3: "n_cols must be in [0, 64] (0 = infer)",
}


def find_cc() -> str:
    """The first of :data:`CC_NAMES` on PATH; raises when there is none."""
    for name in CC_NAMES:
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError(
        f"no C compiler on PATH (looked for {', '.join(CC_NAMES)}): the trace-ingest library is built "
        f"from {SOURCE} with `cc {' '.join(CC_FLAGS)}`; install one or put it on PATH"
    )


def build(build_dir: Optional[Path] = None) -> Path:
    """Compile ``csrc/fastio.c`` unless a library of the same source and
    flags is already in ``build_dir`` (default ``build/host_libs/``); the
    library's path. Concurrent builds each write their own temporary file
    and move it into place atomically."""
    build_dir = Path(build_dir or BUILD_DIR)
    key = hashlib.sha256(SOURCE.read_bytes() + "\0".join(CC_FLAGS).encode()).hexdigest()[:16]
    path = build_dir / f"fastio-{key}.so"
    if path.is_file():
        return path
    cc = find_cc()
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cc, *CC_FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True)
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cc} failed on {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    return path


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    lib.fastio_parse_trace.argtypes = [ctypes.c_char_p, i64, i64, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                                       ctypes.POINTER(i64), ctypes.POINTER(i64)]
    lib.fastio_parse_trace.restype = ctypes.c_int
    lib.fastio_free.argtypes = [ptr]
    lib.fastio_free.restype = None
    lib.fastio_window_fill.argtypes = [ptr, i64, ptr, ptr, i64, i64, i64, i64]
    lib.fastio_window_fill.restype = None
    return lib


def _check_n_cols(n_cols: int) -> None:
    # checked before either version runs, so both refuse alike
    if not 0 <= n_cols <= MAX_COLS:
        raise ValueError(_STATUS[3])


def parse_trace_bytes(data, n_cols: int = 0) -> np.ndarray:
    """Numeric log text (bytes, bytearray or memoryview) → (rows, cols)
    float32 through the C library. Skips blank lines, '#' comments and rows
    with a non-numeric token; ``n_cols`` 0 infers the width from the first
    numeric row, wider rows are truncated and narrower ones dropped."""
    _check_n_cols(n_cols)
    raw = bytes(data)
    out = ctypes.POINTER(ctypes.c_float)()
    rows, cols = ctypes.c_int64(), ctypes.c_int64()
    lib = _lib()
    status = lib.fastio_parse_trace(raw, len(raw), n_cols, ctypes.byref(out), ctypes.byref(rows),
                                    ctypes.byref(cols))
    if status:
        raise (MemoryError if status == 2 else ValueError)(_STATUS[status])
    arr = np.empty((rows.value, cols.value), np.float32)
    if out:
        ctypes.memmove(arr.ctypes.data, out, arr.nbytes)
        lib.fastio_free(out)
    return arr


def parse_trace_plain(data, n_cols: int = 0) -> np.ndarray:
    """The plain version of :func:`parse_trace_bytes`: Python's ``float``
    per token, the JAX package's numpy fallback."""
    _check_n_cols(n_cols)
    rows = []
    for line in bytes(data).decode("utf-8", "replace").splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            vals = [float(p) for p in line.replace(",", " ").split()]
        except ValueError:
            continue
        if n_cols and len(vals) < n_cols:
            continue
        rows.append(vals)
    if not rows:
        return np.zeros((0, n_cols), np.float32)
    # the width is n_cols, or the first numeric row's; longer rows are
    # truncated, shorter ones dropped
    width = n_cols or len(rows[0])
    return np.asarray([r[:width] for r in rows if len(r) >= width], np.float32)


def _fill_checks(trace, past_out, future_out, h_in, stride) -> np.ndarray:
    """The C extension's checks of ``window_fill``, in its order; the trace
    as C-contiguous float32."""
    if stride < 1 or h_in < 1:
        raise ValueError("h_in and stride must be >= 1")
    trace = np.ascontiguousarray(trace, np.float32)
    if past_out is not None and not isinstance(past_out, np.ndarray):
        raise TypeError("past must be an ndarray or None")
    if not isinstance(future_out, np.ndarray):
        raise TypeError("future must be an ndarray")
    for o in (past_out, future_out):
        if o is not None and (o.dtype != np.float32 or o.ndim != 3 or not o.flags.c_contiguous
                              or not o.flags.writeable):
            raise ValueError("outputs must be writable C-contiguous float32 (N,h,D)")
    if trace.ndim != 2:
        raise ValueError("trace must be (T, D)")
    (t, d), (n, h_out) = trace.shape, future_out.shape[:2]
    if future_out.shape[2] != d or (past_out is not None and past_out.shape != (n, h_in, d)):
        raise ValueError("shape mismatch between trace/outputs")
    if n > 0 and (n - 1) * stride + h_in + h_out > t:
        raise ValueError(f"trace length {t} too short for {n} windows")
    return trace


def window_fill(trace, past_out: Optional[np.ndarray], future_out: np.ndarray, h_in: int, stride: int = 1) -> None:
    """Fill preallocated C-contiguous float32 (N, h_in, D) past and
    (N, h_out, D) future windows of a (T, D) trace in place, through the C
    library; ``past_out=None`` fills only the futures, offset by ``h_in``
    (the peer path)."""
    trace = _fill_checks(trace, past_out, future_out, h_in, stride)
    n, h_out = future_out.shape[:2]
    _lib().fastio_window_fill(trace.ctypes.data, trace.shape[1],
                              None if past_out is None else past_out.ctypes.data, future_out.ctypes.data,
                              n, h_in, h_out, stride)


def window_fill_plain(trace, past_out: Optional[np.ndarray], future_out: np.ndarray, h_in: int,
                      stride: int = 1) -> None:
    """The plain version of :func:`window_fill`: a ``sliding_window_view``
    copy."""
    trace = _fill_checks(trace, past_out, future_out, h_in, stride)
    n, h_out = future_out.shape[:2]
    win = np.lib.stride_tricks.sliding_window_view(trace, h_in + h_out, axis=0).transpose(0, 2, 1)[::stride][:n]
    if past_out is not None:
        np.copyto(past_out, win[:, :h_in])
    np.copyto(future_out, win[:, h_in:])


def _copy_shapes(trace, h_in, h_out, stride):
    if stride < 1 or h_in < 1 or h_out < 1:
        raise ValueError("h_in, h_out, stride must be >= 1")
    trace = np.ascontiguousarray(trace, np.float32)
    if trace.ndim != 2:
        raise ValueError("trace must be (T, D)")
    t, d = trace.shape
    if t < h_in + h_out:
        raise ValueError(f"trace length {t} < window span {h_in + h_out}")
    n = (t - h_in - h_out) // stride + 1
    return trace, np.empty((n, h_in, d), np.float32), np.empty((n, h_out, d), np.float32)


def window_copy(trace, h_in: int, h_out: int, stride: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """(T, D) trace → packed ((N, h_in, D), (N, h_out, D)) float32 windows,
    N = (T - h_in - h_out) // stride + 1, through the C library."""
    trace, past, future = _copy_shapes(trace, h_in, h_out, stride)
    window_fill(trace, past, future, h_in, stride)
    return past, future


def window_copy_plain(trace, h_in: int, h_out: int, stride: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """The plain version of :func:`window_copy`."""
    trace, past, future = _copy_shapes(trace, h_in, h_out, stride)
    window_fill_plain(trace, past, future, h_in, stride)
    return past, future
