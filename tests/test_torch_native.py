"""The port's trace-ingest C library (``native``: ``csrc/fastio.c`` over
ctypes) against the JAX package's C extension and its numpy fallback, and
against its own plain versions: ``parse_trace_bytes`` and
``window_fill``/``window_copy`` bit-equal on the cases of
tests/test_native.py and on seeded traces; the checks that refuse bad
arguments; the build, which raises naming the compiler where there is none."""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)
import os
from pathlib import Path

import numpy as np
import pytest

from longterm360fov_tpu import native as jax_native
from longterm360fov_tpu.windows import make_windows
from longterm360fov_tpu_torch import native

PARSE_CASES = [
    (b"# comment\nt,qw,qx,qy,qz\n0.0,1,0,0,0\n0.1, 0.99, 0.0,0.0, 0.1\n", 0),  # header and comment skipped
    (b"0.0 1.0 2.0 3.0\n0.1 4.0 5.0 6.0 99.0\n", 0),  # width of the first row, longer rows truncated
    (b"# c\n1 2 3\n4 5\n6 7 8 9\n", 0),  # a short row dropped, a long one truncated
    (b"1 2 3\n4 5 junk\n7 8 9\n", 0),  # a non-numeric token drops the row
    (b"1.0 2.0 3.0\n4.0 5.0 6.5", 0),  # no trailing newline
    (b"0,1,2,3,4\n5,6,7,8,9,10\n", 3),  # an explicit width truncates
    (b"", 4),
    (b"", 0),
    (b"\r\n  \t\n1e-3,\t-2.5E+2 ,16\r\n3 4 5\n", 0),  # CRLF, tabs, exponents
    (b"1 2 3\n" + b" ".join(str(i).encode() for i in range(70)) + b"\n", 0),  # width from the first row
]


def _seeded_log(rows, seed):
    rng = np.random.default_rng(seed)
    arr = rng.normal(size=(rows, 6)) * [10, 1e9, 1, 1, 1, 1]
    return "\n".join(",".join(f"{v:.9g}" for v in r) for r in arr).encode()


@pytest.mark.parametrize("case", range(len(PARSE_CASES)))
def test_parse_trace_is_bit_equal_to_jax_c_extension_and_fallback(case):
    data, n_cols = PARSE_CASES[case]
    assert jax_native.HAVE_NATIVE  # the JAX package's extension is built in this checkout
    ours = native.parse_trace_bytes(data, n_cols)
    plain = native.parse_trace_plain(data, n_cols)
    assert ours.dtype == plain.dtype == np.float32
    np.testing.assert_array_equal(ours, jax_native.parse_trace_bytes(data, n_cols))
    np.testing.assert_array_equal(ours, jax_native._parse_trace_fallback(data, n_cols))
    np.testing.assert_array_equal(ours, plain)


@pytest.mark.parametrize("seed", [0, 1])
def test_parse_trace_of_a_seeded_log(seed):
    """2000 rows of 9-digit values: float64 parsing rounded once to float32
    on every side."""
    data = _seeded_log(2000, seed)
    ours = native.parse_trace_bytes(data)
    assert ours.shape == (2000, 6)
    np.testing.assert_array_equal(ours, jax_native.parse_trace_bytes(data))
    np.testing.assert_array_equal(ours, native.parse_trace_plain(data))


def test_parse_trace_takes_an_unterminated_memoryview():
    buf = bytearray(b"1.0 2.0 3.0\n4.0 5.0 6.5")
    ours = native.parse_trace_bytes(memoryview(buf))
    np.testing.assert_array_equal(ours, jax_native.parse_trace_bytes(memoryview(buf)))
    np.testing.assert_array_equal(ours, native.parse_trace_plain(memoryview(buf)))


def test_parse_trace_refuses_what_the_c_extension_refuses():
    row = " ".join(str(i) for i in range(70)).encode()
    for fn in (native.parse_trace_bytes, jax_native.parse_trace_bytes):
        with pytest.raises(ValueError, match="more than 64"):
            fn(row)
    np.testing.assert_array_equal(native.parse_trace_bytes(row, 5), jax_native.parse_trace_bytes(row, 5))
    for bad in (-1, 65):
        for fn in (native.parse_trace_bytes, native.parse_trace_plain, jax_native.parse_trace_bytes):
            with pytest.raises(ValueError, match=r"n_cols must be in \[0, 64\]"):
                fn(b"1 2 3\n", n_cols=bad)


@pytest.mark.parametrize("stride", [1, 2, 5])
@pytest.mark.parametrize("d", [3, 4])
def test_window_fill_is_bit_equal_to_jax_and_plain(stride, d):
    rng = np.random.default_rng(stride * 10 + d)
    trace = rng.normal(size=(60, d)).astype(np.float32)
    wb = make_windows(trace, 7, 9, stride)
    n = len(wb.past)
    outs = {}
    for name, fill in (("c", native.window_fill), ("plain", native.window_fill_plain),
                       ("jax", jax_native.window_fill)):
        past = np.full((n, 7, d), np.nan, np.float32)
        fut = np.full((n, 9, d), np.nan, np.float32)
        fill(trace, past, fut, 7, stride)
        peer = np.full((n, 9, d), np.nan, np.float32)
        fill(trace, None, peer, 7, stride)  # the peer path: futures only
        outs[name] = (past, fut, peer)
    for name in ("c", "plain"):
        for a, b in zip(outs[name], outs["jax"]):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(outs["c"][0], wb.past)
    np.testing.assert_array_equal(outs["c"][1], wb.future)
    np.testing.assert_array_equal(outs["c"][2], wb.future)


@pytest.mark.parametrize("stride", [1, 3])
def test_window_copy_is_bit_equal_to_jax_and_plain(stride):
    trace = np.random.default_rng(0).normal(size=(50, 3))  # float64 in: copied to float32
    ref = jax_native.window_copy(trace, 10, 5, stride)
    for fn in (native.window_copy, native.window_copy_plain):
        got = fn(trace, 10, 5, stride)
        for a, b in zip(got, ref):
            assert a.dtype == np.float32 and a.flags.c_contiguous
            np.testing.assert_array_equal(a, b)


def test_window_checks_refuse_what_the_c_extension_refuses():
    trace = np.zeros((20, 3), np.float32)
    cases = [
        (ValueError, lambda f: f(trace, None, np.empty((19, 9, 3), np.float32), 7, 1)),  # too many windows
        (ValueError, lambda f: f(trace, np.empty((2, 7, 2), np.float32), np.empty((2, 9, 3), np.float32), 7, 1)),
        (ValueError, lambda f: f(trace, None, np.empty((4, 9, 6), np.float32)[:, :, :3], 7, 1)),  # strided output
        (ValueError, lambda f: f(trace, None, np.empty((2, 9, 3), np.float64), 7, 1)),
        (ValueError, lambda f: f(trace, None, np.empty((2, 9, 3), np.float32), 0, 1)),
        (ValueError, lambda f: f(trace, None, np.empty((2, 9, 3), np.float32), 7, 0)),
        (TypeError, lambda f: f(trace, None, [[0.0]], 7, 1)),
    ]
    for exc, call in cases:
        for fill in (native.window_fill, native.window_fill_plain, jax_native.window_fill):
            with pytest.raises(exc):
                call(fill)
    for fn in (native.window_copy, native.window_copy_plain, jax_native.window_copy):
        with pytest.raises(ValueError):
            fn(np.zeros((5, 3), np.float32), 10, 10)


def test_build_without_a_compiler_raises_naming_it(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match=r"no C compiler on PATH \(looked for cc, gcc, clang\)"):
        native.build(tmp_path / "libs")
    assert not (tmp_path / "libs").exists()


def test_build_is_keyed_by_the_source_and_reused(tmp_path):
    """The library is built from the port's own source into the directory
    given, under a name that carries its hash; a second build reuses it."""
    assert native.SOURCE.parent.parent == Path(native.__file__).parent
    first = native.build(tmp_path)
    assert first.parent == tmp_path and first.name.startswith("fastio-") and first.suffix == ".so"
    mtime = os.stat(first).st_mtime_ns
    assert native.build(tmp_path) == first and os.stat(first).st_mtime_ns == mtime
    assert [p.name for p in tmp_path.iterdir()] == [first.name]  # no temporary file left
