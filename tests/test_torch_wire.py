"""The port's binary wire against the JAX package's: ``encode_frame`` gives
the same bytes for the same objects (so either side's client talks to either
side's server), frames round-trip, and every hostile manifest that the JAX
codec refuses is refused here too, with the same error."""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)
import io
import json
import struct

import numpy as np
import pytest

from longterm360fov_tpu import serving as jax_serving
from longterm360fov_tpu_torch import serving


def _objects():
    rng = np.random.default_rng(0)
    return [
        {"op": "predict", "id": 1, "past": rng.normal(size=(30, 3)).astype(np.float32)},
        {"op": "predict_batch", "id": 7,
         "past": np.arange(30, dtype=np.float32).reshape(2, 5, 3),
         "group_key": ["v0", "v1"],
         "group_sets": {"v0": np.ones((2, 4, 3), np.float32), "v1": np.full((2, 4, 3), 2.0, np.float32)},
         "group_masks": {"v0": np.ones(2, np.float32), "v1": np.zeros(2, np.float32)},
         "note": "scalars survive"},
        {"id": 3, "yaw": rng.normal(size=(4, 30)).astype(np.float32),
         "pitch": rng.normal(size=(4, 30)).astype(np.float32),
         "prefetch": (rng.random((4, 72)) < 0.3).astype(np.uint8)},
        # dtypes that the encoder converts: bool → u1, f16 → f4, i2 → i4; f64 and i8 kept
        {"m": np.array([True, False]), "h": np.ones(3, np.float16), "s": np.arange(3, dtype=np.int16),
         "d": np.ones(3), "l": np.arange(4, dtype=np.int64), "nested": {"deeper": {"x": np.zeros((0, 3))}}},
        {"op": "stats", "id": None},
        {"id": None, "error": "ValueError: bad"},
    ]


@pytest.mark.parametrize("i", range(6))
def test_encode_frame_bytes_equal_jax(i):
    obj = _objects()[i]
    assert serving.encode_frame(obj) == jax_serving.encode_frame(obj)


@pytest.mark.parametrize("i", range(6))
def test_frames_round_trip_across_both_codecs(i):
    obj = _objects()[i]
    for enc, dec in ((serving.encode_frame, serving.read_frame), (jax_serving.encode_frame, serving.read_frame),
                     (serving.encode_frame, jax_serving.read_frame)):
        got = dec(io.BytesIO(enc(obj)))
        ref = jax_serving.read_frame(io.BytesIO(jax_serving.encode_frame(obj)))
        assert got.keys() == ref.keys()

        def same(a, b):
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
            elif isinstance(a, dict):
                assert a.keys() == b.keys()
                for k in a:
                    same(a[k], b[k])
            else:
                assert a == b

        same(got, ref)


def test_round_trip_keeps_values_and_types():
    obj = _objects()[1]
    got = serving.read_frame(io.BytesIO(serving.encode_frame(obj)))
    assert got["op"] == "predict_batch" and got["id"] == 7 and got["note"] == "scalars survive"
    assert got["group_key"] == ["v0", "v1"]
    np.testing.assert_array_equal(got["past"], obj["past"])
    for k in ("v0", "v1"):
        np.testing.assert_array_equal(got["group_sets"][k], obj["group_sets"][k])
        np.testing.assert_array_equal(got["group_masks"][k], obj["group_masks"][k])
    got2 = serving.read_frame(io.BytesIO(serving.encode_frame(_objects()[3])))
    np.testing.assert_array_equal(got2["m"], np.array([1, 0], np.uint8))
    assert got2["h"].dtype == np.float32 and got2["s"].dtype == np.int32
    assert got2["d"].dtype == np.float64 and got2["l"].dtype == np.int64
    assert got2["nested"]["deeper"]["x"].shape == (0, 3)
    with pytest.raises(TypeError, match="cannot wire dtype"):
        serving.encode_frame({"c": np.ones(2, np.complex64)})


def _evil(manifest, payload=b""):
    hdr = json.dumps({"__bin__": manifest}).encode()
    return b"FoVB" + struct.pack("<I", len(hdr)) + hdr + payload


def _hostile():
    frame = serving.encode_frame({"x": np.ones(2, np.float32)})
    return [
        ("dtype off the list", frame.replace(b"<f4", b"|O8"), ValueError, "whitelist"),
        ("truncated payload", frame[:-1], ConnectionError, None),
        ("bad magic", b"XXXX" + frame[4:], ValueError, "magic"),
        ("negative dim", _evil([{"path": ["x"], "dtype": "<f4", "shape": [-1]}]), ValueError, "shape"),
        ("overflowing dims", _evil([{"path": ["x"], "dtype": "<f4", "shape": [1 << 30, 1 << 30, 1 << 30]}]),
         ValueError, "shape|payload"),
        ("payload past the cap", _evil([{"path": ["x"], "dtype": "<f8", "shape": [1 << 27, 2]}]), ValueError,
         "payload"),
        ("non-integer dim", _evil([{"path": ["x"], "dtype": "<f4", "shape": [2.5]}]), ValueError, "shape"),
        ("header past the cap", b"FoVB" + struct.pack("<I", (16 << 20) + 1), ValueError, "header"),
        ("truncated header", b"FoVB" + struct.pack("<I", 100) + b"{}", ConnectionError, None),
    ]


@pytest.mark.parametrize("case", range(9))
def test_hostile_manifests_refused_like_jax(case):
    _, frame, exc, match = _hostile()[case]
    with pytest.raises(exc) as ref:
        jax_serving.read_frame(io.BytesIO(frame))
    with pytest.raises(exc, match=match) as ours:
        serving.read_frame(io.BytesIO(frame))
    assert str(ours.value) == str(ref.value)
