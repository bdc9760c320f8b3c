"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with a
plain C interface and loaded with ``ctypes``. The build happens at first use,
from the sources in this checkout only, into ``build/torch_kernels/`` beside
the package (listed in ``.gitignore``). The library's file name carries a hash
of the source, the headers of ``csrc/`` and the flags, so an edited source or
header builds anew and an unchanged one is loaded from the cache.

Nothing here runs when the module is imported: the CPU tests import every
module of the package, and the CPU machine has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["Build", "find_nvcc", "build", "load", "sm_count"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
# exact f32: no --use_fast_math; -Xptxas -v reports registers and spills
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class Build:
    path: Path
    seconds: float  # time nvcc took; 0.0 when the library was cached
    log: str  # nvcc's output (ptxas register and spill report); "" if cached


def find_nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else ``$CUDA_HOME/bin/nvcc``,
    else ``/usr/local/cuda/bin/nvcc``. Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file() and os.access(cand, os.X_OK):
        return str(cand)
    raise RuntimeError(
        "nvcc not found (not on PATH, and no "
        f"{cand}): the CUDA kernels are built from "
        f"{CSRC} with the CUDA toolkit; set CUDA_HOME or put nvcc on PATH"
    )


def _flags(defines=()) -> tuple:
    return (*NVCC_FLAGS, *(f"-D{d}" for d in defines))


def _lib_path(name: str, defines=()) -> Path:
    # the source and every header of csrc/ it may include
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    key = hashlib.sha256(src + "\0".join(_flags(defines)).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{key[:16]}.so"


def build(name: str, defines=()) -> Build:
    """Compile ``csrc/<name>.cu`` unless a library of the same source and
    flags is already in the build directory. ``defines``: macro names
    passed as ``-D`` (a probe build, ``TFM_PROBE``), part of the key."""
    path = _lib_path(name, defines)
    if path.is_file():
        return Build(path, 0.0, "")
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc, *_flags(defines), "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
    os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    return Build(path, seconds, log)


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    return ctypes.CDLL(str(build(name).path))


@functools.cache
def sm_count(device) -> int:
    """The streaming multiprocessors of CUDA ``device``: the kernels' block
    choosers size their grids by it."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count
