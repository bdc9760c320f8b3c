"""Tracing, profiling and debug hooks.

Twin of ``longterm360fov_tpu.utils.profiling``: a device trace of a region
(``torch.profiler`` in place of the JAX profiler), a steps-per-second meter,
NaN checks for debug runs, and the JSONL and TensorBoard metric streams.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Iterator, Optional

import torch

__all__ = [
    "profile_trace",
    "StepTimer",
    "debug_nans",
    "MetricsWriter",
    "TensorBoardWriter",
]


@contextlib.contextmanager
def profile_trace(log_dir: str, *, cuda: Optional[bool] = None) -> Iterator[torch.profiler.profile]:
    """Trace the region with ``torch.profiler`` and write it to ``log_dir``
    as a TensorBoard / Perfetto trace (``tensorboard_trace_handler``). The
    CPU activity is always recorded; the CUDA activity where ``cuda`` is
    true, by default where a card is present. Wrap steady-state steps only,
    and synchronize before the region ends::

        with profile_trace("trace"):
            for _ in range(10):
                state, m = step(state, batch)
            torch.cuda.synchronize()
    """
    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof


@contextlib.contextmanager
def debug_nans(enable: bool = True) -> Iterator[None]:
    """Scoped autograd anomaly mode: the backward raises at the op whose
    gradient first holds a NaN, and names the forward op that made it.
    Narrower than JAX's ``jax_debug_nans``, which checks every compiled
    program's outputs, forward ones too: here only the backward is
    checked."""
    with torch.autograd.set_detect_anomaly(enable):
        yield


class StepTimer:
    """Steady-state steps/sec + items/sec meter that ignores the first
    (warm-up) step."""

    def __init__(self, items_per_step: int = 0):
        self.items_per_step = items_per_step
        self.t0: Optional[float] = None
        self.steps = 0

    def tick(self) -> None:
        if self.t0 is None:  # first tick = end of the warm-up step
            self.t0 = time.time()
            return
        self.steps += 1

    @property
    def steps_per_sec(self) -> float:
        if not self.steps or self.t0 is None:
            return 0.0
        return self.steps / (time.time() - self.t0)

    @property
    def items_per_sec(self) -> float:
        return self.steps_per_sec * self.items_per_step


class MetricsWriter:
    """JSONL metrics stream: one dict per line, flushed eagerly so a killed
    run keeps its history."""

    def __init__(self, path: str):
        self.fh = open(path, "a")

    def write(self, **metrics) -> None:
        self.fh.write(json.dumps(metrics) + "\n")
        self.fh.flush()

    def close(self) -> None:
        self.fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TensorBoardWriter:
    """TensorBoard scalar stream beside the JSONL one, through
    ``torch.utils.tensorboard``. Raises ImportError with a clear message
    where the ``tensorboard`` package is absent, so callers can keep to
    JSONL."""

    def __init__(self, log_dir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter  # noqa: PLC0415
        except ImportError as e:
            raise ImportError(
                "TensorBoardWriter needs the tensorboard package (torch.utils.tensorboard); "
                "use MetricsWriter (JSONL) instead"
            ) from e
        self._writer = SummaryWriter(log_dir)

    def write(self, step: Optional[int] = None, **metrics) -> None:
        """Log numeric metrics at ``step`` (or at metrics['step'], so a
        train_loop metrics dict can be splatted whole)."""
        step = int(metrics.pop("step", step if step is not None else 0))
        for k, v in metrics.items():
            if isinstance(v, (int, float)):
                self._writer.add_scalar(k, v, step)
        self._writer.flush()

    def close(self) -> None:
        self._writer.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
