"""Profiling and timing hooks on torch.profiler (port of
smplsim_tpu/utils/profiler.py).

  * `trace(logdir)`  a context manager that records the enclosed block on
                     the host and, where one is present, the CUDA device,
                     and writes a Chrome trace (trace.json) into logdir;
  * `annotate(name)` a named region in such a trace (record_function);
  * `Timer`          an accumulating wall-clock timer whose stop(x)
                     synchronizes x's device first, so device work is
                     charged to the right bucket.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Any

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(logdir: str):
    """Record the enclosed block; on exit write logdir/trace.json."""
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """A named region inside a trace."""
    return record_function(name)


def _synchronize(x: Any) -> None:
    """Wait for the device work behind every CUDA tensor in x (a tensor or
    a tuple, list or dict of them)."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
    elif isinstance(x, (tuple, list)):
        for y in x:
            _synchronize(y)
    elif isinstance(x, dict):
        for y in x.values():
            _synchronize(y)


class Timer:
    """Accumulating wall-clock timer; `stop(x)` waits for x's device first."""

    def __init__(self):
        self.total = 0.0
        self.count = 0
        self._t0: float | None = None

    def start(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def stop(self, block_on: Any = None) -> float:
        if block_on is not None:
            _synchronize(block_on)
        dt = time.perf_counter() - self._t0
        self.total += dt
        self.count += 1
        self._t0 = None
        return dt

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
