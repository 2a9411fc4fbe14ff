"""Spans, counters and traces on torch.profiler (the port's counterpart of
smplsim_tpu/utils/profiler.py, whose trace and named regions it carries).

  * `span(name)`     a named stretch of the program at a layer boundary:
                     `with span(name):` or `@span(name)` on a function;
  * `count(name, v)` adds v, a host number or a device tensor (its sum), to
                     a counter;
  * `span_table()`   {path: {"count", "host_s", "self_s"}}: path is the
                     chain of open span names joined by "/", host_s the
                     host seconds inside the span, self_s those not covered
                     by its child spans;
  * `counters()`     {name: total}; `clear()` empties both;
  * `trace(logdir)`  records the enclosed block on the host and, where one
                     is present, the CUDA device, and writes a Chrome trace
                     (trace.json) into logdir.

Spans and counters are live only while a torch.profiler recording is
active (`profiling()`), whoever started it: `trace(logdir)`, a benchmark's
traced units or an operator's own profiler. There is no other switch.
While none is, `span` returns the name's shared no-op context after one
boolean read (a decorated function's wrapper makes the same read and calls
it), `count` returns at once, and nothing is allocated or entered.

While one is, a span enters a profiler record function under its own name,
so it sits in the same recording as the kernels it launches, on the
profiler's clock, and adds its host duration (`time.perf_counter_ns`) to
the table. A counter keeps the tensors it is given and sums them when
`counters()` is read, folding them into one partial sum once per 64 calls:
neither adds a device operation to the call that records it. Span names
start with "smplsim.", which no CUDA runtime call's name does.

    with torch.profiler.profile(activities=[ProfilerActivity.CPU]):
        state = env.step_autoreset(state, action)
    span_table()["smplsim.env.step_autoreset/smplsim.env.reset"]["host_s"]
"""
from __future__ import annotations

import contextlib
import functools
import os
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile

FOLD = 64            # tensors a counter keeps before summing them into one
_clock = time.perf_counter_ns


def profiling() -> bool:
    """Whether a torch.profiler recording is active in this process: the
    one switch of every span and counter."""
    return _autograd_profiler._is_profiler_enabled


class _Recorder:
    """The span table and the counters of the process; each thread keeps
    its own stack of open spans."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.clear()

    def clear(self):
        with self.lock:
            self.table = {}        # path -> [count, host_ns, self_ns]
            self.numbers = {}      # name -> host total
            self.tensors = {}      # name -> tensors not yet summed

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def close(self, path: str, dur: int, child: int):
        with self.lock:
            rec = self.table.get(path)
            if rec is None:
                self.table[path] = [1, dur, dur - child]
            else:
                rec[0] += 1
                rec[1] += dur
                rec[2] += dur - child

    def add(self, name: str, value):
        with self.lock:
            if isinstance(value, torch.Tensor):
                kept = self.tensors.setdefault(name, [])
                kept.append(value)
                if len(kept) > FOLD:
                    self.tensors[name] = [_fold(kept)]
            else:
                self.numbers[name] = self.numbers.get(name, 0) + value


def _fold(tensors: list) -> torch.Tensor:
    """The sum of every element of `tensors`, as one float64 0-d tensor on
    their device."""
    return torch.cat([t.reshape(-1) for t in tensors]).sum(dtype=torch.float64)


_REC = _Recorder()


class _Span:
    """One live span; fresh for each entry."""

    __slots__ = ("name", "_rf", "_frame")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _REC.stack()
        path = stack[-1][0] + "/" + self.name if stack else self.name
        self._rf = torch._C._profiler._RecordFunctionFast(self.name)
        self._rf.__enter__()
        # [path, ns covered by child spans, start]
        self._frame = [path, 0, _clock()]
        stack.append(self._frame)
        return self

    def __exit__(self, *exc):
        t1 = _clock()
        path, child, t0 = self._frame
        stack = _REC.stack()
        stack.pop()
        self._rf.__exit__(None, None, None)
        dur = t1 - t0
        if stack:
            stack[-1][1] += dur
        _REC.close(path, dur, child)
        return False

    def __call__(self, fn):
        return _spanned(self.name, fn)


class _NoSpan:
    """The no-op context of one span name, shared by every entry while no
    recording is active."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        return _spanned(self.name, fn)


def _spanned(name: str, fn):
    """fn, with the span `name` open around each call made while a
    recording is active."""
    @functools.wraps(fn)
    def spanned(*args, **kwargs):
        if not profiling():
            return fn(*args, **kwargs)
        with _Span(name):
            return fn(*args, **kwargs)
    return spanned


_NO_SPANS: dict = {}


def span(name: str):
    """A span called `name` (start it with "smplsim."): a context manager,
    or a decorator whose wrapper opens the span around each call."""
    if profiling():
        return _Span(name)
    off = _NO_SPANS.get(name)
    return off if off is not None else _NO_SPANS.setdefault(name, _NoSpan(name))


def count(name: str, value) -> None:
    """Add `value` (a host number, or a tensor whose elements are summed)
    to the counter `name`."""
    if profiling():
        _REC.add(name, value)


def span_table() -> dict:
    """{path: {"count", "host_s", "self_s"}} of every span closed since the
    last `clear()`."""
    with _REC.lock:
        return {p: {"count": c, "host_s": h * 1e-9, "self_s": s * 1e-9}
                for p, (c, h, s) in _REC.table.items()}


def counters() -> dict:
    """{name: total} of every counter since the last `clear()`, the device
    tensors summed (one reduction per counter, read back to the host)."""
    with _REC.lock:
        out = dict(_REC.numbers)
        for name, kept in _REC.tensors.items():
            out[name] = out.get(name, 0) + _fold(kept).item()
    return out


def clear() -> None:
    """Empty the span table and the counters."""
    _REC.clear()


@contextlib.contextmanager
def trace(logdir: str):
    """Record the enclosed block, spans included; on exit write
    logdir/trace.json."""
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
