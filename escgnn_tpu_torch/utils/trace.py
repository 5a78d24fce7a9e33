"""Spans and counters of the port, kept in memory in this process.

    with trace.span("pool_step.load"):
        ...
    trace.count("pool_step.steps", n)
    trace.counter("pool_step.steps")  # n, or 0 if it never counted
    trace.snapshot()  # {"spans": {name: {"calls", "seconds"}},
                      #  "counters": {name: n}}

A span nests. While a `torch.profiler` records, it enters
`torch.profiler.record_function("escgnn.<name>")`, so it lands in the
profiler's trace on the clock of the device records, and adds nothing to
the totals; otherwise it adds its `time.perf_counter()` seconds and one
call to the totals under its name. The totals thus describe the
unprofiled run. A counter always counts.

No span belongs inside code that a CUDA graph capture records: the
capture runs its Python once, the replays never. The host runs ahead of
the card, so a span around enqueued work times the host's enqueueing,
and its waits on a full launch queue, not the device's work.

Nothing here starts a thread, reads the environment or writes a file.
"""

from __future__ import annotations

import time

import torch
from torch.autograd import profiler as _profiler

_spans: dict = {}     # name -> [calls, seconds]
_counters: dict = {}  # name -> count
_clock = time.perf_counter


class span:
    """`with span(name):` times its block under `name` (see the module)."""

    __slots__ = ("name", "t0", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function("escgnn." + self.name)
            self.rf.__enter__()
        else:
            self.rf = None
            self.t0 = _clock()
        return self

    def __exit__(self, typ, value, tb):
        if self.rf is not None:
            self.rf.__exit__(typ, value, tb)
            return False
        dt = _clock() - self.t0
        tot = _spans.get(self.name)
        if tot is None:
            _spans[self.name] = [1, dt]
        else:
            tot[0] += 1
            tot[1] += dt
        return False


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name`."""
    _counters[name] = _counters.get(name, 0) + n


def counter(name: str) -> int:
    """The counter `name`, 0 where it never counted."""
    return _counters.get(name, 0)


def snapshot() -> dict:
    """A copy of the totals: {"spans": {name: {"calls", "seconds"}},
    "counters": {name: n}}."""
    return {"spans": {k: {"calls": c, "seconds": s}
                      for k, (c, s) in _spans.items()},
            "counters": dict(_counters)}


def reset(*names: str) -> None:
    """Clear the spans and counters `names`, or every one when none is
    named."""
    if not names:
        _spans.clear()
        _counters.clear()
        return
    for k in names:
        _spans.pop(k, None)
        _counters.pop(k, None)
