"""The system's own spans and counters, for the readers of `metrics/`.

`escgnn_tpu_torch/utils/trace.py` keeps them in the measured process: a
span's calls and host seconds outside the profiler (the set-up, the first
steps, the window and the event-timed tail; the profiled epoch adds
nothing), a counter's count in every run. Beside `port.py`, this file is
the one other place where the benchmark reads the system. A system
without that module, or without a given span or counter, reads as None,
and the metric is then left out of the result line."""

from __future__ import annotations


def totals() -> dict | None:
    """The system's `trace.snapshot()`, or None where it keeps none."""
    try:
        from escgnn_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.snapshot()


def span(name: str) -> dict | None:
    """{"calls", "seconds"} of the span `name`, None if it never ran."""
    t = totals()
    s = t["spans"].get(name) if t else None
    return s if s and s["calls"] else None


def counter(name: str) -> int | None:
    t = totals()
    return t["counters"].get(name) if t else None


def ms_per_call(name: str) -> float | None:
    s = span(name)
    return s["seconds"] / s["calls"] * 1e3 if s else None
