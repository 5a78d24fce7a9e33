"""Host seconds in set-up batching, padding, stacking and compressing
the train pools and the eval stacks (the system's `pools.pad` spans)."""

from perfbench import program_trace


def read(r):
    s = program_trace.span("pools.pad")
    return s["seconds"] if s else None
