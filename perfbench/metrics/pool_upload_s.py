"""Seconds in set-up copying the padded pools and stacks to the card,
each copy waited for (the system's `pools.upload` spans)."""

from perfbench import program_trace


def read(r):
    s = program_trace.span("pools.upload")
    return s["seconds"] if s else None
