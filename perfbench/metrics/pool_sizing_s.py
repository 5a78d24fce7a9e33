"""Host seconds in set-up sizing batch specs: each spec's pass over its
graphs for the per-graph maxima and row budgets (the system's
`pools.size` spans)."""

from perfbench import program_trace


def read(r):
    s = program_trace.span("pools.size")
    return s["seconds"] if s else None
