"""Graphs whose all-pairs SPD grid the system built per second (its
`featurize.spd_graphs` counter over its `featurize.spd` spans)."""

from perfbench import program_trace


def read(r):
    n = program_trace.counter("featurize.spd_graphs")
    s = program_trace.span("featurize.spd")
    return n / s["seconds"] if n and s and s["seconds"] > 0 else None
