"""Graphs featurized per second of the system's featurizer (its
`featurize.graphs` counter over its `featurize` spans, every split)."""

from perfbench import program_trace


def read(r):
    n = program_trace.counter("featurize.graphs")
    s = program_trace.span("featurize")
    return n / s["seconds"] if n and s and s["seconds"] > 0 else None
