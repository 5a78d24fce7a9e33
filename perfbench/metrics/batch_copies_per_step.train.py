"""Tensor copies the pool step enqueues per step to load its batch (the
system's `pool_step.copies` over `pool_step.steps`): one per field of
the batch."""

from perfbench import program_trace


def read(r):
    copies = program_trace.counter("pool_step.copies")
    steps = program_trace.counter("pool_step.steps")
    return copies / steps if copies is not None and steps else None
