"""Host milliseconds per step in the pool step's graph replay and loss
copy (the system's `pool_step.run` span), over every unprofiled step of
the run: the enqueueing, and the waits on a full launch queue."""

from perfbench import program_trace


def read(r):
    return program_trace.ms_per_call("pool_step.run")
