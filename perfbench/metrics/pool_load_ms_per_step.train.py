"""Host milliseconds per step in the pool step's batch copies into its
static buffers (the system's `pool_step.load` span), over every
unprofiled step of the run. The host runs steps ahead of the card, so a
full launch queue shows here as waiting, not as copy time."""

from perfbench import program_trace


def read(r):
    return program_trace.ms_per_call("pool_step.load")
