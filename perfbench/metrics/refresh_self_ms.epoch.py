"""Host milliseconds per refreshed batch that the BN refresh spends
outside its forwards (the system's `refresh` span less its
`refresh.forward` spans, over the forwards): the statistics' copies,
loads and moment recovery around each batch-statistics forward."""

from perfbench import program_trace


def read(r):
    whole = program_trace.span("refresh")
    fwd = program_trace.span("refresh.forward")
    if not whole or not fwd:
        return None
    return (whole["seconds"] - fwd["seconds"]) / fwd["calls"] * 1e3
