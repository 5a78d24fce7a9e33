"""Host milliseconds per eager forward in the BN refresh and the evals
(the system's `refresh.forward` and `eval.forward` spans, one per batch),
over every unprofiled epoch and the checked first refresh and evals."""

from perfbench import program_trace


def read(r):
    f = [program_trace.span(n) for n in ("refresh.forward", "eval.forward")]
    f = [s for s in f if s]
    if not f:
        return None
    return (sum(s["seconds"] for s in f) / sum(s["calls"] for s in f)
            * 1e3)
