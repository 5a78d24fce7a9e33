"""Share of the BN refresh's and the evals' batches that replayed a
captured CUDA graph (the system's `eval.replays` + `refresh.replays` over
`eval.batches` + `refresh.batches`), over every refresh and eval of the
process: the set-up's checked ones, the window's and the traced tail's."""

from perfbench import program_trace


def read(r):
    batches = sum(program_trace.counter(n) or 0
                  for n in ("eval.batches", "refresh.batches"))
    if not batches:
        return None
    replays = sum(program_trace.counter(n) or 0
                  for n in ("eval.replays", "refresh.replays"))
    return replays / batches
