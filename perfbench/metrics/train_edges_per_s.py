"""Real edges (self-loops included, padding not) of every graph trained in
the window, over the window's seconds; the window is whole epochs and
ends in the last epoch's wait."""


def read(r):
    w = r.get("window")
    return w["edges"] / w["seconds"] if w else None
