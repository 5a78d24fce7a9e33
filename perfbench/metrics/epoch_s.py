"""The window's seconds over the whole epochs it completed."""


def read(r):
    w = r.get("window")
    return w["seconds"] / w["epochs"] if w else None
