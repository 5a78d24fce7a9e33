"""As `train_edges_per_s`, in the cells whose step is bound by dense
products: real edges of every graph trained in the window, over the
window's seconds."""


def read(r):
    w = r.get("window")
    return w["edges"] / w["seconds"] if w else None
