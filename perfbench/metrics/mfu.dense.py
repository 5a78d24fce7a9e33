"""The configuration's analytic forward and backward FLOPs of every step
in the window (`perfbench/costs/<config>.py`, at each graph's real sizes)
over the window's seconds, as a share of one card's float32 peak (the
precision the configurations state), in percent.
As `mfu.train`, in the cells that report
`dense_train_edges_per_s`."""


def read(r):
    w = r.get("window")
    if not w or not w.get("flops"):
        return None
    return w["flops"] / w["seconds"] / r["peaks"]["f32_flops"] * 100.0
