"""K1's (the sorted segment sum, `csrc/expand_segsum.cu`) share of its
roofline, in percent: the least time its calls could take (the larger of
their bytes over the HBM peak and their FLOPs over the float32 peak, by
the frozen copy of `segsum_cost`'s rule at the shapes of one eager step's
calls) over their mean device time per record in the profiled tail."""


def read(r):
    calls = r["counters"].get("k1_calls")
    t = r["trace"].get("k1_mean_s")
    if not calls or not t:
        return None
    pk = r["peaks"]
    least = sum(max(f / pk["f32_flops"], b / pk["hbm_bytes_per_s"])
                for f, b in calls) / len(calls)
    return least / t * 100.0
