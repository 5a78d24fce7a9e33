"""What a traced run reads from outside the system: the kernel nodes of a
captured CUDA graph, the shapes of K1's calls, and the device intervals of
a `torch.profiler` trace."""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import re
import tempfile

import torch

# -- kernel nodes of a captured graph -----------------------------------------
# Frozen copy of `chip_smoke.py` `_DOT_NODE`, `_dot_nodes` and
# `_capturing_graph_dot` at commit 260b663: the DOT dump of the graph being
# captured, read through the driver API as the capture ends, whose kernel
# nodes name their functions. Exact, where the profiler drops records.

_DOT_NODE = re.compile(r'^\s*"[^"]+"\s*\[', re.M)


def dot_nodes(dot: str, symbol: str = "") -> int:
    """The nodes of a DOT dump whose declaration holds `symbol`."""
    return sum(symbol in dot[m.start():dot.find("];", m.end())]
               for m in _DOT_NODE.finditer(dot))


def _capturing_graph_dot() -> str:
    cuda = ctypes.CDLL("libcuda.so.1")
    status, graph = ctypes.c_int(), ctypes.c_void_p()
    rc = cuda.cuStreamGetCaptureInfo_v2(
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        ctypes.byref(status), ctypes.byref(ctypes.c_uint64()),
        ctypes.byref(graph), ctypes.byref(ctypes.c_void_p()),
        ctypes.byref(ctypes.c_size_t()))
    if rc != 0 or status.value != 1:  # CU_STREAM_CAPTURE_STATUS_ACTIVE
        raise RuntimeError(f"no capture on the current stream (CUresult "
                           f"{rc}, capture status {status.value})")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "graph.dot")
        rc = cuda.cuGraphDebugDotPrint(graph, path.encode(), ctypes.c_uint(1))
        if rc != 0:
            raise RuntimeError(f"cuGraphDebugDotPrint: CUresult {rc}")
        with open(path) as f:
            return f.read()


@contextlib.contextmanager
def captured_dots(dots: list):
    """Append the DOT dump of every CUDA graph whose capture ends inside
    the block to `dots`."""
    cls = torch.cuda.CUDAGraph
    orig = cls.capture_end

    def capture_end(g):
        dot = _capturing_graph_dot()
        orig(g)
        dots.append(dot)

    cls.capture_end = capture_end
    try:
        yield dots
    finally:
        cls.capture_end = orig


# -- K1's calls ---------------------------------------------------------------
# Frozen copy of the byte and FLOP rule of `escgnn_tpu_torch/ops/
# expand_cuda.py` `segsum_cost` at commit 260b663: one add per element of
# dZ (two when it is converted from bf16) and four per position; the
# kept positions (row id in [0, R)) of dZ's (E, H) elements, perm and the
# sorted ids read once, the (R, H) f32 output written once.

K1_SYMBOL = "segsum_kernel"


def k1_cost(E, H, dz_bytes, perm_bytes, ids_bytes, R, kept, bf16):
    flops = E * H * (2 if bf16 else 1) + 4 * E
    nbytes = kept * (H * dz_bytes + perm_bytes + ids_bytes) + R * H * 4
    return flops, nbytes


@contextlib.contextmanager
def k1_calls(calls: list):
    """Append (flops, bytes) of every K1 call made outside a graph capture
    inside the block, read from its arguments."""
    from escgnn_tpu_torch.ops import expand_cuda

    orig = expand_cuda._sorted_segment_sum

    def wrapped(dZ, perm, rows_sorted, num_rows):
        if not (dZ.is_cuda and torch.cuda.is_current_stream_capturing()):
            E, H = dZ.shape
            kept = int(((rows_sorted >= 0) & (rows_sorted < num_rows)).sum())
            calls.append(k1_cost(E, H, dZ.element_size(), perm.element_size(),
                                 rows_sorted.element_size(), num_rows, kept,
                                 dZ.dtype == torch.bfloat16))
        return orig(dZ, perm, rows_sorted, num_rows)

    expand_cuda._sorted_segment_sum = wrapped
    try:
        yield calls
    finally:
        expand_cuda._sorted_segment_sum = orig


# -- the profiler's trace -----------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def read_profile(prof, spans=()) -> dict:
    """Records of a finished `torch.profiler.profile`: each device
    operation's (name, start us, end us, category) and the harness spans'
    (name, start, end) on the host."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            dev.append((e.get("name", "?"), t0, t1, e["cat"]))
        elif e.get("cat") == "user_annotation" and e.get("name") in spans:
            host.append((e["name"], t0, t1))
    dev.sort(key=lambda r: r[1])
    return dict(device=dev, spans=host)


def union_seconds(intervals) -> float:
    """The length of the union of (start us, end us) intervals, in s."""
    tot, cur0, cur1 = 0.0, None, None
    for a, b in sorted(intervals):
        if cur1 is None or a > cur1:
            if cur1 is not None:
                tot += cur1 - cur0
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    if cur1 is not None:
        tot += cur1 - cur0
    return tot * 1e-6


def idle_gaps(device, spans, t0: float, t1: float) -> dict:
    """Seconds in [t0, t1] (us) with no device operation running, summed
    by the innermost harness span the host was in when each gap began."""
    out: dict = {}
    edges = []
    cur = t0
    for _, a, b, _ in device:
        if a > cur:
            edges.append((cur, min(a, t1)))
        cur = max(cur, b)
    if cur < t1:
        edges.append((cur, t1))
    for a, b in edges:
        if b <= a:
            continue
        inner = [s for s in spans if s[1] <= a < s[2]]
        label = (min(inner, key=lambda s: s[2] - s[1])[0] if inner
                 else "outside_spans")
        out[label] = out.get(label, 0.0) + (b - a) * 1e-6
    return out


def top_ops(device, k: int = 10) -> list:
    """The `k` device operations, by name, that took most time: [[name,
    seconds], ...]."""
    tot: dict = {}
    for name, a, b, _ in device:
        tot[name] = tot.get(name, 0.0) + (b - a) * 1e-6
    return [[n[:200], s] for n, s in
            sorted(tot.items(), key=lambda kv: -kv[1])[:k]]
