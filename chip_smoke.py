#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`escgnn_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from `escgnn_tpu_torch/csrc/`, holds each one
against its plain PyTorch version on the card, then drives these paths:

  * the flagship ESC-GNN train step (128 synthetic ZINC molecules,
    uniform + dedup batch, NestedGINEff hidden 256 x 5 layers with bf16
    conv stacks, L1 loss, Adam 5e-4) for 10 steps and one eval step, and
    one step with the count-matrix kernel path;
  * the PPGN_eff counting train step (128 counting graphs, width batch,
    PPGN emb 128 x 3 regular blocks with bf16 block stacks, node-level L1
    loss, Adam 5e-4) for 10 steps and one eval step through the row-gather
    z kernel and the pooling kernel, and one step with the default impls;
  * the driver twins at their default widths, in a temporary directory:
    `[run_zinc]` (3 epochs on 1000 synthetic molecules, each epoch one
    CUDA-graphed pool step), `[pool_graph]` (one epoch graphed against
    one eager from the same state, K1 counted per graphed step from the
    captured graph), `[run_graphcount]` (3 epochs on 400 counting graphs,
    the best checkpoint restored and re-evaluated, the cache hit, a warm
    start, one PPGN_eff epoch), `[run_zinc_cycle]` (node-level, 3 epochs
    on 1000 molecules) and `[run_qm9]` (3 epochs on 1000 synthetic
    molecules, node-type extras through the graphed step), each with its
    `[pool_graph]`, and `[run_ogb_mol]` (OgbGNN 6 x 300 with a virtual
    node and dropout 0.65, 3 epochs on 640 synthetic molecules with the
    triangle label, 16 graphed steps each; K1 at width 300 in f32 and
    bf16; `[pool_graph]` at dropout 0.65 and at 0; two replays of the
    captured step from one snapshot, different under dropout and equal
    without; `[small_ogb]`, the card against the CPU; the bench's OgbGNN
    step, 32 graphs in bf16, graphed and eager);
  * the copy family: `[run_zinc_i2gnn]` (`run_zinc --model I2GNN` at the
    JAX defaults, 256 x 5, batch 128, h 3, uniform copy blocks, 5 graphed
    epochs on 1000 molecules) and `[run_zinc_ngnn]`, each with its
    `[pool_graph]`; `[copy_bucketed]` (one full-width I2GNN batch as
    uniform and as bucketed copy blocks, loss and gradients compared, then
    the bucketed pool graphed); `[run_ogb_mol_nppgn]` (NestedPPGN at the
    OGB twin's widths, its dense per-copy grid reckoned first and the
    batch cut to fit the card, the cut printed); `[small_copy]`, NGNN,
    I2GNN and NestedPPGN on the card against the CPU;
  * the expressiveness twins on the checkout's data: `[run_sr]` (SR25
    collisions of the untrained 8 x 64 model, card against CPU),
    `[run_exp]` (EXP cut to 400 graphs, 2 splits x 5 epochs) and
    `[run_csl]` (2 folds x 10 epochs, then one fold through K3 inside
    the captured step, against the default impl);
  * the rest of the zoo: `[run_qm9_k123]` (`run_qm9 --model k123_GNN` at
    the JAX defaults, h 3, batch 64, 3 graphed epochs on 1000 molecules,
    its `[pool_graph]`) and `[run_qm9_kgnn]` (set-up seconds, the k-set
    budgets, one epoch each of k1/k12/k13); `[run_ogb_mol_ginep]` (GINE+
    300 x 6, k 3, dropout 0.65, 3 epochs on 640 molecules, `[pool_graph]`
    at dropout 0.65 and 0, the bench's bf16 GINE+ step); `[run_zinc_gnn]`
    and `[run_zinc_cycle_gnn]` (the RGCN baseline, 3 epochs each, with
    their `[pool_graph]`); `[zoo_registry]` (every name this slice
    registers, built by `get_model`, 3 steps each) and `[small_zoo]`
    (card against CPU). No port kernel lies on these paths.

Every phase prints one line; any failed check raises, so the script exits
non-zero and prints no result. A kernel's launches in graphed epochs are
its nodes in the captured CUDA graph, read from the graph's DOT dump,
times the graph's replays (`_GraphLedger`); the profiler, which drops
device records, must see the kernel run and never more often than that.
The last two lines are the kernel table (with the launches on each
path: eager steps counted by the wrappers, graphed epochs by the
ledger) and the result, both JSON.

Needs a CUDA card and nvcc; exits 1 without a card. Imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import torch

# published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
# f32 FLOP/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

NUM_GRAPHS = 128
TRAIN_STEPS = 10
LR = 5e-4
# the PPGN_eff bench line (bench.py:484-501): emb 128, 3 regular blocks
PPGN_EMB = 128
PPGN_BLOCKS = 3


def _log(phase: str, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def _cuda_ms(fn, iters: int = 50, reps: int = 10) -> float:
    """Mean device time of one call of `fn`. The calls are captured into
    a CUDA graph and timed by CUDA events around graph replays, so the
    time is the device's alone: timed eagerly, Python's per-call cost
    (argument checks, allocation, launch) exceeds these kernels' device
    time and the events would measure the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def _bound(nbytes: float, nops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _check_close(name, got, want, rtol, atol):
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                               msg=lambda m: f"{name}: {m}")
    return err


def flagship_config():
    from escgnn_tpu_torch.models.nested_gin_eff import NestedGINEffConfig

    return NestedGINEffConfig(
        hidden=256, num_layers=5, dropout=0.0, act="elu", graph_pred=True,
        pool="add", use_x_embedding_jk=False, head_order="dropout_act",
        node_embed_vocab=100, node_embed_dim=32,
        edge_embed_vocab=100, edge_embed_dim=32, compute_dtype="bfloat16",
    )


def _device_events(prof, name_part: str = ""):
    """Device kernel and copy events of a profile whose name holds
    `name_part`."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and "#" not in e.name and name_part in e.name]


def _kernel_events(prof, name_part: str = "") -> int:
    return len(_device_events(prof, name_part))


def _busy_ms(prof) -> float:
    """Device time of a profile's kernels and copies, in ms."""
    return sum(e.time_range.elapsed_us() for e in _device_events(prof)) / 1e3


def _host_ms(prof, name: str) -> float:
    """Host time of a profile's runtime calls named `name`, in ms."""
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CPU
               and e.name == name) / 1e3


def _profiled(fn):
    """(fn's result, its profile), synchronized inside the profile."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, prof


# a node's declaration in a DOT dump: its quoted name, then its attributes
_DOT_NODE = re.compile(r'^\s*"[^"]+"\s*\[', re.M)


def _dot_nodes(dot: str, symbol: str = "") -> int:
    """The nodes of a graph's DOT dump (`cuGraphDebugDotPrint`) whose
    declaration (its name and attributes, up to `];`) holds `symbol`: a
    kernel node's label names its function."""
    return sum(symbol in dot[m.start():dot.find("];", m.end())]
               for m in _DOT_NODE.finditer(dot))


def _capturing_graph_dot() -> str:
    """The DOT dump (`cuGraphDebugDotPrint`, verbose: a kernel node's
    label names its function) of the graph that the current stream is
    capturing, read through the driver API: torch's `debug_dump` keeps
    no graph to print unless the graph was made with `keep_graph`."""
    import ctypes

    cuda = ctypes.CDLL("libcuda.so.1")
    status, graph = ctypes.c_int(), ctypes.c_void_p()
    rc = cuda.cuStreamGetCaptureInfo_v2(
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        ctypes.byref(status), ctypes.byref(ctypes.c_uint64()),
        ctypes.byref(graph), ctypes.byref(ctypes.c_void_p()),
        ctypes.byref(ctypes.c_size_t()))
    if rc != 0 or status.value != 1:  # CU_STREAM_CAPTURE_STATUS_ACTIVE
        raise AssertionError(f"no capture on the current stream (CUresult "
                             f"{rc}, capture status {status.value})")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "graph.dot")
        rc = cuda.cuGraphDebugDotPrint(graph, path.encode(), ctypes.c_uint(1))
        if rc != 0:
            raise AssertionError(f"cuGraphDebugDotPrint: CUresult {rc}")
        with open(path) as f:
            return f.read()


class _GraphLedger:
    """The CUDA graphs captured, and their replays made, while `watch()`
    is active (`torch.cuda.CUDAGraph`'s capture and replay are wrapped):
    each graph's DOT dump, read as its capture ends, and its replays. A
    replay runs every node of its graph, so a kernel's launches in graph
    replays are its nodes times the replays. The profiler cannot count
    them: on torch 2.11.0+cu128 it drops device records, and it read 2
    launches of a kernel in 3 replays of one graph in three profiles in a
    row (PERF.md §7)."""

    def __init__(self):
        self.dots: list[str] = []
        self.replays: list[int] = []

    @contextlib.contextmanager
    def watch(self):
        cls = torch.cuda.CUDAGraph
        orig = {n: getattr(cls, n) for n in ("capture_end", "replay")}
        ledger = self

        def capture_end(g):
            # torch.cuda.graph ends the capture on the capturing stream
            dot = _capturing_graph_dot()
            orig["capture_end"](g)
            if _dot_nodes(dot) == 0:
                raise AssertionError("the captured graph's DOT dump has no "
                                     "nodes")
            g._ledger_index = len(ledger.dots)
            ledger.dots.append(dot)
            ledger.replays.append(0)

        def replay(g):
            orig["replay"](g)
            i = getattr(g, "_ledger_index", None)
            if i is None:
                raise AssertionError("a graph replayed under the ledger was "
                                     "captured outside it")
            ledger.replays[i] += 1

        cls.capture_end, cls.replay = capture_end, replay
        try:
            yield self
        finally:
            for n, f in orig.items():
                setattr(cls, n, f)

    def clear_replays(self) -> None:
        self.replays = [0] * len(self.dots)

    def nodes(self, symbol: str = "") -> int:
        """Nodes holding `symbol` over every graph captured (every node
        with no symbol)."""
        return sum(_dot_nodes(d, symbol) for d in self.dots)

    def launches(self, symbol: str) -> int:
        """Launches of kernels named `symbol` in the replays counted."""
        return sum(_dot_nodes(d, symbol) * n
                   for d, n in zip(self.dots, self.replays))


def _device_kernels(fn) -> int:
    """The kernels one call of `fn` launches, counted from the profiler's
    device events (a warm call first, so that nothing is built or
    allocated for the first time inside the profile)."""
    fn()
    torch.cuda.synchronize()
    return _kernel_events(_profiled(fn)[1])


def _k1_cases(batch, dev, gen):
    """(name, dZ, perm, rows_sorted, R, exact) cases for K1; `exact`: held
    to the f64 sum (f32 input), else to the plain version (bf16 input).
    The flagship's sorted view with dZ contiguous, as the first 256 columns
    of an (E, 288) tensor (the step's layout) and 4 bytes off 16 (single
    columns); bf16 contiguous, at H 100 (single columns) and as the first
    100 columns of a 104-wide tensor (8-wide units and a 4-column tail);
    ragged ids with gaps and trailing rows; a run of 30% of the edges over
    many blocks, with leading, gap and trailing rows."""
    perm, rows = batch.enc_edge_perm, batch.enc_row_sorted
    E, R, H = perm.shape[0], batch.enc_idx.shape[0], 256
    wide = torch.randn(E, H + 32, device=dev, generator=gen)
    step = wide[:, :H]
    cases = [("flagship_f32", step.contiguous(), perm, rows, R, True),
             ("step_f32_ld288", step, perm, rows, R, True),
             ("f32_ld288_off4", wide[:, 1:H + 1], perm, rows, R, True),
             ("flagship_bf16", step.to(torch.bfloat16), perm, rows, R, False)]
    w16 = torch.randn(E, 104, device=dev, generator=gen).to(torch.bfloat16)
    cases += [("bf16_h100", w16[:, :100].contiguous(), perm, rows, R, False),
              ("bf16_h100_ld104", w16[:, :100], perm, rows, R, False)]
    def perm_of(n):
        return torch.randperm(n, device=dev, generator=gen).to(torch.int32)

    # ragged: 1000 edges on ids 0..248 with gaps, 300 rows, H 96
    ids = torch.randint(0, 125, (1000,), device=dev, generator=gen) * 2
    cases.append(("ragged", torch.randn(1000, 96, device=dev, generator=gen),
                  perm_of(1000), torch.sort(ids).values.to(torch.int32), 300,
                  True))
    # long run: 6000 of 20000 edges on row 1000, the rest on even ids in
    # [6, 2500); 3000 rows
    n, long_n = 20000, 6000
    ids = torch.randint(3, 1250, (n,), device=dev, generator=gen) * 2
    ids[:long_n] = 1000
    cases.append(("long_run", torch.randn(n, H, device=dev, generator=gen),
                  perm_of(n), torch.sort(ids).values.to(torch.int32), 3000,
                  True))
    return cases


def check_k1(batch, dev):
    """K1 on every case of `_k1_cases`: close to its reference, two calls
    bit-equal, every row no id names exactly 0; the step's strided layout
    bit-equal to the same values contiguous; one launch per call; layouts
    and spans it does not take refused. Timed on the step's layout (the
    main path's) beside the contiguous one."""
    from escgnn_tpu_torch import _build
    from escgnn_tpu_torch.ops import expand_cuda, smem_plan

    gen = torch.Generator(device=dev).manual_seed(1)
    # f32 sums of up to a few thousand terms against the same sum in f64
    # (or, for bf16 input, the plain version's f32 index_add_, which adds in
    # an order that changes from run to run)
    tol = dict(rtol=1e-5, atol=1e-4)
    sms = smem_plan.sm_count(dev)
    results, err = {}, 0.0
    for name, dZ, perm, rows, R, exact in _k1_cases(batch, dev, gen):
        got = expand_cuda.sorted_segment_sum(dZ, perm, rows, R)
        if exact:
            want = torch.zeros(R, dZ.shape[1], dtype=torch.float64,
                               device=dev).index_add_(
                0, rows.long(), dZ.double().index_select(0, perm.long()))
        else:
            want = expand_cuda.sorted_segment_sum_plain(dZ, perm, rows, R)
        torch.cuda.synchronize()
        e = _check_close(f"K1 {name}", got, want.float(), **tol)
        if exact:
            err = max(err, e)
        if not torch.equal(got, expand_cuda.sorted_segment_sum(dZ, perm,
                                                               rows, R)):
            raise AssertionError(f"K1 {name}: not deterministic from run to "
                                 f"run")
        unnamed = torch.bincount(rows.long(), minlength=R)[:R] == 0
        if unnamed.any() and got[unnamed].abs().max().item() != 0:
            raise AssertionError(f"K1 {name}: a row no id names is not 0")
        if name == "long_run":
            # the blocks the long run's sorted positions span
            lo, hi = int((rows < 1000).sum()), int((rows <= 1000).sum())
            span = expand_cuda.segsum_plan(len(rows), dZ.shape[1], sms).span
            long_blocks = (hi - 1) // span - lo // span + 1
            if long_blocks < 10:
                raise AssertionError(f"K1 long_run spans {long_blocks} blocks")
        results[name] = (got, int(unnamed.sum().item()))
    if not torch.equal(results["flagship_f32"][0],
                       results["step_f32_ld288"][0]):
        raise AssertionError("K1: the strided step layout differs from the "
                             "same values contiguous")

    perm, rows_sorted = batch.enc_edge_perm, batch.enc_row_sorted
    E, R, H = perm.shape[0], batch.enc_idx.shape[0], 256
    wide = torch.randn(E, H + 32, device=dev, generator=gen)
    dZ, dZc = wide[:, :H], wide[:, :H].contiguous()
    per_call = _device_kernels(
        lambda: expand_cuda.sorted_segment_sum(dZ, perm, rows_sorted, R))
    if per_call != 1:
        raise AssertionError(f"K1 launched {per_call} kernels in one call")
    ms = _cuda_ms(lambda: expand_cuda.sorted_segment_sum(dZ, perm,
                                                         rows_sorted, R))
    ms_contiguous = _cuda_ms(
        lambda: expand_cuda.sorted_segment_sum(dZc, perm, rows_sorted, R))
    plain_ms = _cuda_ms(
        lambda: expand_cuda.sorted_segment_sum_plain(dZ, perm, rows_sorted, R))
    edge_row = batch.enc_edge_row.long()
    # yardstick: the one PyTorch call computing the same dU from the
    # batch's unsorted edge -> row map (never called by the port)
    library_ms = _cuda_ms(
        lambda: torch.zeros(R, H, device=dev).index_add_(0, edge_row, dZ))
    # the strided rows are the same bytes
    nbytes = E * H * 4 + 2 * E * 4 + R * H * 4
    bound_ms, bound_by = _bound(nbytes, E * H)
    plan = expand_cuda.segsum_plan(E, H, sms)

    # refused, each for its own reason: by the C launcher a span outside
    # [1, 256] and a row stride under H (cudaErrorInvalidValue), by the
    # wrapper a column stride of 2
    out_r = torch.empty(R, H, device=dev)
    part = torch.empty(plan.partial_floats, device=dev)

    def launcher(span, ld):
        rc = _build.load("expand_segsum").expand_segsum_f32(
            dZ.data_ptr(), ld, perm.data_ptr(), rows_sorted.data_ptr(), E, H,
            R, span, out_r.data_ptr(), part.data_ptr(),
            expand_cuda._counters(dev, R).data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(rc, "expand_segsum")

    refusals = {
        "span_0": (lambda: launcher(0, dZ.stride(0)), "CUDA error 1"),
        "span_257": (lambda: launcher(257, dZ.stride(0)), "CUDA error 1"),
        "row_stride_under_H": (lambda: launcher(plan.span, H - 1),
                               "CUDA error 1"),
        "column_stride_2": (lambda: expand_cuda.sorted_segment_sum(
            wide[:, ::2], perm, rows_sorted, R), "column stride"),
    }
    for what, (bad, reason) in refusals.items():
        try:
            bad()
        except (RuntimeError, ValueError) as e:
            if reason not in str(e):
                raise AssertionError(f"K1 refused {what} for another reason: "
                                     f"{e}") from e
        else:
            raise AssertionError(f"K1 accepted {what}")
    _log("k1", shapes=f"E={E},R={R},H={H}", layout="ld288", span=plan.span,
         grid=plan.grid, long_run_blocks=long_blocks,
         cases=",".join(results), zero_rows=",".join(
             f"{k}:{v[1]}" for k, v in results.items()),
         max_abs_err_f32=err, deterministic=True,
         strided_equals_contiguous=True, refused=",".join(refusals),
         launches_per_call=per_call, ms=ms, ms_contiguous=ms_contiguous,
         plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
         bound_by=bound_by, ok=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)


def _plan_fields(plan):
    return dict(slice_cols=plan.slice_cols, slices=plan.slices,
                grid=plan.grid, smem_bytes_per_block=plan.smem_bytes,
                table_rows_from="smem" if plan.resident else "l1")


def _ragged_cases(gen, dev):
    """(name, table, ids, counts) cases for K2 and K3: a 256-column slice
    with H off a multiple of 32, a 128-column slice with H off a multiple
    of 4, the tallest table a 128-column slice holds in shared memory and a
    taller one read through L1; ids with duplicates in a row and outside
    [0, Z), E not a multiple of 128, P over one 32-entry chunk."""
    from escgnn_tpu_torch.ops import smem_plan

    cases = []
    for Z, H in ((100, 200), (77, 41), (smem_plan.MAX_RESIDENT_ROWS, 96),
                 (2500, 200)):
        ids = torch.randint(0, Z, (1000, 37), device=dev, generator=gen,
                            dtype=torch.int32)
        cnt = torch.randint(0, 6, (1000, 37), device=dev, generator=gen).float()
        ids[::7, :5] = Z - 1            # duplicates
        ids[3, 0], cnt[3, 0] = Z, 4.0   # outside the table: contributes 0
        ids[5, 1], cnt[5, 1] = -2, 3.0
        table = torch.randn(Z, H, device=dev, generator=gen)
        where = "smem" if smem_plan.smem_plan(Z, H).resident else "l1"
        cases.append((f"{Z}x{H}({where})", table, ids, cnt))
    return cases


def check_k2(batch, dev):
    """K2 against its plain version at the flagship unique-row shapes and
    on ragged cases (Zc off a multiple of 32, H off the slice width,
    duplicate and out-of-range ids, resident and read through L1:
    `_ragged_cases`): C equal to the plain build, z close, two calls
    equal. A plan that does not match the shapes (by the C launcher), ids
    that are not int32 and a table above 2**31 - 1 floats are refused."""
    from escgnn_tpu_torch import _build
    from escgnn_tpu_torch.ops import smem_plan, zemb_cuda, zemb_gather

    gen = torch.Generator(device=dev).manual_seed(2)
    idx = batch.enc_idx.to(torch.int32).contiguous()
    cnt = batch.enc_cnt.to(torch.float32).contiguous()
    R, P = idx.shape
    Zc, H = batch.enc_bucket_ids.shape[0], 256
    sms = smem_plan.sm_count(dev)
    table = torch.randn(Zc, H, device=dev, generator=gen)
    # f32 products summed over up to P entries in another order
    tol = dict(rtol=1e-5, atol=1e-4)

    def check(name, t, i, c):
        z, C = zemb_cuda.zemb_countmat(t, i, c)
        z_ref, C_ref = zemb_cuda.zemb_countmat_plain(t, i, c)
        torch.cuda.synchronize()
        if not torch.equal(C, C_ref):
            raise AssertionError(f"{name}: count matrix differs from the "
                                 f"plain build")
        err = _check_close(f"{name} z", z, z_ref, **tol)
        z2, C2 = zemb_cuda.zemb_countmat(t, i, c)
        if not (torch.equal(z, z2) and torch.equal(C, C2)):
            raise AssertionError(f"{name}: not deterministic from run to run")
        return z, C_ref, err

    z, C_ref, err = check("K2", table, idx, cnt)
    # the same walk as K3: the z reduce is the same f32 sum, bit for bit
    if not torch.equal(z, zemb_gather.zemb_gather(table, idx, cnt)):
        raise AssertionError("K2's z differs from K3's on the same inputs")

    ragged = []
    for name, tr, ir, cr in _ragged_cases(gen, dev):
        check(f"K2 ragged {name}", tr, ir, cr)
        ragged.append(name)
    plan = smem_plan.smem_plan(Zc, H, sms)
    z_out, C_out = torch.empty_like(z), torch.empty_like(C_ref)

    def wrong_plan():
        # the launcher itself, with 4 bytes more table than the shapes need
        rc = _build.load("zemb_countmat").zemb_countmat_f32(
            table.data_ptr(), idx.data_ptr(), cnt.data_ptr(), R, P, Zc, H,
            plan.slice_cols, plan.blocks_per_slice, plan.table_bytes + 4,
            z_out.data_ptr(), C_out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(rc, "zemb_countmat")

    # refused, each with its own reason: a plan that does not match the
    # shapes, int64 ids, and a table above the kernels' 32-bit row offsets
    # (a broadcast view of one row: nothing of its size is allocated)
    refusals = {
        # cudaErrorInvalidValue
        "wrong_plan": (wrong_plan, "CUDA error 1 at launch"),
        "int64_ids": (lambda: zemb_cuda.zemb_countmat(table, idx.long(), cnt),
                      "int32"),
        "table_over_2^31_floats": (lambda: zemb_cuda.zemb_countmat(
            torch.empty(2**11, device=dev).expand(2**20, 2**11), idx, cnt),
            "32-bit"),
    }
    for what, (bad, reason) in refusals.items():
        try:
            bad()
        except (RuntimeError, ValueError) as e:
            if reason not in str(e):
                raise AssertionError(f"K2 refused {what} for another reason: "
                                     f"{e}") from e
        else:
            raise AssertionError(f"K2 accepted {what}")

    ms = _cuda_ms(lambda: zemb_cuda.zemb_countmat(table, idx, cnt))
    plain_ms = _cuda_ms(lambda: zemb_cuda.zemb_countmat_plain(table, idx, cnt))
    # yardstick: the default path's product with the host-built C (the C
    # build excluded), one PyTorch call
    library_ms = _cuda_ms(lambda: torch.matmul(C_ref, table))
    nnz = int((C_ref != 0).sum().item())
    nbytes = Zc * H * 4 + R * P * 8 + R * H * 4 + R * Zc * 4
    bound_ms, bound_by = _bound(nbytes, 2 * nnz * H + R * P)
    _log("k2", shapes=f"R={R},P={P},Zc={Zc},H={H}", nnz_C=nnz,
         dense_gflop=2 * R * Zc * H / 1e9, max_abs_err=err, C_equal=True,
         deterministic=True, equals_k3=True, ragged=",".join(ragged),
         refused=",".join(refusals), **_plan_fields(plan),
         ms=ms, plain_ms=plain_ms, library_matmul_ms=library_ms,
         bound_ms=bound_ms, bound_by=bound_by, ok=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)


def check_small_reference(dev):
    """The port on the card (kernels) against the port on the CPU (plain
    versions) on a small f32 input: train-mode outputs and every
    gradient, under both z impls."""
    from escgnn_tpu_torch.data.batching import BatchSpec, pad_and_batch
    from escgnn_tpu_torch.data.molecules import synthetic_zinc
    from escgnn_tpu_torch.featurize import EscConfig, featurize_many
    from escgnn_tpu_torch.models.nested_gin_eff import NestedGINEff
    from escgnn_tpu_torch.ops import zemb

    graphs = featurize_many(synthetic_zinc(8, seed=5), EscConfig(h=3))
    spec = BatchSpec.uniform(graphs, 8, enc_layout="dedup")
    cfg = dataclasses.replace(flagship_config(), hidden=32, num_layers=2,
                              compute_dtype="float32")
    cpu_model = NestedGINEff(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(3))
    worst = 0.0
    for impl in ("countmat", "countmat_pallas"):
        zemb.set_impl(impl)
        try:
            results = []
            for device in ("cpu", dev):
                b = pad_and_batch(graphs, spec, device=device)
                if impl == "countmat_pallas":
                    b = dataclasses.replace(b, enc_countmat=None)
                m = copy.deepcopy(cpu_model).to(device).train()
                out = m(b)
                out.float().square().sum().backward()
                grads = {k: p.grad.cpu() for k, p in m.named_parameters()}
                results.append((out.detach().cpu(), grads))
        finally:
            zemb.set_impl("countmat")
        (o_cpu, g_cpu), (o_gpu, g_gpu) = results
        # f32 on both sides, sums in another order (rtol/atol 1e-4)
        worst = max(worst, _check_close(f"small[{impl}] out", o_gpu, o_cpu,
                                        rtol=1e-4, atol=1e-4))
        # gradients: atol 1e-4 of the largest gradient — the exactly-zero
        # gradients of biases feeding a BatchNorm are f32 noise on both
        # sides
        gmax = max(g.abs().max().item() for g in g_cpu.values())
        for k in g_cpu:
            _check_close(f"small[{impl}] grad {k}", g_gpu[k], g_cpu[k],
                         rtol=1e-4, atol=1e-4 * gmax)
    _log("small_reference", graphs=8, hidden=32, layers=2,
         max_abs_out_err=worst, ok=True)


def counting_batch(dev):
    """The PPGN_eff bench batch (bench.py:267-282,484-501), built by the
    port: 128 counting graphs, y cut to column 0, featurized with
    EscConfig(h=2, use_rd=True, self_loop=True), one width batch."""
    from escgnn_tpu_torch.data.batching import BatchSpec, pad_and_batch
    from escgnn_tpu_torch.data.counting import (
        CountingDatasetConfig,
        generate_counting_graphs,
    )
    from escgnn_tpu_torch.featurize import EscConfig, featurize_many

    t0 = time.perf_counter()
    splits = generate_counting_graphs(
        CountingDatasetConfig(num_graphs=NUM_GRAPHS, seed=0))
    graphs = [g for s in splits.values() for g in s][:NUM_GRAPHS]
    for g in graphs:
        g.y = g.y[:, :1]
    graphs = featurize_many(graphs, EscConfig(h=2, use_rd=True,
                                              self_loop=True))
    spec = BatchSpec.from_graphs(graphs, NUM_GRAPHS)
    batch = pad_and_batch(graphs, spec, device=dev)
    real_edges = sum(g.num_edges for g in graphs)
    nnz = int((batch.enc_cnt != 0).sum().item())
    _log("ppgn_batch", seconds=round(time.perf_counter() - t0, 3),
         N=batch.num_nodes, E=batch.num_edges, P=spec.enc_width,
         max_nodes=spec.max_nodes_per_graph, real_edges=real_edges,
         real_nodes=sum(g.num_nodes for g in graphs), enc_nnz=nnz)
    return batch, spec, real_edges


def check_k3(batch, dev):
    """K3 against its plain version at the PPGN_eff width shapes (the
    table too tall for shared memory: rows read through L1), two calls
    equal; the same rows with the table cut to 128 rows (resident in
    shared memory); the ragged cases of `_ragged_cases`, resident and
    through L1."""
    import torch.nn.functional as F

    from escgnn_tpu_torch.ops import smem_plan, zemb_gather

    gen = torch.Generator(device=dev).manual_seed(3)
    idx = batch.enc_idx.to(torch.int32).contiguous()
    cnt = batch.enc_cnt.to(torch.float32).contiguous()
    E, P = idx.shape
    Z, H = 1800, PPGN_EMB
    sms = smem_plan.sm_count(dev)
    plan = smem_plan.smem_plan(Z, H, sms)
    table = torch.randn(Z, H, device=dev, generator=gen)
    got = zemb_gather.zemb_gather(table, idx, cnt)
    want = zemb_gather.zemb_gather_plain(table, idx, cnt)
    torch.cuda.synchronize()
    # f32 products of unit normals and counts (row sums up to a few
    # hundred), summed over up to 56 entries in another order
    tol = dict(rtol=1e-5, atol=1e-4)
    err = _check_close("K3", got, want, **tol)
    if not torch.equal(got, zemb_gather.zemb_gather(table, idx, cnt)):
        raise AssertionError("K3 is not deterministic from run to run")
    # the same rows with the table cut to 128 rows (ids modulo 128): the
    # table slice is resident in shared memory
    cut, cut_ids = table[:128].contiguous(), (idx % 128).contiguous()
    if not smem_plan.smem_plan(128, H, sms).resident:
        raise AssertionError("K3: a 128-row table is not planned resident")
    _check_close("K3 cut table", zemb_gather.zemb_gather(cut, cut_ids, cnt),
                 zemb_gather.zemb_gather_plain(cut, cut_ids, cnt), **tol)

    ragged = []
    for name, tr, ir, cr in _ragged_cases(gen, dev):
        _check_close(f"K3 ragged {name}", zemb_gather.zemb_gather(tr, ir, cr),
                     zemb_gather.zemb_gather_plain(tr, ir, cr), **tol)
        ragged.append(name)

    ms = _cuda_ms(lambda: zemb_gather.zemb_gather(table, idx, cnt))
    plain_ms = _cuda_ms(lambda: zemb_gather.zemb_gather_plain(table, idx, cnt))
    # yardstick: the one PyTorch call computing the same z (never called
    # by the port)
    idx64 = idx.long()
    library_ms = _cuda_ms(lambda: F.embedding_bag(
        idx64, table, per_sample_weights=cnt, mode="sum"))
    nonzero = cnt != 0
    nnz = int(nonzero.sum().item())
    # the table rows this batch's entries touch, each read once
    rows = int(torch.unique(idx[nonzero & (idx >= 0) & (idx < Z)]).numel())
    nbytes = E * P * 4 * 2 + rows * H * 4 + E * H * 4
    bound_ms, bound_by = _bound(nbytes, 2 * nnz * H)
    _log("k3", shapes=f"E={E},P={P},Z={Z},H={H}", nnz=nnz,
         table_rows_touched=rows, max_abs_err=err, deterministic=True,
         ragged=",".join(ragged), **_plan_fields(plan),
         ms=ms, plain_ms=plain_ms, library_ms=library_ms,
         library="F.embedding_bag(mode=sum,per_sample_weights)",
         bound_ms=bound_ms, bound_by=bound_by, ok=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)


def check_k4(dev, G, N):
    """K4 against its plain version at the PPGN_eff grid (f32 and bf16
    inputs) and on ragged grids (G, N and C off any tiling)."""
    from escgnn_tpu_torch.ops import ppgn_pool

    gen = torch.Generator(device=dev).manual_seed(4)
    C = PPGN_EMB
    # f32 sums of 2N unit normals in another order
    tol = dict(rtol=1e-6, atol=1e-5)
    x32 = torch.randn(G, N, N, C, device=dev, generator=gen)
    x16 = x32.to(torch.bfloat16)
    err = 0.0
    for name, x in (("f32", x32), ("bf16", x16)):
        got = ppgn_pool.diag_row_col_pool(x)
        torch.cuda.synchronize()
        err = max(err, _check_close(f"K4 {name}", got,
                                    ppgn_pool.diag_row_col_pool_plain(x),
                                    **tol))
    for shape in ((3, 7, 7, 20), (5, 30, 30, 200)):
        for dt in (torch.float32, torch.bfloat16):
            xr = torch.randn(*shape, device=dev, generator=gen).to(dt)
            _check_close(f"K4 ragged {shape} {dt}",
                         ppgn_pool.diag_row_col_pool(xr),
                         ppgn_pool.diag_row_col_pool_plain(xr), **tol)

    # timed on the main path's input type (bf16 blocks)
    ms = _cuda_ms(lambda: ppgn_pool.diag_row_col_pool(x16))
    plain_ms = _cuda_ms(lambda: ppgn_pool.diag_row_col_pool_plain(x16))
    nbytes = G * N * N * C * 2 + G * N * 2 * C * 4
    bound_ms, bound_by = _bound(nbytes, 2 * G * N * N * C)
    _log("k4", shapes=f"G={G},N={N},C={C}", dtype="bf16", max_abs_err=err,
         ms=ms, plain_ms=plain_ms, library_ms=None,
         library="none: no single PyTorch call computes [diag|row+col-2diag]",
         bound_ms=bound_ms, bound_by=bound_by, ok=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bound_ms, bound_by=bound_by)


def ppgn_config(max_nodes: int, pool_impl: str, compute_dtype="bfloat16",
                emb_dim=PPGN_EMB, num_rb_layers=PPGN_BLOCKS):
    from escgnn_tpu_torch.models.ppgn import PPGNConfig

    return PPGNConfig(emb_dim=emb_dim, num_rb_layers=num_rb_layers,
                      max_nodes=max_nodes, node_level=True, use_esc=True,
                      compute_dtype=compute_dtype, pool_impl=pool_impl)


def check_small_ppgn(dev):
    """PPGN_eff on the card (K3 and K4) against the port on the CPU (plain
    versions) on a small f32 width batch: train-mode outputs and every
    gradient."""
    from escgnn_tpu_torch.data.batching import BatchSpec, pad_and_batch
    from escgnn_tpu_torch.data.counting import (
        CountingDatasetConfig,
        generate_counting_graphs,
    )
    from escgnn_tpu_torch.featurize import EscConfig, featurize_many
    from escgnn_tpu_torch.models.ppgn import PPGN
    from escgnn_tpu_torch.ops import zemb
    from escgnn_tpu_torch.train.loop import l1_node_loss

    splits = generate_counting_graphs(CountingDatasetConfig(num_graphs=8,
                                                            seed=5))
    graphs = featurize_many(splits["train"][:6],
                            EscConfig(h=2, use_rd=True, self_loop=True))
    for g in graphs:
        g.y = g.y[:, :1]
    spec = BatchSpec.from_graphs(graphs, 6)
    cfg = ppgn_config(spec.max_nodes_per_graph, "pallas", "float32",
                      emb_dim=32, num_rb_layers=2)
    cpu_model = PPGN(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(6))
    zemb.set_impl("pallas")
    try:
        results = []
        for device in ("cpu", dev):
            b = pad_and_batch(graphs, spec, device=device)
            m = copy.deepcopy(cpu_model).to(device).train()
            out = m(b)
            l1_node_loss(out, b).backward()
            grads = {k: p.grad.cpu() for k, p in m.named_parameters()}
            results.append((out.detach().cpu(), grads))
    finally:
        zemb.set_impl("countmat")
    (o_cpu, g_cpu), (o_gpu, g_gpu) = results
    # f32 on both sides, sums in another order (rtol/atol 1e-4); the
    # gradients at atol 1e-4 of the largest one (the biases feeding a
    # BatchNorm have zero gradients, f32 noise on both sides)
    err = _check_close("small ppgn out", o_gpu, o_cpu, rtol=1e-4, atol=1e-4)
    gmax = max(g.abs().max().item() for g in g_cpu.values())
    for k in g_cpu:
        _check_close(f"small ppgn grad {k}", g_gpu[k], g_cpu[k],
                     rtol=1e-4, atol=1e-4 * gmax)
    _log("small_ppgn", graphs=6, emb=32, blocks=2, max_abs_out_err=err,
         ok=True)


def run_ppgn(batch, spec, real_edges, dev):
    """The PPGN_eff main path through K3 and K4: 10 train steps and one
    eval step, then one default-impl step from the same initial state.
    Returns the kernels' launches on the main path."""
    from escgnn_tpu_torch.models.ppgn import PPGN
    from escgnn_tpu_torch.ops import ppgn_pool, zemb, zemb_gather
    from escgnn_tpu_torch.train.loop import (
        adam_with_plateau,
        eval_step,
        l1_node_loss,
        train_step,
    )

    N = spec.max_nodes_per_graph
    model = PPGN(ppgn_config(N, "pallas"), device=dev,
                 generator=torch.Generator().manual_seed(0))
    init_state = copy.deepcopy(model.state_dict())
    opt = adam_with_plateau(model.parameters(), LR)
    zemb.set_impl("pallas")
    try:
        zemb_gather.launches = 0
        ppgn_pool.launches = 0
        losses, step_ms = [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            losses.append(train_step(model, opt, batch, l1_node_loss))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        launches = {"k3": zemb_gather.launches, "k4": ppgn_pool.launches}
        zemb_gather.launches = 0
        ppgn_pool.launches = 0
        err_sum, count = eval_step(model, batch, node_level=True)
        torch.cuda.synchronize()
        eval_launches = {"k3": zemb_gather.launches, "k4": ppgn_pool.launches}
        with torch.no_grad():
            out = model.eval()(batch)
        torch.cuda.synchronize()
    finally:
        zemb.set_impl("countmat")
    n_rows = batch.num_nodes
    if tuple(out.shape) != (n_rows, 1) or not torch.isfinite(out).all():
        raise AssertionError(f"PPGN eval output {tuple(out.shape)} is not a "
                             f"finite ({n_rows}, 1) tensor")
    losses = [float(v) for v in losses]
    mae = float(err_sum) / float(count)
    if not all(math.isfinite(v) for v in losses) or not math.isfinite(mae):
        raise AssertionError(f"PPGN: non-finite loss or MAE: {losses} {mae}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"PPGN loss did not fall: {losses}")
    if launches != {"k3": TRAIN_STEPS, "k4": TRAIN_STEPS}:
        raise AssertionError(f"PPGN: {launches} launches in {TRAIN_STEPS} "
                             f"steps, want one of each per step")
    if eval_launches != {"k3": 1, "k4": 1}:
        raise AssertionError(f"PPGN eval step: {eval_launches} launches")
    ms_step = statistics.median(step_ms[1:])
    _log("ppgn", steps=TRAIN_STEPS, emb=PPGN_EMB, blocks=PPGN_BLOCKS,
         graphs=NUM_GRAPHS, E=batch.num_edges, P=spec.enc_width, N=N,
         first_loss=losses[0], last_loss=losses[-1], eval_mae=mae,
         first_step_ms=step_ms[0], median_ms_per_step=ms_step,
         real_edges_per_s=real_edges / (ms_step / 1e3),
         k3_launches=launches["k3"], k4_launches=launches["k4"],
         eval_k3_launches=eval_launches["k3"],
         eval_k4_launches=eval_launches["k4"], ok=True)

    # the default impls ("countmat", pool "xla") from the same state: the
    # kernel path's first loss was taken from that state too
    m_def = PPGN(ppgn_config(N, "xla"), device=dev)
    m_def.load_state_dict(init_state)
    zemb_gather.launches = 0
    ppgn_pool.launches = 0
    t0 = time.perf_counter()
    loss_def = float(train_step(m_def, adam_with_plateau(m_def.parameters(), LR),
                                batch, l1_node_loss))
    torch.cuda.synchronize()
    def_ms = (time.perf_counter() - t0) * 1e3
    if zemb_gather.launches or ppgn_pool.launches:
        raise AssertionError("the default impls launched K3 or K4")
    # the bf16 blocks can round an f32 difference of the z reduce (summed
    # in another order) the other way
    if not math.isclose(loss_def, losses[0], rel_tol=1e-3):
        raise AssertionError(f"PPGN default-impl loss {loss_def} != kernel "
                             f"path {losses[0]}")
    _log("ppgn_default", loss_default=loss_def, loss_kernels=losses[0],
         step_ms=def_ms, ok=True)
    return launches


def _check_epochs(name, res, steps):
    """Finite losses that fall from the first epoch to the last, and the
    expected steps per epoch."""
    losses = [e["loss"] for e in res["epochs"]]
    maes = [e["val_mae"] for e in res["epochs"]]
    if not all(math.isfinite(v) for v in losses + maes):
        raise AssertionError(f"{name}: non-finite loss or MAE: {losses} {maes}")
    if len(losses) > 1 and not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: loss did not fall: {losses}")
    if any(e["steps"] != steps for e in res["epochs"]):
        raise AssertionError(f"{name}: steps per epoch "
                             f"{[e['steps'] for e in res['epochs']]}, want "
                             f"{steps}")


def _epoch_fields(res):
    """Per-epoch numbers of a driver run, for a phase line; ms/step is the
    train part of the epoch (synchronized by reading its mean loss) over
    its steps."""
    eps = res["epochs"]
    return dict(
        data_seconds=round(res["data_seconds"], 3),
        epoch_seconds=json.dumps([round(e["seconds"], 4) for e in eps]),
        loss=json.dumps([e["loss"] for e in eps]),
        val_mae=json.dumps([e["val_mae"] for e in eps]),
        best_val_mae=res["best_val"], best_test_mae=res["best_test"],
        graphed_ms_per_step=json.dumps(
            [round(e["train_seconds"] / e["steps"] * 1e3, 4) for e in eps]))


def run_zinc_twin(work: str, smi: str):
    """`[run_zinc]`: the ZINC twin's main() at its defaults (hidden 256 x
    5 layers, batch 128, lr 5e-4, `--bn_eval running`) on 1000 synthetic
    molecules for 3 epochs: 800 train graphs, 7 steps per epoch over 4
    pools, each epoch one graphed pool step. K1's wrapper counts the
    warm-up steps and the capture only; `[pool_graph]` counts its launches
    in a graphed epoch with the profiler. Returns the run's result."""
    from escgnn_tpu_torch import run_zinc
    from escgnn_tpu_torch.ops import expand_cuda

    argv = ["--num_graphs", "1000", "--epochs", "3", "--num_workers", "2",
            "--data_dir", os.path.join(work, "data"),
            "--res_dir", os.path.join(work, "zinc")]
    expand_cuda.launches = 0
    t0 = time.perf_counter()
    res = run_zinc.main(argv)
    seconds = time.perf_counter() - t0
    k1_wrapper = expand_cuda.launches
    _check_epochs("run_zinc", res, steps=7)
    if k1_wrapper < 1:
        raise AssertionError("run_zinc did not launch K1")
    for f in ("config.json", "cmd_input.txt", "log.txt"):
        if not os.path.exists(os.path.join(res["res_dir"], f)):
            raise AssertionError(f"run_zinc wrote no {f}")
    _log("run_zinc", seconds=round(seconds, 3), graphs=1000, steps_per_epoch=7,
         **_epoch_fields(res), k1_wrapper_launches=k1_wrapper,
         card=json.dumps(smi), ok=True)
    return res


def check_pool_graph(twin: str, model, loss_fn, train, spec, lr, dev,
                     kernel=("k1", "segsum_kernel"), rel_tol=(1e-5, 1e-3),
                     batch_transform=None, report=None):
    """`[pool_graph]`: from one state snapshot of `model`, one epoch of a
    twin's train pool (its graphs, spec and model at full width) through
    the graphed pool step and one through eager steps. The first step's
    loss agrees at rel_tol[0] (1e-5) and every later one at rel_tol[1]
    (1e-3): the path is f32, but pooling and the embedding backward add
    with atomics in no fixed order, and Adam amplifies that noise.
    `rel_tol=None` (a model with dropout: the two epochs draw other
    masks) compares nothing and checks that both losses are finite. The
    kernel (label, symbol), K1 unless said, runs once per step of a
    graphed epoch (None: no kernel on the path): one node of the captured
    graph, replayed once per step (`_GraphLedger`), seen by the profiler
    at least once and never more often. Prints
    both ms/step, the device's busy time per step, the launches per eager
    step, the seconds the pool took to build and the peak device memory
    of the graphed epoch; returns the kernel's launches in the graphed
    epoch.
    `batch_transform` applies to every pooled batch (the bucketed copy
    layout); `report`, a dict, receives the printed numbers."""
    import numpy as np

    from escgnn_tpu_torch.data.prefetch import pool_entry, stacked_batch_pools
    from escgnn_tpu_torch.train.loop import (
        adam_with_plateau,
        make_pool_train_step,
        train_step,
    )

    t0 = time.perf_counter()
    pools, steps = stacked_batch_pools(train, spec, k=1, seed=0, device=dev,
                                       batch_transform=batch_transform)
    torch.cuda.synchronize()
    pool_build_s = time.perf_counter() - t0
    pool = pools[0]
    order = np.random.default_rng(0).permutation(steps)
    init = copy.deepcopy(model.state_dict())

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3 / steps

    opt = adam_with_plateau(model.parameters(), lr, capturable=True)
    ledger = _GraphLedger()
    t0 = time.perf_counter()
    with ledger.watch():
        graphed = make_pool_train_step(model, opt, loss_fn, pool)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    g_losses, g_ms = timed(lambda: graphed(pool, order).tolist())
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    model.load_state_dict(init)
    opt_e = adam_with_plateau(model.parameters(), lr, capturable=True)
    e_losses, e_ms = timed(lambda: torch.stack([
        train_step(model, opt_e, pool_entry(pool, int(j)), loss_fn)
        for j in order]).tolist())
    rel = [abs(g - e) / abs(e) for g, e in zip(g_losses, e_losses)]
    if rel_tol is None:
        if not all(math.isfinite(v) for v in g_losses + e_losses):
            raise AssertionError(f"{twin}: non-finite losses {g_losses} "
                                 f"{e_losses}")
    elif rel[0] > rel_tol[0] or max(rel) > rel_tol[1]:
        raise AssertionError(f"{twin}: graphed losses {g_losses} != eager "
                             f"{e_losses}")

    # launches: the kernel's in one graphed epoch (its nodes in the
    # captured graph times the replays; the profiler's sightings beside
    # them) and the profiler's device events in it and in one eager step
    per_epoch = {}
    ledger.clear_replays()
    with ledger.watch():
        _, prof = _profiled(lambda: graphed(pool, order))
    if kernel is not None:
        label, symbol = kernel
        n, seen = ledger.launches(symbol), _kernel_events(prof, symbol)
        if n != steps or not 1 <= seen <= n:
            raise AssertionError(
                f"{twin}: {label} ran {n} times in a graphed epoch of "
                f"{steps} steps ({ledger.nodes(symbol)} node(s) in the "
                f"graph, {sum(ledger.replays)} replays; the profiler saw "
                f"{seen})")
        per_epoch = {f"{label}_per_graphed_epoch": n,
                     f"{label}_profiler_seen": seen}
    graphed_events = _kernel_events(prof)
    graphed_busy = _busy_ms(prof) / steps
    launch_host = _host_ms(prof, "cudaGraphLaunch") / steps
    eager_step = lambda: train_step(  # noqa: E731
        model, opt_e, pool_entry(pool, int(order[0])), loss_fn)
    per_eager = _device_kernels(eager_step)
    _, prof = _profiled(eager_step)
    eager_busy = _busy_ms(prof)
    fields = dict(
        graphed_ms_per_step=g_ms, eager_ms_per_step=e_ms,
        graphed_busy_ms_per_step=graphed_busy,
        eager_busy_ms_per_step=eager_busy,
        graphed_idle_share=1 - graphed_busy / g_ms,
        graph_kernel_nodes=ledger.nodes("{KERNEL"),
        graph_launch_host_ms_per_step=launch_host,
        eager_idle_share=1 - eager_busy / e_ms,
        losses_compared=rel_tol is not None, first_loss_rel=rel[0],
        max_loss_rel=max(rel),
        graphed_losses=json.dumps(g_losses), eager_losses=json.dumps(e_losses),
        **per_epoch, device_events_per_graphed_step=graphed_events / steps,
        launches_per_eager_step=per_eager, pool_build_s=pool_build_s,
        graphed_peak_mem_gb=peak_gb)
    if report is not None:
        report.update(fields)
    _log("pool_graph", twin=twin, steps=steps, capture_s=round(capture_s, 3),
         **fields, ok=True)
    return next(iter(per_epoch.values()), 0)


def check_zinc_pool_graph(work: str, zinc_res, dev):
    """`[pool_graph]` on the ZINC twin's train split (read from its cache,
    normalized as the run did) with its model."""
    import numpy as np

    from escgnn_tpu_torch import run_zinc
    from escgnn_tpu_torch.featurize.cache import cache_path, load_graphs
    from escgnn_tpu_torch.models.nested_gin_eff import NestedGINEff
    from escgnn_tpu_torch.train.loop import l1_graph_loss

    args = run_zinc.build_parser().parse_args([])
    train = load_graphs(cache_path(os.path.join(work, "data", "zinc_synth"),
                                   "train_n1000_s0_esc_h3_rd_sl"))
    for g in train:
        g.y = ((g.y - zinc_res["mean"]) / zinc_res["std"]).astype(np.float32)
    model = NestedGINEff(run_zinc.zinc_model_config(args), device=dev,
                         generator=torch.Generator().manual_seed(0))
    return check_pool_graph("run_zinc", model, l1_graph_loss, train,
                            zinc_res["spec"], args.lr, dev)


def run_graphcount_twin(work: str, smi: str):
    """`[run_graphcount]`: the counting twin's main() at its defaults
    (NestedGIN_eff, h 3, hidden 256 x 5 layers, batch 128, lr 5e-3) on 400
    graphs for 3 epochs; the best checkpoint restored into a fresh model
    and evaluated without a refresh gives the logged best val MAE (rel
    1e-5); a second featurization call hits the cache and gives equal
    arrays; `[pool_graph]` on its pool; a 1-epoch run warm-started from
    the checkpoint (bf16 conv stacks, clipped, `--analyze`) has a lower
    epoch-1 loss than the cold run; 1 epoch of PPGN_eff; 2 eager epochs
    with `--reshuffle_membership --bn_eval batch` whose loss falls."""
    import glob

    import numpy as np

    from escgnn_tpu_torch import run_graphcount as rg
    from escgnn_tpu_torch.data.counting import (
        CountingDatasetConfig,
        generate_counting_graphs,
        normalize_targets,
    )
    from escgnn_tpu_torch.data.prefetch import stack_split
    from escgnn_tpu_torch.featurize import EscConfig, featurize_many
    from escgnn_tpu_torch.ops import expand_cuda
    from escgnn_tpu_torch.train.checkpoint import (
        CheckpointManager,
        load_model_tree,
        model_tree,
    )
    from escgnn_tpu_torch.train.loop import l1_node_loss, make_pool_eval_step

    data = os.path.join(work, "data")
    base = ["--num_graphs", "400", "--data_dir", data]
    cold_dir = os.path.join(work, "count_cold")
    expand_cuda.launches = 0
    t0 = time.perf_counter()
    cold = rg.main(base + ["--epochs", "3", "--res_dir", cold_dir])
    cold_s = time.perf_counter() - t0
    k1_wrapper = expand_cuda.launches
    _check_epochs("run_graphcount", cold, steps=3)
    if k1_wrapper < 1:
        raise AssertionError("run_graphcount did not launch K1")

    # the best checkpoint, restored and evaluated with its saved stats
    args = rg.build_parser().parse_args(base)
    cache_files = sorted(glob.glob(os.path.join(data, "count_cycle", "*.npz")))
    mtimes = [os.path.getmtime(f) for f in cache_files]
    splits = rg.build_datasets(args)
    if len(cache_files) != 3 or [os.path.getmtime(f)
                                 for f in cache_files] != mtimes:
        raise AssertionError(f"the second featurization did not hit the "
                             f"cache: {cache_files}")
    fresh = featurize_many(
        generate_counting_graphs(CountingDatasetConfig(num_graphs=400))["val"],
        EscConfig(h=3, use_rd=True, self_loop=True))
    for a, b in zip(splits["val"], fresh):
        for f in ("edge_index", "x", "y", "enc_idx", "enc_cnt", "enc_offsets"):
            if not np.array_equal(getattr(a, f), getattr(b, f)):
                raise AssertionError(f"cached {f} differs from a fresh "
                                     f"featurization")
    splits, _, std = normalize_targets(splits, args.target)
    spec = cold["spec"]
    model = rg.build_model(args, spec, splits["train"][0].x.shape[1],
                           torch.device("cuda", 0))
    ckpt = CheckpointManager(os.path.join(cold_dir, "ckpt"))
    load_model_tree(model, ckpt.restore(template=model_tree(model)))
    e, c = make_pool_eval_step(model, node_level=True)(
        stack_split(splits["val"], spec))
    restored_mae = float(e) / float(c) * std
    if not math.isclose(restored_mae, cold["best_val"], rel_tol=1e-5):
        raise AssertionError(f"restored best checkpoint: val MAE "
                             f"{restored_mae} != logged {cold['best_val']}")

    k1_graphed = check_pool_graph(
        "run_graphcount",
        rg.build_model(args, spec, splits["train"][0].x.shape[1],
                       torch.device("cuda", 0)),
        l1_node_loss, splits["train"], spec, args.lr, torch.device("cuda", 0))

    # the warm start also captures the bf16 conv stacks and the clip
    warm = rg.main(base + ["--epochs", "1", "--load_ckpt",
                           os.path.join(cold_dir, "ckpt"),
                           "--compute_dtype", "bfloat16", "--grad_clip", "1.0",
                           "--analyze",
                           "--res_dir", os.path.join(work, "count_warm")])
    if not warm["epochs"][0]["loss"] < cold["epochs"][0]["loss"]:
        raise AssertionError(f"warm start: epoch-1 loss "
                             f"{warm['epochs'][0]['loss']} not below the cold "
                             f"run's {cold['epochs'][0]['loss']}")
    t0 = time.perf_counter()
    ppgn = rg.main(base + ["--epochs", "1", "--model", "PPGN_eff",
                           "--res_dir", os.path.join(work, "count_ppgn")])
    ppgn_s = time.perf_counter() - t0
    _check_epochs("run_graphcount PPGN_eff", ppgn, steps=3)
    # the eager path: batches re-formed every epoch by the prefetch thread
    # (pinned, non-blocking copies), eval with batch statistics
    eager = rg.main(base + ["--epochs", "2", "--reshuffle_membership",
                            "--bn_eval", "batch",
                            "--res_dir", os.path.join(work, "count_eager")])
    _check_epochs("run_graphcount --reshuffle_membership", eager, steps=3)
    _log("run_graphcount", seconds=round(cold_s, 3), graphs=400,
         steps_per_epoch=3, **_epoch_fields(cold),
         k1_wrapper_launches=k1_wrapper, ckpt_steps=json.dumps(
             ckpt.all_steps()), restored_val_mae=restored_mae,
         cache_hit=True, warm_epoch1_loss=warm["epochs"][0]["loss"],
         ppgn_seconds=round(ppgn_s, 3), ppgn_loss=ppgn["epochs"][0]["loss"],
         ppgn_graphed_ms_per_step=round(
             ppgn["epochs"][0]["train_seconds"] / 3 * 1e3, 4),
         reshuffle_loss=json.dumps([e["loss"] for e in eager["epochs"]]),
         reshuffle_eager_ms_per_step=json.dumps(
             [round(e["train_seconds"] / 3 * 1e3, 4)
              for e in eager["epochs"]]),
         card=json.dumps(smi), ok=True)
    return k1_graphed


def _regression_twin(name, twin, work, smi, graphs, steps, loss_fn,
                     build_model, flags=(), kernel=("k1", "segsum_kernel")):
    """`[<name>]`: a regression twin's main() at its default widths (and
    `flags`) on `graphs` molecules for 3 graphed epochs (loss
    falls, finite MAE, the expected steps per epoch), then `[pool_graph]`
    on its train split (built again by the twin's own `build_splits`) and
    a fresh model: `kernel`, K1 unless said, once per graphed step,
    counted by the profiler (None: no port kernel on the path). Returns
    (the run's result, its flags, the kernel's launches in one graphed
    epoch)."""
    argv = ["--num_graphs", str(graphs), "--epochs", "3",
            "--num_workers", "2", "--res_dir", os.path.join(work, name),
            *flags]
    if twin.__name__.endswith(("run_qm9", "run_zinc")):
        argv += ["--data_dir", os.path.join(work, "data")]
    t0 = time.perf_counter()
    res = twin.main(argv)
    seconds = time.perf_counter() - t0
    _check_epochs(name, res, steps=steps)
    args = twin.build_parser().parse_args(argv)
    splits = twin.build_splits(args)[0]
    report = {}
    k1_graphed = check_pool_graph(name, build_model(args, splits),
                                  loss_fn, splits["train"], res["spec"],
                                  args.lr, torch.device("cuda", 0),
                                  kernel=kernel, report=report)
    res["pool_graph"] = report
    _log(name, seconds=round(seconds, 3), graphs=graphs,
         steps_per_epoch=steps, hidden=args.hidden, layers=args.layers,
         batch=args.batch_size, **_epoch_fields(res),
         **({f"{kernel[0]}_per_graphed_epoch": k1_graphed} if kernel
            else {}), card=json.dumps(smi), ok=True)
    return res, args, k1_graphed


def run_zinc_cycle_twin(work: str, smi: str):
    """`[run_zinc_cycle]`: the node-level ZINC twin at its defaults
    (hidden 256 x 5, batch 128, lr 1e-3, target 0: 3-cycles per node) on
    1000 synthetic molecules: 800 train graphs, 7 steps per epoch."""
    from escgnn_tpu_torch import run_zinc_cycle
    from escgnn_tpu_torch.train.loop import l1_node_loss

    dev = torch.device("cuda", 0)
    return _regression_twin(
        "run_zinc_cycle", run_zinc_cycle, work, smi, 1000, 7, l1_node_loss,
        lambda args, splits: run_zinc_cycle.build_model(args, dev))[2]


def run_qm9_twin(work: str, smi: str):
    """`[run_qm9]`: the QM9 twin's NestedGIN_eff path at its defaults
    (hidden 256 x 5, batch 64, lr 1e-3, target 0, mean pool, the three
    QM9 fields: node-type extras through the pools and the graphed step)
    on 1000 synthetic molecules: the shuffled 10/10/80 split leaves 800
    train graphs, 13 steps per epoch. The MAE is in the target's units
    (`QM9_CONVERSION[0]`)."""
    from escgnn_tpu_torch import run_qm9
    from escgnn_tpu_torch.data.qm9 import QM9_CONVERSION

    dev = torch.device("cuda", 0)

    def build(args, splits):
        g = splits["train"][0]
        return run_qm9.build_model(args, g.x.shape[1], g.edge_attr.shape[1],
                                   dev)

    res, args, k1 = _regression_twin("run_qm9", run_qm9, work, smi, 1000, 13,
                                     run_qm9.mse_loss, build)
    if res["conversion"] != float(QM9_CONVERSION[args.target]):
        raise AssertionError(f"run_qm9: MAE scaled by {res['conversion']}, "
                             f"not QM9_CONVERSION[{args.target}]")
    if res["spec"].num_nodes != 64 * res["spec"].uniform_nodes:
        raise AssertionError(f"run_qm9: spec {res['spec']}")
    return k1


def check_k1_width300(batch, dev):
    """K1 at the OGB path's width, H 300, on the sorted view of one of its
    dedup batches: f32 contiguous (the path's layout, checked against the
    f64 sum and timed), bf16 contiguous (a 600-byte row stride: single
    columns) and bf16 as the first 300 columns of a 304-wide tensor
    (37 eight-wide units and a 4-column tail), both against the plain
    version; two calls bit-equal, rows no id names exactly 0, one launch
    per call by the wrapper's count (the profiler's device events of one
    call are printed beside it)."""
    from escgnn_tpu_torch.ops import expand_cuda

    perm, rows = batch.enc_edge_perm, batch.enc_row_sorted
    E, R, H = perm.shape[0], batch.enc_idx.shape[0], 300
    gen = torch.Generator(device=dev).manual_seed(3)
    f32 = torch.randn(E, H, device=dev, generator=gen)
    w16 = torch.randn(E, H + 4, device=dev, generator=gen).to(torch.bfloat16)
    cases = {"f32_h300": (f32, True),
             "bf16_h300": (w16[:, :H].contiguous(), False),
             "bf16_h300_ld304": (w16[:, :H], False)}
    unnamed = torch.bincount(rows.long(), minlength=R)[:R] == 0
    err = 0.0
    for name, (dZ, exact) in cases.items():
        got = expand_cuda.sorted_segment_sum(dZ, perm, rows, R)
        if exact:
            want = torch.zeros(R, H, dtype=torch.float64, device=dev).index_add_(
                0, rows.long(), dZ.double().index_select(0, perm.long()))
        else:
            want = expand_cuda.sorted_segment_sum_plain(dZ, perm, rows, R)
        torch.cuda.synchronize()
        e = _check_close(f"K1 {name}", got, want.float(), rtol=1e-5,
                         atol=1e-4)
        if exact:
            err = max(err, e)
        if not torch.equal(got, expand_cuda.sorted_segment_sum(dZ, perm,
                                                               rows, R)):
            raise AssertionError(f"K1 {name}: not deterministic")
        if unnamed.any() and got[unnamed].abs().max().item() != 0:
            raise AssertionError(f"K1 {name}: a row no id names is not 0")
    before = expand_cuda.launches
    profiled_events = _device_kernels(
        lambda: expand_cuda.sorted_segment_sum(f32, perm, rows, R))
    per_call = (expand_cuda.launches - before) / 2  # a warm call, then one
    if per_call != 1:
        raise AssertionError(f"K1 launched {per_call} times in one call")
    ms = _cuda_ms(lambda: expand_cuda.sorted_segment_sum(f32, perm, rows, R))
    plain_ms = _cuda_ms(
        lambda: expand_cuda.sorted_segment_sum_plain(f32, perm, rows, R))
    edge_row = batch.enc_edge_row.long()
    library_ms = _cuda_ms(
        lambda: torch.zeros(R, H, device=dev).index_add_(0, edge_row, f32))
    bound_ms, bound_by = _bound(E * H * 4 + 2 * E * 4 + R * H * 4, E * H)
    return dict(shapes=f"E={E},R={R},H={H}", cases=",".join(cases),
                max_abs_err_f32=err, launches_per_call=per_call,
                profiled_events_per_call=profiled_events, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def check_dropout_replays(args, graphs, spec, dev):
    """Two replays of the captured OGB train step on one batch, the
    weights and Adam's state put back between them but not the dropout
    generator: at the twin's dropout they must give different losses
    (each replay draws new masks), at dropout 0 equal ones (rel 1e-6).
    Returns {dropout: (first, second)}."""
    from escgnn_tpu_torch import run_ogb_mol
    from escgnn_tpu_torch.data.prefetch import stack_split
    from escgnn_tpu_torch.train import loop

    pool = stack_split(graphs[:2 * spec.num_graphs], spec, dev)
    out = {}
    for drop in (args.drop_ratio, 0.0):
        model = run_ogb_mol.build_model(
            argparse.Namespace(**dict(vars(args), drop_ratio=drop)), dev)
        opt = loop.adam_with_plateau(model.parameters(), args.lr,
                                     capturable=True)
        step = loop.make_pool_train_step(model, opt, loop.bce_graph_loss,
                                         pool)
        snap = dict(loop._snapshot(model, opt), rng=[])
        first = float(step(pool, [0])[0])
        loop._restore_in_place(model, opt, snap)
        second = float(step(pool, [0])[0])
        out[drop] = (first, second)
    a, b = out[args.drop_ratio]
    if not (math.isfinite(a) and math.isfinite(b)) or math.isclose(
            a, b, rel_tol=1e-6):
        raise AssertionError(f"dropout {args.drop_ratio}: two replays gave "
                             f"losses {a} and {b}: one mask in every replay")
    a, b = out[0.0]
    if not math.isclose(a, b, rel_tol=1e-6):
        raise AssertionError(f"dropout 0: two replays gave {a} and {b}")
    return out


def _bench_step(make_model, pool, loss_fn, steps: int = 20, kernel=None):
    """One bench-shaped train step, batch 0 of `pool`, timed as the
    graphed pool step replayed over it and as eager steps, each on a
    fresh model from `make_model()`. Returns the numbers: ms/step both
    ways, the graphed step's busy ms, idle share and device events per
    step, from the profiler over 5 replays, and with `kernel` (a symbol)
    its launches per replay (its nodes in the captured graph, seen by the
    profiler at least once and never more often: `_GraphLedger`)."""
    from escgnn_tpu_torch.data.prefetch import pool_entry
    from escgnn_tpu_torch.train.loop import (
        adam_with_plateau,
        make_pool_train_step,
        train_step,
    )

    m = make_model()
    opt = adam_with_plateau(m.parameters(), 1e-3, capturable=True)
    ledger = _GraphLedger()
    with ledger.watch():
        graphed = make_pool_train_step(m, opt, loss_fn, pool)
    graphed(pool, [0] * 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g_losses = graphed(pool, [0] * steps).tolist()
    g_ms = (time.perf_counter() - t0) * 1e3 / steps
    extra = {}
    with ledger.watch():
        _, prof = _profiled(lambda: graphed(pool, [0] * 5))
    if kernel is not None:
        n, seen = ledger.launches(kernel), _kernel_events(prof, kernel)
        if not 1 <= seen <= n:
            raise AssertionError(f"bench step: the profiler saw {kernel} "
                                 f"{seen} times in {n} launches")
        extra = dict(kernel_per_graphed_step=n / 5,
                     kernel_profiler_seen=seen)
    busy = _busy_ms(prof) / 5

    m = make_model()
    opt = adam_with_plateau(m.parameters(), 1e-3, capturable=True)
    b = pool_entry(pool, 0)
    for _ in range(3):
        train_step(m, opt, b, loss_fn)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e_losses = torch.stack([train_step(m, opt, b, loss_fn)
                            for _ in range(steps)]).tolist()
    e_ms = (time.perf_counter() - t0) * 1e3 / steps
    if not all(math.isfinite(v) for v in g_losses + e_losses):
        raise AssertionError(f"bench step: non-finite losses {g_losses} "
                             f"{e_losses}")
    return dict(graphed_ms_per_step=g_ms, eager_ms_per_step=e_ms,
                graphed_busy_ms_per_step=busy,
                graphed_idle_share=1 - busy / g_ms,
                device_events_per_graphed_step=_kernel_events(prof) / 5,
                graph_kernel_nodes=ledger.nodes("{KERNEL"), **extra)


def time_ogb_bench_step(dev):
    """The bench's OgbGNN line (`bench.py:522-540`): 32 molhiv-shaped
    synthetic graphs (h 4) in one uniform + dedup batch, OgbGNN 6 x 300,
    virtual node, dropout 0, bf16 conv stacks, masked BCE. Timed as the
    graphed pool step replayed over that batch and as eager steps, each
    from the same initial weights; the profiler reads the graphed step's
    busy time, device events and K1 launches."""
    from escgnn_tpu_torch.data.batching import BatchSpec
    from escgnn_tpu_torch.data.molecules import synthetic_ogb_mol
    from escgnn_tpu_torch.data.prefetch import stack_split
    from escgnn_tpu_torch.featurize import EscConfig, featurize_many
    from escgnn_tpu_torch.models.ogb_gnn import OgbGNN, OgbGNNConfig
    from escgnn_tpu_torch.train.loop import bce_graph_loss

    graphs = featurize_many(synthetic_ogb_mol(32, seed=0, num_tasks=1),
                            EscConfig(h=4, use_rd=True, self_loop=True),
                            num_workers=2)
    spec = BatchSpec.uniform(graphs, 32, enc_layout="dedup")
    pool = stack_split(graphs, spec, dev)
    cfg = OgbGNNConfig(num_tasks=1, num_layers=6, emb_dim=300, dropout=0.0,
                       virtual_node=True, compute_dtype="bfloat16")
    fields = _bench_step(
        lambda: OgbGNN(cfg, device=dev,
                       generator=torch.Generator().manual_seed(0)),
        pool, bce_graph_loss, kernel="segsum_kernel")
    fields["k1_per_graphed_step"] = fields.pop("kernel_per_graphed_step")
    if fields["k1_per_graphed_step"] != 1:
        raise AssertionError(f"ogb bench step: K1 "
                             f"{fields['k1_per_graphed_step']} times per "
                             f"step")
    real_edges = sum(g.num_edges for g in graphs)
    return dict(graphs=32, N=spec.num_nodes, E=spec.num_edges,
                R=spec.num_enc_rows, real_edges=real_edges, **fields,
                graphed_real_edges_per_s=real_edges / (
                    fields["graphed_ms_per_step"] / 1e3))


def check_small_ogb(dev):
    """OgbGNN on the card (K1 in the backward) against the CPU (plain
    versions) on a small f32 input (8 graphs, emb 16, 2 layers, attention
    pooling): eval logits on the running and on the batch statistics at
    dropout 0.5, and at dropout 0 the train-mode loss and every gradient,
    rtol/atol 1e-4 (gradients: atol 1e-4 of the largest)."""
    from escgnn_tpu_torch.data.batching import BatchSpec, pad_and_batch
    from escgnn_tpu_torch.data.molecules import synthetic_ogb_mol
    from escgnn_tpu_torch.featurize import EscConfig, featurize_many
    from escgnn_tpu_torch.models.layers import bn_statistics
    from escgnn_tpu_torch.models.ogb_gnn import OgbGNN, OgbGNNConfig
    from escgnn_tpu_torch.train.loop import bce_graph_loss

    graphs = featurize_many(synthetic_ogb_mol(8, seed=6, num_tasks=2,
                                              nan_frac=0.2),
                            EscConfig(h=4, use_rd=True, self_loop=True))
    spec = BatchSpec.uniform(graphs, 8, enc_layout="dedup")

    def run(device, drop):
        cfg = OgbGNNConfig(num_tasks=2, num_layers=2, emb_dim=16,
                           dropout=drop, graph_pooling="attention")
        m = OgbGNN(cfg, device=device,
                   generator=torch.Generator().manual_seed(4))
        b = pad_and_batch(graphs, spec, device=device)
        out = {}
        m.eval()
        with torch.no_grad():
            for running in (True, False):
                with bn_statistics(m, use_running_average=running):
                    out[f"eval_running_{running}"] = m(b).cpu()
        if drop == 0.0:
            m.train()
            loss = bce_graph_loss(m(b), b)
            loss.backward()
            out["loss"] = loss.detach().cpu()
            out.update({f"grad {k}": p.grad.cpu()
                        for k, p in m.named_parameters()})
        return out

    worst = 0.0
    for drop in (0.5, 0.0):
        cpu, gpu = run("cpu", drop), run(dev, drop)
        gmax = max((v.abs().max().item() for k, v in cpu.items()
                    if k.startswith("grad")), default=1.0)
        for k in cpu:
            atol = 1e-4 * gmax if k.startswith("grad") else 1e-4
            e = _check_close(f"small ogb[{drop}] {k}", gpu[k], cpu[k],
                             rtol=1e-4, atol=atol)
            if not k.startswith("grad"):
                worst = max(worst, e)
    _log("small_ogb", graphs=8, emb=16, layers=2, pooling="attention",
         max_abs_out_err=worst, ok=True)


def run_ogb_mol_twin(work: str, smi: str, dev):
    """`[run_ogb_mol]`: the OGB twin at its defaults (OgbGNN 6 x 300,
    virtual node, mean pooling, dropout 0.65, batch 32, h 4, masked BCE,
    ROC-AUC) on 640 synthetic molecules with the triangle label for 3
    epochs: 512 train graphs, 16 graphed steps per epoch (loss falls,
    val ROC-AUC in [0, 1]). Then on its train split and fresh models: K1
    at width 300, `[pool_graph]` at the twin's dropout (losses not
    compared; K1 once per graphed step) and at dropout 0 (graphed against
    eager at rel 1e-5 on the first step), two replays from one snapshot,
    the small card-against-CPU check and the bench-shaped step. Returns
    K1's launches in one graphed epoch at the twin's defaults."""
    from escgnn_tpu_torch import run_ogb_mol
    from escgnn_tpu_torch.data.batching import pad_and_batch
    from escgnn_tpu_torch.ops import expand_cuda
    from escgnn_tpu_torch.train.loop import bce_graph_loss

    argv = ["--num_graphs", "640", "--epochs", "3", "--synth_label", "tri",
            "--num_workers", "2", "--data_dir", os.path.join(work, "data"),
            "--res_dir", os.path.join(work, "ogb")]
    expand_cuda.launches = 0
    t0 = time.perf_counter()
    res = run_ogb_mol.main(argv)
    seconds = time.perf_counter() - t0
    k1_wrapper = expand_cuda.launches
    eps = res["epochs"]
    losses, vals = [e["loss"] for e in eps], [e["val"] for e in eps]
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"run_ogb_mol: losses {losses}")
    if not all(0.0 <= v <= 1.0 for v in vals):
        raise AssertionError(f"run_ogb_mol: val ROC-AUC {vals}")
    if any(e["steps"] != 16 for e in eps) or k1_wrapper < 1:
        raise AssertionError(f"run_ogb_mol: steps {[e['steps'] for e in eps]}"
                             f", K1 wrapper launches {k1_wrapper}")

    args = run_ogb_mol.build_parser().parse_args(argv)
    splits = run_ogb_mol.build_splits(args)[0]
    spec = res["spec"]
    k1_300 = check_k1_width300(
        pad_and_batch(splits["train"][:spec.num_graphs], spec, device=dev),
        dev)
    k1_graphed = check_pool_graph(
        "run_ogb_mol", run_ogb_mol.build_model(args, dev), bce_graph_loss,
        splits["train"], spec, args.lr, dev, rel_tol=None)
    args0 = run_ogb_mol.build_parser().parse_args(argv + ["--drop_ratio",
                                                          "0"])
    check_pool_graph("run_ogb_mol_dropout0",
                     run_ogb_mol.build_model(args0, dev), bce_graph_loss,
                     splits["train"], spec, args.lr, dev)
    replays = check_dropout_replays(args, splits["train"], spec, dev)
    check_small_ogb(dev)
    bench = time_ogb_bench_step(dev)
    _log("run_ogb_mol", seconds=round(seconds, 3), graphs=640,
         steps_per_epoch=16, emb=args.emb_dim, layers=args.num_layer,
         dropout=args.drop_ratio, batch=args.batch_size,
         data_seconds=round(res["data_seconds"], 3),
         epoch_seconds=json.dumps([round(e["seconds"], 4) for e in eps]),
         loss=json.dumps(losses), val_rocauc=json.dumps(vals),
         best_val=res["best_val"], best_test=res["best_test"],
         graphed_ms_per_step=json.dumps(
             [round(e["train_seconds"] / e["steps"] * 1e3, 4) for e in eps]),
         k1_wrapper_launches=k1_wrapper, k1_per_graphed_epoch=k1_graphed,
         replay_losses=json.dumps({str(k): v for k, v in replays.items()}),
         k1_h300=json.dumps(k1_300), bench_step=json.dumps(bench),
         card=json.dumps(smi), ok=True)
    return k1_graphed


def run_copy_zinc_twin(work: str, smi: str, model: str, dev):
    """`[run_zinc_<model>]`: the ZINC twin's copy path at the JAX driver's
    defaults (`--model NGNN|I2GNN`: hidden 256 x 5, batch 128, h 3,
    resistance distances, `--copy_layout uniform`; I2GNN with gated
    mean-center-side pair pooling) on 1000 synthetic molecules for 3
    epochs: 800 train graphs, 7 graphed steps per epoch. Then
    `[pool_graph]` on its train split (read from the run's cache and laid
    out again) with a fresh model: graphed against eager, no port kernel
    on this path. Prints the real and padded copy edges per step. Returns
    what `check_copy_bucketed` needs: the result, the pre-uniform splits,
    the uniform splits and the spec."""
    import numpy as np

    from escgnn_tpu_torch import run_zinc
    from escgnn_tpu_torch.featurize.cache import cache_path, load_graphs
    from escgnn_tpu_torch.train.copies import cache_tag, copy_layout_spec
    from escgnn_tpu_torch.train.loop import l1_graph_loss

    name = f"run_zinc_{model.lower()}"
    argv = ["--model", model, "--num_graphs", "1000", "--epochs", "5",
            "--num_workers", "2", "--data_dir", os.path.join(work, "data"),
            "--res_dir", os.path.join(work, name)]
    t0 = time.perf_counter()
    res = run_zinc.main(argv)
    seconds = time.perf_counter() - t0
    args = run_zinc.build_parser().parse_args(argv)
    steps = -(-800 // args.batch_size)  # 7 at the default batch 128
    _check_epochs(name, res, steps=steps)
    spec = res["spec"]
    splits = {}
    for split in ("train", "val", "test"):
        graphs = load_graphs(cache_path(
            os.path.join(work, "data", "zinc_synth"),
            f"{split}_n1000_s0_{cache_tag(model, args.h)}"))
        for g in graphs:
            g.y = ((g.y - res["mean"]) / res["std"]).astype(np.float32)
        splits[split] = graphs
    uniform, uspec, _ = copy_layout_spec(splits, args.batch_size, "uniform")
    if uspec != spec or spec.copy_nodes == 0:
        raise AssertionError(f"{name}: spec {spec} != {uspec}")
    pool = {}
    check_pool_graph(name, run_zinc.build_model(args, dev), l1_graph_loss,
                     uniform["train"], spec, args.lr, dev, kernel=None,
                     report=pool)
    real_edges = sum(g.num_edges for g in splits["train"]) / steps
    _log(name, seconds=round(seconds, 3), graphs=1000, steps_per_epoch=steps,
         hidden=args.hidden, layers=args.layers, batch=args.batch_size,
         h=args.h, layout=args.copy_layout,
         featurize_seconds=round(res["featurize_seconds"], 3),
         **_epoch_fields(res),
         **{f"pool_{k}": v for k, v in pool.items()},
         copy_block=json.dumps([spec.copy_nodes, spec.copy_edges]),
         copies_per_step=(spec.num_segments2 or spec.num_segments),
         node_slots_per_step=spec.num_nodes,
         real_copy_edges_per_step=real_edges,
         padded_copy_edge_slots_per_step=spec.num_edges,
         edge_slots_over_real=spec.num_edges / real_edges,
         card=json.dumps(smi), ok=True)
    return res, splits, uniform, spec


def check_copy_bucketed(main_path, smi, dev):
    """`[copy_bucketed]`: one full-width I2GNN batch of the main path (the
    first 128 train graphs) as uniform and as bucketed copy blocks
    (`make_bucket_transform` over the featurized dataset): the train-mode
    L1 loss agrees at rel 1e-5 and the gradient at 1e-3, the norm of the
    difference over the norm of the whole gradient, from one set of
    weights. The bucketed batch holds the rows in another order, so every
    reduction over the ~150k node rows (BatchNorm's moments, each weight
    gradient) runs in another order, and the two f32 gradients differ by
    the rounding of those sums, more at this width than the 1e-4 that
    `tests/test_torch_port_copies.py` holds them to at a small width. The
    largest elementwise difference and the worst parameter are printed. Then `[pool_graph]` of the bucketed train
    pool: its pinned region budgets give every batch
    one shape, so one captured step replays them all. Prints the padded
    edge slots of both layouts."""
    from escgnn_tpu_torch import run_zinc
    from escgnn_tpu_torch.data.batching import pad_and_batch
    from escgnn_tpu_torch.data.uniform_copies import make_bucket_transform
    from escgnn_tpu_torch.train.loop import l1_graph_loss

    res, splits, uniform, spec = main_path
    args = run_zinc.build_parser().parse_args(["--model", "I2GNN"])
    t0 = time.perf_counter()
    transform, regions = make_bucket_transform(
        [g for s in splits.values() for g in s], args.batch_size)
    host = pad_and_batch(uniform["train"][:args.batch_size], spec,
                         device="cpu")
    bucketed = transform(host)
    layout_s = time.perf_counter() - t0
    model = run_zinc.build_model(args, dev)
    model.train()
    init = copy.deepcopy(model.state_dict())
    out = {}
    for name, b in (("uniform", host), ("bucketed", bucketed)):
        model.load_state_dict(init)
        model.zero_grad(set_to_none=True)
        b = b.to(dev)
        loss = l1_graph_loss(model(b), b)
        loss.backward()
        out[name] = (loss.item(), {k: p.grad.detach().clone()
                                   for k, p in model.named_parameters()})
    (lu, gu), (lb, gb) = out["uniform"], out["bucketed"]
    loss_rel = abs(lb - lu) / abs(lu)
    if loss_rel > 1e-5:
        raise AssertionError(f"copy_bucketed: loss {lb} != uniform {lu}")
    diff2 = sum(((gb[k] - gu[k]) ** 2).sum().item() for k in gu)
    grad_rel = math.sqrt(diff2 / sum((v ** 2).sum().item()
                                     for v in gu.values()))
    per_param = {k: ((gb[k] - gu[k]).norm() / gu[k].norm().clamp_min(
        1e-30)).item() for k in gu}
    worst = max(per_param, key=per_param.get)
    if grad_rel > 1e-3:
        raise AssertionError(f"copy_bucketed: gradients differ by {grad_rel} "
                             f"of their norm")
    gmax = max(v.abs().max().item() for v in gu.values())
    grad_err = max((gb[k] - gu[k]).abs().max().item() for k in gu)
    pool = {}
    check_pool_graph("run_zinc_i2gnn_bucketed", run_zinc.build_model(args, dev),
                     l1_graph_loss, uniform["train"], spec, args.lr, dev,
                     kernel=None, batch_transform=transform, report=pool)
    real = int(host.edge_mask.sum())
    _log("copy_bucketed", regions=json.dumps(bucketed.seg_regions),
         transform_budgets=json.dumps(regions), layout_seconds=layout_s,
         loss_uniform=lu, loss_bucketed=lb, loss_rel=loss_rel,
         grad_rel_norm=grad_rel, worst_param=worst,
         worst_param_rel_norm=per_param[worst],
         max_abs_grad_err=grad_err, grad_max=gmax, real_edges=real,
         uniform_edge_slots=spec.num_edges,
         bucketed_edge_slots=bucketed.num_edges,
         uniform_node_slots=spec.num_nodes,
         bucketed_node_slots=bucketed.num_nodes,
         **{f"pool_{k}": v for k, v in pool.items()},
         card=json.dumps(smi), ok=True)


# autograd keeps about this many (S, M, M, C) grids per regular block (two
# 2-conv MLPs, their masked outputs, the contiguous product operands, the
# product, the skip input and output): the reckoning of NestedPPGN's step
NPPGN_GRIDS_PER_BLOCK = 16


def run_nppgn_twin(work: str, smi: str, dev):
    """`[run_ogb_mol_nppgn]`: `run_ogb_mol --model NestedPPGN` at the
    twin's widths (emb 300, 6 regular blocks per level, h 4) on 320
    synthetic molecules with the triangle label for 3 epochs. The dense
    (S, M, M, C) per-copy grid is reckoned first at the default batch 32
    (S copies, M the largest copy): when NPPGN_GRIDS_PER_BLOCK grids per
    block and level exceed 3/4 of the card's memory the batch is halved
    until they fit, and the cut is printed. Then `[pool_graph]` on its
    train split (graphed against eager at rel 1e-5 on the first step),
    and the peak memory of the run."""
    from escgnn_tpu_torch import run_ogb_mol
    from escgnn_tpu_torch.data.batching import BatchSpec
    from escgnn_tpu_torch.train.loop import bce_graph_loss

    argv = ["--model", "NestedPPGN", "--num_graphs", "320", "--epochs", "3",
            "--synth_label", "tri", "--num_workers", "2",
            "--data_dir", os.path.join(work, "data"),
            "--res_dir", os.path.join(work, "nppgn")]
    args = run_ogb_mol.build_parser().parse_args(argv)
    t0 = time.perf_counter()
    splits = run_ogb_mol.build_splits(args)[0]
    featurize_s = time.perf_counter() - t0
    graphs = [g for s in splits.values() for g in s]
    M = run_ogb_mol.max_copy_nodes(graphs)
    card_bytes = torch.cuda.get_device_properties(dev).total_memory
    reckon = []
    batch = args.batch_size
    while True:
        S = BatchSpec.from_graphs(graphs, batch).num_segments
        grid = S * M * M * args.emb_dim * 4
        need = grid * NPPGN_GRIDS_PER_BLOCK * args.num_layer
        reckon.append(dict(batch=batch, S=S, M=M, grid_gb=grid / 1e9,
                           step_gb=need / 1e9))
        if need <= 0.75 * card_bytes or batch == 1:
            break
        batch //= 2
    if batch != args.batch_size:
        print(f"[run_ogb_mol_nppgn] cut: batch {args.batch_size} -> {batch} "
              f"(reckoned {reckon[0]['step_gb']:.1f} GB of grids at batch "
              f"{args.batch_size}, card {card_bytes / 1e9:.1f} GB)",
              flush=True)
    argv += ["--batch_size", str(batch)]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res = run_ogb_mol.main(argv)
    seconds = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    eps = res["epochs"]
    losses = [e["loss"] for e in eps]
    steps = -(-len(splits["train"]) // batch)
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"run_ogb_mol_nppgn: losses {losses}")
    if any(e["steps"] != steps for e in eps):
        raise AssertionError(f"run_ogb_mol_nppgn: steps "
                             f"{[e['steps'] for e in eps]}, want {steps}")
    if not all(0.0 <= e["val"] <= 1.0 for e in eps):
        raise AssertionError(f"run_ogb_mol_nppgn: val {eps}")
    args_run = run_ogb_mol.build_parser().parse_args(argv)
    pool = {}
    check_pool_graph("run_ogb_mol_nppgn",
                     run_ogb_mol.build_model(args_run, dev, graphs),
                     bce_graph_loss, splits["train"], res["spec"], args.lr,
                     dev, kernel=None, report=pool)
    _log("run_ogb_mol_nppgn", seconds=round(seconds, 3), graphs=320,
         emb=args.emb_dim, blocks_per_level=args.num_layer, h=args.h,
         batch=batch, batch_cut=batch != args.batch_size,
         reckoning=json.dumps(reckon), steps_per_epoch=steps,
         featurize_seconds=round(featurize_s, 3),
         epoch_seconds=json.dumps([round(e["seconds"], 4) for e in eps]),
         loss=json.dumps(losses),
         val_rocauc=json.dumps([e["val"] for e in eps]),
         best_val=res["best_val"], best_test=res["best_test"],
         graphed_ms_per_step=json.dumps(
             [round(e["train_seconds"] / e["steps"] * 1e3, 4) for e in eps]),
         peak_memory_gb=peak_gb,
         **{f"pool_{k}": v for k, v in pool.items()},
         card=json.dumps(smi), ok=True)


def check_small_copy(dev):
    """NGNN (uniform copies), I2GNN (uniform and bucketed copies) and
    NestedPPGN (ragged) on the card against the CPU on small f32 inputs
    (6 molecules, hidden 16, 2 layers): eval logits on the running and
    on the batch statistics, the train-mode loss and every gradient,
    rtol/atol 1e-4 (gradients: atol 1e-4 of the largest)."""
    import numpy as np

    from escgnn_tpu_torch.data.batching import BatchSpec, pad_and_batch
    from escgnn_tpu_torch.data.molecules import synthetic_ogb_mol, synthetic_zinc
    from escgnn_tpu_torch.data.uniform_copies import make_bucket_transform
    from escgnn_tpu_torch.featurize.node_subgraphs import (
        NodeSubgraphConfig,
        create_node_subgraphs,
    )
    from escgnn_tpu_torch.models.i2gnn import I2GNN, I2GNNConfig
    from escgnn_tpu_torch.models.layers import bn_statistics
    from escgnn_tpu_torch.models.nested_ppgn import (
        NestedPPGN,
        NestedPPGNConfig,
    )
    from escgnn_tpu_torch.models.ngnn import NGNN, NGNNConfig
    from escgnn_tpu_torch.train.copies import (
        copy_layout_spec,
        featurize_copies,
    )
    from escgnn_tpu_torch.train.loop import l1_graph_loss

    raw = synthetic_zinc(6, seed=7)
    cases = []
    for model, cls, cfg in (
            ("NGNN", NGNN, NGNNConfig(num_layers=2, hidden=16, use_rd=True)),
            ("I2GNN", I2GNN, I2GNNConfig(
                num_layers=2, hidden=16, use_rd=True,
                subgraph2_pooling="mean-center-side", gate=True))):
        feats = featurize_copies(raw, model, 2)
        uni, spec, _ = copy_layout_spec({"all": feats}, 6, "uniform")
        host = pad_and_batch(uni["all"], spec, device="cpu")
        cases.append((model, lambda d, cls=cls, cfg=cfg: cls(
            cfg, device=d, generator=torch.Generator().manual_seed(3)), host))
        if model == "I2GNN":
            cases.append(("I2GNN_bucketed", cases[-1][1],
                          make_bucket_transform(feats, 6)[0](host)))
    ogb = [create_node_subgraphs(g, NodeSubgraphConfig(h=2, use_rd=True,
                                                       keep_orig_adj=True))
           for g in synthetic_ogb_mol(6, seed=7)]
    M = max(int(np.bincount(g.extras["node_to_subgraph"]).max()) for g in ogb)
    pcfg = NestedPPGNConfig(emb_dim=16, num_rb_layers=2, num_tasks=1,
                            use_rd=True, classify=False,
                            max_nodes_per_subgraph=M)
    host = pad_and_batch(ogb, BatchSpec.from_graphs(ogb, 6), device="cpu")
    host = dataclasses.replace(host, y=torch.from_numpy(
        np.random.default_rng(7).normal(size=(6, 1)).astype(np.float32)))
    cases.append(("NestedPPGN", lambda d: NestedPPGN(
        pcfg, in_dim=ogb[0].x.shape[1], edge_dim=ogb[0].edge_attr.shape[1],
        device=d, generator=torch.Generator().manual_seed(3)), host))

    def run(build, host, device):
        m = build(device)
        b = host.to(device)
        out = {}
        m.eval()
        with torch.no_grad():
            for running in (True, False):
                with bn_statistics(m, use_running_average=running):
                    out[f"eval_running_{running}"] = m(b).cpu()
        m.train()
        loss = l1_graph_loss(m(b), b)
        loss.backward()
        out["loss"] = loss.detach().cpu()
        out.update({f"grad {k}": p.grad.cpu()
                    for k, p in m.named_parameters()})
        return out

    errs = {}
    for name, build, host in cases:
        cpu, gpu = run(build, host, "cpu"), run(build, host, dev)
        gmax = max(v.abs().max().item() for k, v in cpu.items()
                   if k.startswith("grad"))
        errs[name] = max(
            _check_close(f"small_copy {name} {k}", gpu[k], cpu[k], rtol=1e-4,
                         atol=1e-4 * gmax if k.startswith("grad") else 1e-4)
            for k in cpu)
    _log("small_copy", graphs=6, hidden=16, layers=2,
         max_abs_err=json.dumps(errs), ok=True)


def run_qm9_kgnn_twins(work: str, smi: str, dev):
    """`[run_qm9_k123]`: `run_qm9 --model k123_GNN` at the JAX driver's
    defaults (h 3 node copies with resistance distances, all 2-sets and
    connected 3-sets with Malkin neighbourhoods, batch 64, lr 1e-3, MSE)
    on 1000 synthetic molecules for 3 graphed epochs: 800 train graphs,
    13 steps per epoch; its `[pool_graph]` (no port kernel on the path);
    the set-up seconds (featurize with the k-set enumeration apart, then
    one stacked pool) and the spec's k-set budgets. Then one graphed
    epoch each of k1_GNN, k12_GNN and k13_GNN."""
    from escgnn_tpu_torch import run_qm9

    def build(args, splits):
        g = splits["train"][0]
        return run_qm9.build_model(args, g.x.shape[1], g.edge_attr.shape[1],
                                   dev, has_pos=g.pos is not None)

    res, args, _ = _regression_twin(
        "run_qm9_k123", run_qm9, work, smi, 1000, 13, run_qm9.mse_loss,
        build, flags=["--model", "k123_GNN"], kernel=None)
    spec = res["spec"]
    budgets = {f: getattr(spec, f) for f in (
        "num_nodes", "num_edges", "num_segments", "num_kset2",
        "num_kset2_edges", "num_kset2_assign", "num_kset3",
        "num_kset3_edges", "num_kset3_assign", "num_assign_2to3")}
    if not (spec.num_kset2 and spec.num_kset3 and spec.num_assign_2to3):
        raise AssertionError(f"run_qm9_k123: spec {spec}")
    others = {}
    for model in ("k1_GNN", "k12_GNN", "k13_GNN"):
        t0 = time.perf_counter()
        r = run_qm9.main([
            "--model", model, "--num_graphs", "1000", "--epochs", "1",
            "--num_workers", "2", "--data_dir", os.path.join(work, "data"),
            "--res_dir", os.path.join(work, f"qm9_{model}")])
        e = r["epochs"][0]
        if not (math.isfinite(e["loss"]) and math.isfinite(e["val_mae"])
                and e["steps"] == 13):
            raise AssertionError(f"run_qm9 {model}: epoch {e}")
        others[model] = dict(
            seconds=time.perf_counter() - t0, data_seconds=r["data_seconds"],
            kset_seconds=r["kset_seconds"], loss=e["loss"],
            val_mae=e["val_mae"],
            graphed_ms_per_step=e["train_seconds"] / e["steps"] * 1e3)
    _log("run_qm9_kgnn", data_seconds=res["data_seconds"],
         kset_seconds=res["kset_seconds"],
         pool_build_s=res["pool_graph"]["pool_build_s"],
         budgets=json.dumps(budgets), one_epoch=json.dumps(others),
         card=json.dumps(smi), ok=True)


def run_ogb_gineplus_twin(work: str, smi: str, dev):
    """`[run_ogb_mol_ginep]`: `run_ogb_mol --model GINEPlus` at the JAX
    driver's defaults (emb 300 x 6 layers, k 3 hop levels, virtual node,
    dropout 0.65, batch 32, uniform per-graph blocks, masked BCE) on 640
    synthetic molecules with the triangle label for 3 epochs: 512 train
    graphs, 16 graphed steps per epoch. Then `[pool_graph]` at the twin's
    dropout (losses not compared) and at dropout 0, where only the first
    step's loss is held to eager's (rel 1e-5): at 300 x 6 this training
    is chaotic, and the atomics' order alone moves later losses by
    percents; the phase measures that, as the eager epochs' spread from
    initial weights scaled by (1 + 1e-7 N(0, 1)). Then the bench's GINE+
    line (`bench.py:625-640`: 32 graphs, hidden 100 x 6, k 3, bf16,
    dropout 0) graphed and eager. No port kernel lies on this path."""
    from escgnn_tpu_torch import run_ogb_mol
    from escgnn_tpu_torch.data.batching import BatchSpec
    from escgnn_tpu_torch.data.molecules import synthetic_ogb_mol
    from escgnn_tpu_torch.data.prefetch import stack_split
    from escgnn_tpu_torch.featurize.multihop import make_multihop_edges
    from escgnn_tpu_torch.models.gine_plus import (
        GINEPlusConfig,
        GINEPlusNetwork,
    )
    from escgnn_tpu_torch.train.loop import bce_graph_loss

    argv = ["--model", "GINEPlus", "--num_graphs", "640", "--epochs", "3",
            "--synth_label", "tri", "--num_workers", "2",
            "--data_dir", os.path.join(work, "data"),
            "--res_dir", os.path.join(work, "ogb_ginep")]
    t0 = time.perf_counter()
    res = run_ogb_mol.main(argv)
    seconds = time.perf_counter() - t0
    eps = res["epochs"]
    losses, vals = [e["loss"] for e in eps], [e["val"] for e in eps]
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"run_ogb_mol_ginep: losses {losses}")
    if not all(0.0 <= v <= 1.0 for v in vals):
        raise AssertionError(f"run_ogb_mol_ginep: val ROC-AUC {vals}")
    if any(e["steps"] != 16 for e in eps):
        raise AssertionError(f"run_ogb_mol_ginep: steps "
                             f"{[e['steps'] for e in eps]}")
    spec = res["spec"]
    if not spec.uniform_nodes or spec.enc_width:
        raise AssertionError(f"run_ogb_mol_ginep: spec {spec}")
    args = run_ogb_mol.build_parser().parse_args(argv)
    train = run_ogb_mol.build_splits(args)[0]["train"]
    report = {}
    check_pool_graph("run_ogb_mol_ginep", run_ogb_mol.build_model(args, dev),
                     bce_graph_loss, train, spec, args.lr, dev, kernel=None,
                     rel_tol=None, report=report)
    args0 = run_ogb_mol.build_parser().parse_args(argv + ["--drop_ratio",
                                                          "0"])
    check_pool_graph("run_ogb_mol_ginep_dropout0",
                     run_ogb_mol.build_model(args0, dev), bce_graph_loss,
                     train, spec, args.lr, dev, kernel=None,
                     rel_tol=(1e-5, math.inf))
    spread = _perturbed_spread(lambda: run_ogb_mol.build_model(args0, dev),
                               bce_graph_loss, train, spec, args.lr, dev)

    graphs = [make_multihop_edges(g, k=3)
              for g in synthetic_ogb_mol(32, seed=0, num_tasks=1)]
    bspec = BatchSpec.uniform(graphs, 32)
    cfg = GINEPlusConfig(hidden=100, out_dim=1, num_layers=6, dropout=0.0,
                         k=3, virtual_node=True, compute_dtype="bfloat16")
    bench = _bench_step(
        lambda: GINEPlusNetwork(cfg, device=dev,
                                generator=torch.Generator().manual_seed(0)),
        stack_split(graphs, bspec, dev), bce_graph_loss)
    real_edges = sum(g.num_edges for g in graphs)
    bench.update(graphs=32, N=bspec.num_nodes, E=bspec.num_edges,
                 real_multihop_edges=real_edges,
                 graphed_real_edges_per_s=real_edges / (
                     bench["graphed_ms_per_step"] / 1e3))
    _log("run_ogb_mol_ginep", seconds=round(seconds, 3), graphs=640,
         steps_per_epoch=16, emb=args.emb_dim, layers=args.num_layer,
         k=args.multihop_k, dropout=args.drop_ratio, batch=args.batch_size,
         N=spec.num_nodes, E=spec.num_edges,
         data_seconds=round(res["data_seconds"], 3),
         epoch_seconds=json.dumps([round(e["seconds"], 4) for e in eps]),
         loss=json.dumps(losses), val_rocauc=json.dumps(vals),
         best_val=res["best_val"], best_test=res["best_test"],
         graphed_ms_per_step=json.dumps(
             [round(e["train_seconds"] / e["steps"] * 1e3, 4) for e in eps]),
         bench_step=json.dumps(bench),
         dropout0_perturbed_rel=json.dumps(spread), card=json.dumps(smi),
         ok=True)


def _perturbed_spread(make_model, loss_fn, train, spec, lr, dev,
                      scale=1e-7):
    """The relative difference per step between two eager epochs over one
    pool, from a model's initial weights and from the same weights times
    (1 + scale N(0, 1)): how far the training itself carries a rounding
    difference."""
    import numpy as np

    from escgnn_tpu_torch.data.prefetch import pool_entry, stacked_batch_pools
    from escgnn_tpu_torch.train.loop import adam_with_plateau, train_step

    pools, steps = stacked_batch_pools(train, spec, k=1, seed=0, device=dev)
    order = np.random.default_rng(0).permutation(steps)
    gen = torch.Generator().manual_seed(1)
    runs = []
    for eps in (0.0, scale):
        m = make_model()
        with torch.no_grad():
            for p in m.parameters():
                p.mul_(1 + eps * torch.randn(p.shape, generator=gen).to(dev))
        opt = adam_with_plateau(m.parameters(), lr, capturable=True)
        runs.append(torch.stack([
            train_step(m, opt, pool_entry(pools[0], int(j)), loss_fn)
            for j in order]).tolist())
    return [abs(a - b) / abs(a) for a, b in zip(*runs)]


def run_zinc_gnn_twins(work: str, smi: str, dev):
    """`[run_zinc_gnn]`: `run_zinc --model GNN` (the RGCN baseline, 5
    layers, batch 128, lr 5e-4, ragged width batches of the ESC-featurized
    graphs, read from the feature cache `[run_zinc]` wrote) on 1000
    synthetic molecules for 3 graphed epochs: 800 train graphs, 7 steps
    per epoch; its `[pool_graph]`. Then `run_zinc_cycle --model GNN`
    (node-level RGCN on the raw graphs) for 3 epochs with its
    `[pool_graph]`. No port kernel lies on these paths."""
    import numpy as np

    from escgnn_tpu_torch import run_zinc, run_zinc_cycle
    from escgnn_tpu_torch.featurize.cache import cache_path, load_graphs
    from escgnn_tpu_torch.train.loop import l1_graph_loss, l1_node_loss

    argv = ["--model", "GNN", "--num_graphs", "1000", "--epochs", "3",
            "--num_workers", "2", "--data_dir", os.path.join(work, "data"),
            "--res_dir", os.path.join(work, "zinc_gnn")]
    t0 = time.perf_counter()
    res = run_zinc.main(argv)
    seconds = time.perf_counter() - t0
    _check_epochs("run_zinc_gnn", res, steps=7)
    spec = res["spec"]
    if spec.uniform_nodes:
        raise AssertionError(f"run_zinc_gnn: spec {spec}")
    args = run_zinc.build_parser().parse_args(argv)
    train = load_graphs(cache_path(os.path.join(work, "data", "zinc_synth"),
                                   "train_n1000_s0_esc_h3_rd_sl"))
    for g in train:
        g.y = ((g.y - res["mean"]) / res["std"]).astype(np.float32)
    report = {}
    check_pool_graph("run_zinc_gnn", run_zinc.build_model(args, dev),
                     l1_graph_loss, train, spec, args.lr, dev, kernel=None,
                     report=report)
    _log("run_zinc_gnn", seconds=round(seconds, 3), graphs=1000,
         steps_per_epoch=7, layers=args.layers, batch=args.batch_size,
         N=spec.num_nodes, E=spec.num_edges, **_epoch_fields(res),
         card=json.dumps(smi), ok=True)
    _regression_twin(
        "run_zinc_cycle_gnn", run_zinc_cycle, work, smi, 1000, 7,
        l1_node_loss, lambda a, splits: run_zinc_cycle.build_model(a, dev),
        flags=["--model", "GNN"], kernel=None)


def _zoo_data():
    """Host batches for the zoo: (TU-shaped ZINC molecules, one-hot atom
    types and a two-class label; their h-2 node copies; the same
    molecules with type ids and a float target; multihop OGB molecules;
    QM9 molecules with distance edges; 16 QM9 molecules with h-3 copies
    and their 2- and 3-set graphs, the bench's k123 shape)."""
    import numpy as np

    from escgnn_tpu_torch.data.batching import BatchSpec, pad_and_batch
    from escgnn_tpu_torch.data.container import GraphData
    from escgnn_tpu_torch.data.molecules import (
        synthetic_ogb_mol,
        synthetic_zinc,
    )
    from escgnn_tpu_torch.data.qm9 import (
        append_distance_edge_attr,
        synthetic_qm9,
    )
    from escgnn_tpu_torch.featurize.kset import attach_kset_graphs
    from escgnn_tpu_torch.featurize.multihop import make_multihop_edges
    from escgnn_tpu_torch.featurize.node_subgraphs import (
        NodeSubgraphConfig,
        create_node_subgraphs,
    )

    def host(graphs):
        return pad_and_batch(graphs, BatchSpec.from_graphs(graphs,
                                                           len(graphs)),
                             device="cpu")

    zinc = synthetic_zinc(32, seed=11)
    tu = [GraphData(num_nodes=g.num_nodes, edge_index=g.edge_index,
                    x=np.eye(28, dtype=np.float32)[g.x[:, 0]],
                    edge_attr=g.edge_attr,
                    y=np.asarray([int(g.num_nodes >= 24)], np.int64))
          for g in zinc]
    copies = [create_node_subgraphs(g, NodeSubgraphConfig(h=2)) for g in tu]
    qm9 = synthetic_qm9(16, seed=0)
    for g in qm9:
        g.y = np.asarray(g.y, np.float32)[:1]
    qm9 = [append_distance_edge_attr(g) for g in qm9]
    kset = [attach_kset_graphs(create_node_subgraphs(
        g, NodeSubgraphConfig(h=3, use_rd=True)), ks=(2, 3), malkin=True)
        for g in qm9]
    ogb = [make_multihop_edges(g, 3)
           for g in synthetic_ogb_mol(16, seed=0, num_tasks=1)]
    return dict(tu=host(tu), copies=host(copies), zinc=host(zinc),
                ogb=host(ogb), qm9=host(qm9), kset=host(kset),
                kset_graphs=kset)


def check_zoo_registry(dev):
    """`[zoo_registry]`: every name this slice registers, built through
    `get_model` on the card, 3 Adam steps (lr 1e-4) each on one batch:
    BaselineGNN with each of its 8 convs under the pools mean, add, max,
    attention, set2set and sort (gcn_dir on node copies, whose hop labels
    it reads), IDGNN with each of its 4 convs on node copies, RGCN,
    GINEPlus, k1_GNN and the nested k12 / k13 / k123 (the bench's k123
    shape: 16 QM9 molecules, h 3), all at dropout 0. Every loss is
    finite and the third is below the first."""
    from escgnn_tpu_torch.models.baselines import BASELINE_CONVS
    from escgnn_tpu_torch.models.idgnn import IDGNN_CONVS
    from escgnn_tpu_torch.models.registry import get_model
    from escgnn_tpu_torch.run_qm9 import mse_loss
    from escgnn_tpu_torch.train.loop import (
        adam_with_plateau,
        bce_graph_loss,
        ce_graph_loss,
        l1_graph_loss,
        train_step,
    )

    data = _zoo_data()
    b = {k: v.to(dev) for k, v in data.items() if k != "kset_graphs"}
    g0 = data["kset_graphs"][0]
    kgnn_kw = dict(x_dim=g0.x.shape[1], edge_dim=g0.edge_attr.shape[1],
                   use_rd=True, use_pos=True)
    cases = []
    for conv in BASELINE_CONVS:
        for pool in ("mean", "add", "max", "attention", "set2set", "sort"):
            cases.append((f"BaselineGNN[{conv},{pool}]", "BaselineGNN",
                          dict(conv=conv, pool=pool, dropout=0.0,
                               in_dim=28),
                          "copies" if conv == "gcn_dir" else "tu",
                          ce_graph_loss))
    for conv in IDGNN_CONVS:
        cases.append((f"IDGNN[{conv}]", "IDGNN",
                      dict(conv=conv, dropout=0.0, in_dim=28), "copies",
                      ce_graph_loss))
    cases += [
        ("RGCN", "RGCN", {}, "zinc", l1_graph_loss),
        ("GINEPlus", "GINEPlus", dict(out_dim=1, k=3, virtual_node=True,
                                      dropout=0.0), "ogb", bce_graph_loss),
        ("k1_GNN", "k1_GNN", dict(x_dim=g0.x.shape[1],
                                  edge_dim=g0.edge_attr.shape[1],
                                  use_pos=True), "qm9", mse_loss),
        ("Nested_k12_GNN", "Nested_k12_GNN", dict(kgnn_kw, has_pos=False),
         "kset", mse_loss),
        ("Nested_k13_GNN", "Nested_k13_GNN", dict(kgnn_kw, has_pos=False),
         "kset", mse_loss),
        ("Nested_k123_GNN", "Nested_k123_GNN", dict(kgnn_kw, has_pos=False),
         "kset", mse_loss),
    ]
    t0 = time.perf_counter()
    losses = {}
    for label, name, kw, key, loss_fn in cases:
        m = get_model(name, device=dev,
                      generator=torch.Generator().manual_seed(0), **kw)
        opt = adam_with_plateau(m.parameters(), 1e-4)
        ls = torch.stack([train_step(m, opt, b[key], loss_fn)
                          for _ in range(3)]).tolist()
        if not all(math.isfinite(v) for v in ls) or not ls[2] < ls[0]:
            raise AssertionError(f"zoo {label}: losses {ls}")
        losses[label] = ls
    _log("zoo_registry", models=len(cases),
         seconds=round(time.perf_counter() - t0, 3),
         k123_batch=json.dumps(dict(N=b["kset"].num_nodes,
                                    E=b["kset"].num_edges,
                                    S2=b["kset"].extras["kset2_mask"].shape[0],
                                    S3=b["kset"].extras["kset3_mask"].shape[0])),
         losses=json.dumps(losses), ok=True)


def check_small_zoo(dev):
    """`[small_zoo]`: KGNN k123, GINE+ (ragged and uniform blocks), RGCN,
    BaselineGNN (GAT, set2set pooling) and IDGNN (GIN) on the card
    against the CPU on small f32 inputs: eval outputs (on the running and
    on the batch statistics where the model has BatchNorm), the
    train-mode loss and every gradient, rtol/atol 1e-4 (gradients: atol
    1e-4 of the largest)."""
    import numpy as np

    from escgnn_tpu_torch.data.batching import BatchSpec, pad_and_batch
    from escgnn_tpu_torch.data.molecules import synthetic_ogb_mol
    from escgnn_tpu_torch.data.qm9 import (
        append_distance_edge_attr,
        synthetic_qm9,
    )
    from escgnn_tpu_torch.featurize.kset import attach_kset_graphs
    from escgnn_tpu_torch.featurize.multihop import make_multihop_edges
    from escgnn_tpu_torch.featurize.node_subgraphs import (
        NodeSubgraphConfig,
        create_node_subgraphs,
    )
    from escgnn_tpu_torch.models.layers import bn_statistics
    from escgnn_tpu_torch.models.registry import get_model
    from escgnn_tpu_torch.run_qm9 import mse_loss
    from escgnn_tpu_torch.train.loop import bce_graph_loss, ce_graph_loss

    data = _zoo_data()
    qm9 = []
    for g in synthetic_qm9(4, seed=5):
        g.y = np.asarray(g.y, np.float32)[:1]
        qm9.append(attach_kset_graphs(create_node_subgraphs(
            append_distance_edge_attr(g),
            NodeSubgraphConfig(h=2, use_rd=True)), ks=(2, 3)))
    ogb = [make_multihop_edges(g, 3)
           for g in synthetic_ogb_mol(6, seed=7, num_tasks=1)]
    cases = [
        ("k123", "Nested_k123_GNN", dict(
            x_dim=qm9[0].x.shape[1], edge_dim=qm9[0].edge_attr.shape[1],
            has_pos=False, use_rd=True, use_pos=True),
         pad_and_batch(qm9, BatchSpec.from_graphs(qm9, 4), device="cpu"),
         mse_loss),
        ("gineplus_ragged", "GINEPlus", dict(
            hidden=16, num_layers=3, out_dim=1, k=3, virtual_node=True,
            dropout=0.0),
         pad_and_batch(ogb, BatchSpec.from_graphs(ogb, 6), device="cpu"),
         bce_graph_loss),
        ("gineplus_uniform", "GINEPlus", dict(
            hidden=16, num_layers=3, out_dim=1, k=3, virtual_node=True,
            dropout=0.0),
         pad_and_batch(ogb, BatchSpec.uniform(ogb, 6), device="cpu"),
         bce_graph_loss),
        ("rgcn", "RGCN", dict(num_layers=2), data["zinc"], mse_loss),
        ("baseline_gat_set2set", "BaselineGNN", dict(
            conv="gat", pool="set2set", hidden=16, num_layers=2,
            dropout=0.0, in_dim=28), data["tu"], ce_graph_loss),
        ("idgnn_gin", "IDGNN", dict(conv="gin", hidden=16, num_layers=2,
                                    dropout=0.0, in_dim=28),
         data["copies"], ce_graph_loss),
    ]

    def run(name, kw, host, loss_fn, device):
        m = get_model(name, device=device,
                      generator=torch.Generator().manual_seed(3), **kw)
        b = host.to(device)
        out = {}
        m.eval()
        with torch.no_grad():
            for running in (True, False):
                with bn_statistics(m, use_running_average=running):
                    out[f"eval_running_{running}"] = m(b).cpu()
        m.train()
        loss = loss_fn(m(b), b)
        loss.backward()
        out["loss"] = loss.detach().cpu()
        out.update({f"grad {k}": p.grad.cpu()
                    for k, p in m.named_parameters()})
        return out

    errs = {}
    for label, name, kw, host, loss_fn in cases:
        cpu = run(name, kw, host, loss_fn, "cpu")
        gpu = run(name, kw, host, loss_fn, dev)
        gmax = max(v.abs().max().item() for k, v in cpu.items()
                   if k.startswith("grad"))
        errs[label] = max(
            _check_close(f"small_zoo {label} {k}", gpu[k], cpu[k],
                         rtol=1e-4,
                         atol=1e-4 * gmax if k.startswith("grad") else 1e-4)
            for k in cpu)
    _log("small_zoo", max_abs_err=json.dumps(errs), ok=True)


def run_sr_twin(smi: str, dev):
    """`[run_sr]`: the SR25 check at its defaults (untrained, 8 layers x
    64, seed 0, the real graphs from data/sr25) through main(); then the
    same model's scale-normalized embeddings on the card against the CPU
    port's at atol 1e-4. Prints collisions/pairs (the JAX package's record
    is 0/105) and the closest pair's distance."""
    import numpy as np

    from escgnn_tpu_torch import run_sr

    t0 = time.perf_counter()
    bad, total = run_sr.main([])
    seconds = time.perf_counter() - t0
    model = run_sr.sr_model(64, 8, seed=0, device="cpu")
    batch = run_sr.sr_batch(3, None, "cpu")
    want = run_sr.sr_embeddings(model, batch).numpy()
    got = run_sr.sr_embeddings(copy.deepcopy(model).to(dev),
                               batch.to(dev)).cpu().numpy()
    scale = np.abs(want).mean()
    err = float(np.abs(got / scale - want / scale).max())
    if err > 1e-4:
        raise AssertionError(f"SR25 embeddings: card against CPU {err}")
    if run_sr.count_collisions(got) != (bad, total) or total != 105:
        raise AssertionError("SR25: the card's count differs from main()'s")
    e = got / np.abs(got).mean()
    dists = [float(np.linalg.norm(e[i] - e[j]))
             for i in range(len(e)) for j in range(i + 1, len(e))]
    _log("run_sr", collisions=bad, pairs=total, jax_record="0/105",
         min_pair_distance=min(dists), tol=1e-2,
         max_abs_err_vs_cpu_normalized=err, seconds=round(seconds, 3),
         card=json.dumps(smi), ok=True)


def run_exp_twin(smi: str, dev):
    """`[run_exp]`: EXP cut to 400 graphs, 2 splits x 5 epochs at the
    defaults' 64 x 3 (200 train graphs, 7 graphed steps per epoch);
    test, expressivity and learning accuracy; each split's loss falls.
    Then `[pool_graph]` on split 0's train graphs with a fresh model (no
    port kernel on this path: the width layout's default z reduce); the
    GINE aggregation of the width layout adds with atomics, so graphed
    and eager losses are held at rel 1e-3 on the first step and 5e-2
    after."""
    from escgnn_tpu_torch import run_exp
    from escgnn_tpu_torch.models.nested_gin_eff import NestedGINEff
    from escgnn_tpu_torch.train.loop import ce_graph_loss

    argv = ["--max_graphs", "400", "--splits", "2", "--epochs", "5"]
    t0 = time.perf_counter()
    res = run_exp.main(argv)
    seconds = time.perf_counter() - t0
    for r in res["splits"]:
        if not all(math.isfinite(v) for v in r["losses"]) or not (
                r["losses"][-1] < r["losses"][0]):
            raise AssertionError(f"run_exp: loss did not fall: {r['losses']}")
        if r["steps"] != 7:
            raise AssertionError(f"run_exp: {r['steps']} steps per epoch")
    args = run_exp.build_parser().parse_args(argv)
    feats = res["feats"]
    model = NestedGINEff(run_exp.model_config(args), device=dev,
                         generator=torch.Generator().manual_seed(args.seed))
    check_pool_graph("run_exp", model, ce_graph_loss, feats[200:],
                     res["spec"], args.lr, dev, kernel=None,
                     rel_tol=(1e-3, 5e-2))
    _log("run_exp", graphs=400, splits=2, epochs=5, steps_per_epoch=7,
         test=res["test"], expressivity=res["expressivity"],
         learning=res["learning"],
         loss=json.dumps([r["losses"] for r in res["splits"]]),
         seconds=round(seconds, 3), card=json.dumps(smi), ok=True)


def _max_rel(a, b):
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def run_csl_twin(smi: str, dev):
    """`[run_csl]`: CSL at the defaults' 64 x 3, 2 folds x 10 epochs (75
    train graphs, 3 graphed steps per epoch). Then fold 0 again under
    `zemb.set_impl("pallas")`, so the width layout's z reduce is K3 inside
    the captured step:
      * K3 on every train batch of the fold equals its plain version
        (rtol 1e-5, atol 1e-4: f32 sums in another order);
      * K3's launches over the fold are one per graphed step: its nodes
        in the captured graph times the replays (`_GraphLedger`; warm-up
        steps and the accuracy eval are the wrapper's eager calls), and
        the profiler sees it at least once and never more often;
      * from the fold's initial weights, the first two eager train
        losses under K3 equal the default impl's at rel 1e-3;
      * the fold's losses against the default impl's: CSL's graphs are
        vertex-transitive, so the GINE MLPs' BatchNorms see features
        whose batch std is far below their mean, and the last bits of any
        sum (the z reduce's order, the aggregation's atomics) move the
        per-epoch loss by several percent within 10 epochs, the default
        impl against itself as much as K3 against it (PERF.md §6). So
        both must fall and stay within rel 0.25 of the default run at
        every epoch (a band, not a parity check: K3's arithmetic is held
        by the exact check above); the default impl's own spread, from
        one more run of it from the same state, is printed beside it.
    Then `[pool_graph]` on the fold's train graphs under K3 (graphed
    against eager: rel 5e-2 on the first step, 2e-1 after). Returns
    K3's graphed launches in the fold."""
    import numpy as np

    from escgnn_tpu_torch import run_csl
    from escgnn_tpu_torch.data.prefetch import pool_entry, pool_size, stack_split
    from escgnn_tpu_torch.models.nested_gin_eff import NestedGINEff
    from escgnn_tpu_torch.ops import zemb, zemb_gather
    from escgnn_tpu_torch.train.loop import (
        adam_with_plateau,
        ce_graph_loss,
        train_step,
    )

    argv = ["--folds", "2", "--epochs", "10"]
    t0 = time.perf_counter()
    res = run_csl.main(argv)
    seconds = time.perf_counter() - t0
    args = run_csl.build_parser().parse_args(argv)
    feats, labels, spec = run_csl.build_data(args)
    folds = run_csl.k_fold_indices(labels, args.folds, args.seed)
    train = [feats[i] for i in folds[1]]

    stacked = stack_split(train, spec, dev)
    table = torch.randn(1800, args.hidden, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(2))
    k3_err = 0.0
    for i in range(pool_size(stacked)):
        b = pool_entry(stacked, i)
        idx = b.enc_idx.to(torch.int32).contiguous()
        cnt = b.enc_cnt.to(torch.float32).contiguous()
        k3_err = max(k3_err, _check_close(
            "K3 on a CSL batch", zemb_gather.zemb_gather(table, idx, cnt),
            zemb_gather.zemb_gather_plain(table, idx, cnt), 1e-5, 1e-4))

    zemb.set_impl("pallas")
    try:
        # the fold under the ledger and the profiler; the wrapper counts
        # the captured launch, which runs nothing
        ledger = _GraphLedger()
        zemb_gather.launches = 0
        with ledger.watch():
            fold, prof = _profiled(
                lambda: run_csl.run_fold(args, feats, folds, 0, spec, dev))
        eager = zemb_gather.launches - ledger.nodes("zemb_rows_kernel")
        graphed = ledger.launches("zemb_rows_kernel")
        seen = _kernel_events(prof, "zemb_rows_kernel") - eager
        want = args.epochs * fold["steps"]
        model = NestedGINEff(run_csl.model_config(args), device=dev,
                             generator=torch.Generator().manual_seed(args.seed))
        check_pool_graph("run_csl", model, ce_graph_loss, train, spec,
                         args.lr, dev, kernel=("k3", "zemb_rows_kernel"),
                         rel_tol=(5e-2, 2e-1))
    finally:
        zemb.set_impl("countmat")
    if graphed != want or not 1 <= seen <= graphed:
        raise AssertionError(f"run_csl: K3 ran {graphed} times in {want} "
                             f"graphed steps ({ledger.nodes('zemb_rows_kernel')}"
                             f" node(s) in {len(ledger.dots)} graph(s); the "
                             f"profiler saw {seen})")

    def first_steps(impl):
        """The fold's first two eager train losses from its initial
        weights under one z-reduce impl."""
        zemb.set_impl(impl)
        m = NestedGINEff(run_csl.model_config(args), device=dev,
                         generator=torch.Generator().manual_seed(args.seed))
        opt = adam_with_plateau(m.parameters(), args.lr)
        return [float(train_step(m, opt, pool_entry(stacked, j),
                                 ce_graph_loss)) for j in range(2)]

    try:
        k3_first = first_steps("pallas")
    finally:
        zemb.set_impl("countmat")
    base_first = first_steps("countmat")
    first_rel = _max_rel(k3_first, base_first)
    if first_rel > 1e-3:
        raise AssertionError(f"run_csl: K3-path first losses {k3_first} vs "
                             f"default {base_first}")
    base = res["folds"][0]["losses"]
    again = run_csl.run_fold(args, feats, folds, 0, spec, dev)["losses"]
    spread, rel = _max_rel(again, base), _max_rel(fold["losses"], base)
    for name, losses in (("default", base), ("K3", fold["losses"])):
        if not losses[-1] < losses[0]:
            raise AssertionError(f"run_csl {name}: loss did not fall: "
                                 f"{losses}")
    if rel > 0.25:
        raise AssertionError(f"run_csl: K3-path losses {fold['losses']} vs "
                             f"default {base} (default again: {again})")
    _log("run_csl", folds=2, epochs=10, steps_per_epoch=fold["steps"],
         acc_mean=res["mean"], acc_std=res["std"],
         fold_acc=json.dumps([f["acc"] for f in res["folds"]]),
         loss=json.dumps([f["losses"] for f in res["folds"]]),
         k3_max_abs_err_on_csl_batches=k3_err,
         k3_first_losses=json.dumps(k3_first),
         default_first_losses=json.dumps(base_first),
         k3_first_loss_rel=first_rel, k3_fold_acc=fold["acc"],
         k3_loss=json.dumps(fold["losses"]), k3_max_loss_rel=rel,
         default_again_max_loss_rel=spread, k3_graphed_launches=graphed,
         k3_graphed_profiler_seen=seen, k3_eager_launches=eager, seconds=round(seconds, 3),
         card=json.dumps(smi), ok=True)
    return graphed


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    os.chdir(root)  # the expressiveness data is read from data/
    from escgnn_tpu_torch import _build
    from escgnn_tpu_torch.data.batching import BatchSpec, pad_and_batch
    from escgnn_tpu_torch.data.molecules import synthetic_zinc
    from escgnn_tpu_torch.featurize import EscConfig, featurize_many
    from escgnn_tpu_torch.models.nested_gin_eff import NestedGINEff
    from escgnn_tpu_torch.ops import expand_cuda, zemb, zemb_cuda
    from escgnn_tpu_torch.train.loop import (
        adam_with_plateau,
        eval_step,
        l1_graph_loss,
        train_step,
    )

    # 1. device
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _log("device", name=json.dumps(kind), count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    print(smi, flush=True)

    # 2. build
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    for name in _build.SIGNATURES:
        _build.load(name)
    ptxas = [ln.strip() for log in _build.build_log.values()
             for ln in log.splitlines() if "registers" in ln]
    _log("build", seconds=round(build_s, 3), arch="sm_90a",
         sources=",".join(f"{n}.cu" for n in _build.SIGNATURES),
         ptxas=json.dumps(ptxas))

    # 3. the flagship batch, built by the port alone
    t0 = time.perf_counter()
    graphs = featurize_many(synthetic_zinc(NUM_GRAPHS, seed=0),
                            EscConfig(h=3, use_rd=True, self_loop=True))
    spec = BatchSpec.uniform(graphs, NUM_GRAPHS, enc_layout="dedup")
    batch = pad_and_batch(graphs, spec, device=dev)
    real_edges = sum(g.num_edges for g in graphs)
    _log("batch", seconds=round(time.perf_counter() - t0, 3),
         N=batch.num_nodes, E=batch.num_edges, R=spec.num_enc_rows,
         P=spec.enc_width, Zc=spec.num_enc_buckets,
         n_u=spec.uniform_nodes, e_u=spec.uniform_edges,
         enc_countmat=tuple(batch.enc_countmat.shape), real_edges=real_edges)

    # 4.-5. kernels against their plain versions
    k1 = check_k1(batch, dev)
    k2 = check_k2(batch, dev)
    check_small_reference(dev)

    # 6. main path: 10 flagship train steps and one eval step
    model = NestedGINEff(flagship_config(), device=dev,
                         generator=torch.Generator().manual_seed(0))
    opt = adam_with_plateau(model.parameters(), LR)
    init_state = copy.deepcopy(model.state_dict())
    expand_cuda.launches = 0
    zemb_cuda.launches = 0
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(train_step(model, opt, batch, l1_graph_loss))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    err_sum, count = eval_step(model, batch, node_level=False)
    with torch.no_grad():
        out = model.eval()(batch)
    torch.cuda.synchronize()
    if tuple(out.shape) != (NUM_GRAPHS, 1) or not torch.isfinite(out).all():
        raise AssertionError(f"eval output {tuple(out.shape)} is not a "
                             f"finite ({NUM_GRAPHS}, 1) tensor")
    main_launches = {"k1": expand_cuda.launches, "k2": zemb_cuda.launches}
    losses = [float(v) for v in losses]
    mae = float(err_sum) / float(count)
    if not all(math.isfinite(v) for v in losses) or not math.isfinite(mae):
        raise AssertionError(f"non-finite loss or MAE: {losses} {mae}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    if main_launches["k1"] != TRAIN_STEPS:
        raise AssertionError(f"K1 launched {main_launches['k1']} times in "
                             f"{TRAIN_STEPS} steps")
    ms_step = statistics.median(step_ms[1:])
    _log("train", steps=TRAIN_STEPS, hidden=256, layers=5,
         graphs=NUM_GRAPHS, first_loss=losses[0], last_loss=losses[-1],
         eval_mae=mae, first_step_ms=step_ms[0], median_ms_per_step=ms_step,
         real_edges_per_s=real_edges / (ms_step / 1e3),
         k1_launches=main_launches["k1"], k2_launches=main_launches["k2"],
         card=json.dumps(smi), ok=True)

    # 7. the count-matrix kernel path: one step without the host C,
    # against one default-path step from the same state
    m_def = NestedGINEff(flagship_config(), device=dev)
    m_def.load_state_dict(init_state)
    m_k2 = copy.deepcopy(m_def)
    loss_def = float(train_step(m_def, adam_with_plateau(m_def.parameters(), LR),
                                batch, l1_graph_loss))
    batch_k2 = dataclasses.replace(batch, enc_countmat=None)
    zemb.set_impl("countmat_pallas")
    try:
        expand_cuda.launches = 0
        zemb_cuda.launches = 0
        t0 = time.perf_counter()
        loss_k2 = float(train_step(m_k2, adam_with_plateau(m_k2.parameters(), LR),
                                   batch_k2, l1_graph_loss))
        torch.cuda.synchronize()
        k2_step_ms = (time.perf_counter() - t0) * 1e3
        k2_launches = {"k1": expand_cuda.launches, "k2": zemb_cuda.launches}
    finally:
        zemb.set_impl("countmat")
    if k2_launches["k2"] < 1:
        raise AssertionError("the K2 path did not launch K2")
    # the bf16 conv stack can round an f32 z difference the other way
    if not math.isclose(loss_k2, loss_def, rel_tol=1e-3):
        raise AssertionError(f"K2-path loss {loss_k2} != default {loss_def}")
    _log("k2_path", loss_default=loss_def, loss_k2=loss_k2,
         step_ms=k2_step_ms, k1_launches=k2_launches["k1"],
         k2_launches=k2_launches["k2"], ok=True)

    # 8. the PPGN_eff counting path: K3 and K4, then their main path
    ppgn_batch, ppgn_spec, ppgn_edges = counting_batch(dev)
    k3 = check_k3(ppgn_batch, dev)
    k4 = check_k4(dev, NUM_GRAPHS, ppgn_spec.max_nodes_per_graph)
    check_small_ppgn(dev)
    ppgn_launches = run_ppgn(ppgn_batch, ppgn_spec, ppgn_edges, dev)

    # 9. the driver twins, in a temporary directory outside the checkout
    with tempfile.TemporaryDirectory() as work:
        zinc_res = run_zinc_twin(work, smi)
        k1_paths = {"train": main_launches["k1"],
                    "run_zinc": check_zinc_pool_graph(work, zinc_res, dev),
                    "run_graphcount": run_graphcount_twin(work, smi),
                    "run_zinc_cycle": run_zinc_cycle_twin(work, smi),
                    "run_qm9": run_qm9_twin(work, smi),
                    "run_ogb_mol": run_ogb_mol_twin(work, smi, dev)}
        # the copy family: this slice's main path, I2GNN, then NGNN, the
        # bucketed layout and NestedPPGN (no port kernel on these paths)
        i2gnn = run_copy_zinc_twin(work, smi, "I2GNN", dev)
        run_copy_zinc_twin(work, smi, "NGNN", dev)
        check_copy_bucketed(i2gnn, smi, dev)
        run_nppgn_twin(work, smi, dev)
    check_small_copy(dev)
    # 10. the expressiveness twins (data from the checkout's data/)
    run_sr_twin(smi, dev)
    run_exp_twin(smi, dev)
    k3_csl = run_csl_twin(smi, dev)
    # 11. the rest of the zoo: the k-GNNs, GINE+, the RGCN baseline and the
    # registry (no port kernel on these paths)
    with tempfile.TemporaryDirectory() as work:
        run_qm9_kgnn_twins(work, smi, dev)
        run_ogb_gineplus_twin(work, smi, dev)
        run_zinc_gnn_twins(work, smi, dev)
    check_zoo_registry(dev)
    check_small_zoo(dev)

    kernels = [
        dict(name="sorted_segment_sum", route="cuda",
             source="escgnn_tpu_torch/csrc/expand_segsum.cu",
             replaces="escgnn_tpu/ops/expand_pallas.py:53",
             launches=main_launches["k1"], paths=k1_paths, **k1),
        dict(name="zemb_countmat", route="cuda",
             source="escgnn_tpu_torch/csrc/zemb_countmat.cu",
             replaces="escgnn_tpu/ops/zemb_pallas.py:114",
             launches=k2_launches["k2"],
             paths={"k2_path": k2_launches["k2"]}, **k2),
        dict(name="zemb_gather", route="cuda",
             source="escgnn_tpu_torch/csrc/zemb_gather.cu",
             replaces="escgnn_tpu/ops/zemb_pallas.py:62",
             launches=ppgn_launches["k3"],
             paths={"ppgn": ppgn_launches["k3"], "run_csl": k3_csl}, **k3),
        dict(name="diag_row_col_pool", route="cuda",
             source="escgnn_tpu_torch/csrc/ppgn_pool.cu",
             replaces="escgnn_tpu/ops/ppgn_pool.py:57",
             launches=ppgn_launches["k4"],
             paths={"ppgn": ppgn_launches["k4"]}, **k4),
    ]
    _log("total", seconds=round(time.perf_counter() - t_start, 3))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
