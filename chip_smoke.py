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
    start, one PPGN_eff epoch), then `[compress_pools]` (both twins run
    again with `--compress_pools`: the decoded pools bit-equal to the
    plain ones, the counting twin's losses and val MAE bit-equal, the
    pool bytes per batch both ways), `[mesh_world1]` (the ZINC twin under
    `--mesh dp`, `ep` and `dp_ep` on an NCCL group of one rank, graphed,
    held to `[run_zinc]`, K1 counted per graphed step; `--mesh halo` and
    one halo step against the single-device width step;
    `run_graphcount --multihost` bit-equal to `[run_graphcount]`) and
    `[mesh_2rank]` (two processes sharing the card over gloo with CUDA
    tensors, eager: the ep, dp_ep, dp and halo steps against their
    one-process references), `[run_zinc_cycle]` (node-level, 3 epochs
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
    (card against CPU). K1 takes their sums (slice 16);
  * GPS: `[run_gps]` (`run_gps.main` on configs/gps/zinc-GPS.yaml at its
    widths, 64 x 4, 4 heads, batch 32, 3 graphed epochs on 512 graphs;
    its `[pool_graph]`; `--eval_only` on the best checkpoint and
    `--dump_attn`), `[gps_bench]` and `[gps_pep]` (the bench's GPS steps
    on the uniform + dedup layout: 32 ZINC-shaped graphs at 64 x 4, 16
    peptide-shaped graphs at 96 x 10; K1 against its plain version at
    their (E, 64) and (E, 96) and once per layer in every step, eager and
    graphed), `[run_gps_pep]` (`run_gps.main` on configs/gps/peptides-
    struct-GPS.yaml at its widths, 64 x 4, batch 16, 3 graphed epochs on
    600 synthetic peptides; `--eval_only`; its `[pool_graph]`),
    `[run_gps_variants]` (the other 23 configs, at their own widths and
    cut to about 4 train batches x 2 epochs, the single-graph node-split
    ones whole x 8 epochs: macro-F1 and sub-token F1 among the metrics)
    and `[small_gps]` (every global and local model and encoder, card
    against CPU);
  * the TU benchmark twin: `[run_tu]` (`run_tu.main` at its defaults,
    BaselineGNN gin0 32 x 3, 10-fold CV on the synthetic 200-graph TU
    set cut to 20 epochs, then `--model IDGNN` and `--nested` with 3
    folds; a fold's graphed and eager ms/step) and `[run_tu_cycles]` (the
    `class`, `reg --multi_layer` and `reg_gc` cycle trainers, and `class`
    on the synthetic Cora). K1 takes their sums (slice 16);
  * slice 13: `[packed]` (the ZINC twin's 800 training molecules
    packed by `packed_batch_iterator`, dedup and flat, against
    `batch_iterator`'s count; one graphed epoch over the packed dedup
    pool, K1 per step),
    `[halo_toy]` (the halo module's toy GINE stack: graphed on the NCCL
    group of one, then on the two gloo ranks of `[mesh_2rank]`, against
    its single-device reference), `[flat]` (the flagship NestedGINEff at
    the ZINC twin's f32 widths on the flagship batch, and the bench's
    GPS ZINC step, each under the flat and the dedup layout: one step
    held flat to dedup, then a graphed epoch of each, ms/step side by
    side; K1 sums the flat layout's z and table gradient),
    `[flat_bf16_bwd]` (the bf16 table backward against f32),
    `[pool_zoo]` (TopKPool -> DiffPool -> graclus pooling, card against
    CPU) and `[ogb_flag]` (OgbGNN's FLAG perturbation: zeros equal none
    bit for bit, a random one gives a gradient);
  * slice 15: `[cost]` (after `[k4]`: each kernel's charge to
    `utils/cost.py`'s `CostMode` at its path's shapes, the kernel's on the
    card equal to its plain version's on the CPU, the FLOPs equal to the
    plain version's op-by-op count on the card, the bytes over 3.35 TB/s
    printed as its bound beside its time);
  * slice 14: `[bench]`, the bench twin (`python -m
    escgnn_tpu_torch.bench`) at full size: bench.py's ten lines, each
    one batch timed as the graphed pool step, their JSON lines checked
    and each printed on a `[bench_<line>]` line with the first graphed
    loss held to the eager step, K1's nodes per captured step and its
    launches. The phases above that step a bench batch (`[gps_bench]`,
    `[gps_pep]`, `[flat]`'s GPS step, the OGB and GINE+ bench steps and
    `[zoo_registry]`'s k123) read the twin's line table. Slice 15: every
    line's bytes fields, `hbm_bw_frac` and `roofline_frac` set,
    `roofline_frac` at most 1.05, its FLOPs at least the matmul-only
    count of the same step;
  * slice 16: every float segment sum and every row gather's backward
    runs K1 over a sorted view of its ids (`ops/segment.py`), so each
    `[pool_graph]` holds K1's launches per graphed step to its eager
    count (the packed pool's losses at 1e-5 in every step), the bench
    lines' K1 nodes to their counted eager step, `[compress_pools]` the
    ZINC twin's reruns bit for bit; then `[determinism]` (the steps of
    `tools/determinism_probe.py`: two eager steps from one state and two
    graphed epochs from one state bit-equal on the ZINC twin's, packed,
    flat, `run_tu`'s and seven bench lines' steps; K1 against its f64
    sum at every distinct sum they make, one `[k1_call]` line each,
    graph-timed beside `zeros + index_add_`, and per step K1's summed ms
    against `index_add_`'s);
  * slice 17: K1 deals the row ends and positions of the merge path over
    the grid, so `[k1]` adds an interior gap of 4960 rows, a short sum
    and masked positions (sorted last under id R, dropped unread) to its
    cases.

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

from escgnn_tpu_torch.utils import trace

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
    row (PERF.md §7). A graph captured by the forward-only pool eval or
    BN refresh (`train/loop.py` `_ForwardGraph`) is marked in `forward`,
    so a count can keep to the train steps' graphs."""

    def __init__(self):
        self.dots: list[str] = []
        self.replays: list[int] = []
        self.forward: list[bool] = []

    @contextlib.contextmanager
    def watch(self):
        from escgnn_tpu_torch.train import loop

        cls = torch.cuda.CUDAGraph
        orig = {n: getattr(cls, n) for n in ("capture_end", "replay")}
        forward_init = loop._ForwardGraph.__init__
        in_forward = []
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
            ledger.forward.append(bool(in_forward))

        def forward_capture(g, *args, **kwargs):
            in_forward.append(True)
            try:
                forward_init(g, *args, **kwargs)
            finally:
                in_forward.pop()

        def replay(g):
            orig["replay"](g)
            i = getattr(g, "_ledger_index", None)
            if i is None:
                raise AssertionError("a graph replayed under the ledger was "
                                     "captured outside it")
            ledger.replays[i] += 1

        cls.capture_end, cls.replay = capture_end, replay
        loop._ForwardGraph.__init__ = forward_capture
        try:
            yield self
        finally:
            for n, f in orig.items():
                setattr(cls, n, f)
            loop._ForwardGraph.__init__ = forward_init

    def clear_replays(self) -> None:
        self.replays = [0] * len(self.dots)

    def nodes(self, symbol: str = "") -> int:
        """Nodes holding `symbol` over every graph captured (every node
        with no symbol)."""
        return sum(_dot_nodes(d, symbol) for d in self.dots)

    def launches(self, symbol: str, forward: bool | None = None) -> int:
        """Launches of kernels named `symbol` in the replays counted: of
        every graph, or with `forward` of the forward-only eval and
        refresh graphs (True) or of the others (False)."""
        return sum(_dot_nodes(d, symbol) * n
                   for i, (d, n) in enumerate(zip(self.dots, self.replays))
                   if forward is None or self.forward[i] == forward)


def _captured_kernels(fn, symbol: str) -> tuple:
    """(kernel nodes, nodes naming `symbol`) of one call of `fn` captured
    into a CUDA graph (after a warm call on a side stream), read from the
    graph's DOT dump: exact, where the profiler drops device records."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    ledger = _GraphLedger()
    with ledger.watch():
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
    return ledger.nodes("{KERNEL"), ledger.nodes(symbol)


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
    many blocks, with leading, gap and trailing rows; the sums the sorted
    views brought: an interior gap of 4960 unnamed rows at H 64 (k123's),
    a short sum (E 1024 into R 928 at H 64, GPS ZINC's), and a third of
    the positions masked (sorted last under id R, never read) beside a
    gap and a long run."""
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

    def sorted_ids(ids):
        return torch.sort(ids).values.to(torch.int32)

    # ragged: 1000 edges on ids 0..248 with gaps, 300 rows, H 96
    ids = torch.randint(0, 125, (1000,), device=dev, generator=gen) * 2
    cases.append(("ragged", torch.randn(1000, 96, device=dev, generator=gen),
                  perm_of(1000), sorted_ids(ids), 300, True))
    # long run: 6000 of 20000 edges on row 1000, the rest on even ids in
    # [6, 2500); 3000 rows
    n, long_n = 20000, 6000
    ids = torch.randint(3, 1250, (n,), device=dev, generator=gen) * 2
    ids[:long_n] = 1000
    cases.append(("long_run", torch.randn(n, H, device=dev, generator=gen),
                  perm_of(n), sorted_ids(ids), 3000, True))
    # an interior gap: 20000 positions on rows [0, 3528) and [8488, 12016),
    # rows 3528..8487 unnamed (k123's 4960-row gap), H 64
    n, lo_rows = 20000, 3528
    ids = torch.randint(0, 2 * lo_rows, (n,), device=dev, generator=gen)
    ids = torch.where(ids < lo_rows, ids, ids + 4960)
    cases.append(("gap_4960", torch.randn(n, 64, device=dev, generator=gen),
                  perm_of(n), sorted_ids(ids), 12016, True))
    # short: 1024 positions on 928 rows, runs of a few (GPS ZINC's)
    ids = torch.randint(0, 928, (1024,), device=dev, generator=gen)
    cases.append(("short_1024", torch.randn(1024, 64, device=dev,
                                            generator=gen),
                  perm_of(1024), sorted_ids(ids), 928, True))
    # masked: 45408 positions into 12016 rows, 20494 of them masked (id
    # R), a 4960-row gap and a run of 3000 on row 100, H 64
    n, masked = 45408, 20494
    ids = torch.randint(0, 2 * lo_rows, (n,), device=dev, generator=gen)
    ids = torch.where(ids < lo_rows, ids, ids + 4960)
    ids[:3000] = 100
    ids[-masked:] = 12016
    cases.append(("masked_k123", torch.randn(n, 64, device=dev,
                                             generator=gen),
                  perm_of(n), sorted_ids(ids), 12016, True))
    return cases


def _f64_sum(dZ, perm, rows, R):
    """The segment sum in f64, positions outside [0, R) dropped."""
    keep = torch.where((rows >= 0) & (rows < R), rows.long(), R)
    out = torch.zeros(R + 1, dZ.shape[1], dtype=torch.float64,
                      device=dZ.device)
    out.index_add_(0, keep, dZ.double().index_select(0, perm.long()))
    return out[:R]


def _unnamed_rows(rows, R):
    """(R,) bool: the rows no position names."""
    keep = rows[(rows >= 0) & (rows < R)].long()
    return torch.bincount(keep, minlength=R)[:R] == 0


def check_k1(batch, dev):
    """K1 on every case of `_k1_cases`: close to its reference, two calls
    bit-equal, every row no id names exactly 0; the step's strided layout
    bit-equal to the same values contiguous; one launch per call; layouts
    and shares it does not take refused. Timed on the step's layout (the
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
            want = _f64_sum(dZ, perm, rows, R)
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
        unnamed = _unnamed_rows(rows, R)
        if unnamed.any() and got[unnamed].abs().max().item() != 0:
            raise AssertionError(f"K1 {name}: a row no id names is not 0")
        if name == "long_run":
            # the blocks the long run's merge-path items span: its
            # positions come after the 1000 row ends before row 1000
            lo, hi = int((rows < 1000).sum()), int((rows <= 1000).sum())
            share = expand_cuda.segsum_plan(len(rows), dZ.shape[1], R,
                                            sms).share
            w = expand_cuda.POS_WEIGHT
            long_blocks = ((1000 + w * hi - 1) // share
                           - (1000 + w * lo) // share + 1)
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
    # one call captured into a graph: its kernel nodes, exact where the
    # profiler drops device records
    per_call, k1_nodes = _captured_kernels(
        lambda: expand_cuda.sorted_segment_sum(dZ, perm, rows_sorted, R),
        K1_SYMBOL)
    if per_call != 1 or k1_nodes != 1:
        raise AssertionError(f"K1 launched {per_call} kernels in one call, "
                             f"{k1_nodes} of them K1")
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
    plan = expand_cuda.segsum_plan(E, H, R, sms)

    # refused, each for its own reason: by the C launcher a share outside
    # [POS_WEIGHT, MAX_SHARE] and a row stride under H
    # (cudaErrorInvalidValue), by the wrapper a column stride of 2
    out_r = torch.empty(R, H, device=dev)
    part = torch.empty(plan.partial_floats, device=dev)

    def launcher(share, ld):
        rc = _build.load("expand_segsum").expand_segsum_f32(
            dZ.data_ptr(), ld, perm.data_ptr(), rows_sorted.data_ptr(), E, H,
            R, share, out_r.data_ptr(), part.data_ptr(),
            expand_cuda._counters(dev, R).data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(rc, "expand_segsum")

    too_big = expand_cuda.MAX_SHARE + 1
    refusals = {
        f"share_{expand_cuda.POS_WEIGHT - 1}": (
            lambda: launcher(expand_cuda.POS_WEIGHT - 1, dZ.stride(0)),
            "CUDA error 1"),
        f"share_{too_big}": (lambda: launcher(too_big, dZ.stride(0)),
                             "CUDA error 1"),
        "row_stride_under_H": (lambda: launcher(plan.share, H - 1),
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
    _log("k1", shapes=f"E={E},R={R},H={H}", layout="ld288", share=plan.share,
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
    from escgnn_tpu_torch.bench import flagship_config
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


def _charged(fn, *args):
    """The one charge `fn` (a kernel's wrapper) makes to a `CostMode`:
    (name, flops, transcendentals, bytes)."""
    from escgnn_tpu_torch.utils import cost

    with cost.CostMode() as mode:
        fn(*args)
    torch.cuda.synchronize()
    if len(mode.by_op) != 1:
        raise AssertionError(f"cost: {fn.__name__} charged {sorted(mode.by_op)}"
                             f", not one kernel")
    (name, c), = mode.by_op.items()
    if c.calls != 1:
        raise AssertionError(f"cost: {name} charged {c.calls} times")
    return name, c.flops, c.transcendentals, c.bytes


def check_cost(batch, ppgn_batch, N: int, dev, timed: dict) -> dict:
    """`[cost]`: each kernel's charge to `utils/cost.py`'s `CostMode` at its
    path's shapes (K1 the flagship's (E, 288) strided f32 gradient, K2 its
    unique rows, K3 the PPGN_eff width batch, K4 its bf16 grid of N nodes
    per graph): the
    kernel's call on the card and its plain version (the wrapper on CPU
    copies of the same inputs) charge the same FLOPs and bytes, and the
    FLOPs are what the plain version counts op by op on the card. Prints
    the charge's bytes over 3.35 TB/s as the kernel's bound beside its
    time from `[k1]`-`[k4]` (`timed`). Returns each kernel's bound in ms,
    by short name."""
    from escgnn_tpu_torch.ops import expand_cuda, ppgn_pool, zemb_cuda, zemb_gather
    from escgnn_tpu_torch.utils import cost

    gen = torch.Generator(device=dev).manual_seed(5)
    perm, rows = batch.enc_edge_perm, batch.enc_row_sorted
    R, H = batch.enc_idx.shape[0], 256
    dZ = torch.randn(perm.shape[0], H + 32, device=dev, generator=gen)[:, :H]
    idx = batch.enc_idx.to(torch.int32).contiguous()
    cnt = batch.enc_cnt.to(torch.float32).contiguous()
    table2 = torch.randn(batch.enc_bucket_ids.shape[0], H, device=dev,
                         generator=gen)
    idx3 = ppgn_batch.enc_idx.to(torch.int32).contiguous()
    cnt3 = ppgn_batch.enc_cnt.to(torch.float32).contiguous()
    table3 = torch.randn(1800, PPGN_EMB, device=dev, generator=gen)
    x4 = torch.randn(NUM_GRAPHS, N, N, PPGN_EMB, device=dev,
                     generator=gen).to(torch.bfloat16)
    cases = {
        "k1": (expand_cuda.sorted_segment_sum,
               expand_cuda.sorted_segment_sum_plain, (dZ, perm, rows, R)),
        "k2": (zemb_cuda.zemb_countmat, zemb_cuda.zemb_countmat_plain,
               (table2, idx, cnt)),
        "k3": (zemb_gather.zemb_gather, zemb_gather.zemb_gather_plain,
               (table3, idx3, cnt3)),
        "k4": (ppgn_pool.diag_row_col_pool, ppgn_pool.diag_row_col_pool_plain,
               (x4,)),
    }
    bounds = {}
    for short, (wrapper, plain, args) in cases.items():
        name, flops, trans, nbytes = _charged(wrapper, *args)
        cpu = tuple(a.cpu() if isinstance(a, torch.Tensor) else a
                    for a in args)
        plain_charge = _charged(wrapper, *cpu)
        if plain_charge != (name, flops, trans, nbytes):
            raise AssertionError(f"cost {short}: the kernel's charge "
                                 f"{(name, flops, trans, nbytes)} != its "
                                 f"plain version's {plain_charge}")
        with cost.CostMode() as mode:
            plain(*args)
        torch.cuda.synchronize()
        bare = mode.total()
        if bare.flops != flops:
            raise AssertionError(f"cost {short}: charged {flops} FLOPs, its "
                                 f"plain version counts {bare.flops}")
        # the charge's FLOPs are the plain version's (K2's dense product
        # among them), not the kernel's: the bound is the bytes'
        bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        bounds[short] = bound_ms
        _log(f"cost_{short}", kernel=name, flops=flops,
             transcendentals=trans, bytes=nbytes, bytes_bound_ms=bound_ms,
             ms=timed[short], ms_over_bound=timed[short] / bound_ms,
             plain_op_by_op_bytes=bare.bytes, plain_charge_equal=True,
             ok=True)
    _log("cost", kernels=len(cases), bound_ms=json.dumps(bounds), ok=True)
    return bounds


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
    from escgnn_tpu_torch.ops import zemb
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
        trace.reset("k3.launches", "k4.launches")
        losses, step_ms = [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            losses.append(train_step(model, opt, batch, l1_node_loss))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        launches = {k: trace.counter(k + ".launches") for k in ("k3", "k4")}
        trace.reset("k3.launches", "k4.launches")
        err_sum, count = eval_step(model, batch, node_level=True)
        torch.cuda.synchronize()
        eval_launches = {k: trace.counter(k + ".launches")
                         for k in ("k3", "k4")}
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
    trace.reset("k3.launches", "k4.launches")
    t0 = time.perf_counter()
    loss_def = float(train_step(m_def, adam_with_plateau(m_def.parameters(), LR),
                                batch, l1_node_loss))
    torch.cuda.synchronize()
    def_ms = (time.perf_counter() - t0) * 1e3
    if trace.counter("k3.launches") or trace.counter("k4.launches"):
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

    argv = ["--num_graphs", "1000", "--epochs", "3", "--num_workers", "2",
            "--data_dir", os.path.join(work, "data"),
            "--res_dir", os.path.join(work, "zinc")]
    trace.reset("k1.launches")
    t0 = time.perf_counter()
    res = run_zinc.main(argv)
    seconds = time.perf_counter() - t0
    k1_wrapper = trace.counter("k1.launches")
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
                     batch_transform=None, report=None, per_step=None,
                     pool=None, k1_min: int = 1):
    """`[pool_graph]`: from one state snapshot of `model`, one epoch of a
    twin's train pool (its graphs, spec and model at full width) through
    the graphed pool step and one through eager steps. The first step's
    loss agrees at rel_tol[0] (1e-5) and every later one at rel_tol[1]
    (1e-3 unless said: captured and eager kernels may round apart, and
    Adam amplifies that). `rel_tol=None` (a model with dropout: the two
    epochs draw other masks) compares nothing and checks that both
    losses are finite. The kernel (label, symbol), K1 unless said, runs
    `per_step` times per step of a graphed epoch: `per_step` nodes of the
    captured graph, replayed once per step (`_GraphLedger`), seen by the
    profiler at least once and never more often. For K1 `per_step`
    defaults to the launches its wrapper counts in the eager epoch, the
    same in every step and at least `k1_min` (every sum of a step and
    every row gather's backward run K1). Prints both ms/step, the
    device's busy time per step, the launches per eager step, the seconds
    the pool took to build and the peak device memory of the graphed
    epoch; returns the kernel's launches in the graphed epoch.
    `batch_transform` applies to every pooled batch (the bucketed copy
    layout); `report`, a dict, receives the printed numbers; `pool`, a
    stacked pool on the card, is taken instead of one built from `train`
    and `spec` (its steps walked in a permuted order all the same)."""
    import numpy as np

    from escgnn_tpu_torch.data.prefetch import (
        pool_entry,
        pool_size,
        stacked_batch_pools,
    )
    from escgnn_tpu_torch.train.loop import (
        adam_with_plateau,
        make_pool_train_step,
        train_step,
    )

    t0 = time.perf_counter()
    if pool is None:
        pools, steps, _ = stacked_batch_pools(
            train, spec, k=1, seed=0, device=dev,
            batch_transform=batch_transform)
        pool = pools[0]
    else:
        steps = pool_size(pool)
    torch.cuda.synchronize()
    pool_build_s = time.perf_counter() - t0
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
    trace.reset("k1.launches")
    e_losses, e_ms = timed(lambda: torch.stack([
        train_step(model, opt_e, pool_entry(pool, int(j)), loss_fn)
        for j in order]).tolist())
    k1_eager = trace.counter("k1.launches")
    if kernel is not None and kernel[0] == "k1" and per_step is None:
        per_step = k1_eager // steps
        if k1_eager != per_step * steps or per_step < k1_min:
            raise AssertionError(
                f"{twin}: K1 ran {k1_eager} times in an eager epoch of "
                f"{steps} steps, not one count of at least {k1_min} per step")
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
        if n != steps * per_step or not min(1, n) <= seen <= n:
            raise AssertionError(
                f"{twin}: {label} ran {n} times in a graphed epoch of "
                f"{steps} steps, not {per_step} per step "
                f"({ledger.nodes(symbol)} node(s) in the "
                f"graph, {sum(ledger.replays)} replays; the profiler saw "
                f"{seen})")
        per_epoch = {f"{label}_per_graphed_epoch": n,
                     f"{label}_profiler_seen": seen,
                     f"{label}_per_step": per_step}
        if label == "k1":
            POOL_GRAPH_K1[twin] = n
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
    from escgnn_tpu_torch.train.checkpoint import (
        CheckpointManager,
        load_model_tree,
        model_tree,
    )
    from escgnn_tpu_torch.train.loop import l1_node_loss, make_pool_eval_step

    data = os.path.join(work, "data")
    base = ["--num_graphs", "400", "--data_dir", data]
    cold_dir = os.path.join(work, "count_cold")
    trace.reset("k1.launches")
    t0 = time.perf_counter()
    cold = rg.main(base + ["--epochs", "3", "--res_dir", cold_dir])
    cold_s = time.perf_counter() - t0
    k1_wrapper = trace.counter("k1.launches")
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
    return k1_graphed, cold


def _regression_twin(name, twin, work, smi, graphs, steps, loss_fn,
                     build_model, flags=(), kernel=("k1", "segsum_kernel")):
    """`[<name>]`: a regression twin's main() at its default widths (and
    `flags`) on `graphs` molecules for 3 graphed epochs (loss
    falls, finite MAE, the expected steps per epoch), then `[pool_graph]`
    on its train split (built again by the twin's own `build_splits`) and
    a fresh model: `kernel`, K1 unless said, as often per graphed step
    as per eager step (`check_pool_graph`). Returns
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
    before = trace.counter("k1.launches")
    profiled_events = _device_kernels(
        lambda: expand_cuda.sorted_segment_sum(f32, perm, rows, R))
    # a warm call, then one
    per_call = (trace.counter("k1.launches") - before) / 2
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
    from escgnn_tpu_torch import bench
    from escgnn_tpu_torch.data.prefetch import stack_split

    line = bench_line(bench.OGB)
    graphs, spec = line.graphs, line.spec
    pool = stack_split(graphs, spec, dev)
    fields = _bench_step(lambda: line.model(dev), pool, line.loss_fn,
                         kernel="segsum_kernel")
    fields["k1_per_graphed_step"] = fields.pop("kernel_per_graphed_step")
    if fields["k1_per_graphed_step"] != BENCH_K1_NODES["ogb"]:
        raise AssertionError(f"ogb bench step: K1 "
                             f"{fields['k1_per_graphed_step']} times per "
                             f"step")
    return dict(graphs=len(graphs), N=spec.num_nodes, E=spec.num_edges,
                R=spec.num_enc_rows, real_edges=line.real_edges, **fields,
                graphed_real_edges_per_s=line.real_edges / (
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
    from escgnn_tpu_torch.train.loop import bce_graph_loss

    argv = ["--num_graphs", "640", "--epochs", "3", "--synth_label", "tri",
            "--num_workers", "2", "--data_dir", os.path.join(work, "data"),
            "--res_dir", os.path.join(work, "ogb")]
    trace.reset("k1.launches")
    t0 = time.perf_counter()
    res = run_ogb_mol.main(argv)
    seconds = time.perf_counter() - t0
    k1_wrapper = trace.counter("k1.launches")
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
    out again) with a fresh model: graphed against eager, K1 in its
    pooling sums and gathers' backwards. Prints the real and padded copy edges per step. Returns
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
                     uniform["train"], spec, args.lr, dev, report=pool)
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
                     batch_transform=transform, report=pool)
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
                     dev, report=pool, k1_min=0)
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
    13 steps per epoch; its `[pool_graph]` (K1 in the set-graph sums);
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
        build, flags=["--model", "k123_GNN"])
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
    from escgnn_tpu_torch import bench as bench_twin
    from escgnn_tpu_torch import run_ogb_mol
    from escgnn_tpu_torch.data.prefetch import stack_split
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
                     bce_graph_loss, train, spec, args.lr, dev,
                     rel_tol=None, report=report)
    args0 = run_ogb_mol.build_parser().parse_args(argv + ["--drop_ratio",
                                                          "0"])
    check_pool_graph("run_ogb_mol_ginep_dropout0",
                     run_ogb_mol.build_model(args0, dev), bce_graph_loss,
                     train, spec, args.lr, dev, rel_tol=(1e-5, math.inf))
    spread = _perturbed_spread(lambda: run_ogb_mol.build_model(args0, dev),
                               bce_graph_loss, train, spec, args.lr, dev)

    line = bench_line(bench_twin.GINE_PLUS)
    bench = _bench_step(lambda: line.model(dev),
                        stack_split(line.graphs, line.spec, dev),
                        line.loss_fn)
    bench.update(graphs=len(line.graphs), N=line.spec.num_nodes,
                 E=line.spec.num_edges, real_multihop_edges=line.real_edges,
                 graphed_real_edges_per_s=line.real_edges / (
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

    pools, steps, _ = stacked_batch_pools(train, spec, k=1, seed=0,
                                          device=dev)
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
    `[pool_graph]`, K1 in their sums."""
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
                     l1_graph_loss, train, spec, args.lr, dev, report=report)
    _log("run_zinc_gnn", seconds=round(seconds, 3), graphs=1000,
         steps_per_epoch=7, layers=args.layers, batch=args.batch_size,
         N=spec.num_nodes, E=spec.num_edges, **_epoch_fields(res),
         card=json.dumps(smi), ok=True)
    _regression_twin(
        "run_zinc_cycle_gnn", run_zinc_cycle, work, smi, 1000, 7,
        l1_node_loss, lambda a, splits: run_zinc_cycle.build_model(a, dev),
        flags=["--model", "GNN"])


def _zoo_data():
    """Host batches for the zoo: (TU-shaped ZINC molecules, one-hot atom
    types and a two-class label; their h-2 node copies; the same
    molecules with type ids and a float target; multihop OGB molecules;
    QM9 molecules with distance edges; 16 QM9 molecules with h-3 copies
    and their 2- and 3-set graphs: the bench twin's k123 line)."""
    import numpy as np

    from escgnn_tpu_torch import bench
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
    k123 = bench_line(bench.K123)
    ogb = [make_multihop_edges(g, 3)
           for g in synthetic_ogb_mol(16, seed=0, num_tasks=1)]
    return dict(tu=host(tu), copies=host(copies), zinc=host(zinc),
                ogb=host(ogb), qm9=host(qm9), kset=k123.host_batch(),
                kset_line=k123)


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
    k123 = data.pop("kset_line")
    b = {k: v.to(dev) for k, v in data.items()}
    g0 = k123.graphs[0]
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


# ---------------------------------------------------------------------------
# GPS: the run_gps twin, the bench-shaped steps with K1 in their backward,
# the other configs and every attention / local model / encoder
# ---------------------------------------------------------------------------

GPS_CFG = "configs/gps/zinc-GPS.yaml"
PEP_CFG = "configs/gps/peptides-struct-GPS.yaml"
# the configs `[run_gps_variants]` runs (each at its own widths): the
# graphs each keeps (about 4 train batches per epoch; None: the dataset
# is not cut) and its epochs. The single-graph node-split configs (batch
# 1, one step per epoch) run 8 epochs, as many steps as the others' 2;
# imdb's synthetic TU set has 200 graphs whatever num_graphs says
GPS_VARIANTS = {
    "zinc-GPS-bigbird": (160, 2), "zinc-GPS-graphormer": (160, 2),
    "zinc-GPS-linear": (160, 2), "zinc-GPS-san": (160, 2),
    "counting-GPS": (160, 2), "qm9-GPS": (160, 2), "molhiv-GPS": (80, 2),
    "aqsol-GPS": (160, 2), "pcqm4mv2-GPS": (3200, 2), "ppa-GPS": (80, 2),
    "contact-GPS": (160, 2), "ogbl-GPS": (200, 2),
    "peptides-func-GPS": (80, 2), "peptides-struct-GPS": (80, 2),
    "mnist-GPS": (160, 2), "malnet-GPS": (80, 2), "imdb-GPS": (None, 2),
    "voc-GPS": (80, 2), "pattern-GPS": (80, 2), "code2-GPS": (80, 2),
    "cora-GPS": (None, 8), "actor-GPS": (None, 8),
    "chameleon-GPS": (None, 8),
}


def bench_line(metric: str, smoke: bool = False):
    """The bench twin's line `metric` (`escgnn_tpu_torch/bench.py`
    `bench_line`: its graphs, spec, model config and loss), its graph set
    built here with 2 forked featurizer workers: the one source of the
    bench's shapes for the phases that step a bench batch."""
    from escgnn_tpu_torch import bench

    gsets = bench.make_graph_sets((metric,), smoke, num_workers=2)
    return bench.bench_line(metric, gsets, smoke)


def check_k1_gps(batch, H: int, dev, label: str):
    """K1 at a GPS shape: the contiguous (E, H) gradient of one layer's z
    expansion over the batch's sorted view, against the f64 sum (rtol
    1e-5, atol 1e-4) and bit-equal from run to run; one launch per call
    (the kernel nodes of one call captured into a graph: the profiler
    drops device records); its CUDA-graph-timed ms beside the plain
    version's, `index_add_`'s on
    the unsorted edge -> row map, and the bound."""
    from escgnn_tpu_torch.ops import expand_cuda, smem_plan

    gen = torch.Generator(device=dev).manual_seed(2)
    perm, rows = batch.enc_edge_perm, batch.enc_row_sorted
    E, R = perm.shape[0], batch.enc_idx.shape[0]
    dZ = torch.randn(E, H, device=dev, generator=gen)
    got = expand_cuda.sorted_segment_sum(dZ, perm, rows, R)
    want = torch.zeros(R, H, dtype=torch.float64, device=dev).index_add_(
        0, rows.long(), dZ.double().index_select(0, perm.long()))
    err = _check_close(f"K1 {label}", got, want.float(), rtol=1e-5,
                       atol=1e-4)
    if not torch.equal(got, expand_cuda.sorted_segment_sum(dZ, perm, rows,
                                                           R)):
        raise AssertionError(f"K1 {label}: not deterministic")
    per_call, k1_nodes = _captured_kernels(
        lambda: expand_cuda.sorted_segment_sum(dZ, perm, rows, R),
        "segsum_kernel")
    if per_call != 1 or k1_nodes != 1:
        raise AssertionError(f"K1 {label}: one call captured {per_call} "
                             f"kernel nodes, {k1_nodes} of them K1")
    ms = _cuda_ms(lambda: expand_cuda.sorted_segment_sum(dZ, perm, rows, R))
    plain_ms = _cuda_ms(
        lambda: expand_cuda.sorted_segment_sum_plain(dZ, perm, rows, R))
    edge_row = batch.enc_edge_row.long()
    library_ms = _cuda_ms(
        lambda: torch.zeros(R, H, device=dev).index_add_(0, edge_row, dZ))
    bound_ms, bound_by = _bound(E * H * 4 + 2 * E * 4 + R * H * 4, E * H)
    plan = expand_cuda.segsum_plan(E, H, R, smem_plan.sm_count(dev))
    fields = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                  library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
    _log(f"k1_{label}", shapes=f"E={E},R={R},H={H}", share=plan.share,
         grid=plan.grid, launches_per_call=per_call, **fields, ok=True)
    return fields


def run_gps_bench(shape: str, dev, reps: int):
    """`[gps_bench]` / `[gps_pep]`: the bench's GPS train step on the
    uniform + dedup layout, graphed (`[pool_graph]` over `reps` copies of
    the bench batch, each a step) against eager, K1 `num_layers` times
    per step in both; K1 against its plain version at the step's
    (E, dim_h). Returns (K1's launches in the graphed epoch, K1's
    numbers at this shape)."""
    from escgnn_tpu_torch import bench
    from escgnn_tpu_torch.train.loop import (
        adam_with_plateau,
        l1_graph_loss,
        train_step,
    )

    label = "gps_bench" if shape == "zinc" else "gps_pep"
    t0 = time.perf_counter()
    line = bench_line(bench.GPS_ZINC if shape == "zinc" else bench.GPS_PEP)
    data_s = time.perf_counter() - t0
    graphs, spec, cfg = line.graphs, line.spec, line.config
    batch = line.host_batch().to(dev)
    k1 = check_k1_gps(batch, cfg.dim_h, dev, label)
    model = line.model(dev)
    # eager launches of K1 per step: the bench line's count (per layer the
    # z expansion's backward and the attention grid's gather, and the
    # embedding lookups)
    trace.reset("k1.launches")
    train_step(copy.deepcopy(model),
               adam_with_plateau(model.parameters(), LR), batch,
               l1_graph_loss)
    torch.cuda.synchronize()
    eager = trace.counter("k1.launches")
    want = BENCH_K1_NODES["gps" if shape == "zinc" else "gps_pep"]
    if eager != want:
        raise AssertionError(f"{label}: K1 ran {eager} times in an eager "
                             f"step, not {want}")
    report = {}
    graphed = check_pool_graph(label, model, l1_graph_loss, graphs * reps,
                               spec, LR, dev, report=report,
                               k1_min=cfg.num_layers)
    _log(label, graphs=len(graphs), N=batch.num_nodes, E=batch.num_edges,
         R=spec.num_enc_rows, M=spec.max_nodes_per_graph,
         spd_ids_per_layer=len(graphs) * spec.max_nodes_per_graph ** 2,
         dim_h=cfg.dim_h, layers=cfg.num_layers, data_s=round(data_s, 3),
         k1_eager_launches_per_step=eager,
         k1_graphed_launches=graphed, steps=reps,
         graphed_ms_per_step=report["graphed_ms_per_step"],
         busy_ms_per_step=report["graphed_busy_ms_per_step"],
         idle_share=report["graphed_idle_share"],
         device_events_per_step=report["device_events_per_graphed_step"],
         peak_mem_gb=report["graphed_peak_mem_gb"], ok=True)
    return graphed, k1


def _gps_args(work: str, cfg: str, *extra):
    return ["--cfg", cfg, "out_dir", os.path.join(work, "gps_runs"),
            "dataset.dir", os.path.join(work, "data"), *extra]


def run_gps_twin(work: str, smi: str, dev):
    """`[run_gps]`: `run_gps.main` on configs/gps/zinc-GPS.yaml at its
    widths (64 x 4, 4 heads, batch 32, ESC h 3 rd, SPD bias, 512 graphs)
    for 3 graphed epochs; its `[pool_graph]` (K1 in the attention grid's
    gather backward), graphed = eager on the first step at rel 1e-5, and the
    spread two eager epochs show from a 1e-7 weight perturbation
    (`perturbed_rel`: the training carries rounding differences that
    far); `--eval_only` on the best checkpoint reproduces the best val
    MAE at rel 1e-5; `--dump_attn` writes 4 (G, 4, M, M) tensors."""
    import numpy as np

    from escgnn_tpu_torch import run_gps
    from escgnn_tpu_torch.config import load_cfg
    from escgnn_tpu_torch.data.batching import BatchSpec

    t0 = time.perf_counter()
    res = run_gps.main(_gps_args(work, GPS_CFG, "train.epochs", "3"))
    seconds = time.perf_counter() - t0
    run = res["runs"][0]
    eps = run["epochs"]
    losses = [e["loss"] for e in eps]
    vals = [e["val"] for e in eps]
    if not all(math.isfinite(v) for v in losses + vals):
        raise AssertionError(f"run_gps: non-finite {losses} {vals}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"run_gps: loss did not fall: {losses}")
    ckpt = os.path.join(res["out_dir"], "ckpt_s0")
    npz = os.path.join(work, "attn.npz")
    ev = run_gps.main(_gps_args(work, GPS_CFG, "--eval_only", ckpt,
                                "--dump_attn", npz))
    if not math.isclose(ev["val_mae"], run["best_val_mae"], rel_tol=1e-5):
        raise AssertionError(f"run_gps --eval_only val MAE {ev['val_mae']} "
                             f"!= the best epoch's {run['best_val_mae']}")
    cfg = load_cfg(GPS_CFG, ["dataset.dir", os.path.join(work, "data")])
    splits, _, _ = run_gps.build_dataset(cfg, 0)
    spec = BatchSpec.from_graphs([g for s in splits.values() for g in s],
                                 cfg.train.batch_size)
    want = (cfg.train.batch_size, cfg.model.num_heads,
            spec.max_nodes_per_graph, spec.max_nodes_per_graph)
    attn = np.load(npz)
    shapes = {k: attn[k].shape for k in attn.files}
    if sorted(shapes) != [f"layer{i}/self_attn" for i in range(4)] or any(
            v != want for v in shapes.values()):
        raise AssertionError(f"run_gps --dump_attn wrote {shapes}, want 4 "
                             f"{want}")
    rows = attn["layer0/self_attn"].sum(-1)
    if not np.allclose(rows, 1.0, atol=1e-5):
        raise AssertionError("run_gps: dumped attention rows do not sum to 1")
    # the first step is held to eager; later steps carry the atomics'
    # rounding through Adam (see `perturbed_rel`)
    make = lambda: run_gps.build_model(cfg, splits, 0, dev)  # noqa: E731
    loss_fn = run_gps._loss_fn(cfg)
    check_pool_graph("run_gps", make(), loss_fn, splits["train"], spec,
                     cfg.optim.base_lr, dev, rel_tol=(1e-5, math.inf))
    spread = _perturbed_spread(make, loss_fn, splits["train"], spec,
                               cfg.optim.base_lr, dev)
    _log("run_gps", config=GPS_CFG, seconds=round(seconds, 3),
         steps_per_epoch=eps[0]["steps"],
         epoch_seconds=json.dumps([round(e["seconds"], 4) for e in eps]),
         graphed_ms_per_step=json.dumps(
             [round(e["train_seconds"] / e["steps"] * 1e3, 4) for e in eps]),
         losses=json.dumps(losses),
         val_mae=json.dumps(vals), best_val_mae=run["best_val_mae"],
         eval_only_val_mae=ev["val_mae"], perturbed_rel=json.dumps(spread),
         attn_shapes=json.dumps(
             {k: list(v) for k, v in shapes.items()}), card=json.dumps(smi),
         ok=True)


def run_gps_variants(work: str, smi: str):
    """`[run_gps_variants]`: graphed epochs of each of the other 23
    configs at its own widths, cut as `GPS_VARIANTS` says: finite losses
    that fall, a finite metric (accuracy, AP, AUC, MAE, MRR, and the
    node-classification macro-F1 and code2's sub-token F1)."""
    from escgnn_tpu_torch import run_gps

    out = {}
    for name, (num_graphs, epochs) in GPS_VARIANTS.items():
        t0 = time.perf_counter()
        cut = [] if num_graphs is None else ["dataset.num_graphs",
                                             str(num_graphs)]
        res = run_gps.main(_gps_args(
            work, f"configs/gps/{name}.yaml", "train.epochs", str(epochs),
            *cut))
        run = res["runs"][0]
        losses = [e["loss"] for e in run["epochs"]]
        metric = {k: v for k, v in run.items() if k.startswith("best_val")}
        if not all(math.isfinite(v) for v in losses + list(metric.values())):
            raise AssertionError(f"run_gps {name}: non-finite {losses} "
                                 f"{metric}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"run_gps {name}: loss did not fall: "
                                 f"{losses}")
        out[name] = dict(seconds=round(time.perf_counter() - t0, 3),
                         steps=run["epochs"][0]["steps"], losses=losses,
                         **metric)
    _log("run_gps_variants", configs=len(out), runs=json.dumps(out),
         card=json.dumps(smi), ok=True)


def run_gps_pep_twin(work: str, smi: str, dev):
    """`[run_gps_pep]`: `run_gps.main` on configs/gps/peptides-struct-
    GPS.yaml at its widths (64 x 4, 4 heads, batch 16, ESC h 2 rd, SPD
    bias, 600 synthetic peptides, 11 standardized targets) for 3 graphed
    epochs: losses fall, val MAE; `--eval_only` on the best checkpoint
    reproduces the best val MAE at rel 1e-5; its `[pool_graph]` holds the
    first graphed step to eager at rel 1e-5 (the GPS twin is chaotic past
    step 1, see `[run_gps]`) and reads busy ms/step, the idle share,
    device events per step and the peak memory."""
    from escgnn_tpu_torch import run_gps
    from escgnn_tpu_torch.config import load_cfg
    from escgnn_tpu_torch.data.batching import BatchSpec

    args = ["--cfg", PEP_CFG, "out_dir", os.path.join(work, "gps_pep_runs"),
            "dataset.dir", os.path.join(work, "data")]
    t0 = time.perf_counter()
    res = run_gps.main(args + ["train.epochs", "3"])
    seconds = time.perf_counter() - t0
    run = res["runs"][0]
    eps = run["epochs"]
    losses = [e["loss"] for e in eps]
    vals = [e["val"] for e in eps]
    if not all(math.isfinite(v) for v in losses + vals):
        raise AssertionError(f"run_gps_pep: non-finite {losses} {vals}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"run_gps_pep: loss did not fall: {losses}")
    ev = run_gps.main(args + ["--eval_only",
                              os.path.join(res["out_dir"], "ckpt_s0")])
    if not math.isclose(ev["val_mae"], run["best_val_mae"], rel_tol=1e-5):
        raise AssertionError(f"run_gps_pep --eval_only val MAE "
                             f"{ev['val_mae']} != the best epoch's "
                             f"{run['best_val_mae']}")
    cfg = load_cfg(PEP_CFG, ["dataset.dir", os.path.join(work, "data")])
    splits, _, _ = run_gps.build_dataset(cfg, 0)
    spec = BatchSpec.from_graphs([g for s in splits.values() for g in s],
                                 cfg.train.batch_size)
    report = {}
    check_pool_graph("run_gps_pep", run_gps.build_model(cfg, splits, 0, dev),
                     run_gps._loss_fn(cfg), splits["train"], spec,
                     cfg.optim.base_lr, dev, rel_tol=(1e-5, math.inf),
                     report=report)
    _log("run_gps_pep", config=PEP_CFG, seconds=round(seconds, 3),
         steps_per_epoch=eps[0]["steps"], N=spec.num_nodes,
         E=spec.num_edges, M=spec.max_nodes_per_graph,
         epoch_seconds=json.dumps([round(e["seconds"], 4) for e in eps]),
         graphed_ms_per_step=json.dumps(
             [round(e["train_seconds"] / e["steps"] * 1e3, 4) for e in eps]),
         losses=json.dumps(losses), val_mae=json.dumps(vals),
         best_val_mae=run["best_val_mae"],
         best_test_mae=run["best_test_mae"],
         eval_only_val_mae=ev["val_mae"],
         busy_ms_per_step=report["graphed_busy_ms_per_step"],
         idle_share=report["graphed_idle_share"],
         device_events_per_step=report["device_events_per_graphed_step"],
         peak_mem_gb=report["graphed_peak_mem_gb"], card=json.dumps(smi),
         ok=True)


# ---------------------------------------------------------------------------
# the run_tu twin
# ---------------------------------------------------------------------------

TU_EPOCHS = "20"  # the twin's default is 100


def run_tu_twin(work: str, smi: str, dev):
    """`[run_tu]`: `run_tu.main` at its defaults (BaselineGNN gin0 32 x 3,
    mean pool, dropout 0.5, batch 128, lr 1e-2, 10 folds) on the synthetic
    200-graph TU set, cut to 20 epochs; then `--model IDGNN` and
    `--nested` (h 2 node copies) with 3 folds each. Each fold's val loss
    falls, its accuracies lie in [0, 1]; prints per-fold seconds and the
    test accuracy's mean and std. Then the graphed and eager ms/step of
    fold 0's train split with the default model (`[pool_graph]`; dropout
    draws differ, so the losses are only held finite)."""
    import numpy as np

    from escgnn_tpu_torch import run_tu
    from escgnn_tpu_torch.data.batching import BatchSpec
    from escgnn_tpu_torch.data.tu import get_tu_dataset
    from escgnn_tpu_torch.train.cv import k_fold
    from escgnn_tpu_torch.train.loop import ce_graph_loss

    data = os.path.join(work, "TU")
    runs = {}
    for label, extra in (("BaselineGNN", []),
                         ("IDGNN", ["--model", "IDGNN", "--folds", "3"]),
                         ("nested", ["--nested", "--folds", "3"])):
        t0 = time.perf_counter()
        res = run_tu.main(["--data_dir", data, "--epochs", TU_EPOCHS,
                           "--res_dir", os.path.join(work, f"tu_{label}"),
                           *extra])
        val, acc = res["val_losses"], res["test_accs"]
        if not (np.isfinite(val).all() and ((acc >= 0) & (acc <= 1)).all()):
            raise AssertionError(f"run_tu {label}: val {val} acc {acc}")
        if not (val[:, -1] < val[:, 0]).all():
            raise AssertionError(f"run_tu {label}: a fold's val loss did "
                                 f"not fall: {val[:, [0, -1]].tolist()}")
        runs[label] = dict(
            seconds=round(time.perf_counter() - t0, 3), folds=len(val),
            fold_seconds=[round(d, 3) for d in res["durations"]],
            test_acc_mean=res["test_acc_mean"],
            test_acc_std=res["test_acc_std"], val_loss=res["val_loss"])
    args = run_tu.build_parser().parse_args(["--data_dir", data])
    graphs = get_tu_dataset(args.dataset, root=args.data_dir)
    labels = np.asarray([int(g.y[0]) for g in graphs])
    train = [graphs[i] for i in k_fold(labels, args.folds)[0][0]]
    spec = BatchSpec.from_graphs(graphs, args.batch_size)
    factory = run_tu.cv_model_factory(args, 2, graphs[0].x.shape[1], dev)
    report = {}
    check_pool_graph("run_tu", factory(torch.Generator().manual_seed(0)),
                     ce_graph_loss, train, spec, args.lr, dev,
                     rel_tol=None, report=report)
    _log("run_tu", dataset="synthetic TU (200 graphs)",
         epochs=int(TU_EPOCHS), runs=json.dumps(runs),
         fold_graphed_ms_per_step=report["graphed_ms_per_step"],
         fold_eager_ms_per_step=report["eager_ms_per_step"],
         card=json.dumps(smi), ok=True)


def run_tu_cycles(work: str, smi: str):
    """`[run_tu_cycles]`: the three cycle trainers through `run_tu.main`
    at their defaults (100 epochs, BaselineGNN gin0 32 x 3 node-level
    with jumping knowledge, dropout 0.5) on the synthetic TU set: `class`
    (BCE over a node split of the 200 graphs' union), `reg
    --multi_layer` and `reg_gc` (batches of 128 rebuilt every epoch), and
    `class` on `--dataset Cora` (the synthetic 600-node citation graph).
    The train loss falls and the metric tuple is finite; prints it with
    `duration_s`."""
    from escgnn_tpu_torch import run_tu

    out = {}
    for label, extra in (("class", ["--use_cycle", "class"]),
                         ("reg_multi_layer", ["--use_cycle", "reg",
                                              "--multi_layer"]),
                         ("reg_gc", ["--use_cycle", "reg_gc"]),
                         ("cora_class", ["--use_cycle", "class",
                                         "--dataset", "Cora"])):
        res = run_tu.main(["--data_dir", os.path.join(work, "TU"),
                           "--res_dir", os.path.join(work, f"cyc_{label}"),
                           *extra])
        hist = res["history"]
        metrics = {k: v for k, v in res.items()
                   if k.startswith("test_") or k == "best_val"}
        if not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"run_tu {label}: {metrics}")
        if not hist[-1]["train_loss"] < hist[0]["train_loss"]:
            raise AssertionError(f"run_tu {label}: train loss did not "
                                 f"fall: {hist[0]} {hist[-1]}")
        out[label] = dict(metrics, epochs=len(hist),
                          first_loss=hist[0]["train_loss"],
                          last_loss=hist[-1]["train_loss"],
                          duration_s=res["duration_s"])
    _log("run_tu_cycles", runs=json.dumps(out), card=json.dumps(smi),
         ok=True)


# the ppa_uniform case's graphs in other orders: the same mathematics with
# its sums in other orders, whose spread sets the limit on its gradients
PPA_ORDERS = ((5, 4, 3, 2, 1, 0), (1, 0, 2, 3, 4, 5), (2, 0, 1, 5, 3, 4))


def _gps_prep(graphs, layout="width"):
    """(host batch, featurized graphs) of `graphs` for `[small_gps]`: ESC
    h 2, the SPD bias, LapPE (k 4), RWSE (k 4) and degree extras, one
    batch at the graphs' own width or deduplicated (`layout="dedup"`)."""
    from escgnn_tpu_torch.data.batching import BatchSpec, pad_and_batch
    from escgnn_tpu_torch.featurize import EscConfig, featurize_many
    from escgnn_tpu_torch.featurize.posenc import (
        attach_degree,
        attach_lap_pe,
        attach_rwse,
    )
    from escgnn_tpu_torch.featurize.spd import attach_attn_bias

    gs = [attach_degree(attach_rwse(attach_lap_pe(attach_attn_bias(g), k=4),
                                    k=4))
          for g in featurize_many(graphs, EscConfig(h=2))]
    spec = (BatchSpec.uniform(gs, len(gs), enc_layout="dedup")
            if layout == "dedup" else BatchSpec.from_graphs(gs, len(gs)))
    return pad_and_batch(gs, spec, device="cpu"), gs


def _ppa_graphs():
    from escgnn_tpu_torch.data.molecules import synthetic_ppa

    return synthetic_ppa(6, seed=5)


def gps_small_cases():
    """(label, GPSConfig fields, host batch, loss, model kwargs) for every
    global and local model and every encoder at width 16 x 2 layers, 2
    heads, on small batches with the SPD bias, LapPE (k 4), RWSE (k 4)
    and degree extras."""
    import numpy as np

    from escgnn_tpu_torch.data.contact import synthetic_contact
    from escgnn_tpu_torch.data.counting import (
        CountingDatasetConfig,
        generate_counting_graphs,
    )
    from escgnn_tpu_torch.data.molecules import (
        synthetic_ogb_mol,
        synthetic_zinc,
    )
    from escgnn_tpu_torch.train.loop import (
        bce_graph_loss,
        ce_graph_loss,
        l1_graph_loss,
        l1_node_loss,
    )
    from escgnn_tpu_torch.train.metrics import link_pair_loss

    prep = _gps_prep
    zinc, _ = prep(synthetic_zinc(6, seed=3))
    zinc_dedup, _ = prep(synthetic_zinc(6, seed=3), "dedup")
    ogb, _ = prep(synthetic_ogb_mol(6, seed=4, num_tasks=2))
    ppa_graphs = _ppa_graphs()
    ppa, _ = prep(ppa_graphs)
    counting = generate_counting_graphs(CountingDatasetConfig(
        num_graphs=10, seed=6))["train"][:6]
    # the counting graphs' x is all ones: with the constant edge row every
    # node starts equal and a BatchNorm normalizes a zero-variance column,
    # whose rounding the two devices take apart (3% on the card); the
    # linear encoder reads seeded features instead
    feats = np.random.default_rng(6)
    for g in counting:
        g.y = np.asarray(g.y, np.float32)[:, :1]
        g.x = feats.normal(size=g.x.shape).astype(np.float32)
    cnt, cg = prep(counting)
    ast_graphs = synthetic_zinc(6, seed=7)
    for g in ast_graphs:
        g.x = np.concatenate([g.x, np.arange(g.num_nodes)[:, None] % 25],
                             axis=1).astype(np.int32)
    ast, _ = prep(ast_graphs)
    link, _ = prep(synthetic_contact(4, seed=8))
    ppa_dim = np.asarray(ppa_graphs[0].edge_attr).shape[1]
    return [
        ("transformer_bias", dict(use_attn_bias=True), zinc, l1_graph_loss,
         {}),
        ("transformer_bias_dedup", dict(use_attn_bias=True), zinc_dedup,
         l1_graph_loss, {}),
        ("transformer_mean_pool", dict(use_attn_bias=False, pool="mean"),
         zinc, l1_graph_loss, {}),
        ("bigbird_pna", dict(global_model="bigbird", local_model="pna",
                             avg_deg_log=1.3), zinc_dedup, l1_graph_loss,
         {}),
        ("graphormer_degree", dict(global_model="graphormer",
                                   use_degree=True), zinc, l1_graph_loss, {}),
        ("gatedgcn_linear_lappe_rwse", dict(
            local_model="gatedgcn", global_model="linear", use_lap_pe=True,
            use_rwse=True), zinc, l1_graph_loss, {}),
        ("gatedgcn_san_equivstable", dict(
            local_model="gatedgcn", global_model="san",
            use_equivstable_pe=True), zinc_dedup, l1_graph_loss, {}),
        ("san2_signnet", dict(global_model="san2", use_signnet=True), zinc,
         l1_graph_loss, {}),
        ("performer", dict(global_model="performer"), zinc, l1_graph_loss,
         {}),
        ("ogb_atom_bond", dict(node_encoder_kind="ogb_atom",
                               edge_encoder_kind="ogb_bond", out_dim=2),
         ogb, bce_graph_loss, {}),
        ("ppa_uniform_linear", dict(node_encoder_kind="ppa_uniform",
                                    edge_encoder_kind="linear", out_dim=37,
                                    pool="mean"), ppa, ce_graph_loss,
         dict(edge_dim=ppa_dim)),
        ("linear_none_node_level", dict(node_encoder_kind="linear",
                                        edge_encoder_kind="none",
                                        graph_pred=False), cnt, l1_node_loss,
         dict(node_dim=np.asarray(cg[0].x).shape[1])),
        ("ast", dict(node_encoder_kind="ast"), ast, l1_graph_loss, {}),
        ("link_head", dict(node_encoder_kind="ogb_atom",
                           edge_encoder_kind="ogb_bond",
                           head="inductive_edge"), link, link_pair_loss, {}),
    ]


def check_small_gps(dev):
    """`[small_gps]`: every case of `gps_small_cases` on the card against
    the CPU, the same weights drawn from one seed: eval outputs on the
    running statistics and the train-mode loss at rtol/atol 1e-5 of their
    largest entry; eval outputs on the batch statistics and every
    gradient at rtol 1e-4, atol 1e-4 of their largest entry, as
    `[small_zoo]` holds them (the BatchNorms' batch statistics sum in
    other orders on the two devices). The ppa_uniform case's gradients
    are held to the spread the order of its graphs gives on the CPU
    (`_hold_grads_to_order_spread`): every node starts from one learned
    row, so the first layer's attention branch is constant across the
    batch in exact arithmetic, and its BatchNorm divides the branch's
    rounding residue by sqrt(1e-5).
    """
    from escgnn_tpu_torch.models.gps import GPSConfig, GPSModel
    from escgnn_tpu_torch.models.layers import bn_statistics

    def run(cfg, kw, host, loss_fn, device):
        m = GPSModel(cfg, lap_k=4, rwse_k=4, device=device,
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
                    for k, p in m.named_parameters() if p.grad is not None})
        return out

    errs, ppa = {}, {}
    for label, fields, host, loss_fn, kw in gps_small_cases():
        cfg = GPSConfig(dim_h=16, num_layers=2, num_heads=2, **fields)
        cpu = run(cfg, kw, host, loss_fn, "cpu")
        gpu = run(cfg, kw, host, loss_fn, dev)
        if set(cpu) != set(gpu):
            raise AssertionError(f"small_gps {label}: gradients differ in "
                                 f"which parameters they reach")
        grads = [k for k in cpu if k.startswith("grad")]
        gmax = max(cpu[k].abs().max().item() for k in grads)
        err = 0.0
        for k, want in cpu.items():
            scale = max(want.abs().max().item(), 1e-6)
            if k.startswith("grad"):
                if label.startswith("ppa"):
                    continue  # held below, to the order's own spread
                tol = dict(rtol=1e-4, atol=1e-4 * gmax)
            elif k == "eval_running_False":
                tol = dict(rtol=1e-4, atol=1e-4 * scale)
            else:
                tol = dict(rtol=1e-5, atol=1e-5 * scale)
            err = max(err, _check_close(f"small_gps {label} {k}", gpu[k],
                                        want, **tol))
        errs[label] = err
        if label.startswith("ppa"):
            graphs = _ppa_graphs()
            reordered = [_gps_prep([graphs[i] for i in order])[0]
                         for order in PPA_ORDERS]
            ppa = _hold_grads_to_order_spread(
                label, cfg, kw, reordered, loss_fn, run, cpu, gpu, grads,
                gmax, dev)
    _log("small_gps", cases=len(errs), max_abs_err=json.dumps(errs),
         **ppa, ok=True)


def _hold_grads_to_order_spread(label, cfg, kw, reordered, loss_fn, run,
                                cpu, gpu, grads, gmax, dev):
    """The card's gradients against the CPU's at no more than twice the
    spread the order of the batch's graphs gives on the CPU (the largest
    gap of any gradient entry between a reordered batch and the original,
    over the largest gradient; the same mathematics with its sums in
    other orders), plus 1e-5. The card's own spread over the same orders
    is reported, not used."""
    def gap(a, b):
        per = {k: (a[k] - b[k]).abs().max().item() / gmax for k in grads}
        worst = max(per, key=per.get)
        return per[worst], worst

    if not all(torch.isfinite(gpu[k]).all() for k in grads):
        raise AssertionError(f"small_gps {label}: gradients not finite")
    cpu_spread = [gap(run(cfg, kw, host, loss_fn, "cpu"), cpu)
                  for host in reordered]
    card_spread = [gap(run(cfg, kw, host, loss_fn, dev), gpu)[0]
                   for host in reordered]
    spread, spread_worst = max(cpu_spread)
    card_gap, card_worst = gap(gpu, cpu)
    limit = 2.0 * spread + 1e-5
    if card_gap > limit:
        raise AssertionError(
            f"small_gps {label}: the card's gradients part from the CPU's "
            f"by {card_gap:.3e} of the largest ({card_worst}), over 2 x "
            f"the CPU's reordered spread {spread:.3e} ({spread_worst}) + "
            f"1e-5 = {limit:.3e}")
    return dict(ppa_grad_gap_over_gmax=card_gap, ppa_worst_grad=card_worst,
                ppa_cpu_reordered_gaps=[g for g, _ in cpu_spread],
                ppa_card_reordered_gaps=card_spread,
                ppa_spread_worst_grad=spread_worst, ppa_grad_limit=limit)


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
                     res["spec"], args.lr, dev, rel_tol=(1e-3, 5e-2),
                     k1_min=0)
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
        trace.reset("k3.launches")
        with ledger.watch():
            fold, prof = _profiled(
                lambda: run_csl.run_fold(args, feats, folds, 0, spec, dev))
        eager = trace.counter("k3.launches") - ledger.nodes("zemb_rows_kernel")
        graphed = ledger.launches("zemb_rows_kernel")
        seen = _kernel_events(prof, "zemb_rows_kernel") - eager
        want = args.epochs * fold["steps"]
        model = NestedGINEff(run_csl.model_config(args), device=dev,
                             generator=torch.Generator().manual_seed(args.seed))
        check_pool_graph("run_csl", model, ce_graph_loss, train, spec,
                         args.lr, dev, kernel=("k3", "zemb_rows_kernel"),
                         rel_tol=(5e-2, 2e-1), per_step=1)
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


# ---------------------------------------------------------------------------
# compressed pools and the parallel modes
# ---------------------------------------------------------------------------

K1_SYMBOL = "segsum_kernel"
# K1's launches in each `[pool_graph]` graphed epoch, by twin
POOL_GRAPH_K1: dict = {}
MESH_EPOCHS = 1  # the ZINC twin's depth under each parallel mode
# `_hold_grads`: a reference gradient under ZERO_GRAD of the largest is
# zero to rounding (a bias that feeds a BatchNorm reads 0.0 on the card);
# its counterpart must stay under NOISE_GRAD of the largest
ZERO_GRAD = 1e-6
NOISE_GRAD = 1e-4


def _expect_k1(name: str, got: int, steps: int, at_least: int = 1) -> int:
    """K1's `got` launches over `steps` steps: one count per step, at
    least `at_least`. Returns the count per step."""
    per = got // steps
    if got != per * steps or per < at_least:
        raise AssertionError(f"{name}: K1 ran {got} times in {steps} steps, "
                             f"not one count of at least {at_least} per step")
    return per


def _step_losses(res):
    return [v for e in res["epochs"] for v in e["step_losses"]]


def _watched(fn):
    """(fn(), K1's launches in the train steps' CUDA-graph replays made
    during it; the graphed pool eval and refresh replays left out)."""
    ledger = _GraphLedger()
    with ledger.watch():
        out = fn()
    return out, ledger.launches(K1_SYMBOL, forward=False)


def _twin_train(work: str, twin: str, res):
    """A twin's train split as its run used it: read from the feature
    cache in `work` and normalized with the run's statistics."""
    import numpy as np

    from escgnn_tpu_torch import run_graphcount as rg
    from escgnn_tpu_torch.data.counting import normalize_targets
    from escgnn_tpu_torch.featurize.cache import cache_path, load_graphs

    if twin == "run_graphcount":
        args = rg.build_parser().parse_args(
            ["--num_graphs", "400", "--data_dir", os.path.join(work, "data")])
        splits, _, _ = normalize_targets(rg.build_datasets(args), args.target)
        return splits["train"]
    train = load_graphs(cache_path(os.path.join(work, "data", "zinc_synth"),
                                   "train_n1000_s0_esc_h3_rd_sl"))
    for g in train:
        g.y = ((g.y - res["mean"]) / res["std"]).astype(np.float32)
    return train


def run_compress_pools(work: str, smi: str, dev, zinc_res, count_res) -> int:
    """`[compress_pools]`: the counting twin (400 graphs, 3 graphed
    epochs) and the ZINC twin (1000 molecules, 3 graphed epochs) run
    again with `--compress_pools` beside their `[run_graphcount]` /
    `[run_zinc]` runs. The train pool, built both ways on the card
    (stacked_batch_pools, k 1), decodes to the plain pool bit for bit,
    tensor by tensor; its bytes per batch both ways are printed. Each
    twin's step losses, epoch losses and val MAE are bit-equal to its
    plain run's, and the ZINC twin run a second time without compression
    gives them bit for bit again: every sum adds in a fixed order. K1
    runs once per graphed step; the graphed ms/step is printed both ways.
    Returns K1's graphed launches in the compressed runs."""
    from escgnn_tpu_torch import run_graphcount as rg
    from escgnn_tpu_torch import run_zinc
    from escgnn_tpu_torch.data.compress import pool_nbytes
    from escgnn_tpu_torch.data.prefetch import stacked_batch_pools

    data = os.path.join(work, "data")
    runs = (
        ("run_graphcount", rg.main, count_res, 3, 3,
         ["--num_graphs", "400"]),
        ("run_zinc", run_zinc.main, zinc_res, 7, 3,
         ["--num_graphs", "1000", "--num_workers", "2"]),
    )
    total = 0
    for twin, main_fn, plain, steps, epochs, argv in runs:
        argv = argv + ["--epochs", str(epochs), "--data_dir", data]
        t0 = time.perf_counter()
        comp, k1 = _watched(lambda: main_fn(
            argv + ["--compress_pools", "--res_dir",
                    os.path.join(work, twin + "_compressed")]))
        seconds = time.perf_counter() - t0
        _check_epochs(twin + " --compress_pools", comp, steps)
        fields = {}
        again = {"compressed": comp}
        if twin == "run_zinc":
            again["plain_rerun"] = main_fn(argv + [
                "--res_dir", os.path.join(work, twin + "_rerun")])
        for name, res in again.items():
            for key in ("loss", "val_mae", "step_losses"):
                if ([e[key] for e in res["epochs"]]
                        != [e[key] for e in plain["epochs"]]):
                    raise AssertionError(f"{twin} {name}: {key} differs from "
                                         f"the plain run's")
            fields[f"{name}_bit_equal"] = True
        _expect_k1(f"{twin} --compress_pools graphed", k1, steps * epochs)
        total += k1
        train = _twin_train(work, twin, plain)
        pools = {}
        for compress in (False, True):
            built, n, decode = stacked_batch_pools(
                train, plain["spec"], k=1, compress=compress, device=dev)
            pools[compress] = (built[0], decode)
        decoded = pools[True][1](pools[True][0]).tensors()
        for k, t in pools[False][0].tensors().items():
            if decoded[k].dtype != t.dtype or not torch.equal(decoded[k], t):
                raise AssertionError(f"{twin}: decoded pool tensor {k} "
                                     f"differs from the plain pool's")
        per_batch = {c: pool_nbytes(p) / n for c, (p, _) in pools.items()}
        del pools, decoded
        ms = {name: [round(e["train_seconds"] / e["steps"] * 1e3, 4)
                     for e in res["epochs"]]
              for name, res in (("plain", plain), ("compressed", comp))}
        _log("compress_pools", twin=twin, seconds=round(seconds, 3),
             epochs=epochs, steps_per_epoch=steps,
             pool_decode_bit_equal=True, **fields,
             loss=json.dumps([e["loss"] for e in comp["epochs"]]),
             plain_loss=json.dumps([e["loss"] for e in plain["epochs"]]),
             val_mae=json.dumps([e["val_mae"] for e in comp["epochs"]]),
             pool_mb_per_batch=per_batch[False] / 2**20,
             compressed_pool_mb_per_batch=per_batch[True] / 2**20,
             shrink=per_batch[False] / per_batch[True],
             graphed_ms_per_step=json.dumps(ms["plain"]),
             compressed_graphed_ms_per_step=json.dumps(ms["compressed"]),
             k1_graphed_launches=k1, card=json.dumps(smi), ok=True)
    return total


def _hold_losses(name, got, want, first_rtol=1e-5, rtol=1e-3):
    """The first step's loss (same weights) at `first_rtol`, every later
    one at `rtol` (sums in another order, amplified by Adam); returns the
    largest relative difference."""
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} steps, want {len(want)}")
    rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
    if rel[0] > first_rtol or max(rel) > rtol:
        raise AssertionError(f"{name}: losses {got} against {want}")
    return rel


def _zinc_model(dev):
    """The ZINC twin's model at its default widths, seed 0."""
    from escgnn_tpu_torch import run_zinc
    from escgnn_tpu_torch.models.nested_gin_eff import NestedGINEff

    args = run_zinc.build_parser().parse_args([])
    return NestedGINEff(run_zinc.zinc_model_config(args), device=dev,
                        generator=torch.Generator().manual_seed(0))


def _grads(model) -> dict:
    return {k: p.grad.detach().float().cpu()
            for k, p in model.named_parameters() if p.grad is not None}


def _hold_grads(name, got: dict, want: dict, rel=1e-3) -> tuple:
    """Each parameter's gradient within `rel` of its own norm, the GPS
    tests' rule at a bound the card needs: its segment sums add with
    atomics in no fixed order, so an entry-wise bound fails on entries
    that are rounding noise. Only a gradient that is zero to rounding in
    the reference (norm under `ZERO_GRAD` of the largest: the biases
    that feed a BatchNorm) is exempt, and must stay under `NOISE_GRAD`
    of the largest. Returns the largest norm of a difference over its
    gradient's norm, the number of exempt gradients and their largest
    norm over the largest reference norm."""
    if set(got) != set(want):
        raise AssertionError(f"{name}: gradients of {sorted(got)} against "
                             f"{sorted(want)}")
    norms = {k: float(w.norm()) for k, w in want.items()}
    top = max(norms.values())
    worst = 0.0
    exempt = []
    for k, w in want.items():
        if norms[k] < ZERO_GRAD * top:
            exempt.append(float(got[k].norm()) / top)
            if exempt[-1] >= NOISE_GRAD:
                raise AssertionError(
                    f"{name} {k}: norm {float(got[k].norm())} where the "
                    f"reference's is zero to rounding ({norms[k]})")
            continue
        diff = float((got[k] - w).norm())
        worst = max(worst, diff / norms[k])
        if diff > rel * norms[k]:
            raise AssertionError(f"{name} {k}: difference {diff} over "
                                 f"{rel} of the norm {norms[k]}")
    return worst, len(exempt), max(exempt, default=0.0)


def _plain_grads(model, batch, loss_fn):
    """Loss and gradients of one plain SGD train step."""
    from escgnn_tpu_torch.train.loop import train_step

    opt = torch.optim.SGD(model.parameters(), lr=1e-2)
    loss = float(train_step(model, opt, batch, loss_fn))
    return loss, _grads(model)


def _mesh_inputs(work: str, zinc_res, halo_spec):
    """Host batches of the ZINC twin's train split for the mesh checks:
    two uniform + dedup batches of 128 (A = the first) and one width
    batch of 128 under the halo run's spec."""
    from escgnn_tpu_torch.data.batching import pad_and_batch

    train = _twin_train(work, "run_zinc", zinc_res)
    spec = zinc_res["spec"]
    return dict(
        B0=pad_and_batch(train[:128], spec, device="cpu"),
        B1=pad_and_batch(train[128:256], spec, device="cpu"),
        C=pad_and_batch(train[:128], halo_spec, device="cpu"))


def run_mesh_world1(work: str, smi: str, dev, zinc_res, count_res) -> dict:
    """`[mesh_world1]`: the ZINC twin (1000 molecules, its widths, 1
    epoch) under `--mesh dp`, `ep` and `dp_ep --mesh_dp 1` on an NCCL
    group of one rank on the card, each epoch one CUDA-graphed pool step
    with its collectives: the step losses held to the `[run_zinc]` run's
    (first step rtol 1e-5, later ones 1e-3), K1 once per graphed step
    (`_GraphLedger`). `--mesh halo` for 1 epoch (the width layout, no
    port kernel), and one halo step on a width batch of 128 held to the
    single-device step (loss rtol 1e-5, each gradient within 1e-2 of its
    norm, `_hold_grads`). `run_graphcount --multihost` with no
    coordinator against the `[run_graphcount]` run, bit for bit. Returns
    K1's graphed launches per mode and the host batches of `_mesh_inputs`
    (for `[mesh_2rank]`)."""
    from escgnn_tpu_torch import run_graphcount as rg
    from escgnn_tpu_torch import run_zinc
    from escgnn_tpu_torch.parallel import halo
    from escgnn_tpu_torch.parallel.mesh import make_mesh
    from escgnn_tpu_torch.train.loop import l1_graph_loss

    data = os.path.join(work, "data")
    argv = ["--num_graphs", "1000", "--epochs", str(MESH_EPOCHS),
            "--num_workers", "2", "--data_dir", data]
    want = _step_losses(zinc_res)[:7 * MESH_EPOCHS]
    k1 = {}
    for mode, flags in (("dp", ["--mesh", "dp"]), ("ep", ["--mesh", "ep"]),
                        ("dp_ep", ["--mesh", "dp_ep", "--mesh_dp", "1"])):
        t0 = time.perf_counter()
        res, n = _watched(lambda: run_zinc.main(
            argv + flags + ["--res_dir", os.path.join(work, "zinc_" + mode)]))
        seconds = time.perf_counter() - t0
        _check_epochs(f"run_zinc --mesh {mode}", res, steps=7)
        rel = _hold_losses(f"run_zinc --mesh {mode}", _step_losses(res), want)
        per_step = _expect_k1(f"--mesh {mode} graphed", n, 7 * MESH_EPOCHS)
        k1[f"mesh_{mode}"] = n
        _log("mesh_world1", mode=mode, backend="nccl", world=1,
             seconds=round(seconds, 3), epochs=MESH_EPOCHS,
             first_loss_rel=rel[0], max_loss_rel=max(rel),
             val_mae=json.dumps([e["val_mae"] for e in res["epochs"]]),
             graphed_ms_per_step=json.dumps(
                 [round(e["train_seconds"] / e["steps"] * 1e3, 4)
                  for e in res["epochs"]]),
             k1_graphed_launches=n, k1_per_step=per_step,
             card=json.dumps(smi), ok=True)

    t0 = time.perf_counter()
    hres, n = _watched(lambda: run_zinc.main(
        argv + ["--mesh", "halo", "--res_dir", os.path.join(work, "zinc_h")]))
    seconds = time.perf_counter() - t0
    _check_epochs("run_zinc --mesh halo", hres, steps=7)
    halo_per_step = _expect_k1("--mesh halo graphed", n, 7 * MESH_EPOCHS)
    k1["mesh_halo"] = n
    inputs = _mesh_inputs(work, zinc_res, hres["spec"])
    plain = _zinc_model(dev)
    sharded = copy.deepcopy(plain)
    loss, grads = _plain_grads(plain, inputs["C"].to(dev), l1_graph_loss)
    mesh = make_mesh(0, ("model",), device=dev)
    shard = halo.halo_shard(halo.build_halo_batch(
        inputs["C"], halo.plan_halo_sharding(inputs["C"], 1)), 0).to(dev)
    hloss = float(halo.make_halo_nested_train_step(
        sharded, torch.optim.SGD(sharded.parameters(), lr=1e-2), "model",
        graph_loss_fn=l1_graph_loss)(shard))
    _hold_losses("halo step", [hloss], [loss])
    # the sharded step adds its sums in another order than one process's
    gerr, n_zero, zero_max = _hold_grads("halo step", _grads(sharded), grads,
                                         rel=1e-2)
    _log("mesh_world1", mode="halo", backend="nccl", world=1,
         seconds=round(seconds, 3), epochs=MESH_EPOCHS,
         loss=json.dumps([e["loss"] for e in hres["epochs"]]),
         graphed_ms_per_step=json.dumps(
             [round(e["train_seconds"] / e["steps"] * 1e3, 4)
              for e in hres["epochs"]]),
         step_loss=hloss, plain_step_loss=loss, max_grad_rel_err=gerr,
         zero_grads=n_zero, zero_grads_max_norm_rel=zero_max,
         k1_graphed_launches=n, k1_per_step=halo_per_step,
         card=json.dumps(smi), ok=True)
    # slice 13: the halo module's toy GINE stack on the same batch
    inputs.update(run_halo_toy_world1(inputs["C"], mesh, dev, smi))

    t0 = time.perf_counter()
    multi = rg.main(["--num_graphs", "400", "--epochs", "3", "--data_dir",
                     data, "--multihost",
                     "--res_dir", os.path.join(work, "count_multihost")])
    seconds = time.perf_counter() - t0
    for key in ("loss", "val_mae", "step_losses"):
        got = [e[key] for e in multi["epochs"]]
        if got != [e[key] for e in count_res["epochs"]]:
            raise AssertionError(f"run_graphcount --multihost: {key} {got} "
                                 f"differs from the run without it")
    _log("mesh_world1", mode="multihost", processes=1,
         seconds=round(seconds, 3), bit_equal=True,
         loss=json.dumps([e["loss"] for e in multi["epochs"]]),
         card=json.dumps(smi), ok=True)
    return k1, inputs


def run_mesh_2rank(work: str, smi: str, dev, inputs: dict) -> dict:
    """`[mesh_2rank]`: two processes share the card over gloo with CUDA
    tensors and eager steps (gloo's collectives cannot be captured), on
    the ZINC twin's widths and batches of 128: the ep step (each rank half
    the edges of batch A = B0, its own sorted view, K1 on it) and the
    dp_ep step (2 data shards of 64 graphs) against the plain
    single-device step on A; the dp step (rank r on batch B_r) against
    the mean of the two batches' gradients in this process; the
    two-shard halo step on the width batch C against the single-device
    step; `[halo_toy]`'s `TOY_STEPS` toy stack steps on C over two halo
    shards against its single-device reference (`_hold_toy`). Loss rtol
    1e-5; each
    gradient within 1e-3 of its own norm for dp and 1e-2 for the modes
    that split a sum over the ranks (`_hold_grads`), on both ranks.
    Returns K1's launches on rank 0 per mode."""
    from escgnn_tpu_torch.train.loop import l1_graph_loss

    out_dir = os.path.join(work, "mesh_2rank")
    os.makedirs(out_dir)
    torch.save(dict(inputs, device=str(dev)), os.path.join(out_dir, "in.pt"))

    # references in this process: the plain single-device step
    refs = {}
    refs["ep"] = refs["dp_ep"] = _plain_grads(
        _zinc_model(dev), inputs["B0"].to(dev), l1_graph_loss)
    dp_losses, dp_grads = [], []
    for b in ("B0", "B1"):
        lb, gb = _plain_grads(_zinc_model(dev), inputs[b].to(dev),
                              l1_graph_loss)
        dp_losses.append(lb)
        dp_grads.append(gb)
    refs["dp"] = (sum(dp_losses) / 2,
                  {k: (dp_grads[0][k] + dp_grads[1][k]) / 2
                   for k in dp_grads[0]})
    refs["halo"] = _plain_grads(_zinc_model(dev), inputs["C"].to(dev),
                                l1_graph_loss)

    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-rank", str(r),
         out_dir], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"mesh rank {r} exited {p.returncode}:\n"
                                 f"{log[-4000:]}")
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                        weights_only=False) for r in range(2)]
    k1 = {}
    for mode in ("ep", "dp_ep", "dp", "halo"):
        want_loss, want_grads = refs[mode]
        # a sum split over ranks cancels in another order than one
        # process's: ep / dp_ep / halo gradients read up to 5.8e-4 of
        # their norm in four chip runs; dp splits no sum (5e-7)
        bound = 1e-3 if mode == "dp" else 1e-2
        errs, zeros = [], []
        for r, res in enumerate(ranks):
            got_loss, got_grads, n = res[mode]
            _hold_losses(f"2-rank {mode} rank {r}", [got_loss], [want_loss])
            err, n_zero, zero_max = _hold_grads(
                f"2-rank {mode} rank {r}", got_grads, want_grads, rel=bound)
            errs.append(err)
            zeros.append(zero_max)
        _expect_k1(f"2-rank {mode} step", ranks[0][mode][2], 1)
        k1[f"mesh_2rank_{mode}"] = ranks[0][mode][2]
        _log("mesh_2rank", mode=mode, backend="gloo", world=2,
             device="cuda:0 shared", loss=ranks[0][mode][0],
             reference_loss=want_loss, max_grad_rel_err=max(errs),
             grad_rel_bound=bound, zero_grads=n_zero,
             zero_grads_max_norm_rel=max(zeros),
             k1_launches_rank0=ranks[0][mode][2],
             card=json.dumps(smi), ok=True)
    worst = max(_hold_toy(f"2-rank halo toy rank {r}", *res["toy"],
                          inputs["toy_ref"])
                for r, res in enumerate(ranks))
    _log("halo_toy", backend="gloo", world=2, device="cuda:0 shared",
         graphed=False, steps=TOY_STEPS,
         losses=json.dumps(ranks[0]["toy"][0]),
         reference_losses=json.dumps(inputs["toy_ref"][0]),
         max_param_rel=worst, card=json.dumps(smi), ok=True)
    _log("mesh_2rank", seconds=round(seconds, 3),
         rank_seconds=json.dumps([res["seconds"] for res in ranks]),
         card=json.dumps(smi), ok=True)
    return k1


def _rank_store(rank: int, out_dir: str):
    """The 2-rank group's TCP store, on a port rank 0 binds itself and
    publishes in `<out_dir>/port` (no other process can take it between
    its choice and its bind)."""
    import torch.distributed as dist

    path = os.path.join(out_dir, "port")
    if rank == 0:
        store = dist.TCPStore("localhost", 0, 2, True,
                              wait_for_workers=False)
        with open(path + ".tmp", "w") as f:
            f.write(str(store.port))
        os.replace(path + ".tmp", path)
        return store
    deadline = time.time() + 120
    while not os.path.exists(path):
        if time.time() > deadline:
            raise TimeoutError(f"rank 0 published no port in {path}")
        time.sleep(0.05)
    with open(path) as f:
        return dist.TCPStore("localhost", int(f.read()), 2, False)


def mesh_rank_main(rank: int, out_dir: str) -> int:
    """One rank of `[mesh_2rank]` (`chip_smoke.py --mesh-rank R DIR`):
    joins the gloo group of two on localhost (`_rank_store`), runs the
    ep, dp_ep, dp and halo steps and the halo toy stack's steps on the
    device DIR/in.pt names (the card the parent runs on) and writes
    (loss, gradients, K1 launches) per mode and the toy's (losses,
    parameters) to DIR/rank<R>.pt."""
    import torch.distributed as dist

    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from escgnn_tpu_torch.parallel import data_parallel as dpm
    from escgnn_tpu_torch.parallel import edge_partition as ep
    from escgnn_tpu_torch.parallel import halo
    from escgnn_tpu_torch.parallel.mesh import make_mesh
    from escgnn_tpu_torch.train.loop import l1_graph_loss
    from escgnn_tpu_torch.weights import halo_params

    t0 = time.perf_counter()
    inputs = torch.load(os.path.join(out_dir, "in.pt"), weights_only=False)
    dev = torch.device(inputs["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=_rank_store(rank, out_dir),
                            world_size=2, rank=rank)
    res = {}

    def run(mode, make_step, batch, mesh):
        t = time.perf_counter()
        model = _zinc_model(dev)
        opt = torch.optim.SGD(model.parameters(), lr=1e-2)
        step = make_step(model, opt, mesh)
        trace.reset("k1.launches")
        loss = float(step(batch))
        res[mode] = (loss, _grads(model), trace.counter("k1.launches"))
        res[mode + "_seconds"] = round(time.perf_counter() - t, 3)

    mesh = make_mesh(0, ("model",), device=dev)
    run("ep", lambda m, o, mesh: ep.make_ep_train_step(
        m, o, l1_graph_loss),
        ep.shard_batch_by_edges(inputs["B0"], mesh, "model", device=dev),
        mesh)
    plan = halo.plan_halo_sharding(inputs["C"], 2)
    run("halo", lambda m, o, mesh: halo.make_halo_nested_train_step(
        m, o, "model", graph_loss_fn=l1_graph_loss),
        halo.halo_shard(halo.build_halo_batch(inputs["C"], plan),
                        rank).to(dev), mesh)
    toy, losses = inputs["toy"], []
    step = halo.make_halo_train_step(mesh, TOY_LAYERS, TOY_LR)
    plan_dev = halo.shard_plan(plan, mesh, "model", device=dev)
    params = halo_params(toy["params"], dev)
    for _ in range(TOY_STEPS):
        params, loss = step(params, *_toy_shard(plan, toy, rank, dev),
                            plan_dev)
        losses.append(float(loss))
    res["toy"] = (losses, {k: v.cpu() for k, v in params.items()})
    mesh = make_mesh(0, ("data", "model"), (2, 1), device=dev)
    run("dp_ep", lambda m, o, mesh: ep.make_dp_ep_train_step(
        m, o, l1_graph_loss),
        ep.shard_batch_2d(inputs["B0"], mesh, device=dev), mesh)
    mesh = make_mesh(0, ("data",), device=dev)
    run("dp", lambda m, o, mesh: dpm.make_dp_train_step(
        m, o, l1_graph_loss, mesh),
        inputs[f"B{rank}"].to(dev), mesh)
    res["seconds"] = round(time.perf_counter() - t0, 3)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


# slice 13: the flat and packed layouts, the pooling zoo, the halo toy
# stack and FLAG's input hook
FLAT_REPS = 4  # copies of a bench batch in a [flat] pool, one step each
TOY_FEATURES = 64  # the halo toy stack's width
TOY_LAYERS = 2
TOY_STEPS = 3
TOY_LR = 1e-2


def _flat_pair(label, make_model, graphs, lr, dev, smi):
    """`[flat]` for one model: its graphs batched whole under the uniform
    flat and the uniform dedup layouts; one train step of each from the
    same weights (loss at rel 1e-5; the z table's gradient within 1e-3 of
    its norm: only the order of the sums differs, through five BatchNorms
    over 12288 edges or 3712 weighted rows; the width layout's gradient
    is printed beside it as the control), then one graphed pool epoch of
    each over `FLAT_REPS` copies of the batch
    (`check_pool_graph`, its graphed and eager losses held as there; K1
    once per layer per step on the dedup epoch, twice on the flat one: its
    z reduce and its table gradient). Returns (the flat step's gradients,
    the flat batch, K1's launches in each layout's epoch)."""
    import numpy as np

    from escgnn_tpu_torch.data.batching import BatchSpec, pad_and_batch
    from escgnn_tpu_torch.train.loop import l1_graph_loss

    specs = {lay: BatchSpec.uniform(graphs, len(graphs), enc_layout=lay)
             for lay in ("flat", "dedup", "width")}
    batches = {lay: pad_and_batch(graphs, sp, device=dev)
               for lay, sp in specs.items()}
    model = make_model()
    init = copy.deepcopy(model.state_dict())
    step = {}
    for lay, b in batches.items():
        model.load_state_dict(init)
        step[lay] = _plain_grads(model, b, l1_graph_loss)
    _hold_losses(f"{label} flat step", [step["flat"][0]], [step["dedup"][0]])
    tables = [k for k in step["dedup"][1] if k.endswith("z_initial")]

    def table_rel(lay):
        return max(float((step[lay][1][k] - step["dedup"][1][k]).norm())
                   / float(step["dedup"][1][k].norm()) for k in tables)

    if not tables or table_rel("flat") > 1e-3:
        raise AssertionError(f"{label}: flat z table gradients {tables} "
                             f"{table_rel('flat')} of the dedup ones' norm "
                             f"(width: {table_rel('width')})")
    K = specs["flat"].num_enc_nnz
    entries = sum(int(np.diff(g.enc_offsets).sum()) for g in graphs)
    reports, k1 = {}, {}
    layers = model.cfg.num_layers if label == "gps" else 1
    for lay in ("flat", "dedup"):
        model.load_state_dict(init)
        reports[lay] = {}
        k1[lay] = check_pool_graph(
            f"{label}_{lay}", model, l1_graph_loss, graphs * FLAT_REPS,
            specs[lay], lr, dev, report=reports[lay],
            k1_min=layers * (2 if lay == "flat" else 1))
    r_f, r_d = reports["flat"], reports["dedup"]
    _log("flat", model=label, graphs=len(graphs), E=specs["flat"].num_edges,
         K_budget=K, K_entries=entries, R=specs["dedup"].num_enc_rows,
         first_loss_flat=step["flat"][0], first_loss_dedup=step["dedup"][0],
         first_loss_rel=abs(step["flat"][0] - step["dedup"][0])
         / abs(step["dedup"][0]), table_grad_rel=table_rel("flat"),
         width_table_grad_rel=table_rel("width"),
         width_loss_rel=abs(step["width"][0] - step["dedup"][0])
         / abs(step["dedup"][0]),
         flat_graphed_ms_per_step=r_f["graphed_ms_per_step"],
         dedup_graphed_ms_per_step=r_d["graphed_ms_per_step"],
         flat_busy_ms_per_step=r_f["graphed_busy_ms_per_step"],
         dedup_busy_ms_per_step=r_d["graphed_busy_ms_per_step"],
         flat_idle_share=r_f["graphed_idle_share"],
         dedup_idle_share=r_d["graphed_idle_share"],
         flat_over_dedup_graphed=r_f["graphed_ms_per_step"]
         / r_d["graphed_ms_per_step"],
         flat_peak_mem_gb=r_f["graphed_peak_mem_gb"],
         dedup_peak_mem_gb=r_d["graphed_peak_mem_gb"],
         k1_flat_graphed_launches=k1["flat"],
         k1_dedup_graphed_launches=k1["dedup"], card=json.dumps(smi),
         ok=True)
    return step["flat"][1], batches["flat"], k1


def run_flat(graphs, dev, smi) -> dict:
    """`[flat]`: the flagship NestedGINEff at the ZINC twin's f32 widths
    (256 x 5) on the flagship's 128 molecules, and the bench's GPS ZINC
    step (32 graphs, 64 x 4), each under the flat and the dedup layout
    (`_flat_pair`). `[flat_bf16_bwd]`: one flagship flat step with
    `set_backward_matmul_dtype(torch.bfloat16)`, its table gradient held
    to the f32 one within 1e-2 of its norm (bf16 keeps 8 bits of each
    gradient entry) and not equal to it; f32 set back. Returns K1's
    launches in the four graphed epochs."""
    from escgnn_tpu_torch import bench, run_zinc
    from escgnn_tpu_torch.ops import zemb
    from escgnn_tpu_torch.train.loop import l1_graph_loss

    args = run_zinc.build_parser().parse_args([])
    flat_grads, flat_batch, k1_flagship = _flat_pair(
        "flagship", lambda: _zinc_model(dev), graphs, args.lr, dev, smi)
    gps = bench_line(bench.GPS_ZINC)
    _, _, k1_gps = _flat_pair(
        "gps", lambda: gps.model(dev), gps.graphs, LR, dev, smi)
    k1 = {f"flat_{model}_{lay}": n
          for model, per_layout in (("flagship", k1_flagship),
                                    ("gps", k1_gps))
          for lay, n in per_layout.items()}

    zemb.set_backward_matmul_dtype(torch.bfloat16)
    try:
        _, bf16 = _plain_grads(_zinc_model(dev), flat_batch, l1_graph_loss)
    finally:
        zemb.set_backward_matmul_dtype(torch.float32)
    want, got = flat_grads["z_initial"], bf16["z_initial"]
    rel = float((got - want).norm()) / float(want.norm())
    if not 0.0 < rel <= 1e-2:
        raise AssertionError(f"bf16 table backward: {rel} of the f32 "
                             f"gradient's norm (want in (0, 1e-2])")
    if zemb._BWD_MATMUL_DTYPE != torch.float32:
        raise AssertionError("the backward dtype was not set back to f32")
    _log("flat_bf16_bwd", table_grad_rel=rel, bound=1e-2,
         restored="float32", card=json.dumps(smi), ok=True)
    return k1


def run_packed(work: str, zinc_res, dev, smi) -> int:
    """`[packed]`: the ZINC twin's training split (800 of its 1000
    molecules) under `BatchSpec.from_graphs` at its batch of 128, dedup
    and flat, batched by `packed_batch_iterator` and by `batch_iterator`:
    the packed batches are no more and hold every graph once. Then one
    graphed pool epoch over the packed dedup pool at the twin's widths
    (`check_pool_graph`, graphed against eager, K1 once per step).
    Returns K1's launches in that epoch."""
    from escgnn_tpu_torch import run_zinc
    from escgnn_tpu_torch.data.batching import (
        BatchSpec,
        batch_from_arrays,
        batch_iterator,
        packed_batch_iterator,
    )
    from escgnn_tpu_torch.data.prefetch import stack_batches
    from escgnn_tpu_torch.train.loop import l1_graph_loss

    args = run_zinc.build_parser().parse_args([])
    train = _twin_train(work, "run_zinc", zinc_res)
    counts, pool = {}, None
    for lay in ("dedup", "flat"):
        spec = BatchSpec.from_graphs(train, args.batch_size, enc_layout=lay)
        t0 = time.perf_counter()
        packed = list(packed_batch_iterator(train, spec, device=None))
        pack_s = time.perf_counter() - t0
        fixed = sum(1 for _ in batch_iterator(train, spec, device=None))
        graphs = sum(int(a["graph_mask"].sum()) for a in packed)
        edges = sum(int(a["edge_mask"].sum()) for a in packed)
        if len(packed) > fixed or graphs != len(train) or edges != sum(
                g.num_edges for g in train):
            raise AssertionError(f"packed {lay}: {len(packed)} batches of "
                                 f"{graphs} graphs / {edges} edges against "
                                 f"{fixed} fixed batches of {len(train)}")
        counts[lay] = (len(packed), fixed, round(pack_s, 3))
        if lay == "dedup":
            pool = stack_batches([batch_from_arrays(a, spec, "cpu")
                                  for a in packed]).to(dev)
    report = {}
    # the ragged GINE messages and pooling sum through K1 in a fixed order:
    # graphed and eager held at 1e-5 in every step
    k1 = check_pool_graph("packed_dedup", _zinc_model(dev), l1_graph_loss,
                          None, None, args.lr, dev, report=report, pool=pool,
                          rel_tol=(1e-5, 1e-5))
    _log("packed", graphs=len(train), batch=args.batch_size,
         dedup_packed_batches=counts["dedup"][0],
         dedup_fixed_batches=counts["dedup"][1],
         flat_packed_batches=counts["flat"][0],
         flat_fixed_batches=counts["flat"][1],
         pack_s=json.dumps({k: v[2] for k, v in counts.items()}),
         graphed_ms_per_step=report["graphed_ms_per_step"],
         busy_ms_per_step=report["graphed_busy_ms_per_step"],
         idle_share=report["graphed_idle_share"],
         losses=report["graphed_losses"], k1_graphed_launches=k1,
         card=json.dumps(smi), ok=True)
    return k1


def _pool_zoo_forward(x, batch, topk, assign, max_nodes):
    """TopKPool -> DiffPool over the kept nodes -> graclus cluster pooling
    of the gated rows; returns the scalar that sums every output."""
    from escgnn_tpu_torch.models import pooling

    h, keep = topk(x, batch, batch.node_mask)
    kept = dataclasses.replace(batch, node_mask=keep)
    dense, mask = pooling.to_dense_batch(h, kept, max_nodes)
    adj = pooling.batch_dense_adj(batch, max_nodes)
    x2, a2, link, ent = pooling.dense_diff_pool(dense, adj, assign(dense),
                                                mask)
    # x2 and a2 weighted by fixed ramps: their plain sums are constant in
    # the assignment (each node's rows of S sum to 1), so their gradients
    # would be two large terms that cancel
    ei = torch.stack([batch.senders, batch.receivers]).cpu().numpy()
    ei = ei[:, batch.edge_mask.cpu().numpy()]
    cl = torch.from_numpy(pooling.graclus_cluster(ei, batch.num_nodes,
                                                  seed=0)).to(x.device)
    C = int(cl.max()) + 1
    out = 0.0
    for how in ("avg", "max", "sum"):
        out = out + pooling.pool_by_cluster(h, cl, C, mask=keep,
                                            how=how).sum()
    return (_ramp(x2) * x2).sum() + (_ramp(a2) * a2).sum() + link + ent + out


def _ramp(t):
    """Fixed weights in [-1, 1] of `t`'s shape (no random draw)."""
    return torch.sin(torch.arange(t.numel(), dtype=t.dtype,
                                  device=t.device)).reshape(t.shape)


def run_pool_zoo(dev, smi) -> None:
    """`[pool_zoo]`: the TU pooling zoo on 64 graphs of the synthetic TU
    set (degree one-hot features): a forward and backward of TopKPool
    (ratio 0.5) -> dense_diff_pool (4 clusters from a linear assignment)
    -> pool_by_cluster on graclus clusters, on the card against the same
    modules on the CPU: the output at rel 1e-4, each gradient within 1e-4
    of its norm."""
    from escgnn_tpu_torch.data.batching import BatchSpec, pad_and_batch
    from escgnn_tpu_torch.data.tu import synthetic_tu
    from escgnn_tpu_torch.models.layers import TorchDense
    from escgnn_tpu_torch.models.pooling import TopKPool

    graphs = synthetic_tu(64, seed=0)
    spec = BatchSpec.from_graphs(graphs, 64)
    M = spec.max_nodes_per_graph
    F = graphs[0].x.shape[1]
    res = {}
    for d in ("cpu", dev):
        gen = torch.Generator().manual_seed(0)
        topk = TopKPool(F, ratio=0.5, generator=gen).to(d)
        assign = TorchDense(F, 4, generator=gen).to(d)
        b = pad_and_batch(graphs, spec, device=d)
        x = b.x.float().requires_grad_(True)
        out = _pool_zoo_forward(x, b, topk, assign, M)
        out.backward()
        res[str(d)] = (float(out.detach()), {"x": x.grad.cpu(),
                                    "topk": topk.weight.grad.cpu(),
                                    "assign": assign.weight.grad.cpu()})
    want, got = res["cpu"], res[str(dev)]
    if abs(got[0] - want[0]) > 1e-4 * abs(want[0]):
        raise AssertionError(f"pool zoo: card {got[0]} != CPU {want[0]}")
    worst = 0.0
    for k, w in want[1].items():
        rel = float((got[1][k] - w).norm()) / float(w.norm())
        worst = max(worst, rel)
        if not float(w.norm()) > 0 or rel > 1e-4:
            raise AssertionError(f"pool zoo {k}: gradient {rel} of its "
                                 f"norm {float(w.norm())}")
    _log("pool_zoo", graphs=len(graphs), N=spec.num_nodes, M=M, features=F,
         clusters=4, out_card=got[0], out_cpu=want[0],
         out_rel=abs(got[0] - want[0]) / abs(want[0]),
         max_grad_rel=worst, card=json.dumps(smi), ok=True)


def _toy_inputs(batch) -> dict:
    """The halo toy stack's numpy-seeded inputs on a width batch: x, y
    (N, F), edge payload (E, F), its node mask and {w_i, b_i}."""
    import numpy as np

    rng = np.random.default_rng(13)
    N, E, F = batch.num_nodes, batch.num_edges, TOY_FEATURES
    params = {}
    for i in range(TOY_LAYERS):
        params[f"w_{i}"] = (0.5 * rng.normal(size=(F, F)) / np.sqrt(F)
                            ).astype(np.float32)
        params[f"b_{i}"] = (0.1 * rng.normal(size=F)).astype(np.float32)
    return dict(x=rng.normal(size=(N, F)).astype(np.float32),
                y=rng.normal(size=(N, F)).astype(np.float32),
                edge_emb=rng.normal(size=(E, F)).astype(np.float32),
                node_mask=batch.node_mask.numpy(), params=params)


def _toy_reference(batch, toy, dev):
    """The toy stack's `TOY_STEPS` SGD steps on one device, written out:
    h <- relu((h + sum over real edges of relu(h[s] + e)) @ w + b), the
    masked mean square over nodes. Returns (losses, parameters)."""
    s, r = batch.senders.long().to(dev), batch.receivers.long().to(dev)
    em = batch.edge_mask.to(dev)
    x, y, e = (torch.from_numpy(toy[k]).to(dev)
               for k in ("x", "y", "edge_emb"))
    nm = torch.from_numpy(toy["node_mask"]).to(dev)
    p = {k: torch.from_numpy(v).to(dev) for k, v in toy["params"].items()}
    losses = []
    for _ in range(TOY_STEPS):
        p = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        h = x
        for i in range(TOY_LAYERS):
            msg = torch.relu(h[s] + e) * em[:, None]
            agg = torch.zeros_like(h).index_add_(0, r, msg)
            h = torch.relu((h + agg) @ p[f"w_{i}"] + p[f"b_{i}"])
        err = (h - y) * nm[:, None]
        loss = (err * err).sum() / nm.sum().clamp_min(1)
        grads = torch.autograd.grad(loss, list(p.values()))
        p = {k: (v - TOY_LR * g).detach() for (k, v), g in
             zip(p.items(), grads)}
        losses.append(float(loss))
    return losses, {k: v.cpu() for k, v in p.items()}


def _toy_shard(plan, toy, d, dev):
    """Rank d's toy inputs: its node rows and its edge payload shard."""
    from escgnn_tpu_torch.parallel import halo

    nps = plan.nodes_per_shard
    rows = slice(d * nps, (d + 1) * nps)
    return (torch.from_numpy(toy["x"][rows]).to(dev),
            torch.from_numpy(halo.scatter_edge_payload(
                plan, toy["edge_emb"])[d]).to(dev),
            torch.from_numpy(toy["y"][rows]).to(dev),
            torch.from_numpy(toy["node_mask"][rows]).to(dev))


def _hold_toy(name, losses, params, ref) -> float:
    """The toy's losses (first rtol 1e-5, later 1e-3) and each final
    parameter's change from its start within 1e-2 of the reference
    change's norm (the limits `[mesh_2rank]` holds split sums to)."""
    want_losses, want_params, start = ref
    _hold_losses(name, losses, want_losses)
    worst = 0.0
    for k, w in want_params.items():
        dw = w - start[k]
        rel = float((params[k] - w).norm()) / float(dw.norm())
        worst = max(worst, rel)
        if rel > 1e-2:
            raise AssertionError(f"{name} {k}: {rel} of the update's norm")
    return worst


def run_halo_toy_world1(batch, mesh, dev, smi) -> dict:
    """`[halo_toy]` on the NCCL group of one rank: `make_halo_train_step`
    (the toy GINE stack, `TOY_LAYERS` x `TOY_FEATURES`) on the width
    batch `batch`, captured once into a CUDA graph with its collectives
    and its parameter update, replayed `TOY_STEPS` times, held to the
    single-device reference (`_hold_toy`). Returns the inputs and the
    reference for `[mesh_2rank]`."""
    from escgnn_tpu_torch.parallel import halo
    from escgnn_tpu_torch.weights import halo_params

    toy = _toy_inputs(batch)
    ref = _toy_reference(batch, toy, dev)
    ref = (ref[0], ref[1], {k: torch.from_numpy(v)
                            for k, v in toy["params"].items()})
    plan = halo.plan_halo_sharding(batch, 1)
    plan_dev = halo.shard_plan(plan, mesh, "model", device=dev)
    args = _toy_shard(plan, toy, 0, dev)
    step = halo.make_halo_train_step(mesh, TOY_LAYERS, TOY_LR)
    params = halo_params(toy["params"], dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(params, *args, plan_dev)  # warm-up, result dropped
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        new, loss = step(params, *args, plan_dev)
        for k, v in new.items():
            params[k].copy_(v)
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TOY_STEPS):
        graph.replay()
        losses.append(loss.clone())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / TOY_STEPS
    losses = [float(v) for v in losses]
    worst = _hold_toy("halo toy world 1", losses,
                      {k: v.cpu() for k, v in params.items()}, ref)
    _log("halo_toy", backend="nccl", world=1, graphed=True,
         steps=TOY_STEPS, N=batch.num_nodes, E=batch.num_edges,
         features=TOY_FEATURES, layers=TOY_LAYERS,
         losses=json.dumps(losses), reference_losses=json.dumps(ref[0]),
         max_param_rel=worst, graphed_ms_per_step=ms,
         card=json.dumps(smi), ok=True)
    return dict(toy=toy, toy_ref=ref)


def run_ogb_flag(dev, smi) -> None:
    """`[ogb_flag]`: the bench's OgbGNN (6 x 300, virtual node, dropout 0,
    32 molhiv-shaped graphs, uniform + dedup) and FLAG's input hook: one
    Adam step with `perturb` zeros equals the step without it bit for bit
    (loss and every parameter; the step is first checked to repeat bit
    for bit from one state); one step with a N(0, 1e-2) perturb is
    finite and its perturb gradient is not zero."""
    from escgnn_tpu_torch.data.batching import BatchSpec, pad_and_batch
    from escgnn_tpu_torch.data.molecules import synthetic_ogb_mol
    from escgnn_tpu_torch.featurize import EscConfig, featurize_many
    from escgnn_tpu_torch.models.ogb_gnn import OgbGNN, OgbGNNConfig
    from escgnn_tpu_torch.train.loop import adam_with_plateau, bce_graph_loss

    graphs = featurize_many(synthetic_ogb_mol(32, seed=0, num_tasks=1),
                            EscConfig(h=4, use_rd=True, self_loop=True),
                            num_workers=2)
    spec = BatchSpec.uniform(graphs, 32, enc_layout="dedup")
    batch = pad_and_batch(graphs, spec, device=dev)
    cfg = OgbGNNConfig(num_tasks=1, num_layers=6, emb_dim=300, dropout=0.0,
                       virtual_node=True)
    model = OgbGNN(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    init = copy.deepcopy(model.state_dict())

    def step(perturb):
        model.load_state_dict(init)
        model.train()
        opt = adam_with_plateau(model.parameters(), 1e-3)
        opt.zero_grad(set_to_none=True)
        loss = bce_graph_loss(model(batch, perturb=perturb), batch)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        return loss.detach(), {k: v.detach().clone()
                               for k, v in model.state_dict().items()}

    def same(a, b):
        return torch.equal(a[0], b[0]) and all(
            torch.equal(a[1][k], b[1][k]) for k in a[1])

    none = step(None)
    if not same(step(None), none):
        raise AssertionError("ogb flag: the step does not repeat bit for "
                             "bit from one state")
    zeros = torch.zeros(batch.num_nodes, cfg.emb_dim, device=dev)
    if not same(step(zeros), none):
        raise AssertionError("ogb flag: perturb=zeros differs from no "
                             "perturb")
    gen = torch.Generator(device=dev).manual_seed(0)
    p = (1e-2 * torch.randn(batch.num_nodes, cfg.emb_dim, generator=gen,
                            device=dev)).requires_grad_(True)
    model.load_state_dict(init)
    model.train()
    loss = bce_graph_loss(model(batch, perturb=p), batch)
    loss.backward()
    g = p.grad
    if not (torch.isfinite(loss) and torch.isfinite(g).all()
            and float(g.abs().sum()) > 0):
        raise AssertionError(f"ogb flag: loss {float(loss)}, perturb "
                             f"gradient norm {float(g.norm())}")
    real = batch.node_mask[:, None]
    _log("ogb_flag", graphs=32, N=batch.num_nodes, emb_dim=cfg.emb_dim,
         layers=cfg.num_layers, zeros_equal_none=True,
         loss_none=float(none[0]), loss_perturbed=loss.item(),
         perturb_grad_norm=float(g.norm()),
         perturb_grad_on_padding=float((g * ~real).abs().sum()),
         card=json.dumps(smi), ok=True)


# ---------------------------------------------------------------------------
# the bench twin: bench.py's ten lines as graphed train steps
# ---------------------------------------------------------------------------

# K1's nodes in each bench line's captured step: the dedup expansion's
# backward (flagship, OGB, GPS per layer), every segment sum, and the
# backward of every row gather and embedding lookup (`embed_take`);
# PPGN_eff writes dense grids and looks nothing up: no K1
BENCH_K1_NODES = {"flagship": 4, "ogb": 2, "gps": 14, "gps_pep": 32,
                  "k123": 34, "ngnn": 13, "i2gnn": 14, "ginep": 6,
                  "nppgn": 1}


def _bench_short(metric: str) -> str:
    from escgnn_tpu_torch import bench

    return {bench.PPGN: "ppgn", bench.GPS_ZINC: "gps", bench.OGB: "ogb",
            bench.I2GNN: "i2gnn", bench.NGNN: "ngnn",
            bench.NESTED_PPGN: "nppgn", bench.GINE_PLUS: "ginep",
            bench.K123: "k123", bench.GPS_PEP: "gps_pep",
            bench.FLAGSHIP: "flagship"}[metric]


def run_bench(dev, smi) -> dict:
    """`[bench]`: the bench twin (`python -m escgnn_tpu_torch.bench`) at
    full size, its `main` run in this process under `_GraphLedger.watch()`
    with BENCH_SMOKE, BENCH_ONLY and BENCH_PROFILE_DIR unset. Its graph
    sets are featurized by 8 forked workers while this process holds its
    CUDA context: the workers run numpy and the native core only, as the
    earlier twins' do. Holds: ten JSON lines, the flagship last, the
    metric names in bench.py's order, each with every field of the twin's
    `perf_fields` and `metric`, `unit`, `vs_baseline` (null) and
    `device` (this card's nvidia-smi line); `value` and `ms_per_step`
    finite and positive, `flops_per_step` positive, `mfu` in (0, 1];
    slice 15: `bytes_per_step` positive, `hbm_bw_frac`, `roofline_frac`
    and `binding_resource` set, `roofline_frac` at most 1.05, and
    `flops_per_step` at least `FlopCounterMode`'s matmul count of the
    same counted step (run around `count_cost`);
    every loss finite; the first graphed step's loss equal to the eager
    step from the same state (the one the FLOP count ran) at rel 1e-5;
    one graph captured per line, replayed once per step of its windows;
    K1's nodes per captured step (`BENCH_K1_NODES`, none on the other six
    lines), its launches the nodes times the replays. Prints one
    `[bench_<line>]` line each and `[bench]`; returns K1's launches per
    line that runs it, by `bench_<line>`."""
    import io

    from escgnn_tpu_torch import bench

    from torch.utils.flop_counter import FlopCounterMode

    saved = {k: os.environ.pop(k, None)
             for k in ("BENCH_SMOKE", "BENCH_ONLY", "BENCH_PROFILE_DIR")}
    ledger = _GraphLedger()
    out = io.StringIO()
    # the matmul-only count of each line's counted step, beside its cost
    matmul_flops = []
    count_cost = bench.count_cost

    def count_with_matmuls(*args):
        with FlopCounterMode(display=False) as counter:
            res = count_cost(*args)
        matmul_flops.append(counter.get_total_flops())
        return res

    bench.count_cost = count_with_matmuls
    trace.reset("k1.launches")
    t0 = time.perf_counter()
    try:
        with ledger.watch(), contextlib.redirect_stdout(out):
            results = bench.main(["--device", "cuda"])
        torch.cuda.synchronize()
    finally:
        bench.count_cost = count_cost
        os.environ.update({k: v for k, v in saved.items() if v is not None})
    seconds = time.perf_counter() - t0
    eager_k1 = trace.counter("k1.launches")
    printed = [json.loads(ln) for ln in out.getvalue().splitlines()]
    if [p["metric"] for p in printed] != list(bench.METRICS):
        raise AssertionError(f"bench: printed {[p.get('metric') for p in printed]}"
                             f", not bench.py's ten metrics in order")
    if printed != [r.fields for r in results]:
        raise AssertionError("bench: the printed lines are not main's")
    if len(ledger.dots) != len(results):
        raise AssertionError(f"bench: {len(ledger.dots)} graphs captured "
                             f"for {len(results)} lines")
    want_keys = set(bench.perf_fields([1.0], 1, 1, None, None)) | {
        "metric", "unit", "vs_baseline", "device"}
    paths = {}
    for i, res in enumerate(results):
        f = res.fields
        short = _bench_short(f["metric"])
        keys = want_keys | ({"vs_r01"} if short == "flagship" else set())
        if set(f) != keys:
            raise AssertionError(f"bench {short}: fields {sorted(f)}")
        if f["vs_baseline"] is not None or f.get("vs_r01") is not None:
            raise AssertionError(f"bench {short}: a TPU denominator")
        if f["device"] != smi:
            raise AssertionError(f"bench {short}: device {f['device']!r}")
        if not (math.isfinite(f["value"]) and f["value"] > 0
                and math.isfinite(f["ms_per_step"]) and f["ms_per_step"] > 0
                and f["flops_per_step"] and f["flops_per_step"] > 0):
            raise AssertionError(f"bench {short}: {f}")
        if f["mfu"] is None or not 0 < f["mfu"] <= 1:
            raise AssertionError(f"bench {short}: mfu {f['mfu']}")
        if not (f["bytes_per_step"] and f["bytes_per_step"] > 0
                and f["bytes_per_step_scanbody"]
                and f["hbm_bw_frac"] is not None
                and f["roofline_frac"] is not None
                and f["binding_resource"] is not None):
            raise AssertionError(f"bench {short}: bytes fields {f}")
        # a share above 1 no card can give: the count would be wrong
        if f["roofline_frac"] > 1.05:
            raise AssertionError(f"bench {short}: roofline_frac "
                                 f"{f['roofline_frac']} > 1.05")
        if f["flops_per_step"] < matmul_flops[i]:
            raise AssertionError(f"bench {short}: {f['flops_per_step']} "
                                 f"FLOPs under the matmul-only "
                                 f"{matmul_flops[i]}")
        losses = [res.first_loss, res.eager_loss] + [
            v for w in res.window_losses for v in w]
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"bench {short}: non-finite losses")
        first = res.window_losses[0][0]
        rel = abs(first - res.eager_loss) / abs(res.eager_loss)
        if rel > 1e-5:
            raise AssertionError(f"bench {short}: first graphed loss {first}"
                                 f" != eager {res.eager_loss}")
        replays = sum(len(w) for w in res.window_losses)
        if ledger.replays[i] != replays:
            raise AssertionError(f"bench {short}: {ledger.replays[i]} "
                                 f"replays for {replays} steps")
        nodes = _dot_nodes(ledger.dots[i], "segsum_kernel")
        counted = res.cost.by_op.get("sorted_segment_sum")
        counted = counted.calls if counted else 0
        if nodes != BENCH_K1_NODES.get(short, 0) or nodes != counted:
            raise AssertionError(f"bench {short}: K1 {nodes} times in the "
                                 f"captured step ({counted} in the counted "
                                 f"eager step), not "
                                 f"{BENCH_K1_NODES.get(short, 0)}")
        k1 = nodes * ledger.replays[i]
        if nodes:
            paths[f"bench_{short}"] = k1
        _log(f"bench_{short}", **f, steps_per_window=len(res.window_losses[0]),
             replays=replays, graph_kernel_nodes=_dot_nodes(ledger.dots[i],
                                                            "{KERNEL"),
             k1_nodes=nodes, k1_launches=k1, matmul_flops=matmul_flops[i],
             top_bytes=json.dumps(sorted(
                 ((k, c.bytes) for k, c in res.cost.by_op.items()),
                 key=lambda kv: -kv[1])[:6]), first_loss=res.first_loss,
             eager_loss=res.eager_loss, first_graphed_loss=first,
             first_graphed_rel=rel, last_loss=res.window_losses[-1][-1],
             ok=True)
    _log("bench", lines=len(results), seconds=round(seconds, 3),
         k1_eager_launches=eager_k1, k1_graphed=json.dumps(paths),
         card=json.dumps(smi), ok=True)
    return paths


# ---------------------------------------------------------------------------
# slice 16: sums in a fixed order
# ---------------------------------------------------------------------------


def check_k1_sum(call, dev, label: str, probe) -> dict:
    """K1 at one sum a step makes (`determinism_probe.record_k1_calls`):
    random values of the call's shape and dtype summed over its sorted
    ids, against the f64 sum of the same values (rtol 1e-5, atol 1e-4),
    positions outside [0, R) dropped, every unnamed row exactly 0, and
    bit-equal from run to run; CUDA-graph-timed ms beside `zeros +
    index_add_` on the unsorted ids (`probe.index_add_sum`, the library
    call), the bytes bound, and the longest run and largest gap of its
    ids."""
    from escgnn_tpu_torch.ops import expand_cuda

    (E, H), dtype, perm, rows, R = call
    gen = torch.Generator(device=dev).manual_seed(16)
    dZ = torch.randn(E, H, device=dev, generator=gen).to(dtype)
    got = expand_cuda.sorted_segment_sum(dZ, perm, rows, R)
    err = _check_close(f"K1 {label}", got, _f64_sum(dZ, perm, rows, R).float(),
                       rtol=1e-5, atol=1e-4)
    if not torch.equal(got, expand_cuda.sorted_segment_sum(dZ, perm, rows,
                                                           R)):
        raise AssertionError(f"K1 {label}: not deterministic")
    unnamed = _unnamed_rows(rows, R)
    if unnamed.any() and got[unnamed].abs().max().item() != 0:
        raise AssertionError(f"K1 {label}: a row no id names is not 0")
    ms = _cuda_ms(lambda: expand_cuda.sorted_segment_sum(dZ, perm, rows, R))
    library_ms = _cuda_ms(probe.index_add_sum(dZ, perm, rows, R))
    bound_ms, bound_by = probe.k1_bound_ms(dZ, perm, rows, R)
    return dict(shape=f"E={E},R={R},H={H},{str(dtype)[6:]}",
                **probe.ids_stats(rows, R), max_abs_err=err, ms=ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)


def run_determinism(dev, smi) -> dict:
    """`[determinism]`: the steps of `tools/determinism_probe.py` (the
    ZINC twin's, packed, flat, the `run_tu` fold's and seven bench lines:
    k123, NGNN, I2GNN, GINE+, OGB, GPS ZINC and GPS peptides) at their
    shapes. Each: a warm-up, then two eager steps from one state (the
    model built anew from its seed, a fresh Adam) with bit-equal losses
    and gradients, then two graphed epochs of one pool (its batches twice
    over, the captured step replayed, weights, Adam and generators put
    back between) with bit-equal losses. Then K1 at every distinct sum
    of every step (its shape and ids: `check_k1_sum`), one `[k1_call]`
    line each, and per step K1's summed ms against `zeros + index_add_`'s
    over all its calls. Per step it prints K1's launches and one
    profiled eager step's busy ms, its K1 ms and its sort kernels' ms
    (the views' stable sorts). Returns the per-step K1 sums."""
    tools = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import determinism_probe as probe
    from escgnn_tpu_torch.train.loop import adam_with_plateau, train_step

    t0 = time.perf_counter()
    cases = probe.build_cases(dev, probe.STEPS, num_workers=2)
    build_s = time.perf_counter() - t0
    steps = {}
    for name, case in cases.items():
        eager = probe.eager_twice(case)
        if not (eager["loss_equal"] and eager["grads_equal"]):
            raise AssertionError(f"determinism {name}: two eager steps from "
                                 f"one state differ: {eager}")
        first, second = probe.graphed_twice(case)
        if first != second:
            raise AssertionError(f"determinism {name}: two graphed epochs "
                                 f"from one state gave {first} and {second}")
        model = case.make_model()
        opt = adam_with_plateau(model.parameters(), case.lr)
        train_step(model, opt, case.batches[0], case.loss_fn)
        trace.reset("k1.launches")
        _, prof = _profiled(lambda: train_step(model, opt, case.batches[0],
                                               case.loss_fn))
        ms = lambda part: sum(  # noqa: E731
            e.time_range.elapsed_us() for e in _device_events(prof, part)
        ) / 1e3
        steps[name] = dict(
            loss=eager["losses"][0], graphed=first,
            k1_per_step=trace.counter("k1.launches"), busy_ms=_busy_ms(prof),
            k1_ms=ms(K1_SYMBOL), sort_ms=ms("Sort") + ms("sort"),
            kernels=_kernel_events(prof))
    sums, slower = {}, []
    for name, case in cases.items():
        calls = probe.distinct_k1_calls(probe.record_k1_calls(case))
        k1_sum = lib_sum = 0.0
        for call, count in calls:
            got = check_k1_sum(call, dev, name, probe)
            k1_sum += count * got["ms"]
            lib_sum += count * got["library_ms"]
            ratio = got["ms"] / got["library_ms"]
            if ratio > 1.1:
                slower.append(f"{name}:{got['shape']}")
            _log("k1_call", step=name, count=count, ratio=round(ratio, 4),
                 **got)
        sums[name] = dict(calls=sum(c for _, c in calls),
                          distinct=len(calls), k1_ms=k1_sum,
                          index_add_ms=lib_sum)
    _log("determinism", steps=len(steps), build_s=round(build_s, 3),
         seconds=round(time.perf_counter() - t0, 3),
         per_step=json.dumps(steps), k1_sums=json.dumps(sums),
         k1_over_index_add_by_10pct=",".join(slower) or "none",
         card=json.dumps(smi), ok=True)
    return sums


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
    from escgnn_tpu_torch.bench import flagship_config
    from escgnn_tpu_torch.data.batching import BatchSpec, pad_and_batch
    from escgnn_tpu_torch.data.molecules import synthetic_zinc
    from escgnn_tpu_torch.featurize import EscConfig, featurize_many
    from escgnn_tpu_torch.models.nested_gin_eff import NestedGINEff
    from escgnn_tpu_torch.ops import zemb
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
    trace.reset("k1.launches", "k2.launches")
    losses, step_ms, k1_steps = [], [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        k1_before = trace.counter("k1.launches")
        losses.append(train_step(model, opt, batch, l1_graph_loss))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        k1_steps.append(trace.counter("k1.launches") - k1_before)
    err_sum, count = eval_step(model, batch, node_level=False)
    with torch.no_grad():
        out = model.eval()(batch)
    torch.cuda.synchronize()
    if tuple(out.shape) != (NUM_GRAPHS, 1) or not torch.isfinite(out).all():
        raise AssertionError(f"eval output {tuple(out.shape)} is not a "
                             f"finite ({NUM_GRAPHS}, 1) tensor")
    main_launches = {k: trace.counter(k + ".launches") for k in ("k1", "k2")}
    losses = [float(v) for v in losses]
    mae = float(err_sum) / float(count)
    if not all(math.isfinite(v) for v in losses) or not math.isfinite(mae):
        raise AssertionError(f"non-finite loss or MAE: {losses} {mae}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    # K1 per step: the z expansion's backward and the three embedding
    # lookups' (node and edge types, the active z-table rows)
    if k1_steps != [BENCH_K1_NODES["flagship"]] * TRAIN_STEPS:
        raise AssertionError(f"K1 launched {k1_steps} times in "
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
        trace.reset("k1.launches", "k2.launches")
        t0 = time.perf_counter()
        loss_k2 = float(train_step(m_k2, adam_with_plateau(m_k2.parameters(), LR),
                                   batch_k2, l1_graph_loss))
        torch.cuda.synchronize()
        k2_step_ms = (time.perf_counter() - t0) * 1e3
        k2_launches = {k: trace.counter(k + ".launches") for k in ("k1", "k2")}
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
    # slice 15: the kernels' cost charges, kernel against plain version
    check_cost(batch, ppgn_batch, ppgn_spec.max_nodes_per_graph, dev,
               {k: v["ms"] for k, v in zip(("k1", "k2", "k3", "k4"),
                                           (k1, k2, k3, k4))})
    check_small_ppgn(dev)
    ppgn_launches = run_ppgn(ppgn_batch, ppgn_spec, ppgn_edges, dev)

    # 9. the driver twins, in a temporary directory outside the checkout
    with tempfile.TemporaryDirectory() as work:
        zinc_res = run_zinc_twin(work, smi)
        k1_zinc = check_zinc_pool_graph(work, zinc_res, dev)
        k1_count, count_res = run_graphcount_twin(work, smi)
        # slice 12: the compressed pools, then the parallel modes on one
        # NCCL rank and on two gloo ranks sharing the card
        k1_mesh = {"compress_pools": run_compress_pools(
            work, smi, dev, zinc_res, count_res)}
        k1_world1, mesh_inputs = run_mesh_world1(work, smi, dev, zinc_res,
                                                 count_res)
        k1_mesh.update(k1_world1)
        k1_mesh.update(run_mesh_2rank(work, smi, dev, mesh_inputs))
        torch.distributed.destroy_process_group()
        k1_paths = {"train": main_launches["k1"],
                    "run_zinc": k1_zinc,
                    "run_graphcount": k1_count, **k1_mesh,
                    # slice 13: packed batches of the ZINC twin's split
                    "packed": run_packed(work, zinc_res, dev, smi),
                    "run_zinc_cycle": run_zinc_cycle_twin(work, smi),
                    "run_qm9": run_qm9_twin(work, smi),
                    "run_ogb_mol": run_ogb_mol_twin(work, smi, dev)}
        # the copy family: this slice's main path, I2GNN, then NGNN, the
        # bucketed layout and NestedPPGN (K1 in the copy family's sums)
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
    # registry (K1 in their sums)
    with tempfile.TemporaryDirectory() as work:
        run_qm9_kgnn_twins(work, smi, dev)
        run_ogb_gineplus_twin(work, smi, dev)
        run_zinc_gnn_twins(work, smi, dev)
    check_zoo_registry(dev)
    check_small_zoo(dev)
    # 12. GPS: the run_gps twin, the bench-shaped steps (K1 once per layer
    # per step), the other configs and every attention and encoder
    with tempfile.TemporaryDirectory() as work:
        run_gps_twin(work, smi, dev)
        k1_paths["gps_bench"], k1_gps = run_gps_bench("zinc", dev, reps=10)
        k1_paths["gps_pep"], k1_pep = run_gps_bench("pep", dev, reps=4)
        run_gps_pep_twin(work, smi, dev)
        run_gps_variants(work, smi)
    check_small_gps(dev)
    # 13. the run_tu twin: k-fold CV and the three cycle trainers (no port
    # kernel on these paths)
    with tempfile.TemporaryDirectory() as work:
        run_tu_twin(work, smi, dev)
        run_tu_cycles(work, smi)
    # 14. slice 13: the flat layout against dedup (flagship and GPS), its
    # bf16 table backward, the pooling zoo and FLAG's input hook
    k1_paths.update(run_flat(graphs, dev, smi))
    run_pool_zoo(dev, smi)
    run_ogb_flag(dev, smi)
    # 15. the bench twin: bench.py's ten lines at full size, graphed
    k1_paths.update(run_bench(dev, smi))
    # 16. slice 16: two runs of each step from one state, bit for bit, and
    # K1 at every sum it takes there
    k1_sums = run_determinism(dev, smi)

    kernels = [
        dict(name="sorted_segment_sum", route="cuda",
             source="escgnn_tpu_torch/csrc/expand_segsum.cu",
             replaces="escgnn_tpu/ops/expand_pallas.py:53",
             launches=main_launches["k1"],
             paths=dict(k1_paths, pool_graph=POOL_GRAPH_K1),
             shapes={"gps_bench": k1_gps, "gps_pep": k1_pep},
             per_step_sums=k1_sums,
             **k1),
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
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank_main(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
