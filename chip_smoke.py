#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`escgnn_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from `escgnn_tpu_torch/csrc/`, holds each one
against its plain PyTorch version on the card, then drives two main
paths:

  * the flagship ESC-GNN train step (128 synthetic ZINC molecules,
    uniform + dedup batch, NestedGINEff hidden 256 x 5 layers with bf16
    conv stacks, L1 loss, Adam 5e-4) for 10 steps and one eval step, and
    one step with the count-matrix kernel path;
  * the PPGN_eff counting train step (128 counting graphs, width batch,
    PPGN emb 128 x 3 regular blocks with bf16 block stacks, node-level L1
    loss, Adam 5e-4) for 10 steps and one eval step through the row-gather
    z kernel and the pooling kernel, and one step with the default impls.

Every phase prints one line; any failed check raises, so the script exits
non-zero and prints no result. The last two lines are the kernel table
and the result, both JSON.

Needs a CUDA card and nvcc; exits 1 without a card. Imports no JAX.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
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


def _device_kernels(fn) -> int:
    """The kernels one call of `fn` launches, counted from the profiler's
    device events (a warm call first, so that nothing is built or
    allocated for the first time inside the profile)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and "#" not in e.name)


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
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

    kernels = [
        dict(name="sorted_segment_sum", route="cuda",
             source="escgnn_tpu_torch/csrc/expand_segsum.cu",
             replaces="escgnn_tpu/ops/expand_pallas.py:53",
             launches=main_launches["k1"], **k1),
        dict(name="zemb_countmat", route="cuda",
             source="escgnn_tpu_torch/csrc/zemb_countmat.cu",
             replaces="escgnn_tpu/ops/zemb_pallas.py:114",
             launches=k2_launches["k2"], **k2),
        dict(name="zemb_gather", route="cuda",
             source="escgnn_tpu_torch/csrc/zemb_gather.cu",
             replaces="escgnn_tpu/ops/zemb_pallas.py:62",
             launches=ppgn_launches["k3"], **k3),
        dict(name="diag_row_col_pool", route="cuda",
             source="escgnn_tpu_torch/csrc/ppgn_pool.cu",
             replaces="escgnn_tpu/ops/ppgn_pool.py:57",
             launches=ppgn_launches["k4"], **k4),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
