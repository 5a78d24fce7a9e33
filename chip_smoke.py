#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`escgnn_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from `escgnn_tpu_torch/csrc/`, holds each one
against its plain PyTorch version on the card, then drives the flagship
ESC-GNN train step (128 synthetic ZINC molecules, uniform + dedup batch,
NestedGINEff hidden 256 x 5 layers with bf16 conv stacks, L1 loss, Adam
5e-4) for 10 steps and one eval step, and one step with the count-matrix
kernel path. Every phase prints one line; any failed check raises, so the
script exits non-zero and prints no result. The last two lines are the
kernel table and the result, both JSON.

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


def check_k1(batch, dev):
    """K1 against its plain version at the flagship shapes (f32 and bf16
    gradients) and on a ragged case with gaps and trailing empty rows."""
    from escgnn_tpu_torch.ops import expand_cuda

    gen = torch.Generator(device=dev).manual_seed(1)
    perm, rows_sorted = batch.enc_edge_perm, batch.enc_row_sorted
    E, R, H = perm.shape[0], batch.enc_idx.shape[0], 256
    dZ = torch.randn(E, H, device=dev, generator=gen)
    # f32 sums of up to a few hundred terms, taken in another order by the
    # plain version's index_add_
    tol = dict(rtol=1e-5, atol=1e-4)
    got = expand_cuda.sorted_segment_sum(dZ, perm, rows_sorted, R)
    want = expand_cuda.sorted_segment_sum_plain(dZ, perm, rows_sorted, R)
    torch.cuda.synchronize()
    err = _check_close("K1 f32", got, want, **tol)
    again = expand_cuda.sorted_segment_sum(dZ, perm, rows_sorted, R)
    if not torch.equal(got, again):
        raise AssertionError("K1 is not deterministic from run to run")
    dZ16 = dZ.to(torch.bfloat16)
    err16 = _check_close(
        "K1 bf16", expand_cuda.sorted_segment_sum(dZ16, perm, rows_sorted, R),
        expand_cuda.sorted_segment_sum_plain(dZ16, perm, rows_sorted, R), **tol)

    # ragged: 1000 edges on ids 0..249 with gaps, 300 rows, H not a
    # multiple of 32
    ids = torch.randint(0, 125, (1000,), device=dev, generator=gen) * 2
    rs = torch.sort(ids).values.to(torch.int32)
    pm = torch.randperm(1000, device=dev, generator=gen).to(torch.int32)
    dz = torch.randn(1000, 96, device=dev, generator=gen)
    got_r = expand_cuda.sorted_segment_sum(dz, pm, rs, 300)
    _check_close("K1 ragged", got_r,
                 expand_cuda.sorted_segment_sum_plain(dz, pm, rs, 300), **tol)
    if got_r[250:].abs().max().item() != 0 or got_r[1:250:2].abs().max().item() != 0:
        raise AssertionError("K1: empty rows are not 0")

    ms = _cuda_ms(lambda: expand_cuda.sorted_segment_sum(dZ, perm, rows_sorted, R))
    plain_ms = _cuda_ms(
        lambda: expand_cuda.sorted_segment_sum_plain(dZ, perm, rows_sorted, R))
    edge_row = batch.enc_edge_row.long()
    # yardstick: the one PyTorch call computing the same dU from the
    # batch's unsorted edge -> row map (never called by the port)
    library_ms = _cuda_ms(
        lambda: torch.zeros(R, H, device=dev).index_add_(0, edge_row, dZ))
    nbytes = E * H * 4 + 2 * E * 4 + R * H * 4
    bound_ms, bound_by = _bound(nbytes, E * H)
    _log("k1", shapes=f"E={E},R={R},H={H}", max_abs_err_f32=err,
         max_abs_err_bf16=err16, ms=ms, plain_ms=plain_ms,
         library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
         ok=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)


def check_k2(batch, dev):
    """K2 against its plain version at the flagship unique-row shapes."""
    from escgnn_tpu_torch.ops import zemb_cuda

    gen = torch.Generator(device=dev).manual_seed(2)
    idx = batch.enc_idx.to(torch.int32).contiguous()
    cnt = batch.enc_cnt.to(torch.float32).contiguous()
    R, P = idx.shape
    Zc, H = batch.enc_bucket_ids.shape[0], 256
    table = torch.randn(Zc, H, device=dev, generator=gen)
    z, C = zemb_cuda.zemb_countmat(table, idx, cnt)
    z_ref, C_ref = zemb_cuda.zemb_countmat_plain(table, idx, cnt)
    torch.cuda.synchronize()
    if not torch.equal(C, C_ref):
        raise AssertionError("K2: count matrix differs from the plain build")
    # f32 products summed over up to 128 buckets in another order
    err = _check_close("K2 z", z, z_ref, rtol=1e-5, atol=1e-4)
    try:
        zemb_cuda.zemb_countmat(torch.zeros(1000, H, device=dev), idx, cnt)
    except ValueError:
        pass
    else:
        raise AssertionError("K2 accepted a count tile above shared memory")

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

    kernels = [
        dict(name="sorted_segment_sum", route="cuda",
             source="escgnn_tpu_torch/csrc/expand_segsum.cu",
             replaces="escgnn_tpu/ops/expand_pallas.py:53",
             launches=main_launches["k1"], **k1),
        dict(name="zemb_countmat", route="cuda",
             source="escgnn_tpu_torch/csrc/zemb_countmat.cu",
             replaces="escgnn_tpu/ops/zemb_pallas.py:114",
             launches=k2_launches["k2"], **k2),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
