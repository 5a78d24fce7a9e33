#!/usr/bin/env python3
"""Where the time of the PyTorch port's train steps goes, on one GPU.

    python3 tools/torch_step_profile.py [--model flagship] [--steps 5] [--impl countmat]
    python3 tools/torch_step_profile.py --model ppgn --impl pallas --pool pallas
    python3 tools/torch_step_profile.py --model i2gnn [--layout bucketed]
    python3 tools/torch_step_profile.py --model k123    # or gineplus
    python3 tools/torch_step_profile.py --model gps [--spd_embed sort]
    python3 tools/torch_step_profile.py --model gps_pep

Builds the batch and model of the flagship (NestedGINEff) or of the
PPGN_eff counting path exactly as chip_smoke.py does, or the first train
batch of the `run_zinc --model I2GNN|NGNN` main path at the JAX defaults
(1000 synthetic molecules, batch 128, h 3, 256 x 5, uniform or bucketed
copy blocks), or the first train batch of `run_qm9 --model k123_GNN`
(1000 synthetic molecules, h 3, batch 64) or of `run_ogb_mol --model
GINEPlus` (640 synthetic molecules, 300 x 6, k 3, dropout 0.65, batch
32, uniform blocks), at the twins' defaults, or the bench's GPS steps
(`--model gps`: 32 ZINC-shaped molecules, 64 x 4; `--model gps_pep`: 16
peptide-shaped graphs, 96 x 10; uniform + dedup, the SPD bias), takes
3 warm-up steps, then profiles `--steps` train steps with torch.profiler
(CPU and CUDA activities). Prints one JSON line: host ms per step (wall
clock around synchronized steps), device busy ms per step (the union of
the kernels' intervals on the GPU timeline), the device's idle share,
kernel launches per step, the device time of the port's own CUDA
kernels, the kernels with the most device time and, for the flagship, the
copies of an (E, hidden) f32 tensor to another: K1 reads its strided
gradient in place, so the step should make none (ops are recorded with
their shapes to find them), and the longest idle gaps on the device
timeline with the kernels on either side. The GPS models also report
the device time of the SPD bias's backward (`spd_bias_backward_ms`: the
one-hot product, or with `--spd_embed sort` `F.embedding`'s sorting
backward) and of K1 (`segsum_kernel`, once per layer).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _union_ms(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total / 1e3  # profiler times are in microseconds


def _label_spd_backward(gps, kind: str) -> str:
    """Wrap the SPD bias's backward in a profiler label (the one-hot
    product, or with `kind="sort"` the lookup switched to `F.embedding`,
    whose backward sorts the ids); returns the label."""
    import torch.nn.functional as F

    label = "spd_bias_backward"
    if kind == "sort":
        class _Sorted(torch.autograd.Function):
            @staticmethod
            def forward(ctx, table, ids):
                with torch.enable_grad():
                    t = table.detach().requires_grad_()
                    out = F.embedding(ids, t)
                ctx.saved = (t, out)
                return out.detach()

            @staticmethod
            def backward(ctx, dy):
                t, out = ctx.saved
                with torch.profiler.record_function(label):
                    return torch.autograd.grad(out, t, dy)[0], None

        gps._OneHotEmbed = _Sorted
        return label
    inner = gps._OneHotEmbed.backward

    def backward(ctx, dy):
        with torch.profiler.record_function(label):
            return inner(ctx, dy)

    gps._OneHotEmbed.backward = staticmethod(backward)
    return label


def _labelled_device_ms(prof, label: str) -> float:
    """Device ms of the kernels launched inside the host ranges `label`."""
    total = 0.0
    for e in prof.events():
        if e.name == label and e.device_type == torch.autograd.DeviceType.CPU:
            total += (e.device_time_total if hasattr(e, "device_time_total")
                      else e.cuda_time_total)
    return total / 1e3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--model", default="flagship",
                    choices=["flagship", "ppgn", "i2gnn", "ngnn", "k123",
                             "gineplus", "gps", "gps_pep"])
    ap.add_argument("--spd_embed", default="onehot",
                    choices=["onehot", "sort"],
                    help="GPS: the SPD bias lookup's backward, the one-hot "
                    "product or F.embedding's (gps and gps_pep only)")
    ap.add_argument("--layout", default="uniform",
                    choices=["uniform", "bucketed"],
                    help="copy layout (i2gnn and ngnn only)")
    ap.add_argument("--impl", default="countmat",
                    choices=["countmat", "countmat_pallas", "gather",
                             "pallas"])
    ap.add_argument("--pool", default="xla", choices=["xla", "pallas"],
                    help="PPGN node pooling (ppgn only)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_step_profile: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import dataclasses

    from chip_smoke import NUM_GRAPHS, counting_batch, ppgn_config
    from escgnn_tpu_torch.bench import flagship_config
    from escgnn_tpu_torch.data.batching import BatchSpec, pad_and_batch
    from escgnn_tpu_torch.data.molecules import synthetic_zinc
    from escgnn_tpu_torch.featurize import EscConfig, featurize_many
    from escgnn_tpu_torch.models.nested_gin_eff import NestedGINEff
    from escgnn_tpu_torch.models.ppgn import PPGN
    from escgnn_tpu_torch.ops import zemb
    from escgnn_tpu_torch.train.loop import (
        adam_with_plateau,
        l1_graph_loss,
        l1_node_loss,
        train_step,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    gen = torch.Generator().manual_seed(0)
    if args.model in ("i2gnn", "ngnn"):
        from escgnn_tpu_torch import run_zinc
        from escgnn_tpu_torch.data.uniform_copies import make_bucket_transform
        from escgnn_tpu_torch.train.copies import (
            copy_layout_spec,
            featurize_copies,
        )

        name = "I2GNN" if args.model == "i2gnn" else "NGNN"
        feats = featurize_copies(synthetic_zinc(1000, seed=0), name, 3)
        uni, spec, _ = copy_layout_spec({"all": feats}, 128, "uniform")
        host = pad_and_batch(uni["all"][:128], spec, device="cpu")
        if args.layout == "bucketed":
            host = make_bucket_transform(feats, 128)[0](host)
        batch = host.to(dev)
        zargs = run_zinc.build_parser().parse_args(["--model", name])
        model = run_zinc.build_model(zargs, dev)
        loss_fn = l1_graph_loss
    elif args.model == "k123":
        from escgnn_tpu_torch import run_qm9

        qargs = run_qm9.build_parser().parse_args(
            ["--model", "k123_GNN", "--num_graphs", "1000"])
        splits = run_qm9.build_splits(qargs)[0]
        spec = BatchSpec.from_graphs([g for s in splits.values() for g in s],
                                     qargs.batch_size)
        batch = pad_and_batch(splits["train"][:qargs.batch_size], spec,
                              device=dev)
        g0 = splits["train"][0]
        model = run_qm9.build_model(qargs, g0.x.shape[1],
                                    g0.edge_attr.shape[1], dev,
                                    has_pos=g0.pos is not None)
        loss_fn = run_qm9.mse_loss
    elif args.model == "gineplus":
        from escgnn_tpu_torch import run_ogb_mol
        from escgnn_tpu_torch.data.molecules import synthetic_ogb_mol
        from escgnn_tpu_torch.featurize.multihop import make_multihop_edges
        from escgnn_tpu_torch.train.loop import bce_graph_loss

        oargs = run_ogb_mol.build_parser().parse_args(["--model", "GINEPlus"])
        graphs = [make_multihop_edges(g, oargs.multihop_k)
                  for g in synthetic_ogb_mol(640, seed=0, label_kind="tri")]
        spec = BatchSpec.uniform(graphs, oargs.batch_size)
        batch = pad_and_batch(graphs[:oargs.batch_size], spec, device=dev)
        model = run_ogb_mol.build_model(oargs, dev)
        loss_fn = bce_graph_loss
    elif args.model in ("gps", "gps_pep"):
        from chip_smoke import bench_line
        from escgnn_tpu_torch import bench
        from escgnn_tpu_torch.models import gps

        line = bench_line(bench.GPS_ZINC if args.model == "gps"
                          else bench.GPS_PEP)
        batch = line.host_batch().to(dev)
        model = line.model(dev, generator=gen)
        loss_fn = line.loss_fn
        spd_backward = _label_spd_backward(gps, args.spd_embed)
    elif args.model == "ppgn":
        batch, spec, _ = counting_batch(dev)
        model = PPGN(ppgn_config(spec.max_nodes_per_graph, args.pool),
                     device=dev, generator=gen)
        loss_fn = l1_node_loss
    else:
        graphs = featurize_many(synthetic_zinc(NUM_GRAPHS, seed=0),
                                EscConfig(h=3))
        spec = BatchSpec.uniform(graphs, NUM_GRAPHS, enc_layout="dedup")
        batch = pad_and_batch(graphs, spec, device=dev)
        if args.impl != "countmat":
            batch = dataclasses.replace(batch, enc_countmat=None)
        model = NestedGINEff(flagship_config(), device=dev, generator=gen)
        loss_fn = l1_graph_loss
    if args.model not in ("gps", "gps_pep"):
        spd_backward = None
    zemb.set_impl(args.impl)
    opt = adam_with_plateau(model.parameters(), 5e-4)
    for _ in range(3):
        train_step(model, opt, batch, loss_fn)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            train_step(model, opt, batch, loss_fn)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    zemb.set_impl("countmat")

    # device-side events, without the user annotations the profiler
    # mirrors onto the GPU timeline (e.g. "Optimizer.step#Adam.step")
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and "#" not in e.name]
    busy = _union_ms((e.time_range.start, e.time_range.end) for e in kernels)
    timeline = sorted(kernels, key=lambda e: e.time_range.start)
    gaps, end, before = [], None, None
    for e in timeline:
        if end is not None and e.time_range.start > end:
            gaps.append(((e.time_range.start - end) / 1e3, before, e.name))
        if end is None or e.time_range.end > end:
            end, before = e.time_range.end, e.name
    gaps.sort(key=lambda g: -g[0])
    by_name: dict = {}
    for e in kernels:
        by_name.setdefault(e.name, [0.0, 0])
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
        by_name[e.name][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    busy_ms = busy / args.steps
    # the device time of aten::copy_ calls from one (E, hidden) f32 tensor
    # to another, such as a contiguous copy of K1's strided input
    copies = None
    if args.model == "flagship":
        shape = [batch.num_edges, flagship_config().hidden]
        hits = [e for e in prof.events()
                if e.name == "aten::copy_" and e.input_shapes
                and list(e.input_shapes[:2]) == [shape, shape]
                and (getattr(e, "input_dtypes", None)
                     or ["float"] * 2)[:2] == ["float", "float"]]
        copies = {"shape": shape,
                  "calls_per_step": len(hits) / args.steps,
                  "ms_per_step": sum(k.duration for e in hits
                                     for k in e.kernels) / 1e3 / args.steps}
    print(json.dumps({
        "card": smi, "model": args.model, "impl": args.impl,
        "layout": args.layout if args.model in ("i2gnn", "ngnn") else None,
        "pool": args.pool if args.model == "ppgn" else None,
        "steps": args.steps,
        "host_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "kernel_launches_per_step": len(kernels) / args.steps,
        "port_kernels_ms_per_step": {
            n[:60]: v[0] / args.steps for n, v in by_name.items()
            if any(k in n for k in ("segsum_kernel", "zemb_rows_kernel",
                                    "pool_kernel"))},
        "f32_copies_e_by_hidden": copies,
        "spd_embed": args.spd_embed if spd_backward else None,
        "spd_bias_backward_ms_per_step": (
            _labelled_device_ms(prof, spd_backward) / args.steps
            if spd_backward else None),
        "idle_gaps_ms_per_step": sum(g[0] for g in gaps) / args.steps,
        "longest_gaps": [{"ms": g, "after": a[:70], "before": b[:70]}
                         for g, a, b in gaps[:8]],
        "top_kernels_ms_per_step": [
            {"name": n[:90], "ms": v[0] / args.steps,
             "calls": v[1] / args.steps} for n, v in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
