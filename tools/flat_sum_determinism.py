#!/usr/bin/env python3
"""Run-to-run determinism and time of the flat layout's two sums, then
chip_smoke.py's `[flat]` phase a few times, on one GPU.

    python3 tools/flat_sum_determinism.py [--repeats 20] [--flat_runs 3]

The flat z reduce sums its K COO entries twice: the weighted table rows
into their edges (forward) and the weighted edge gradients into their
table buckets (dTable). At the flagship batch's flat shape (128
molecules, K 345,216 entries, E 12,288 edges, Z 1500 buckets, H 256 f32)
each sum runs three ways:

  * index_add: `index_add_`, which adds with atomics in no fixed order;
  * index_put: `index_put_(accumulate=True)`, which sorts its indices and
    adds each index's terms in order;
  * sort_k1: what `ops/zemb.py` runs (`_sum_by`): a stable device sort of
    the ids, then the sorted segment sum K1.

For each: the largest difference of `--repeats` calls from the first,
how many of them differ at all, the difference of one CUDA-graph replay
from the first eager call, and the mean time of one call (CUDA events
over 50 eager calls after 5 warm ones). Then `[flat]` (the flagship and
the bench GPS ZINC step, flat against dedup, each a graphed epoch held to
eager) `--flat_runs` times; a failed check is printed, not raised, so
every run is seen. Prints the card's name and power limit, one JSON line
per sum and method, chip_smoke.py's own `[flat]` and `[pool_graph]`
lines, and one JSON line per `[flat]` run.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--flat_runs", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("flat_sum_determinism: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from escgnn_tpu_torch import _build
    from escgnn_tpu_torch.data.batching import BatchSpec, pad_and_batch
    from escgnn_tpu_torch.data.molecules import synthetic_zinc
    from escgnn_tpu_torch.featurize import EscConfig, featurize_many
    from escgnn_tpu_torch.ops import zemb

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    graphs = featurize_many(synthetic_zinc(chip_smoke.NUM_GRAPHS, seed=0),
                            EscConfig(h=3, use_rd=True, self_loop=True))
    spec = BatchSpec.uniform(graphs, len(graphs), enc_layout="flat")
    batch = pad_and_batch(graphs, spec, device=dev)
    idx = batch.enc_flat_idx.long()
    cnt = batch.enc_flat_cnt.float()
    edge = batch.enc_flat_edge.long()
    E, H = batch.num_edges, 256
    Z = int(idx.max()) + 1
    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn(Z, H, device=dev, generator=gen)
    dZ = torch.randn(E, H, device=dev, generator=gen)

    def add(values, ids, n):
        return values.new_zeros(n, H).index_add_(0, ids, values)

    def put(values, ids, n):
        return values.new_zeros(n, H).index_put_((ids,), values,
                                                 accumulate=True)

    sums = {
        "forward": (lambda: table.index_select(0, idx) * cnt[:, None],
                    edge, E),
        "dtable": (lambda: cnt[:, None] * dZ.index_select(0, edge), idx, Z),
    }
    for sum_name, (values, ids, n) in sums.items():
        for method, fn in (("index_add", add), ("index_put", put),
                           ("sort_k1", zemb._sum_by)):
            def call():
                return fn(values(), ids, n)

            first = call()
            diffs = [float((call() - first).abs().max())
                     for _ in range(args.repeats)]
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                call()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                replayed = call()
            graph.replay()
            torch.cuda.synchronize()
            for _ in range(5):
                call()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(50):
                call()
            end.record()
            torch.cuda.synchronize()
            print(json.dumps(dict(
                sum=sum_name, method=method, K=int(ids.numel()), rows=n, H=H,
                repeats=args.repeats, max_diff=max(diffs),
                differing=sum(d > 0 for d in diffs),
                graph_vs_eager=float((replayed - first).abs().max()),
                norm=float(first.norm()), ms=start.elapsed_time(end) / 50,
                card=smi)), flush=True)

    for run in range(args.flat_runs):
        t0 = time.perf_counter()
        error = None
        try:
            launches = chip_smoke.run_flat(graphs, dev, smi)
        except AssertionError as e:
            launches, error = None, str(e)
        print(json.dumps(dict(flat_run=run, k1_launches=launches,
                              error=error,
                              seconds=time.perf_counter() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
