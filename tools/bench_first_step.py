#!/usr/bin/env python3
"""Is each bench line's train step deterministic on the card?

    python3 tools/bench_first_step.py [--eager 4] [--graphed 3]
        [--f32 METRIC ...]

For each line of the bench twin (`escgnn_tpu_torch/bench.py`, full size):
one eager train step (the twin's first), then from that one state
`--eager` eager steps, each on a deep copy of the model and its Adam, and
`--graphed` replays of the graphed pool step, the model and Adam put back
between replays. Prints the card's name and power limit, then one JSON
line per line: the losses, the eager steps' spread and the replays' and
their own largest distance from the first eager loss (relative). A step
whose forward adds in a fixed order reads 0 for all three; `chip_smoke.py`
`[bench]` holds the first replay to the eager step at 1e-5. `--f32`
repeats the named lines with `compute_dtype="float32"`. Needs a card.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def first_steps(line, dev, n_eager: int, n_graphed: int) -> dict:
    from escgnn_tpu_torch import bench
    from escgnn_tpu_torch.data.prefetch import stack_batches
    from escgnn_tpu_torch.train import loop

    batch = line.host_batch().to(dev)
    pool = stack_batches([batch])
    model = line.model(dev)
    opt = loop.adam_with_plateau(model.parameters(), bench.LR,
                                 capturable=True)
    loop.train_step(model, opt, batch, line.loss_fn)
    eager = []
    for _ in range(n_eager):
        m, o = copy.deepcopy((model, opt))
        eager.append(float(loop.train_step(m, o, batch, line.loss_fn)))
    snapshot = loop._snapshot(model, opt)
    step = loop.make_pool_train_step(model, opt, line.loss_fn, pool)
    graphed = []
    for _ in range(n_graphed):
        graphed.append(float(step(pool, [0])[0]))
        loop._restore_in_place(model, opt, snapshot)

    def rel(vs, ref):
        return max(abs(v - ref) / abs(ref) for v in vs)

    return dict(eager=eager, graphed=graphed,
                eager_spread=rel(eager, eager[0]),
                graphed_vs_eager=rel(graphed, eager[0]),
                graphed_spread=rel(graphed, graphed[0]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--eager", type=int, default=4)
    p.add_argument("--graphed", type=int, default=3)
    p.add_argument("--f32", nargs="*", default=[],
                   help="metric names to repeat in float32")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_first_step: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from escgnn_tpu_torch import bench

    gsets = bench.make_graph_sets()  # forks its featurizers before CUDA
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    lines = bench.bench_lines(gsets)
    lines += [dataclasses.replace(
        ln, metric=ln.metric + "+f32",
        config=dataclasses.replace(ln.config, compute_dtype="float32"))
        for ln in lines if ln.metric in args.f32]
    for line in lines:
        out = first_steps(line, dev, args.eager, args.graphed)
        print(json.dumps(dict(line=line.metric, **out)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
