"""The readings that the limits of `perfbench/limits/` are set from, made
on the chip at a cell's own size (no measured window: the compared numbers
come from set-up's first three steps and, in an epoch cell, the refresh
and evals after them):

    python3 -m perfbench.calibrate --workload <name> --seeds 1,2,3 \
        [--controls 1,2,3] [--out FILE]

For each seed of `--seeds`, one JSON line with the system's gaps to the
reference (`sound`) and the leaves of the first gradient with the largest
gaps (`sound_grad_leaves`: name, gap, reference norm over the median
leaf's); for each seed of `--controls` also the gaps of the
control (the reference in TF32) and of two faults planted in the
reference put in the system's place: half of each batch left out of the
loss (`drop_half`) and one output row altered where it is produced
(`alter_answer`). A step that leaves the state unchanged reads 1 on
`change_gap` by the measure itself and needs no run. All seeds run in one
process, one after another."""

import argparse
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m perfbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--controls", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if _ROOT not in sys.path:
        sys.path.insert(0, _ROOT)
    import torch

    from perfbench import cell, checks, refcheck

    res = cell.resolve(args.workload)
    if not torch.cuda.is_available():
        print("calibration runs on the card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    controls = {int(s) for s in args.controls.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",") if s]
    out = open(args.out, "a") if args.out else None
    for seed in seeds + sorted(controls - set(seeds)):
        t0 = time.time()
        run = cell.Run(res, seed, 0.0, False, dev, t0, cell.workers())
        run.setup()
        t_setup = time.time() - t0
        sys_read = run.sys_read
        groups = run.groups()
        run.free_system()
        batches = run.reference_batches(groups)
        m = res["config"]["model"]
        opt = res["config"]["optimizer"]

        def ref(**kw):
            return refcheck.readings(m["reference"], m["fields"], run.w0,
                                     batches, opt, **kw)

        t1 = time.time()
        r32 = ref()
        t_ref = time.time() - t1
        line = dict(workload=args.workload, seed=seed,
                    setup_s=t_setup, reference_s=t_ref,
                    losses=sys_read["losses"])
        line["ref_losses"] = r32["losses"]
        if seed in seeds:
            line["sound"] = checks.gaps(sys_read, r32)
            line["sound_worst_leaves"] = checks.worst_leaves(sys_read, r32)
            line["sound_grad_leaves"] = checks.leaf_table(sys_read, r32)
        if seed in controls:
            tf32 = ref(tf32=True)
            line["control_tf32"] = checks.gaps(tf32, r32)
            line["control_grad_leaves"] = checks.leaf_table(tf32, r32)
            for fault in ("drop_half", "alter_answer"):
                line[fault] = checks.gaps(ref(fault=fault), r32)
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
        del run, batches
        torch.cuda.empty_cache()
    if out:
        out.close()
    bad = cell.forbidden_modules()
    if bad:
        print(f"loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
