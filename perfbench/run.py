"""Run one cell of `BENCHMARK.json` once and print its result line:

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for. The last line of standard output is one JSON object (`correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` `breakdown`,
and last `checks`: each number compared with its limit); the last lines of
standard error repeat the checks. A run without the cards, or with a
module of JAX or of the JAX package loaded, prints no result and exits
with a code other than 0."""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
# every build and kernel cache at a fixed path inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_ROOT, "build", "perfbench",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_ROOT, "build", "perfbench",
                                              "triton")
os.environ["USE_FLAX"] = "0"
os.environ.setdefault("OMP_NUM_THREADS", "4")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python3 -m perfbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if _ROOT not in sys.path:
        sys.path.insert(0, _ROOT)
    import torch

    from perfbench import cell

    res = cell.resolve(args.workload)
    need = int(res["cell"]["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        print(f"{args.workload} needs {need} CUDA device(s); {have} "
              "available", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    out = cell.run(res, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), T_START, cell.workers())
    bad = cell.forbidden_modules()
    if bad:
        print(f"loaded in the measured process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(f"correct {out['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
