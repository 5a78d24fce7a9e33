#!/usr/bin/env python3
"""Time K1 under two builds of its source at every sum the steps make.

    python3 tools/k1_ab.py --other DIR [--steps k123,gps_zinc,...]
        [--out FILE]

DIR is the root of another checkout (the parent commit unpacked by
`git archive` into a directory that .gitignore lists): its
`escgnn_tpu_torch/csrc/expand_segsum.cu` is built with the same nvcc
flags into DIR/build/k1_other/ and called through its own C launcher
beside the checkout's kernel (`ops/expand_cuda.py`). A source that
declares `kMaxSpan` is the layout before the merge path: one span of
ceil(E / SMs) sorted positions per block (at most kMaxSpan), and no
dropped positions, so its ids are those of the views before masked rows
sorted last: each id outside [0, R) is sent to row 0 and the ids sorted
again, stably (the same sum, the masked values being 0 in the steps).

The sums: every distinct K1 call (shape, dtype and ids) of one eager
step of each `tools/determinism_probe.py` step, recorded on the
checkout's views, and the flagship step's (E, 288) gradient slice
(`chip_smoke.py`'s `[k1]` layout). Each is held to its f64 sum under
both builds (rtol 1e-5, atol 1e-4), then CUDA-graph timed as
`chip_smoke.py` times kernels, in turns: other, this, this, other,
beside `zeros + index_add_` on the same values. Prints the card's name
and power limit, one JSON line per call (both times, the library's, the
bytes bound, the longest run and largest gap of its ids) and one per
step (each time summed over all its calls). Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (ROOT, os.path.join(ROOT, "tools")):
    if path not in sys.path:
        sys.path.insert(0, path)


def build_other(other: str):
    """(the other source's f32 and bf16 launchers, its kMaxSpan or None)."""
    from escgnn_tpu_torch import _build

    src = os.path.join(other, "escgnn_tpu_torch", "csrc", "expand_segsum.cu")
    out_dir = os.path.join(other, "build", "k1_other")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libk1_other.so")
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
                          capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{done.stdout}"
                           f"{done.stderr}")
    so = ctypes.CDLL(lib)
    fns = {}
    for dtype, name in ((torch.float32, "expand_segsum_f32"),
                        (torch.bfloat16, "expand_segsum_bf16")):
        fn = getattr(so, name)
        fn.restype, fn.argtypes = _build.SIGNATURES["expand_segsum"][name]
        fns[dtype] = fn
    span = re.search(r"constexpr int kMaxSpan = (\d+);", open(src).read())
    return fns, int(span.group(1)) if span else None


def other_call(fns, max_span, dZ, perm, rows, R):
    """A call of the other build on the same sum, as its layout takes it."""
    from escgnn_tpu_torch import _build
    from escgnn_tpu_torch.ops import expand_cuda, smem_plan

    E, H = dZ.shape
    sms = smem_plan.sm_count(dZ.device)
    hp = -(-H // 4) * 4
    if max_span is not None:
        outside = (rows < 0) | (rows >= R)
        rows, order = torch.sort(torch.where(outside, 0, rows), stable=True)
        rows, perm = rows.to(torch.int32), perm[order].contiguous()
        step = min(max(1, -(-E // sms)), max_span)
        grid = max(1, -(-E // step))
    else:
        plan = expand_cuda.segsum_plan(E, H, R, sms)
        step, grid = plan.share, plan.grid
    partial = torch.empty(2 * grid * hp, device=dZ.device)
    counters = expand_cuda._counters(dZ.device, R)
    fn = fns[dZ.dtype]

    def call():
        out = torch.empty(R, H, device=dZ.device)
        rc = fn(dZ.data_ptr(), dZ.stride(0), perm.data_ptr(), rows.data_ptr(),
                E, H, R, step, out.data_ptr(), partial.data_ptr(),
                counters.data_ptr(),
                torch.cuda.current_stream(dZ.device).cuda_stream)
        _build.check(rc, "expand_segsum (other)")
        return out

    return call


def flagship_call(dev):
    """The flagship step's K1 call: the first 256 columns of an (E, 288)
    gradient over the batch's sorted view."""
    from chip_smoke import NUM_GRAPHS
    from escgnn_tpu_torch.data.batching import BatchSpec, pad_and_batch
    from escgnn_tpu_torch.data.molecules import synthetic_zinc
    from escgnn_tpu_torch.featurize import EscConfig, featurize_many

    graphs = featurize_many(synthetic_zinc(NUM_GRAPHS, seed=0),
                            EscConfig(h=3, use_rd=True, self_loop=True))
    batch = pad_and_batch(graphs, BatchSpec.uniform(graphs, NUM_GRAPHS,
                                                    enc_layout="dedup"),
                          device=dev)
    wide = torch.randn(batch.num_edges, 288, device=dev)
    return (wide[:, :256], batch.enc_edge_perm, batch.enc_row_sorted,
            batch.enc_idx.shape[0])


def time_sum(fns, max_span, dZ, perm, rows, R) -> dict:
    """One sum under both builds: held to f64, then timed in turns. The
    values of positions outside [0, R) are zeroed first, as the steps'
    masked values are, so the other build's row 0 gets nothing from
    them."""
    import determinism_probe as probe
    from chip_smoke import _cuda_ms, _f64_sum
    from escgnn_tpu_torch.ops import expand_cuda

    dropped = perm[(rows < 0) | (rows >= R)].long()
    if dropped.numel():
        dZ = dZ.clone()
        dZ[dropped] = 0
    other = other_call(fns, max_span, dZ, perm, rows, R)
    this = lambda: expand_cuda.sorted_segment_sum(  # noqa: E731
        dZ, perm, rows, R)
    want = _f64_sum(dZ, perm, rows, R).float()
    for name, fn in (("other", other), ("this", this)):
        torch.testing.assert_close(fn(), want, rtol=1e-5, atol=1e-4,
                                   msg=lambda m: f"K1 {name}: {m}")
    times = {"other": [], "this": []}
    for name in ("other", "this", "this", "other"):
        times[name].append(_cuda_ms(other if name == "other" else this))
    return dict(**probe.ids_stats(rows, R),
                other_ms=sum(times["other"]) / 2,
                this_ms=sum(times["this"]) / 2,
                index_add_ms=_cuda_ms(probe.index_add_sum(dZ, perm, rows, R)),
                bound_ms=probe.k1_bound_ms(dZ, perm, rows, R)[0])


def main(argv=None) -> int:
    import determinism_probe as probe

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--other", required=True,
                   help="root of the other checkout")
    p.add_argument("--steps", default=",".join(probe.STEPS))
    p.add_argument("--out", default=None, help="also write the lines here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_ab: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lines = [subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]]
    print(lines[0], flush=True)
    fns, max_span = build_other(args.other)

    def emit(rec):
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)

    emit(dict(step="flagship", call="ld288", count=1,
              **time_sum(fns, max_span, *flagship_call(dev))))
    names = [n for n in args.steps.split(",") if n]
    for name, case in probe.build_cases(dev, names, num_workers=2).items():
        totals = dict(other_ms=0.0, this_ms=0.0, index_add_ms=0.0)
        calls = probe.distinct_k1_calls(probe.record_k1_calls(case))
        gen = torch.Generator(device=dev).manual_seed(17)
        for (shape, dtype, perm, rows, R), count in calls:
            dZ = torch.randn(*shape, device=dev, generator=gen).to(dtype)
            rec = time_sum(fns, max_span, dZ, perm, rows, R)
            for k in totals:
                totals[k] += count * rec[k]
            emit(dict(step=name, shape=[*shape, str(dtype)[6:]], rows=R,
                      count=count, **rec))
        emit(dict(step=name, calls=sum(c for _, c in calls),
                  distinct=len(calls), **totals))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
