#!/usr/bin/env python3
"""Time the sorted segment sum K1 under other shares and row layouts, and
phase by phase, on one GPU.

    python3 tools/segsum_sweep.py

K1 runs with dZ in the flagship step's layout (the first 256 columns of
an (E, 288) f32 tensor, E 12288, R 3712) under every share in SHARES: the
merge-path items (row ends and sorted positions) one block takes, and so
the grid. The shares are handed to the C launcher here; the wrapper
always takes the one `ops/expand_cuda.py::segsum_plan` derives, which is
marked. Four row layouts of the same E:

  * flagship: the batch's own sorted view (a run of 2667 padding edges,
    runs of 3.4 edges on average);
  * short: row k // 3 for sorted position k, so no run is cut and no
    block takes a ticket: the kernel without its cut-run path;
  * gap: the flagship's ids with every id at or above 1000 moved up by
    R, into 2R rows: a gap of R unnamed rows that the grid zeroes;
  * one_run: every edge on row 0, so every block takes a ticket and one
    block adds all the slots.

Each is timed warm (the same inputs again and again: they stay in the
50 MB L2) and cold (a 64 MB buffer written before each call, its own
time taken off), since in the train step dZ comes from earlier kernels.
Every result is checked against the f64 sum.

Then the phases, at the flagship layout and the plan's share: copies of
`csrc/expand_segsum.cu` that return early, each before one section of the
kernel (found by its comment; a missing one fails the run), built into
build/escgnn_tpu_torch/phases/ and never used by the package:

  * launch: the kernel returns at once;
  * search: after two warps have found the block's ends on the merge path;
  * indices: after the block's rows_sorted and perm are in shared memory;
  * walk: after the unnamed rows are zeroed and the groups have summed
    their runs (finished rows written, cut pieces in slots);
  * chains: after the runs cut between groups are added up;
  * full: the kernel as it is, tickets and the cut runs' merges included
    (its result equal to the wrapper's bit for bit).

Every time is the mean device time of one call, CUDA-graph timed as in
chip_smoke.py. Prints the card's name and power limit, then one JSON line
per measurement.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARES = (16, 32, 64, 122, 160, 240, 320, 480)
# phase -> the source line the early return goes before
PHASES = {
    "launch": "  const int b = blockIdx.x;\n",
    "search": "  // past the last row end: only positions outside [0, R) are left",
    "indices": "  // the ends moved to run starts",
    "walk": "  // a run that began in an earlier group ends in this one",
    "chains": "  // tickets for the runs cut by the block's start and end",
}
# the stores keep the loads before the return from being dropped as dead
RETURNS = {
    "launch": "  if (a.E == -7) a.out[0] = 1.f;\n  return;\n",
    "search": ("  if (a.E == -7 && s_split[0] == -7) a.out[0] = 1.f;\n"
               "  return;\n"),
    "other": ("  if (a.E == -7 && s_row[0] == -7) a.out[0] = 1.f;\n"
              "  return;\n"),
}


def build_phases(_build):
    """The early-return copies of the kernel, one nvcc each, all at once:
    {phase: its f32 launcher}."""
    src = open(os.path.join(_build.CSRC, "expand_segsum.cu")).read()
    out_dir = os.path.join(_build.BUILD_DIR, "phases")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name in [*PHASES, "full"]:
        text = src
        if name in PHASES:
            anchor = PHASES[name]
            if text.count(anchor) != 1:
                raise RuntimeError(f"segsum_sweep: no single {anchor!r} in "
                                   f"the source")
            text = text.replace(
                anchor, RETURNS.get(name, RETURNS["other"]) + anchor)
        cu = os.path.join(out_dir, f"expand_segsum_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o",
             os.path.join(out_dir, f"libk1_{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    restype, argtypes = _build.SIGNATURES["expand_segsum"]["expand_segsum_f32"]
    fns = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} copy:\n{log}")
        fn = ctypes.CDLL(os.path.join(out_dir, f"libk1_{name}.so")
                         ).expand_segsum_f32
        fn.restype, fn.argtypes = restype, argtypes
        fns[name] = fn
    return fns


def main() -> int:
    if not torch.cuda.is_available():
        print("segsum_sweep: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from chip_smoke import NUM_GRAPHS, _cuda_ms
    from escgnn_tpu_torch import _build
    from escgnn_tpu_torch.data.batching import BatchSpec, pad_and_batch
    from escgnn_tpu_torch.data.molecules import synthetic_zinc
    from escgnn_tpu_torch.featurize import EscConfig, featurize_many
    from escgnn_tpu_torch.ops import expand_cuda, smem_plan

    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0], flush=True)
    graphs = featurize_many(synthetic_zinc(NUM_GRAPHS, seed=0),
                            EscConfig(h=3, use_rd=True, self_loop=True))
    batch = pad_and_batch(graphs, BatchSpec.uniform(graphs, NUM_GRAPHS,
                                                    enc_layout="dedup"),
                          device=dev)
    perm = batch.enc_edge_perm
    E, R, H = perm.shape[0], batch.enc_idx.shape[0], 256
    sms = smem_plan.sm_count(dev)
    lib = _build.load("expand_segsum")
    gen = torch.Generator(device=dev).manual_seed(0)
    wide = torch.randn(E, H + 32, device=dev, generator=gen)
    flush = torch.empty(16 * 2**20, device=dev)
    flush_ms = _cuda_ms(flush.zero_, iters=10)
    k = torch.arange(E, device=dev, dtype=torch.int32)
    flagship = batch.enc_row_sorted
    layouts = {
        "flagship": (flagship, R),
        "short": (k // 3, -(-E // 3)),
        "gap": (torch.where(flagship >= 1000, flagship + R, flagship), 2 * R),
        "one_run": (torch.zeros_like(k), R),
    }

    for dtype, names in ((torch.float32, tuple(layouts)),
                         (torch.bfloat16, ("flagship",))):
        dZ = wide.to(dtype)[:, :H]
        fn = (lib.expand_segsum_f32 if dtype == torch.float32
              else lib.expand_segsum_bf16)
        for layout in names:
            rows, rows_out = layouts[layout]
            chosen = expand_cuda.segsum_plan(E, H, rows_out, sms).share
            counters = expand_cuda._counters(dev, rows_out)
            for share in SHARES:
                grid = -(-(rows_out + E) // share)
                partial = torch.empty(2 * grid * H, device=dev)
                out = torch.empty(rows_out, H, device=dev)

                def call():
                    # the stream is the capturing one inside _cuda_ms
                    rc = fn(dZ.data_ptr(), dZ.stride(0), perm.data_ptr(),
                            rows.data_ptr(), E, H, rows_out, share,
                            out.data_ptr(), partial.data_ptr(),
                            counters.data_ptr(),
                            torch.cuda.current_stream(dev).cuda_stream)
                    _build.check(rc, "expand_segsum")

                def cold():
                    flush.zero_()
                    call()

                call()
                torch.cuda.synchronize()
                want = torch.zeros(rows_out, H, dtype=torch.float64,
                                   device=dev)
                want.index_add_(0, rows.long(),
                                dZ.double().index_select(0, perm.long()))
                # f32 sums of up to 12288 terms against the f64 sum: their
                # rounding grows with the terms a block adds in a row
                torch.testing.assert_close(out, want.float(), rtol=1e-5,
                                           atol=1e-3)
                print(json.dumps({
                    "dtype": str(dtype).replace("torch.", ""),
                    "layout": layout, "rows": rows_out, "share": share,
                    "grid": grid, "plan": share == chosen,
                    "ms": _cuda_ms(call),
                    "cold_ms": _cuda_ms(cold, iters=10) - flush_ms}),
                    flush=True)

    # the phases: the flagship layout under the plan's share, twice over
    dZ = wide[:, :H]
    rows = batch.enc_row_sorted
    plan = expand_cuda.segsum_plan(E, H, R, sms)
    counters = expand_cuda._counters(dev, R)
    out = torch.empty(R, H, device=dev)
    partial = torch.empty(plan.partial_floats, device=dev)
    fns = build_phases(_build)
    for rep in range(2):
        for name, fn in fns.items():
            def call():
                rc = fn(dZ.data_ptr(), dZ.stride(0), perm.data_ptr(),
                        rows.data_ptr(), E, H, R, plan.share, out.data_ptr(),
                        partial.data_ptr(), counters.data_ptr(),
                        torch.cuda.current_stream(dev).cuda_stream)
                _build.check(rc, "expand_segsum")

            call()
            torch.cuda.synchronize()
            if name == "full" and not torch.equal(
                    out, expand_cuda.sorted_segment_sum(dZ, perm, rows, R)):
                raise AssertionError("segsum_sweep: the full copy differs "
                                     "from the wrapper's kernel")
            print(json.dumps({"phase": name, "rep": rep, "share": plan.share,
                              "grid": plan.grid, "ms": _cuda_ms(call)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
