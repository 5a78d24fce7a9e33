#!/usr/bin/env python3
"""Time the z-reduce kernels K2 and K3 under other launch plans, on one GPU.

    python3 tools/zemb_smem_sweep.py

K2 runs on the flagship batch's unique rows (Zc 128, H 256) and K3 on
the PPGN_eff width batch (Z 1800, H 128), at every slice width up to what
H needs (256 and 128 columns), with the table slice in shared memory
where it fits and with its rows read through L1. The plans are built
here and handed to the C launchers; the wrappers always take the one
`ops/smem_plan.py` derives.

K3 runs with the whole table and with the table cut to its first 128
rows (ids taken modulo 128): if the time falls with the cut table, the
bytes the table reads pull from L2 set it. K3 also runs on the first
half and quarter of the rows, to show how its time scales with the work.

Every time is the mean device time of one call, CUDA-graph timed as in
chip_smoke.py. Prints the card's name and power limit, then one JSON
line per measurement.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _plans(smem_plan, Z, H, sms):
    """Every slice width up to what H needs, resident where it fits and
    read through L1."""
    plans = {}
    for w in smem_plan.SLICE_COLS:
        if w > max(H, 128):
            continue
        slices = -(-H // w)
        fits = smem_plan.FIXED_BYTES + Z * w * 4 <= smem_plan.MAX_SMEM_BYTES
        for res in (True, False) if fits else (False,):
            plans[f"{'smem' if res else 'l1'}_w{w}"] = smem_plan.SmemPlan(
                slice_cols=w, slices=slices,
                blocks_per_slice=max(1, sms // slices),
                table_bytes=Z * w * 4 if res else 0)
    return plans


def main() -> int:
    if not torch.cuda.is_available():
        print("zemb_smem_sweep: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from chip_smoke import NUM_GRAPHS, _cuda_ms, counting_batch
    from escgnn_tpu_torch import _build
    from escgnn_tpu_torch.data.batching import BatchSpec, pad_and_batch
    from escgnn_tpu_torch.data.molecules import synthetic_zinc
    from escgnn_tpu_torch.featurize import EscConfig, featurize_many
    from escgnn_tpu_torch.ops import smem_plan, zemb_cuda, zemb_gather

    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0], flush=True)
    sms = smem_plan.sm_count(dev)

    def stream():  # the stream at call time: the timer captures on its own
        return torch.cuda.current_stream(dev).cuda_stream

    k2 = _build.load("zemb_countmat").zemb_countmat_f32
    k3 = _build.load("zemb_gather").zemb_gather_f32

    def emit(**fields):
        print(json.dumps(fields), flush=True)

    # K2 on the flagship unique rows
    graphs = featurize_many(synthetic_zinc(NUM_GRAPHS, seed=0),
                            EscConfig(h=3, use_rd=True, self_loop=True))
    spec = BatchSpec.uniform(graphs, NUM_GRAPHS, enc_layout="dedup")
    batch = pad_and_batch(graphs, spec, device=dev)
    idx = batch.enc_idx.to(torch.int32).contiguous()
    cnt = batch.enc_cnt.to(torch.float32).contiguous()
    R, P = idx.shape
    Zc, H = batch.enc_bucket_ids.shape[0], 256
    table = torch.randn(Zc, H, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(2))
    z_ref, C_ref = zemb_cuda.zemb_countmat(table, idx, cnt)
    z_plain = zemb_cuda.zemb_countmat_plain(table, idx, cnt)[0]
    z, C = torch.empty_like(z_ref), torch.empty_like(C_ref)
    for pname, plan in _plans(smem_plan, Zc, H, sms).items():

        def run_k2(plan=plan):
            _build.check(k2(table.data_ptr(), idx.data_ptr(), cnt.data_ptr(),
                            R, P, Zc, H, plan.slice_cols,
                            plan.blocks_per_slice, plan.table_bytes,
                            z.data_ptr(), C.data_ptr(), stream()),
                         "zemb_countmat")

        run_k2()
        torch.cuda.synchronize()
        emit(kernel="k2", shapes=f"R={R},P={P},Zc={Zc},H={H}", path=pname,
             slice_cols=plan.slice_cols, grid=plan.grid,
             smem_bytes=plan.smem_bytes, ms=_cuda_ms(run_k2),
             z_equal_default=torch.equal(z, z_ref),
             C_equal_default=torch.equal(C, C_ref),
             max_abs_err_plain=(z - z_plain).abs().max().item())

    # K3 on the PPGN_eff width batch, with the whole table and cut
    batch, _, _ = counting_batch(dev)
    idx = batch.enc_idx.to(torch.int32).contiguous()
    cnt = batch.enc_cnt.to(torch.float32).contiguous()
    E, P = idx.shape
    Z, H = 1800, 128
    full = torch.randn(Z, H, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(3))
    cases = {"full": (full, idx),
             "cut128": (full[:128].contiguous(), (idx % 128).contiguous())}
    out = torch.empty(E, H, device=dev)
    for tname, (t, ids) in cases.items():
        ref = zemb_gather.zemb_gather(t, ids, cnt)
        plain = zemb_gather.zemb_gather_plain(t, ids, cnt)
        for pname, plan in _plans(smem_plan, t.shape[0], H, sms).items():

            def run_k3(plan=plan, t=t, ids=ids):
                _build.check(k3(t.data_ptr(), ids.data_ptr(), cnt.data_ptr(),
                                E, P, t.shape[0], H, plan.slice_cols,
                                plan.blocks_per_slice, plan.table_bytes,
                                out.data_ptr(), stream()), "zemb_gather")

            run_k3()
            torch.cuda.synchronize()
            emit(kernel="k3", table=tname, path=pname,
                 shapes=f"E={E},P={P},Z={t.shape[0]},H={H}",
                 slice_cols=plan.slice_cols, grid=plan.grid,
                 smem_bytes=plan.smem_bytes, ms=_cuda_ms(run_k3),
                 equal_default=torch.equal(out, ref),
                 max_abs_err_plain=(out - plain).abs().max().item())
    # the same walk over the first half and the first quarter of the rows:
    # how the time scales with the work
    for frac in (2, 4):
        n = E // frac
        ids_f, cnt_f = idx[:n].contiguous(), cnt[:n].contiguous()
        emit(kernel="k3", table="full", rows=n, ms=_cuda_ms(
            lambda: zemb_gather.zemb_gather(full, ids_f, cnt_f)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
