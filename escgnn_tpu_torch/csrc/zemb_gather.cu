// Weighted row gather for the z-embedding reduce on the width layout.
//
// Replaces escgnn_tpu/ops/zemb_pallas.py::zemb_pallas (kernel `_kernel`).
//
//   out[e, :] = sum_p cnt[e, p] * table[idx[e, p], :]        (E, H) f32
//
// The TPU kernel kept the whole (Z, H) table in VMEM and, because Mosaic
// had no row gather, built a (block, Z) bf16 coefficient tile with P
// compare passes, then ran one MXU product over all Z buckets.
//
// Bound on an H100 SXM at the PPGN_eff counting shapes (E 21504, P 56,
// Z 1800, H 128): the function must move idx and cnt (2 x 4.8 MB), the
// 64 table rows the batch touches (32 KB) and out (11.0 MB), 20.7 MB,
// ~6.2 us at 3.35 TB/s; its
// 2*nnz*H = 0.11 GFLOP over the nonzero entries are ~1.6 us at
// 67 TFLOP/s f32, so the bytes bound it.
//
// The first Hopper design gave each edge row a warp that read the table
// row of every nonzero entry, one dependent read at a time, and took
// 0.0306 ms. Its reads were not bound by L2: the batch touches 64 of the
// 1800 table rows, which stay in L1, and its time did not move with the
// table cut to 128 rows. What set it was the work per entry (a ballot
// walk with two shuffles and four 4-byte loads) and each warp waiting on
// its row's (id, count) loads before it could start.
//
// This design (zemb_rows.cuh) keeps a warp per row and the ascending-p
// f32 sum, so its result is the first design's, bit for bit. A warp takes
// its rows from a block counter and loads the next row's pairs while it
// walks the current one, packs each 32-entry chunk's marked pairs into
// shared memory so a step reads its pair with one broadcast, and reads a
// table row as one float4 per lane. A table whose 128-column slice fits
// in shared memory (Z <= 437) is held there; a taller one, as here, is
// read through L1. Two ways to hold it in shared memory here were tried
// and were slower than L1: 32-column resident slices, which walk every
// entry once per slice, and a shared-memory cache of the rows met, whose
// bookkeeping cost more than its reads saved.

#include "zemb_rows.cuh"

extern "C" {

// The plan (slice width W, blocks per slice, bytes of the table slice in
// shared memory, 0 to read the rows through L1) comes from
// ops/smem_plan.py; a plan that does not match the shapes is refused with
// cudaErrorInvalidValue.
int zemb_gather_f32(const void* table, const void* idx, const void* cnt,
                    int E, int P, int Z, int H, int W, int bps,
                    int table_bytes, void* out, void* stream) {
  return zemb_rows::launch_plan<false>(table, idx, cnt, E, P, Z, H, W, bps,
                                       table_bytes, out, nullptr, stream);
}

}  // extern "C"
