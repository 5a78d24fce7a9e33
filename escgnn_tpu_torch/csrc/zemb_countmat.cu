// Count-matrix build + product for the z-embedding reduce over unique rows.
//
// Replaces escgnn_tpu/ops/zemb_pallas.py::zemb_countmat_pallas.
//
//   C[r, z] = sum_p cnt[r, p] * [idx[r, p] == z]       (R, Zc) f32
//   out[r, :] = C[r, :] @ table                        (R, H)  f32
//
// The TPU kernel built C with P compare-accumulate passes over a
// (block, Zc) tile because Mosaic had no row scatter, then ran one dense
// MXU product. Bound on an H100 SXM, flagship shapes (R 3712, P 48,
// Zc 128, H 256): the function must move ~7.3 MB (~2.2 us at 3.35 TB/s);
// its work is the product over C's nonzeros (~0.06 GFLOP, ~0.9 us at
// 67 TFLOP/s f32), so the bytes bound it.
//
// The first Hopper design built C tiles in shared memory and ran the
// dense product over all Zc buckets (0.24 GFLOP) in 64 x 64 output tiles;
// every column tile rebuilt the same C tile, and it ran at 17x its bound
// (0.0370 ms). This design (zemb_rows.cuh) holds the compacted table in
// shared memory on every SM (at the flagship shapes all 256 columns,
// 128 KB) and walks each row's nonzero entries only, a warp per row: the
// warp zeroes its C row and adds the row's counts into it as it packs the
// pairs, then adds one table row per entry from shared memory. On the
// batcher's data a row's nonzero ids are unique and ascending, so the
// walk adds exactly C's nonzeros, in the order of the dense product.
//
// A table whose slice does not fit beside the fixed 8320 bytes (Zc > 218
// at 256 columns, > 437 at 128) is read through L1 by the same kernel, so
// K2 takes any Zc.

#include "zemb_rows.cuh"

extern "C" {

// The plan (slice width W, blocks per slice, bytes of the table slice in
// shared memory, 0 to read the rows through L1) comes from
// ops/smem_plan.py; a plan that does not match the shapes is refused with
// cudaErrorInvalidValue.
int zemb_countmat_f32(const void* table, const void* idx, const void* cnt,
                      int R, int P, int Zc, int H, int W, int bps,
                      int table_bytes, void* out, void* C, void* stream) {
  return zemb_rows::launch_plan<true>(table, idx, cnt, R, P, Zc, H, W, bps,
                                      table_bytes, out, C, stream);
}

}  // extern "C"
