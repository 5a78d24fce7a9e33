// Weighted row gather for the z-embedding reduce on the width layout.
//
// Replaces escgnn_tpu/ops/zemb_pallas.py::zemb_pallas (kernel `_kernel`).
//
//   out[e, :] = sum_p cnt[e, p] * table[idx[e, p], :]        (E, H) f32
//
// The TPU kernel kept the whole (Z, H) table in VMEM and, because Mosaic
// had no row gather, built a (block, Z) bf16 coefficient tile with P
// compare passes, then ran one MXU product over all Z buckets. On Hopper
// the table (Z 1800 x H 128 f32 = 0.92 MB, 1.8 MB at H 256) is far above
// the 227 KB of shared memory a block may use, but it stays in the 50 MB
// L2, and the card gathers rows directly. So one warp owns one edge row:
//   1. its 32 lanes load 32 (idx, cnt) pairs of the row at once;
//   2. a ballot marks the pairs that add something: cnt != 0 and an id in
//      [0, Z). The warp walks the marked pairs in ascending p, taking
//      each pair from its lane with a shuffle. A padding row (all counts
//      0) or a padding slot reads no table row, and an id outside [0, Z)
//      is never read;
//   3. each lane accumulates 4 columns (lane + 32 j) of a 128-column tile
//      with f32 FMAs: the warp reads a table row as coalesced 128-byte
//      lines;
//   4. it writes its tile once. Wider H takes more tiles.
// No shared memory, no atomics, and a fixed summation order per row: the
// result is the f32 gather-reduce up to summation order. (The TPU kernel
// rounded the table and the coefficient tile to bf16.)
//
// Bound on an H100 SXM at the PPGN_eff counting shapes (E 21504, P 56,
// Z 1800, H 128): the function must move idx and cnt (2 x 4.8 MB), the
// table (0.92 MB) and out (11.0 MB), 21.6 MB, ~6.4 us at 3.35 TB/s. Its
// 2*E*P*H = 0.31 GFLOP (less over the nonzero entries only) are ~4.6 us
// at 67 TFLOP/s f32, so the bytes bound it. The gathered rows (~0.2 GB
// over the nonzero entries) come from L2, and L2 latency per dependent
// gather is what this simple design pays.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarps = 8;    // edge rows per block, one per warp
constexpr int kTile = 128;   // columns per pass, 4 per lane
constexpr unsigned kAll = 0xffffffffu;

__global__ void zemb_gather_kernel(const float* __restrict__ table,
                                   const int* __restrict__ idx,
                                   const float* __restrict__ cnt,
                                   int E, int P, int Z, int H,
                                   float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t e =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (e >= E) return;  // whole warps leave together
  const int* irow = idx + e * P;
  const float* crow = cnt + e * P;
  float* orow = out + e * H;
  for (int h0 = 0; h0 < H; h0 += kTile) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int p0 = 0; p0 < P; p0 += 32) {
      const int p = p0 + lane;
      int z = 0;
      float c = 0.f;
      if (p < P) {
        z = __ldg(irow + p);
        c = __ldg(crow + p);
      }
      unsigned todo = __ballot_sync(kAll, c != 0.f && z >= 0 && z < Z);
      while (todo) {  // lowest lane first: ascending p
        const int j = __ffs(todo) - 1;
        todo &= todo - 1;
        const int zj = __shfl_sync(kAll, z, j);
        const float cj = __shfl_sync(kAll, c, j);
        const float* trow = table + static_cast<int64_t>(zj) * H + h0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int h = lane + 32 * k;
          if (h0 + h < H) acc[k] = fmaf(cj, __ldg(trow + h), acc[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int h = h0 + lane + 32 * k;
      if (h < H) orow[h] = acc[k];
    }
  }
}

}  // namespace

extern "C" {

int zemb_gather_f32(const void* table, const void* idx, const void* cnt,
                    int E, int P, int Z, int H, void* out, void* stream) {
  if (E <= 0 || H <= 0) return 0;
  const int blocks = (E + kWarps - 1) / kWarps;
  zemb_gather_kernel<<<blocks, kWarps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int*>(idx),
      static_cast<const float*>(cnt), E, P, Z, H, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
