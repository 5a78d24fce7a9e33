// Count-matrix build + product for the z-embedding reduce over unique rows.
//
// Replaces escgnn_tpu/ops/zemb_pallas.py::zemb_countmat_pallas.
//
//   C[r, z] = sum_p cnt[r, p] * [idx[r, p] == z]       (R, Zc) f32
//   out[r, :] = C[r, :] @ table                        (R, H)  f32
//
// The TPU kernel built C with P compare-accumulate passes over a
// (block, Zc) tile because Mosaic had no row scatter. On Hopper a block
// owns a tile of kRows rows and kCols output columns:
//   1. it zeroes a (kRows, Zc) C tile in shared memory and adds the
//      tile's R*P (idx, cnt) entries into it with shared-memory atomics.
//      Counts are small integers, so the f32 sums are exact and the same
//      in any order; ids outside [0, Zc) contribute nothing, like the
//      one-hot compare of the plain version;
//   2. the blocks of column tile 0 write their C tile out (the backward
//      dT = C^T @ dU needs it);
//   3. it streams the table through shared memory in (kDepth, kCols)
//      slices and each thread accumulates a 4 x 4 output micro-tile with
//      f32 FMAs, then writes it.
// Shared memory holds kRows * (Zc + 1) floats of C (the +1 pads the row
// pitch off the bank of the next row) plus one table slice, which caps
// Zc at 875 with the 227 KB a block may use; the wrapper raises above.
//
// Bound on an H100 SXM, flagship shapes (R 3712, P 48, Zc 128, H 256):
// it must move ~7.3 MB (~2.2 us at 3.35 TB/s). This kernel runs the
// dense product, 2*R*Zc*H = 0.24 GFLOP (~3.6 us at 67 TFLOP/s f32
// without tensor cores), but the data needs only the product over C's
// nonzeros (~0.06 GFLOP; chip_smoke.py counts it from the batch), so the
// bound is the bytes.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kRows = 64;    // rows per block
constexpr int kCols = 64;    // output columns per block
constexpr int kDepth = 32;   // table rows per shared-memory slice
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void countmat_kernel(const float* __restrict__ table,
                                const int* __restrict__ idx,
                                const float* __restrict__ cnt,
                                int R, int P, int Zc, int H,
                                float* __restrict__ out,
                                float* __restrict__ C) {
  extern __shared__ float smem[];
  const int pitch = Zc + 1;
  float* Cs = smem;                       // kRows x pitch
  float* Ts = smem + kRows * pitch;       // kDepth x kCols
  const int t = threadIdx.x;
  const int r0 = blockIdx.x * kRows;
  const int h0 = blockIdx.y * kCols;

  // 1. build the C tile
  for (int i = t; i < kRows * pitch; i += kThreads) Cs[i] = 0.f;
  __syncthreads();
  for (int i = t; i < kRows * P; i += kThreads) {
    const int rr = i / P;
    const int r = r0 + rr;
    if (r >= R) continue;
    const int64_t k = static_cast<int64_t>(r) * P + (i - rr * P);
    const int z = __ldg(idx + k);
    if (z >= 0 && z < Zc) atomicAdd(&Cs[rr * pitch + z], __ldg(cnt + k));
  }
  __syncthreads();

  // 2. write C once (column tile 0 only)
  if (blockIdx.y == 0) {
    for (int i = t; i < kRows * Zc; i += kThreads) {
      const int rr = i / Zc, z = i - rr * Zc;
      if (r0 + rr < R) {
        C[static_cast<int64_t>(r0 + rr) * Zc + z] = Cs[rr * pitch + z];
      }
    }
  }

  // 3. out tile = C tile @ table[:, h0:h0+kCols]
  const int tr = (t / 16) * 4;  // first of this thread's 4 rows
  const int tc = (t % 16) * 4;  // first of its 4 columns
  float acc[4][4] = {};
  for (int k0 = 0; k0 < Zc; k0 += kDepth) {
    for (int i = t; i < kDepth * kCols; i += kThreads) {
      const int kk = i / kCols, c = i - kk * kCols;
      const int z = k0 + kk, h = h0 + c;
      Ts[i] = (z < Zc && h < H)
                  ? __ldg(table + static_cast<int64_t>(z) * H + h) : 0.f;
    }
    __syncthreads();
    const int kn = min(kDepth, Zc - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Cs[(tr + i) * pitch + k0 + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ts[kk * kCols + tc + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + tr + i;
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int h = h0 + tc + j;
      if (h < H) out[static_cast<int64_t>(r) * H + h] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

int zemb_countmat_smem_bytes(int Zc) {
  return static_cast<int>(sizeof(float)) * (kRows * (Zc + 1) + kDepth * kCols);
}

int zemb_countmat_f32(const void* table, const void* idx, const void* cnt,
                      int R, int P, int Zc, int H, void* out, void* C,
                      void* stream) {
  if (R <= 0 || H <= 0 || Zc <= 0) return 0;
  const int smem = zemb_countmat_smem_bytes(Zc);
  // above the default 48 KB a kernel must opt in to more dynamic shared
  // memory; raise the opt-in once to the largest size asked for so far
  static int opted_in = 48 * 1024;
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        countmat_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  dim3 grid((R + kRows - 1) / kRows, (H + kCols - 1) / kCols);
  countmat_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int*>(idx),
      static_cast<const float*>(cnt), R, P, Zc, H,
      static_cast<float*>(out), static_cast<float*>(C));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
