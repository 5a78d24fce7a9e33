// The row walk shared by the z-embedding reduce kernels K2
// (zemb_countmat.cu) and K3 (zemb_gather.cu).
//
//   out[r, :] = sum_p cnt[r, p] * table[idx[r, p], :]        (R, H) f32
//   C[r, z]   = sum_p cnt[r, p] * [idx[r, p] == z]           (R, Z) f32, K2 only
//
// Design (one kernel, instantiated by both sources):
//   * a persistent grid: the output columns are cut into slices of
//     W = 128 V columns (V = 1 or 2), each slice gets `bps` blocks of
//     kThreads, one block per SM. The plan (W, blocks per slice, whether
//     the table slice is copied in) comes from `escgnn_tpu_torch/ops/
//     smem_plan.py`; the launchers check it;
//   * kSmem: each block copies its (Z, W) f32 column slice of the table
//     into shared memory once with cp.async, zero-filling the columns past
//     H, and reads every table row from there (the slice starts on a
//     128-byte line: off it, the reads took twice the wavefronts).
//     Otherwise the rows are read through L1: a batch touches few of them
//     (64 of 1800 at the PPGN_eff shapes), and they stay there;
//   * one warp per row. Block b of a slice owns the rows b, b + bps, ...
//     (neighbouring rows, often all padding or all real, spread over the
//     SMs), and its warps take them from a counter in shared memory, so a
//     warp that drew short rows takes more. A warp takes its next row and
//     loads that row's (id, count) pairs while it walks the current one.
//     Per 32 entries, a ballot marks the pairs with a count and an id in
//     [0, Z), and the marked lanes write them, in ascending p, to the
//     warp's slot of shared memory as (row offset, count). The warp then
//     walks them kUnroll at a time: every lane reads each pair by
//     broadcast, then V float4 of each table row, and adds them with f32
//     FMAs. A step costs one shared-memory wavefront for the pair and 4 V
//     for the row's 512 V bytes; each column sums in ascending p;
//   * kWriteC (K2): the blocks of slice 0 also write C. The warp that owns
//     a row zeroes it and adds the row's counts into it with atomics of
//     that warp alone as it packs the pairs. Counts are small integers, so
//     the f32 sums are exact and the same in any order.
// Every row is summed by one warp in a fixed order, so two calls give the
// same bits whichever warp takes a row, and no atomics touch `out`.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace zemb_rows {
namespace {  // each source keeps its own copy

constexpr int kThreads = 1024;            // 32 warps, one block per SM
constexpr int kWarps = kThreads / 32;
// the block's row counter (padded to 128 bytes, so that the pairs and the
// table rows after it start on a 128-byte line) and its warps' packed
// pairs (8 KB)
constexpr int kHeadBytes = 128;
constexpr int kFixedBytes = kHeadBytes + kWarps * 32 * 8;
constexpr int kMaxSmemBytes = 232448;     // a Hopper block's shared memory
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int src_bytes, bool vec) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // src_bytes < the copy size zero-fills the rest of dst
  if (vec) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(src_bytes));
  }
}

// Copies the (Z, W) column slice table[:, h0:h0+W] into Ts (pitch W),
// zeros past column H, a warp per row; 16-byte copies where H and the
// table allow them. Waits for them.
__device__ __forceinline__ void stage_slice(const float* __restrict__ table,
                                            int Z, int H, int h0, int W,
                                            bool vec, float* Ts) {
  const int lane = threadIdx.x & 31;
  const int step = vec ? 4 : 1;
  const int per_row = W / step;
  for (int z = threadIdx.x >> 5; z < Z; z += kWarps) {
    for (int k = lane; k < per_row; k += 32) {
      const int c = k * step;
      const int h = h0 + c;
      const bool in = h < H;  // a 16-byte chunk is all in or all out
      cp_async(Ts + z * W + c,
               in ? table + static_cast<int64_t>(z) * H + h : table,
               in ? step * 4 : 0, vec);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// The pair of entry p0 + lane of row r (count 0 past P).
__device__ __forceinline__ void fetch(const int* __restrict__ idx,
                                      const float* __restrict__ cnt,
                                      int64_t r, int P, int p0, int lane,
                                      int& z, float& c) {
  const int p = p0 + lane;
  z = 0;
  c = 0.f;
  if (p < P) {
    z = __ldg(idx + r * P + p);
    c = __ldg(cnt + r * P + p);
  }
}

// A row's first 64 pairs, one per lane in each half (none past row R).
struct Pairs {
  int z0, z1;
  float c0, c1;
};

__device__ __forceinline__ Pairs fetch_row(const int* __restrict__ idx,
                                           const float* __restrict__ cnt,
                                           int64_t r, int R, int P,
                                           int lane) {
  Pairs pr;
  const int Pr = r < R ? P : 0;
  fetch(idx, cnt, r, Pr, 0, lane, pr.z0, pr.c0);
  fetch(idx, cnt, r, Pr, 32, lane, pr.z1, pr.c1);
  return pr;
}

// Writes the pairs that add something (count != 0, id in [0, Z)) to the
// warp's slot in ascending lane order, as (row offset z * pitch, count),
// adds their counts to the C row when there is one, and returns their
// number.
__device__ __forceinline__ int pack(int z, float c, int Z, int pitch,
                                    int2* slot, float* Crow, int lane) {
  const bool ok = c != 0.f && z >= 0 && z < Z;
  const unsigned todo = __ballot_sync(kAll, ok);
  if (ok) {
    slot[__popc(todo & ((1u << lane) - 1u))] =
        make_int2(z * pitch, __float_as_int(c));
    if (Crow != nullptr) atomicAdd(Crow + z, c);
  }
  __syncwarp();
  return __popc(todo);
}

template <bool kShared>
__device__ __forceinline__ float4 load4(const float* row, int c, int ncols,
                                        bool vec) {
  // a shared-memory row is zero-padded to W columns
  if (kShared) return *reinterpret_cast<const float4*>(row + c);
  if (vec && c + 4 <= ncols) return __ldg(reinterpret_cast<const float4*>(row + c));
  float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c < ncols) t.x = __ldg(row + c);
  if (c + 1 < ncols) t.y = __ldg(row + c + 1);
  if (c + 2 < ncols) t.z = __ldg(row + c + 2);
  if (c + 3 < ncols) t.w = __ldg(row + c + 3);
  return t;
}

__device__ __forceinline__ void fma4(float c, const float4& t, float4& a) {
  a.x = fmaf(c, t.x, a.x);
  a.y = fmaf(c, t.y, a.y);
  a.z = fmaf(c, t.z, a.z);
  a.w = fmaf(c, t.w, a.w);
}

// Adds the n packed pairs of the warp's slot, in order. col0 is the
// lane's first column (4 lane); its others are col0 + 128 v.
template <int V, bool kShared>
__device__ __forceinline__ void walk(const int2* slot, int n, const float* tb,
                                     int col0, int ncols, bool vec,
                                     float4 (&acc)[V]) {
  constexpr int kUnroll = 4 / V;  // entries whose rows are read together
  for (int e0 = 0; e0 < n; e0 += kUnroll) {
    // pairs past n are read but not used (e0 + kUnroll <= 32)
    int2 pr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) pr[u] = slot[e0 + u];
    float4 t[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        t[u][v] = e0 + u < n
                      ? load4<kShared>(tb + pr[u].x, col0 + 128 * v, ncols, vec)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (e0 + u < n) {
#pragma unroll
        for (int v = 0; v < V; ++v) fma4(__int_as_float(pr[u].y), t[u][v], acc[v]);
      }
    }
  }
  __syncwarp();  // the slot is read before the next pack writes it
}

// One row's z (its pairs in cur, more past entry 64 fetched here) into
// out, and its C row when Crow is set.
template <int V, bool kShared>
__device__ __forceinline__ void reduce_row(
    const int* __restrict__ idx, const float* __restrict__ cnt, int64_t r,
    int P, int Z, const Pairs& cur, const float* tb,
    int pitch, int ncols, bool vec, bool vec_out, int2* slot, float* Crow,
    float* orow, int lane) {
  const int col0 = 4 * lane;
  float4 acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);
  walk<V, kShared>(slot, pack(cur.z0, cur.c0, Z, pitch, slot, Crow, lane),
                   tb, col0, ncols, vec, acc);
  if (P > 32) {
    walk<V, kShared>(slot, pack(cur.z1, cur.c1, Z, pitch, slot, Crow, lane),
                     tb, col0, ncols, vec, acc);
  }
  for (int p0 = 64; p0 < P; p0 += 32) {
    int z;
    float c;
    fetch(idx, cnt, r, P, p0, lane, z, c);
    walk<V, kShared>(slot, pack(z, c, Z, pitch, slot, Crow, lane), tb,
                     col0, ncols, vec, acc);
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int col = col0 + 128 * v;
    if (vec_out && col + 4 <= ncols) {
      *reinterpret_cast<float4*>(orow + col) = acc[v];
    } else {
      if (col < ncols) orow[col] = acc[v].x;
      if (col + 1 < ncols) orow[col + 1] = acc[v].y;
      if (col + 2 < ncols) orow[col + 2] = acc[v].z;
      if (col + 3 < ncols) orow[col + 3] = acc[v].w;
    }
  }
}

template <int V, bool kSmem, bool kWriteC>
__global__ void __launch_bounds__(kThreads, 1)
zemb_rows_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                 const float* __restrict__ cnt, int R, int P, int Z, int H,
                 int bps, float* __restrict__ out, float* __restrict__ C) {
  extern __shared__ __align__(16) int2 smem[];
  constexpr int W = 128 * V;
  int* next_row = reinterpret_cast<int*>(smem);
  int2* slot = smem + kHeadBytes / 8 + (threadIdx.x >> 5) * 32;
  float* Ts = reinterpret_cast<float*>(smem + kFixedBytes / 8);
  const int slice = blockIdx.x / bps;
  const int h0 = slice * W;
  const int lane = threadIdx.x & 31;
  // the block's rows are b, b + bps, b + 2 bps, ... (neighbouring rows,
  // often all padding or all real, spread over the SMs); its warps take
  // them from a counter, the first kWarps in warp order
  const int b = blockIdx.x - slice * bps;
  int k = threadIdx.x >> 5;
  if (threadIdx.x == 0) *next_row = kWarps;
  const bool vec =
      H % 4 == 0 && (reinterpret_cast<uintptr_t>(table) & 15) == 0;
  // the first row's pairs load first, then the table slice
  int64_t r = b + static_cast<int64_t>(k) * bps;
  Pairs cur = fetch_row(idx, cnt, r, R, P, lane);
  if (kSmem) stage_slice(table, Z, H, h0, W, vec, Ts);
  __syncthreads();  // the counter is set
  const float* tb = kSmem ? Ts : table + h0;
  const int pitch = kSmem ? W : H;
  const int ncols = min(W, H - h0);
  const bool vec_out = H % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  while (r < R) {
    // take the next row and load its pairs while this one is walked
    int k_next = lane == 0 ? atomicAdd(next_row, 1) : 0;
    k_next = __shfl_sync(kAll, k_next, 0);
    const int64_t r_next = b + static_cast<int64_t>(k_next) * bps;
    const Pairs nxt = fetch_row(idx, cnt, r_next, R, P, lane);
    float* Crow = nullptr;
    if (kWriteC && slice == 0) {
      Crow = C + r * Z;
      for (int z = lane; z < Z; z += 32) Crow[z] = 0.f;
      __syncwarp();  // the zeros land before any lane adds
    }
    reduce_row<V, kSmem>(idx, cnt, r, P, Z, cur, tb, pitch, ncols, vec,
                         vec_out, slot, Crow, out + r * H + h0, lane);
    r = r_next;
    cur = nxt;
  }
}

// Checks the plan against the shapes, opts the kernel in to its shared
// memory once, and launches it. Returns a cudaError_t.
template <int V, bool kSmem, bool kWriteC>
int launch(const void* table, const void* idx, const void* cnt, int R, int P,
           int Z, int H, int bps, int table_bytes, void* out, void* C,
           cudaStream_t stream) {
  constexpr int W = 128 * V;
  const int64_t want = kSmem ? static_cast<int64_t>(Z) * W * sizeof(float) : 0;
  if (table_bytes != want || kFixedBytes + want > kMaxSmemBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = kFixedBytes + table_bytes;
  static int opted_in = 48 * 1024;  // one per instantiation
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        zemb_rows_kernel<V, kSmem, kWriteC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  const int slices = (H + W - 1) / W;
  zemb_rows_kernel<V, kSmem, kWriteC><<<slices * bps, kThreads, smem, stream>>>(
      static_cast<const float*>(table), static_cast<const int*>(idx),
      static_cast<const float*>(cnt), R, P, Z, H, bps,
      static_cast<float*>(out), static_cast<float*>(C));
  return static_cast<int>(cudaGetLastError());
}

// Dispatch on the slice width (128 or 256 columns) and on whether the
// table slice is copied into shared memory (table_bytes > 0) or its rows
// are read through L1.
template <bool kWriteC>
int launch_plan(const void* table, const void* idx, const void* cnt, int R,
                int P, int Z, int H, int W, int bps, int table_bytes,
                void* out, void* C, void* stream) {
  if (H <= 0 || Z <= 0 || P < 0 || bps <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (R <= 0) return 0;  // nothing to launch
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool smem = table_bytes > 0;
  if (W == 128 && smem) {
    return launch<1, true, kWriteC>(table, idx, cnt, R, P, Z, H, bps, table_bytes, out, C, s);
  }
  if (W == 128) {
    return launch<1, false, kWriteC>(table, idx, cnt, R, P, Z, H, bps, table_bytes, out, C, s);
  }
  if (W == 256 && smem) {
    return launch<2, true, kWriteC>(table, idx, cnt, R, P, Z, H, bps, table_bytes, out, C, s);
  }
  if (W == 256) {
    return launch<2, false, kWriteC>(table, idx, cnt, R, P, Z, H, bps, table_bytes, out, C, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace zemb_rows
