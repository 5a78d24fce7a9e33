// Sorted segment sum for the backward of the dedup row -> edge expansion.
//
// Replaces escgnn_tpu/ops/expand_pallas.py::sorted_segment_sum_pallas.
//
//   dU[r, :] = sum_{k : rows_sorted[k] == r} dZ[perm[k], :]    (f32 out)
//
// `rows_sorted` is non-decreasing (the batcher's stable argsort of the
// edge -> row map), so row r owns the contiguous run [lo(r), hi(r)) of
// the sorted order. The TPU kernel turned each edge tile into a one-hot
// matmul and carried row sums across its sequential grid. On Hopper the
// blocks run in parallel and in no order, and one run can be very long
// (every padding edge of a batch maps to the same all-zero row: a quarter
// of the edges at the flagship shapes), so a block per row would leave
// that row's block streaming megabytes alone. Instead, three passes:
//
//   1. chunk pass: block j takes the kChunk sorted positions
//      [j*kChunk, (j+1)*kChunk), a thread per column. Each thread first
//      loads its column of all kChunk gathered rows dZ[perm[k]] into
//      registers (the perm gather fused into the load; every load of the
//      chunk in flight at once), then sums them run by run in ascending
//      k. A run that lies inside the chunk is a finished row and is
//      written to dU; a run cut by the chunk's start or end is written to
//      a per-chunk partial slot (head: the run began in an earlier chunk;
//      tail: it began here and goes on);
//   2. offsets pass: a thread per sorted position k writes the CSR
//      offsets off[r] = first k with rows_sorted[k] >= r for the rows
//      between its left neighbour's id and its own (each r once);
//   3. row pass: block r reads its run [off[r], off[r+1]). An empty run
//      writes 0 (gaps, and trailing rows past the largest id); a run
//      spanning chunks c0 < c1 adds tail(c0) + head(c0+1) + ... +
//      head(c1) in that order; any other run was written by pass 1.
//
// No atomics: every sum is taken in a fixed order, so the result is
// bit-identical from run to run. The wrapper allocates the partial slots
// and the offsets.
//
// Bound on an H100 SXM: bytes. It must read dZ once (E*H*4 bytes for f32),
// perm and rows_sorted once and write dU once: at the flagship shapes
// (E 12288, R ~3700, H 256) about 16 MB, ~5 us at 3.35 TB/s. The E*H adds
// are negligible next to that. The partial slots add at most 2*H*4 bytes
// per chunk of 32 edges written and read.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int kChunk = 32;     // sorted positions per chunk-pass block
constexpr int kThreads = 256;  // columns handled at once by a block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void chunk_pass(const T* __restrict__ dZ,
                           const int* __restrict__ perm,
                           const int* __restrict__ rows_sorted,
                           int E, int H, int R,
                           float* __restrict__ out,
                           float* __restrict__ partial) {
  __shared__ int s_row[kChunk];
  __shared__ int64_t s_src[kChunk];
  __shared__ int s_prev, s_next;
  const int j = blockIdx.x;
  const int k0 = j * kChunk;
  const int n = min(kChunk, E - k0);
  if (threadIdx.x < n) {
    s_row[threadIdx.x] = __ldg(rows_sorted + k0 + threadIdx.x);
    s_src[threadIdx.x] =
        static_cast<int64_t>(__ldg(perm + k0 + threadIdx.x)) * H;
  }
  if (threadIdx.x == 0) {
    s_prev = k0 > 0 ? __ldg(rows_sorted + k0 - 1) : -1;
    s_next = k0 + n < E ? __ldg(rows_sorted + k0 + n) : -1;
  }
  __syncthreads();
  float* head = partial + static_cast<int64_t>(2 * j) * H;
  float* tail = head + H;
  for (int c = threadIdx.x; c < H; c += kThreads) {
    float v[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      v[i] = i < n ? to_f32(dZ[s_src[i] + c]) : 0.f;
    }
    float acc = 0.f;
    bool at_start = true;
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      if (i >= n) break;
      acc += v[i];
      const int r = s_row[i];
      const bool at_end = (i == n - 1);
      if (at_end || s_row[i + 1] != r) {
        const bool began_before = at_start && s_prev == r;
        const bool goes_on = at_end && s_next == r;
        if (r >= 0 && r < R) {
          if (began_before) {
            head[c] = acc;
          } else if (goes_on) {
            tail[c] = acc;
          } else {
            out[static_cast<int64_t>(r) * H + c] = acc;
          }
        }
        acc = 0.f;
        at_start = false;
      }
    }
  }
}

// off[r] for r in [0, R]: position k owns the rows r with
// rows_sorted[k-1] < r <= rows_sorted[k] (sentinels -1 and +inf at the
// ends), so every r is written exactly once
__global__ void offsets_pass(const int* __restrict__ rows_sorted, int E,
                             int R, int* __restrict__ off) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k > E) return;
  const int prev = k == 0 ? -1 : __ldg(rows_sorted + k - 1);
  const int cur = k == E ? R : min(__ldg(rows_sorted + k), R);
  for (int r = max(prev + 1, 0); r <= cur; ++r) off[r] = k;
}

__global__ void row_pass(const int* __restrict__ off, int H,
                         const float* __restrict__ partial,
                         float* __restrict__ out) {
  const int r = blockIdx.x;
  const int lo = __ldg(off + r);
  const int hi = __ldg(off + r + 1);
  float* orow = out + static_cast<int64_t>(r) * H;
  if (lo == hi) {
    for (int c = threadIdx.x; c < H; c += kThreads) orow[c] = 0.f;
    return;
  }
  const int c0 = lo / kChunk, c1 = (hi - 1) / kChunk;
  if (c0 == c1) return;  // the chunk pass wrote the whole run
  for (int c = threadIdx.x; c < H; c += kThreads) {
    float acc = partial[static_cast<int64_t>(2 * c0 + 1) * H + c];
#pragma unroll 8
    for (int j = c0 + 1; j <= c1; ++j) {
      acc += partial[static_cast<int64_t>(2 * j) * H + c];
    }
    orow[c] = acc;
  }
}

template <typename T>
int launch(const void* dZ, const void* perm, const void* rows_sorted,
           int E, int H, int R, void* out, void* partial, void* offsets,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R > 0 && H > 0) {
    const int* rs = static_cast<const int*>(rows_sorted);
    float* o = static_cast<float*>(out);
    float* p = static_cast<float*>(partial);
    int* off = static_cast<int*>(offsets);
    if (E > 0) {
      chunk_pass<T><<<(E + kChunk - 1) / kChunk, kThreads, 0, s>>>(
          static_cast<const T*>(dZ), static_cast<const int*>(perm), rs,
          E, H, R, o, p);
    }
    offsets_pass<<<(E + kThreads) / kThreads, kThreads, 0, s>>>(rs, E, R, off);
    row_pass<<<R, kThreads, 0, s>>>(off, H, p, o);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// floats of partial-slot scratch the launchers need for E sorted edges
long long expand_segsum_partial_floats(int E, int H) {
  return 2LL * ((E + kChunk - 1) / kChunk) * H;
}

// `partial`: expand_segsum_partial_floats(E, H) floats; `offsets`: R + 1
// ints
int expand_segsum_f32(const void* dZ, const void* perm,
                      const void* rows_sorted, int E, int H, int R,
                      void* out, void* partial, void* offsets,
                      void* stream) {
  return launch<float>(dZ, perm, rows_sorted, E, H, R, out, partial,
                       offsets, stream);
}

int expand_segsum_bf16(const void* dZ, const void* perm,
                       const void* rows_sorted, int E, int H, int R,
                       void* out, void* partial, void* offsets,
                       void* stream) {
  return launch<__nv_bfloat16>(dZ, perm, rows_sorted, E, H, R, out,
                               partial, offsets, stream);
}

}  // extern "C"
