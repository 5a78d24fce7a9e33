// Diagonal / row / column pooling of the dense PPGN grid, node level.
//
// Replaces escgnn_tpu/ops/ppgn_pool.py::diag_row_col_pool (kernel
// `_pool_kernel`, called by `_pool_fwd_impl`).
//
//   diag[g, n, c] = x[g, n, n, c]
//   row[g, n, c]  = sum_k x[g, n, k, c]      col[g, n, c] = sum_k x[g, k, n, c]
//   out[g, n, :]  = [diag | row + col - 2 * diag]          (G, N, 2C) f32
//
// x is (G, N, N, C), channels last, f32 or bf16; the sums run in f32.
// The TPU kernel took a few whole graphs per grid step into VMEM and
// reduced them there. On Hopper one thread owns one output (g, n, c): it
// walks row n and column n of its channel (2N reads; a warp's 32 threads
// take 32 consecutive channels, so each of its reads is one coalesced
// line), adds in ascending k, and writes both
// halves of its output. Threads share nothing: no shared memory, no
// synchronisation, no atomics, any G, N and C. A block is 32 channels x 8
// nodes of one graph. Every element of x is read twice, once by its row's
// thread and once by its column's; a graph's grid (147 KB in bf16 at
// N 24, C 128) is small enough that the second read hits L1 or L2.
//
// Bound on an H100 SXM at the PPGN_eff counting shapes (G 128, N 24,
// C 128, bf16): it must read x once (9.4 MB) and write out once (3.1 MB),
// ~3.8 us at 3.35 TB/s; its 2 G N N C adds are negligible. So bytes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int kChan = 32;   // channels per block (threadIdx.x)
constexpr int kNodes = 8;   // nodes per block (threadIdx.y)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void pool_kernel(const T* __restrict__ x, int N, int C,
                            int chan_blocks, int node_blocks,
                            float* __restrict__ out) {
  // blockIdx.x = (g * node_blocks + node block) * chan_blocks + chan block
  const int cb = blockIdx.x % chan_blocks;
  const int rest = blockIdx.x / chan_blocks;
  const int nb = rest % node_blocks;
  const int64_t g = rest / node_blocks;
  const int c = cb * kChan + threadIdx.x;
  const int n = nb * kNodes + threadIdx.y;
  if (c >= C || n >= N) return;
  const T* xg = x + g * N * N * C;
  const int64_t nC = static_cast<int64_t>(N) * C;
  float row = 0.f, col = 0.f;
  for (int k = 0; k < N; ++k) {
    row += to_f32(xg[n * nC + static_cast<int64_t>(k) * C + c]);
    col += to_f32(xg[k * nC + static_cast<int64_t>(n) * C + c]);
  }
  const float diag = to_f32(xg[n * nC + static_cast<int64_t>(n) * C + c]);
  float* o = out + (g * N + n) * 2 * C;
  o[c] = diag;
  o[C + c] = row + col - 2.f * diag;
}

template <typename T>
int launch(const void* x, int G, int N, int C, void* out, void* stream) {
  if (G <= 0 || N <= 0 || C <= 0) return 0;
  const int chan_blocks = (C + kChan - 1) / kChan;
  const int node_blocks = (N + kNodes - 1) / kNodes;
  const int64_t blocks =
      static_cast<int64_t>(G) * node_blocks * chan_blocks;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  pool_kernel<T><<<static_cast<unsigned>(blocks), dim3(kChan, kNodes), 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), N, C, chan_blocks, node_blocks,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ppgn_pool_f32(const void* x, int G, int N, int C, void* out,
                  void* stream) {
  return launch<float>(x, G, N, C, out, stream);
}

int ppgn_pool_bf16(const void* x, int G, int N, int C, void* out,
                   void* stream) {
  return launch<__nv_bfloat16>(x, G, N, C, out, stream);
}

}  // extern "C"
