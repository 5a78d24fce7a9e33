// Sorted segment sum for the backward of the dedup row -> edge expansion
// (K1).
//
// Replaces escgnn_tpu/ops/expand_pallas.py::sorted_segment_sum_pallas.
//
//   dU[r, :] = sum_{k : rows_sorted[k] == r} dZ[perm[k], :]    (R, H) f32
//
// dZ is (E, H) f32 or bf16 with unit column stride and any row stride
// ld >= H. The flagship step's gradient is the first 256 columns of the
// (E, 288) gradient of [z_emb | edge-type embedding]; it is read in place,
// with no copy to a contiguous tensor first.
//
// `rows_sorted` is non-decreasing (the batcher's stable argsort of the
// edge -> row map), so row r owns one run of the sorted order. The TPU
// kernel turned each edge tile into a one-hot matmul and carried the row
// sums across its sequential grid. On Hopper the blocks run in parallel
// and in no order, and one run can be long (every padding edge of a batch
// maps to the same all-zero row: 2667 of the 12288 edges at the flagship
// shapes). One launch does it all:
//
//   * block b takes the `span` sorted positions [b*span, (b+1)*span) (the
//     plan: escgnn_tpu_torch/ops/expand_cuda.py::segsum_plan, about one
//     block per SM) and splits them over `ng` groups of threads, `gp`
//     positions each. In a group a thread owns a unit of columns: 16 bytes
//     of a row (4 f32 or 8 bf16), or a single column where the row stride
//     or the base is not a multiple of 16 bytes, and for the last H % unit
//     columns. It loads up to kBatch gathered rows dZ[perm[k]] of its unit
//     at once (the perm gather fused into the load), then adds them run by
//     run in ascending k. Where each run's sum goes is worked out once per
//     block into a table of one pointer per position (s_dst), so the walk
//     does one broadcast read and a test per position;
//   * a run that lies inside a group is a finished row and is written to
//     dU. A piece of a run cut by a group boundary inside the block goes
//     to the group's first or last slot in shared memory; after a
//     __syncthreads() the group where such a run ends adds its pieces in
//     group order and writes the row. A run cut by the block's start or end
//     is written, so summed, to the block's head or tail slot of `partial`;
//   * the blocks b0 < ... < b1 that share a cut run each write their
//     slot, then add a ticket to the row's 64-bit counter: after a
//     __syncthreads(), one lane per cut run (the head's and the tail's at
//     once) adds it with an acquire-release atomic of gpu scope, which
//     publishes the block's slot writes as a fence would. The low 24 bits
//     sum 1 + b0 from b0, -b1 from b1 and 1 from each block between: 0
//     exactly when the last of them arrives (no subset of the tickets sums
//     to 0, since b0 >= 0, nor to a multiple of 2^24, since the grid is
//     under 2^20);
//     b0 and b1 add their index into bits 24-43 and 44-63. So the atomic
//     that completes the count returns b0 and b1 too, and its block adds
//     the slots tail(b0), head(b0 + 1), ..., head(b1): each group adds a
//     contiguous share of them in order, all loaded at once, then group 0
//     adds the groups' sums in order and writes the row. That block sets
//     the counter back to 0 for the next call: the wrapper zeroes the
//     counters once per device, and no call needs a memset. The long
//     padding run of the flagship spans ~28 blocks of ~94 positions, whose
//     slots 8 groups load in one round trip;
//   * rows that no id names are written 0: a gap between two ids by the
//     block holding the second one, the rows before the first id and after
//     the last id dealt over all blocks (at the flagship shapes 89 trailing
//     rows, which one block alone would write at the end of the grid).
//
// Every sum is taken in a fixed order, so the result is bit-identical from
// run to run: the counters decide only which block adds a cut row.
//
// Bound on an H100 SXM: bytes. It must read dZ once (E*H*4 bytes for f32),
// perm and rows_sorted once and write dU once: at the flagship shapes
// (E 12288, R 3712, H 256) 16.5 MB, 4.9 us at 3.35 TB/s; the E*H adds are
// negligible next to that. The partial slots add at most 2*H*4 bytes per
// block, written and read once through L2.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kBatch = 16;        // rows a thread has in flight at once
constexpr int kMaxSpan = 256;     // most sorted positions one block takes
constexpr int kMaxThreads = 512;  // threads of a block, one block per SM
constexpr int kSlotAlign = 4;     // partial slots start on 16 bytes
constexpr int kMaxGrid = 1 << 20; // blocks: b0 and b1 fit 20 bits
constexpr int kMaxGroupSmem = 48 * 1024;  // the groups' slots in a block
constexpr unsigned long long kSumMask = (1ull << 24) - 1;

template <typename T> struct Unit16;  // columns in 16 bytes of a row
template <> struct Unit16<float> { static constexpr int kWidth = 4; };
template <> struct Unit16<__nv_bfloat16> { static constexpr int kWidth = 8; };

// W columns of one row of T: loaded raw, added into f32 sums
template <typename T, int W> struct Cols;

template <> struct Cols<float, 4> {
  using Raw = float4;
  __device__ static Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static void add(float (&a)[4], const Raw& v) {
    a[0] += v.x; a[1] += v.y; a[2] += v.z; a[3] += v.w;
  }
};

template <> struct Cols<__nv_bfloat16, 8> {
  using Raw = uint4;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ static void add(float (&a)[8], const Raw& v) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // a bf16 is the high half of its f32; element 2j is the low half
      a[2 * j] += __uint_as_float(w[j] << 16);
      a[2 * j + 1] += __uint_as_float(w[j] & 0xffff0000u);
    }
  }
};

template <> struct Cols<float, 1> {
  using Raw = float;
  __device__ static Raw load(const float* p) { return __ldg(p); }
  __device__ static void add(float (&a)[1], const Raw& v) { a[0] += v; }
};

template <> struct Cols<__nv_bfloat16, 1> {
  using Raw = unsigned short;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ static void add(float (&a)[1], const Raw& v) {
    a[0] += __uint_as_float(static_cast<unsigned>(v) << 16);
  }
};

// *p += v at gpu scope, acquire and release: the writes of the block
// before a __syncthreads() are visible to the block that reads this
// counter's total, and that block's reads after its next __syncthreads()
// see them
__device__ __forceinline__ unsigned long long add_acq_rel(
    unsigned long long* p, unsigned long long v) {
  unsigned long long old;
  asm volatile("atom.acq_rel.gpu.global.add.u64 %0, [%1], %2;"
               : "=l"(old) : "l"(p), "l"(v) : "memory");
  return old;
}

// W sums to p: as float4 where p is on 16 bytes (slots always; dU rows
// where H % 4 == 0)
template <int W>
__device__ __forceinline__ void store(float* p, const float (&a)[W]) {
  if constexpr (W % 4 == 0) {
    if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
      for (int j = 0; j < W; j += 4) {
        *reinterpret_cast<float4*>(p + j) =
            make_float4(a[j], a[j + 1], a[j + 2], a[j + 3]);
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < W; ++j) p[j] = a[j];
}

template <typename T>
struct Args {
  const T* dZ;
  long long ld;          // row stride of dZ, in elements
  const int* perm;
  const int* rows;       // rows_sorted
  int E, H, R, span;
  int ng, gp, tu;        // groups, positions and threads per group
  int nvec, nunits;      // 16-byte units of a row, and all units
  bool out_vec;          // dU rows start on 16 bytes (H % 4 == 0)
  int hp;                // floats from one slot to the next
  float* out;
  float* partial;        // 2 slots (head, tail) of hp floats per block
  unsigned long long* counters;  // per row: ticket sum, b0, b1
};

__device__ __forceinline__ void zero_row(float* out, long long r, int H,
                                         bool vec) {
  float* p = out + r * H;
  if (vec) {
    for (int c = 4 * threadIdx.x; c < H; c += 4 * blockDim.x) {
      *reinterpret_cast<float4*>(p + c) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int c = threadIdx.x; c < H; c += blockDim.x) p[c] = 0.f;
  }
}

// the runs of a group's n sorted positions, for the W columns from col:
// the sum of a piece goes where s_dst names at its last position (0: no
// piece ends there; 1: it ends there, on a row outside [0, R))
template <typename T, int W>
__device__ __forceinline__ void walk(const T* __restrict__ dZ, int col,
                                     int n, const long long* s_src,
                                     const unsigned long long* s_dst) {
  using C = Cols<T, W>;
  float acc[W];
#pragma unroll
  for (int j = 0; j < W; ++j) acc[j] = 0.f;
  for (int base = 0; base < n; base += kBatch) {
    const int m = min(kBatch, n - base);
    typename C::Raw v[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      v[i] = i < m ? C::load(dZ + s_src[base + i] + col)
                   : typename C::Raw{};
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (i < m) {
        C::add(acc, v[i]);
        const unsigned long long d = s_dst[base + i];
        if (d != 0) {
          if (d != 1) store<W>(reinterpret_cast<float*>(d) + col, acc);
#pragma unroll
          for (int j = 0; j < W; ++j) acc[j] = 0.f;
        }
      }
    }
  }
}

// adds the slots s_lo <= s < s_hi of a cut run's chain tail(b0),
// head(b0 + 1), ..., head(b1) into acc, in order, kAtOnce loaded at once
template <int W>
__device__ __forceinline__ void merge(const float* partial, int hp, int col,
                                      int b0, int s_lo, int s_hi,
                                      float (&acc)[W]) {
  constexpr int kVecs = W >= 4 ? W / 4 : 1;
  constexpr int kAtOnce = kBatch / kVecs;
  for (int base = s_lo; base < s_hi; base += kAtOnce) {
    const int m = min(kAtOnce, s_hi - base);
    float v[kAtOnce][W];
#pragma unroll
    for (int i = 0; i < kAtOnce; ++i) {
      const int s = base + i;
      const float* p = partial +
          static_cast<long long>(s == 0 ? 2 * b0 + 1 : 2 * (b0 + s)) * hp +
          col;
      if constexpr (W >= 4) {
#pragma unroll
        for (int q = 0; q < kVecs; ++q) {
          const float4 x = i < m
              ? __ldcg(reinterpret_cast<const float4*>(p) + q)
              : make_float4(0.f, 0.f, 0.f, 0.f);
          v[i][4 * q] = x.x; v[i][4 * q + 1] = x.y;
          v[i][4 * q + 2] = x.z; v[i][4 * q + 3] = x.w;
        }
      } else {
        v[i][0] = i < m ? __ldcg(p) : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < kAtOnce; ++i) {
      if (i < m) {
#pragma unroll
        for (int j = 0; j < W; ++j) acc[j] += v[i][j];
      }
    }
  }
}

// the pieces of a run cut by group boundaries, from shared memory: the
// last slot of group g0 (or its first, if the run began before the
// block), then the first slots of groups g0 + 1 .. g1, in order
template <int W>
__device__ __forceinline__ void chain(const float* s_slot, int hp, int col,
                                      int g0, bool from_first, int g1,
                                      float* dst) {
  float acc[W];
#pragma unroll
  for (int j = 0; j < W; ++j) acc[j] = 0.f;
  for (int g = g0; g <= g1; ++g) {
    const float* p = s_slot + (2 * g + (g == g0 && !from_first)) * hp + col;
#pragma unroll
    for (int j = 0; j < W; ++j) acc[j] += p[j];
  }
  store<W>(dst + col, acc);
}

// calls f(W-wide or single column, col) for each unit of thread lt of a
// group of tu threads
template <typename T, bool kVec, typename F>
__device__ __forceinline__ void for_units(const Args<T>& a, int lt, F&& f) {
  constexpr int W = Unit16<T>::kWidth;
  for (int u = lt; u < a.nunits; u += a.tu) {
    if constexpr (kVec) {
      if (u < a.nvec) {
        f(std::integral_constant<int, W>{}, u * W);
        continue;
      }
    }
    f(std::integral_constant<int, 1>{}, a.nvec * W + (u - a.nvec));
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kMaxThreads, 1) segsum_kernel(Args<T> a) {
  extern __shared__ float4 s_dyn[];
  float* s_slot = reinterpret_cast<float*>(s_dyn);  // [ng][first, last][hp]
  __shared__ int s_row[kMaxSpan];
  __shared__ long long s_src[kMaxSpan];
  __shared__ unsigned long long s_dst[kMaxSpan];
  __shared__ int s_prev, s_next, s_first, s_last;
  __shared__ int s_done[2], s_b0[2], s_b1[2];
  const int b = blockIdx.x;
  const int G = gridDim.x;
  const int tid = threadIdx.x;
  const int g = tid / a.tu;
  const int lt = tid - g * a.tu;
  const int k0 = b * a.span;
  const int n = max(0, min(a.span, a.E - k0));
  for (int i = tid; i < n; i += blockDim.x) {
    s_row[i] = __ldg(a.rows + k0 + i);
    s_src[i] = static_cast<long long>(__ldg(a.perm + k0 + i)) * a.ld;
  }
  if (tid == 0) {
    s_prev = k0 > 0 && n > 0 ? __ldg(a.rows + k0 - 1) : 0;
    s_next = n > 0 && k0 + n < a.E ? __ldg(a.rows + k0 + n) : 0;
    s_first = a.E > 0 ? __ldg(a.rows) : a.R;
    s_last = a.E > 0 ? __ldg(a.rows + a.E - 1) : a.R - 1;
  }
  __syncthreads();
  const bool head_cut = n > 0 && k0 > 0 && s_prev == s_row[0];
  const bool tail_cut = n > 0 && k0 + n < a.E && s_next == s_row[n - 1];

  // rows no id names: before the first id and after the last, dealt over
  // all blocks; then the gaps before this span's ids
  const long long lead = min(max(static_cast<long long>(s_first), 0LL),
                             static_cast<long long>(a.R));
  const long long trail = min(max(s_last + 1LL, 0LL),
                              static_cast<long long>(a.R));
  const long long n_edge_rows = lead + (a.R - trail);
  for (long long j = b; j < n_edge_rows; j += G) {
    zero_row(a.out, j < lead ? j : trail + (j - lead), a.H, a.out_vec);
  }
  // the groups: group g walks the positions [ga, gb). A finished run goes
  // to dU; a run cut only by the block's start or end to the block's head
  // or tail slot; a piece cut by a boundary between groups to the group's
  // first (began before the group) or last (goes on past it) slot
  float* head = a.partial + 2LL * b * a.hp;
  float* tail = head + a.hp;
  struct Group {
    int ga, gb;
    bool head, tail, through;  // through: one run going on into the next
  };
  auto group = [&](int gi) {
    Group q;
    q.ga = min(gi * a.gp, n);
    q.gb = min(q.ga + a.gp, n);
    const bool has = q.ga < q.gb;
    q.head = has && (q.ga > 0 ? s_row[q.ga - 1] == s_row[q.ga] : head_cut);
    q.tail = has && (q.gb < n ? s_row[q.gb] == s_row[q.gb - 1] : tail_cut);
    q.through = has && s_row[q.ga] == s_row[q.gb - 1] && q.tail && q.gb < n;
    return q;
  };
  // per position: where the piece that ends there goes; and whether a
  // gap of unnamed rows lies before it
  bool gap = false;
  for (int k = tid; k < n; k += blockDim.x) {
    const long long lo = k > 0 ? s_row[k - 1] : (k0 > 0 ? s_prev : s_row[0]);
    gap |= max(lo + 1, 0LL) < min(static_cast<long long>(s_row[k]),
                                  static_cast<long long>(a.R));
    const int gk = k / a.gp;
    const Group q = group(gk);
    const int r = s_row[k];
    unsigned long long d = 0;
    if (k == q.gb - 1 || s_row[k + 1] != r) {
      d = 1;
      if (r >= 0 && r < a.R) {
        float* slots = s_slot + 2 * gk * a.hp;
        float* to;
        if (s_row[q.ga] == r && q.head) {
          to = q.ga == 0 && !q.through ? head : slots;
        } else if (k == q.gb - 1 && q.tail) {
          to = q.gb == n ? tail : slots + a.hp;
        } else {
          to = a.out + static_cast<long long>(r) * a.H;
        }
        d = reinterpret_cast<unsigned long long>(to);
      }
    }
    s_dst[k] = d;
  }
  if (__syncthreads_or(gap)) {
    for (int i = 0; i < n; ++i) {
      const long long lo =
          i > 0 ? s_row[i - 1] : (k0 > 0 ? s_prev : s_row[0]);
      const long long hi = min(static_cast<long long>(s_row[i]),
                               static_cast<long long>(a.R));
      for (long long r = max(lo + 1, 0LL); r < hi; ++r) {
        zero_row(a.out, r, a.H, a.out_vec);
      }
    }
  }

  const Group q = group(g);
  const int ga = q.ga, gb = q.gb;
  if (ga < gb) {
    for_units<T, kVec>(a, lt, [&](auto w, int col) {
      walk<T, decltype(w)::value>(a.dZ, col, gb - ga, s_src + ga,
                                  s_dst + ga);
    });
  }
  __syncthreads();

  // a run that began in an earlier group ends in this one (or goes on past
  // the block from here): add its pieces in group order
  if (ga < gb && q.head && ga > 0 && !q.through) {
    const int r = s_row[ga];
    int lo = 0, hi = ga;  // its first position in the block
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_row[mid] < r) lo = mid + 1; else hi = mid;
    }
    const bool from_before = lo == 0 && head_cut;
    const bool past = gb == n && q.tail && s_row[ga] == s_row[gb - 1];
    float* dst = from_before ? head : past ? tail
        : a.out + static_cast<long long>(r) * a.H;
    if (r >= 0 && r < a.R) {
      for_units<T, kVec>(a, lt, [&](auto w, int col) {
        chain<decltype(w)::value>(s_slot, a.hp, col, lo / a.gp, from_before,
                                  g, dst);
      });
    }
  }

  // tickets for the runs cut by the block's start and end, the head's on
  // lane 0 and the tail's on lane 1 at once; the block that completes a
  // row's count adds its slots
  __syncthreads();
  if (tid < 2) {
    s_done[tid] = -1;
    const int rh = n > 0 ? s_row[0] : -1;
    const int rt = n > 0 ? s_row[n - 1] : -1;
    const bool whole = rh == rt;
    // the head run ends in this span unless the span lies inside one run
    // that goes on; a run both cut at the start and going on takes one
    // ticket, the head's
    const bool ends_here = !(whole && tail_cut);
    const int r = tid == 0 ? rh : rt;
    const bool take = tid == 0 ? head_cut : tail_cut && !(whole && head_cut);
    if (take && r >= 0 && r < a.R) {
      const unsigned long long ub = static_cast<unsigned>(b);
      const unsigned long long t =
          tid == 1 ? 1ull + ub + (ub << 24)                      // b0
          : ends_here ? (ub << 44) - ub                          // b1
          : 1ull;                                                // between
      const unsigned long long now = add_acq_rel(a.counters + r, t) + t;
      if ((now & kSumMask) == 0) {
        s_done[tid] = r;
        s_b0[tid] = static_cast<int>((now >> 24) & 0xfffff);
        s_b1[tid] = static_cast<int>(now >> 44);
        a.counters[r] = 0;
      }
    }
  }
  __syncthreads();
  for (int d = 0; d < 2; ++d) {
    const int r = s_done[d];
    if (r < 0) continue;
    // group g adds its share of the slots, then group 0 the groups' sums
    const int count = s_b1[d] - s_b0[d] + 1;
    const int per = (count + a.ng - 1) / a.ng;
    const int s_lo = min(g * per, count);
    const int s_hi = min(s_lo + per, count);
    float* dst = a.out + static_cast<long long>(r) * a.H;
    for_units<T, kVec>(a, lt, [&](auto w, int col) {
      constexpr int Wc = decltype(w)::value;
      float acc[Wc];
#pragma unroll
      for (int j = 0; j < Wc; ++j) acc[j] = 0.f;
      merge<Wc>(a.partial, a.hp, col, s_b0[d], s_lo, s_hi, acc);
      store<Wc>((a.ng == 1 ? dst : s_slot + g * a.hp) + col, acc);
    });
    if (a.ng > 1) {
      __syncthreads();
      if (g == 0) {
        for_units<T, kVec>(a, lt, [&](auto w, int col) {
          constexpr int Wc = decltype(w)::value;
          float acc[Wc];
#pragma unroll
          for (int j = 0; j < Wc; ++j) acc[j] = 0.f;
          for (int q = 0; q < a.ng && q * per < count; ++q) {
#pragma unroll
            for (int j = 0; j < Wc; ++j) acc[j] += s_slot[q * a.hp + col + j];
          }
          store<Wc>(dst + col, acc);
        });
      }
      __syncthreads();
    }
  }
}

template <typename T>
int launch(const void* dZ, long long ld, const void* perm,
           const void* rows_sorted, int E, int H, int R, int span, void* out,
           void* partial, void* counters, void* stream) {
  constexpr int W = Unit16<T>::kWidth;
  if (E < 0 || H < 0 || R < 0 || span < 1 || span > kMaxSpan || ld < H) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = E > 0 ? (E + span - 1LL) / span : 1;
  if (blocks >= kMaxGrid) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(blocks);
  if (R == 0 || H == 0) return static_cast<int>(cudaGetLastError());
  Args<T> a;
  a.dZ = static_cast<const T*>(dZ);
  a.ld = ld;
  a.perm = static_cast<const int*>(perm);
  a.rows = static_cast<const int*>(rows_sorted);
  a.E = E; a.H = H; a.R = R; a.span = span;
  a.out_vec = H % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  a.hp = (H + kSlotAlign - 1) / kSlotAlign * kSlotAlign;
  a.out = static_cast<float*>(out);
  a.partial = static_cast<float*>(partial);
  a.counters = static_cast<unsigned long long*>(counters);
  // 16-byte units where every row starts on 16 bytes
  const bool vec = ld % W == 0 && reinterpret_cast<uintptr_t>(dZ) % 16 == 0;
  a.nvec = vec ? H / W : 0;
  a.nunits = a.nvec + (H - a.nvec * W);
  a.tu = min(kMaxThreads, (a.nunits + 31) / 32 * 32);
  // as many groups as fit the block's threads and the groups' slots in
  // shared memory, none of them empty at a full span
  int ng = min(kMaxThreads / a.tu, span);
  ng = max(1, min(ng, kMaxGroupSmem / (2 * a.hp * 4)));
  a.gp = (span + ng - 1) / ng;
  a.ng = (span + a.gp - 1) / a.gp;
  const size_t smem = a.ng > 1 ? 2ull * a.ng * a.hp * sizeof(float) : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    segsum_kernel<T, true><<<grid, a.ng * a.tu, smem, s>>>(a);
  } else {
    segsum_kernel<T, false><<<grid, a.ng * a.tu, smem, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// `partial`: 2 * grid * roundup(H, 4) floats, grid = ceil(E / span)
// (at least 1, below 2^20); `counters`: R 64-bit ints, all 0 before the
// first call (each call leaves them 0)
int expand_segsum_f32(const void* dZ, long long ld, const void* perm,
                      const void* rows_sorted, int E, int H, int R, int span,
                      void* out, void* partial, void* counters,
                      void* stream) {
  return launch<float>(dZ, ld, perm, rows_sorted, E, H, R, span, out,
                       partial, counters, stream);
}

int expand_segsum_bf16(const void* dZ, long long ld, const void* perm,
                       const void* rows_sorted, int E, int H, int R, int span,
                       void* out, void* partial, void* counters,
                       void* stream) {
  return launch<__nv_bfloat16>(dZ, ld, perm, rows_sorted, E, H, R, span,
                               out, partial, counters, stream);
}

}  // extern "C"
