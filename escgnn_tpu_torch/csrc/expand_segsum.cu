// Sorted segment sum (K1): every float segment sum of the port, and the
// backward of every row gather.
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
// `rows_sorted` is non-decreasing (a stable sort of the ids), so row r
// owns one run of the sorted order. A position whose id lies outside
// [0, R) (the sorted views send masked rows to R, past every run) is
// dropped: its dZ row is never loaded. The TPU kernel turned each edge
// tile into a one-hot matmul and carried the row sums across its
// sequential grid. On Hopper the blocks run in parallel and in no order,
// and the sums come in three regimes: dense ones (the flagship's E 12288
// edges on R 3712 rows, with one run of 2667 padding edges), sparse ones
// (ids with gaps of thousands of unnamed rows), and short ones (a few
// thousand positions or fewer, where the bound is under a microsecond and
// the kernel's round trips to memory are the time). One launch does all:
//
//   * the merge path: the R row ends and the E sorted positions, merged
//     (position k comes before the end of row i iff rows_sorted[k] <= i),
//     weigh R + kPosWeight * E items (a position, which the kernel reads,
//     weighs 2; a row end, which it writes, 1), and block b takes the
//     `share` items from b * share (the plan:
//     escgnn_tpu_torch/ops/expand_cuda.py::segsum_plan, one share per SM).
//     Two warps find the block's two ends, each searching the R / 2 + 1
//     candidate position counts 128 at a time (2 rounds at the flagship),
//     the last round's load giving the end's row too. So a block writes
//     at most share + 1 rows and reads at most share / 2 + snap + 1
//     positions: rows no id names are zeroed by the whole grid, each
//     block its own, after its sums;
//   * an end that falls inside a run moves back to the run's start when
//     the start lies under `snap` positions before it (64 in a short
//     share of at most kShortShare items, else 32; ballots of a warp over
//     the staged ids), and an end just past a row's run moves past the
//     row's end too. So no run shorter than snap is ever cut between
//     blocks, and a short sum runs in one phase: find the ends, stage
//     rows_sorted and perm, sum, write (a larger snap in a large share
//     would swell its blocks' slices past one batch of loads);
//   * in a block, `ng` groups of threads take equal slices of the
//     positions. In a group a thread owns a unit of W columns: 16 bytes
//     of a row (4 f32 or 8 bf16) where every row of dZ and dU starts on 16
//     bytes, else 4 bf16, else one column (one kernel per unit: no
//     branches on it). It loads up to kBatch gathered rows dZ[perm[k]] of
//     its unit at once (4 where its slice is that short), the perm gather
//     fused into the load, then adds them run by run in ascending k and
//     writes each finished row;
//   * a piece of a run cut by a group boundary goes to the group's first
//     or last slot in shared memory; after a __syncthreads() the group
//     where such a run ends adds its pieces in group order and writes the
//     row. A run cut by the block's start or end (only runs of snap or
//     more) is written, so summed, to the block's head or tail slot of
//     `partial`;
//   * the blocks b0 < ... < b1 that share a cut run each write their
//     slot, then add a ticket to the row's 64-bit counter: after a
//     __syncthreads(), one lane per cut run (the head's and the tail's at
//     once) adds it with an acquire-release atomic of gpu scope, which
//     publishes the block's slot writes as a fence would. The low 24 bits
//     sum 1 + b0 from b0, -b1 from b1 and 1 from each block between: 0
//     exactly when the last of them arrives (no subset of the tickets sums
//     to 0, since b0 >= 0, nor to a multiple of 2^24, since the grid is
//     under 2^20; a share of at least one position's weight leaves no
//     block inside a run without a position of it, so each takes one);
//     b0 and b1 add their index into bits 24-43 and 44-63. So the atomic
//     that completes the count returns b0 and b1 too, and its block adds
//     the slots tail(b0), head(b0 + 1), ..., head(b1): each group adds a
//     contiguous share of them in order, all loaded at once, then group 0
//     adds the groups' sums in order and writes the row. That block sets
//     the counter back to 0 for the next call: the wrapper zeroes the
//     counters once per device, and no call needs a memset. The long
//     padding run of the flagship spans ~25 blocks, whose slots 8 groups
//     load in one round trip.
//
// Every sum is taken in a fixed order, so the result is bit-identical from
// run to run: the counters decide only which block adds a cut row.
//
// Bound on an H100 SXM: bytes. It must read the dZ rows of the positions
// in range once (E*H*4 bytes for f32), perm and rows_sorted once and write
// dU once: at the flagship shapes (E 12288, R 3712, H 256) 16.5 MB, 4.9 us
// at 3.35 TB/s; the E*H adds are negligible next to that. The partial
// slots add at most 2*H*4 bytes per block, written and read once through
// L2. A short sum is bound by its chain of round trips instead: the
// search's two, the staging's and dZ's.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int kBatch = 16;        // rows a thread has in flight at once
constexpr int kProbes = 4;        // merge-path candidates a lane probes a round
constexpr int kPosWeight = 2;     // merge-path items a sorted position weighs
constexpr int kMaxShare = 1024;   // most merge-path items one block takes
constexpr int kSnap = 64;         // a short share's end moves back this far
constexpr int kShortShare = 128;  // at most: a short share; a longer one's
                                  // end moves back kSnap / 2 at most
constexpr int kMaxStage = 608;    // positions a block stages
constexpr int kMaxNamed = kMaxShare + kPosWeight + 1;  // rows a block marks
constexpr int kMaxThreads = 512;  // threads of a block, one block per SM
constexpr int kSlotAlign = 4;     // partial slots start on 16 bytes
constexpr int kMaxGrid = 1 << 20; // blocks: b0 and b1 fit 20 bits
constexpr int kMaxGroupSmem = 16 * 1024;  // the groups' slots in a block
constexpr unsigned long long kSumMask = (1ull << 24) - 1;
// a block's ends weigh share apart, each within kPosWeight of its mark:
// at most share / kPosWeight + 1 positions, share + kPosWeight - 1 rows
static_assert(kMaxShare / kPosWeight + kSnap + 2 <= kMaxStage,
              "staging too small");
static_assert(kSnap == 64, "two ballots of a warp cover the snap window");
static_assert(kShortShare / kPosWeight + kSnap + 2 <= kMaxStage,
              "staging too small");

// W columns of one row of T (the unit a thread loads at once): loaded
// raw, added into f32 sums
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

template <> struct Cols<float, 1> {
  using Raw = float;
  __device__ static Raw load(const float* p) { return __ldg(p); }
  __device__ static void add(float (&a)[1], const Raw& v) { a[0] += v; }
};

// a bf16 is the high half of its f32; element 2j of a word is the low half
__device__ __forceinline__ void add_bf16x2(float* a, unsigned w) {
  a[0] += __uint_as_float(w << 16);
  a[1] += __uint_as_float(w & 0xffff0000u);
}

template <> struct Cols<__nv_bfloat16, 8> {
  using Raw = uint4;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ static void add(float (&a)[8], const Raw& v) {
    add_bf16x2(a, v.x); add_bf16x2(a + 2, v.y);
    add_bf16x2(a + 4, v.z); add_bf16x2(a + 6, v.w);
  }
};

template <> struct Cols<__nv_bfloat16, 4> {
  using Raw = uint2;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ static void add(float (&a)[4], const Raw& v) {
    add_bf16x2(a, v.x); add_bf16x2(a + 2, v.y);
  }
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

// W sums to p: as float4s for a unit of 4 or 8 (dU rows, slots and
// columns then all start on 16 bytes)
template <int W>
__device__ __forceinline__ void store(float* p, const float (&a)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int j = 0; j < W; j += 4) {
      *reinterpret_cast<float4*>(p + j) =
          make_float4(a[j], a[j + 1], a[j + 2], a[j + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) p[j] = a[j];
  }
}

template <typename T>
struct Args {
  const T* dZ;
  long long ld;          // row stride of dZ, in elements
  const int* perm;
  const int* rows;       // rows_sorted
  int E, H, R, share;
  int ng, tu;            // groups, and threads per group
  int nunits;            // units (W columns) of a row
  int hp;                // floats from one slot to the next
  int snap;              // kSnap for a short share, else kSnap / 2
  float* out;
  float* partial;        // 2 slots (head, tail) of hp floats per block
  unsigned long long* counters;  // per row: ticket sum, b0, b1
};

// the merge path's last point at weight d: (i, k), the most sorted
// positions k with k == 0 or key(k - 1) + kPosWeight * k <= d, key(x) =
// x clamped to [0, R], and the row ends i = min(d - kPosWeight * k,
// key(rows[k])) before it (R past the last position). A key is at most
// R, so k lies in [(d - R) / kPosWeight, d / kPosWeight]: a stretch of at
// most R / kPosWeight + 1. The warp probes kWays candidates a round,
// kProbes a lane, all loaded at once: strided while kWays or more are
// left, keeping the stretch between the last that holds and the first
// that fails; then each candidate left, whose first failure gives k and
// whose load gives key(rows[k]).
__device__ int2 split_point(const int* __restrict__ rows, int E, int R,
                            long long d, int lane) {
  constexpr int kWays = 32 * kProbes;
  const auto weighs = [&](int k, int row_before) {
    return min(max(row_before, 0), R) +
           static_cast<long long>(kPosWeight) * k <= d;
  };
  int lo = static_cast<int>(
      max(0LL, min(static_cast<long long>(E), (d - R) / kPosWeight)));
  int hi = static_cast<int>(min(static_cast<long long>(E), d / kPosWeight));
  while (hi - lo >= kWays) {  // lo holds, the answer lies in [lo, hi]
    const long long len = hi - lo;
    bool fails[kProbes];
#pragma unroll
    for (int q = 0; q < kProbes; ++q) {
      const int c = lo + static_cast<int>(len * (lane + 32 * q + 1) / kWays);
      fails[q] = !weighs(c, __ldg(rows + c - 1));
    }
    int first = kWays;  // the first failing probe
#pragma unroll
    for (int q = kProbes - 1; q >= 0; --q) {
      const unsigned m = __ballot_sync(0xffffffffu, fails[q]);
      if (m != 0) first = 32 * q + __ffs(m) - 1;
    }
    const int new_hi = first == kWays
        ? hi : lo + static_cast<int>(len * (first + 1) / kWays) - 1;
    if (first > 0) lo += static_cast<int>(len * first / kWays);
    hi = new_hi;
  }
  // probe j: rows[lo + j], the row before candidate lo + j + 1; probe
  // hi - lo only gives key(rows[hi]) and counts as failing
  const int len = hi - lo;
  int x[kProbes];
#pragma unroll
  for (int q = 0; q < kProbes; ++q) {
    const int j = lane + 32 * q;
    x[q] = j <= len && lo + j < E ? __ldg(rows + lo + j) : R;
  }
  int first = kWays;
#pragma unroll
  for (int q = kProbes - 1; q >= 0; --q) {
    const int j = lane + 32 * q;
    const bool fails = j <= len && (j == len || !weighs(lo + j + 1, x[q]));
    const unsigned m = __ballot_sync(0xffffffffu, fails);
    if (m != 0) first = 32 * q + __ffs(m) - 1;
  }
  int mine = x[0];  // this lane's load in the first failing probe's round
#pragma unroll
  for (int q = 1; q < kProbes; ++q) {
    if (q == first / 32) mine = x[q];
  }
  const int row = __shfl_sync(0xffffffffu, mine, first % 32);
  const int k = lo + first;
  const int i = static_cast<int>(
      min(d - static_cast<long long>(kPosWeight) * k,
          static_cast<long long>(min(max(row, 0), R))));
  return make_int2(i, k);
}

// the first k in [lo, hi] with row(k) >= key, given row(hi) >= key
template <typename F>
__device__ __forceinline__ int first_at_least(F row, int lo, int hi,
                                              int key) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (row(mid) < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// the runs of a group's positions [ga, gb), for the W columns from col:
// a run's sum goes to first_dst if it is row r_first's, to last_dst if it
// is row r_last's, else to its row of dU
template <typename T, int W, int KB>
__device__ __forceinline__ void walk(const T* __restrict__ dZ, long long ld,
                                     int col, int ga, int gb,
                                     const int* srow, const int* sperm,
                                     float* out, int H, int r_first,
                                     float* first_dst, int r_last,
                                     float* last_dst) {
  using C = Cols<T, W>;
  float acc[W];
#pragma unroll
  for (int j = 0; j < W; ++j) acc[j] = 0.f;
  for (int base = ga; base < gb; base += KB) {
    const int m = min(KB, gb - base);
    typename C::Raw v[KB];
#pragma unroll
    for (int i = 0; i < KB; ++i) {
      v[i] = i < m ? C::load(dZ + sperm[base + i] * ld + col)
                   : typename C::Raw{};
    }
#pragma unroll
    for (int i = 0; i < KB; ++i) {
      if (i < m) {
        C::add(acc, v[i]);
        const int k = base + i;
        const int r = srow[k];
        if (k == gb - 1 || srow[k + 1] != r) {
          float* to = r == r_first ? first_dst
                      : r == r_last ? last_dst
                      : out + static_cast<long long>(r) * H;
          store<W>(to + col, acc);
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

// W is the unit of columns a thread owns: 16 bytes of a row (4 f32 or 8
// bf16) where every row of dZ and dU starts on 16 bytes, else 4 bf16 (8
// bytes), else one column
template <typename T, int W>
__global__ void __launch_bounds__(kMaxThreads, 1) segsum_kernel(Args<T> a) {
  extern __shared__ float4 s_dyn[];
  float* s_slot = reinterpret_cast<float*>(s_dyn);  // [ng][first, last][hp]
  __shared__ int s_row[kMaxStage];
  __shared__ int s_perm[kMaxStage];
  __shared__ unsigned char s_named[kMaxNamed];
  __shared__ int s_split[2], s_pos[2];
  __shared__ int s_done[2], s_b0[2], s_b1[2];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int g = tid / a.tu;
  const int lt = tid - g * a.tu;
  const int R = a.R, E = a.E, H = a.H;
  const long long items = R + static_cast<long long>(kPosWeight) * E;
  const long long d0 = min(static_cast<long long>(b) * a.share, items);
  const long long d1 = min(static_cast<long long>(b + 1) * a.share, items);
  const int named_len = a.share + kPosWeight + 1;
  for (int j = tid; j < named_len; j += blockDim.x) s_named[j] = 0;
  // the block's two ends on the merge path, one warp each: (row ends,
  // positions) before each, i + kPosWeight * k at most d (the last point)
  for (int w = tid >> 5; w < 2; w += blockDim.x >> 5) {
    const int2 ik = split_point(a.rows, E, R, w == 0 ? d0 : d1, tid & 31);
    if ((tid & 31) == 0) {
      s_split[w] = ik.x;
      s_pos[w] = ik.y;
    }
  }
  __syncthreads();
  const int ri0 = s_split[0], ri1 = s_split[1];
  // past the last row end: only positions outside [0, R) are left
  if (ri0 >= R) return;
  const int rk0 = s_pos[0], rk1 = s_pos[1];

  // stage rows_sorted and perm from snap before the block's start to one
  // past its end, and mark the rows the staged positions name
  const int base = max(0, rk0 - a.snap);
  const int top = min(E, rk1 + 1);
  for (int j = base + tid; j < top; j += blockDim.x) {
    const int r = __ldg(a.rows + j);
    s_row[j - base] = r;
    s_perm[j - base] = __ldg(a.perm + j);
    const int f = r - ri0;
    if (f >= 0 && f < named_len && r < R) s_named[f] = 1;
  }
  __syncthreads();

  // the ends moved to run starts: (i, k) with k inside the run of row i
  // goes back to the run's start if that lies under snap positions
  // before k, and (i, k) just past the run of row i goes on to (i + 1, k)
  // (each warp finds them, its lanes over the snap positions before k,
  // 32 at a time)
  auto row_at = [&](int k) { return s_row[k - base]; };
  auto settle = [&](int& i, int& k) {
    if (i >= R || k == 0 || row_at(k - 1) != i) return;
    if (k == E || row_at(k) != i) {
      ++i;
      return;
    }
    // bit j: position k - snap + j is in the run (the top bits); the run
    // starts before the window if the window's first position, past 0, is
    const int p = k - a.snap + (tid & 31);
    unsigned long long m =
        __ballot_sync(0xffffffffu, p >= 0 && row_at(p) == i);
    if (a.snap == kSnap) {
      m |= static_cast<unsigned long long>(__ballot_sync(
               0xffffffffu, p + 32 >= 0 && row_at(p + 32) == i)) << 32;
    }
    if (!(m & 1ull) || k == a.snap) k = k - a.snap + __ffsll(m) - 1;
  };
  int i0 = ri0, k0 = rk0, i1 = ri1, k1 = rk1;
  settle(i0, k0);
  settle(i1, k1);
  // the block's positions named by a row in [0, R) (ids outside it lie
  // at the ends of the sorted order): never loaded
  if (k0 < k1 && row_at(k0) < 0) k0 = first_at_least(row_at, k0, k1, 0);
  if (k0 < k1 && row_at(k1 - 1) >= R) {
    k1 = first_at_least(row_at, k0, k1, R);
  }
  const int n = k1 - k0;
  const int* srow = s_row + (k0 - base);
  const int* sperm = s_perm + (k0 - base);
  const bool head_cut = n > 0 && k0 > 0 && srow[-1] == srow[0];
  const bool tail_cut = n > 0 && k1 < E && srow[n] == srow[n - 1];

  // the groups: group gi walks the positions [gi * gp, (gi + 1) * gp) of
  // the block. A finished run goes to dU; a run cut only by the block's
  // start or end to the block's head or tail slot; a piece cut by a
  // boundary between groups to the group's first (began before the
  // group) or last (goes on past it) slot
  const int gp = max(1, (n + a.ng - 1) / a.ng);
  float* head = a.partial + 2LL * b * a.hp;
  float* tail = head + a.hp;
  const int ga = g < a.ng ? min(g * gp, n) : n;
  const int gb = g < a.ng ? min(ga + gp, n) : n;
  const bool has = ga < gb;
  // the group's first run began before it; its last goes on past it; one
  // run fills it and goes on into the next group
  const bool q_head = has && (ga > 0 ? srow[ga - 1] == srow[ga] : head_cut);
  const bool q_tail = has && (gb < n ? srow[gb] == srow[gb - 1] : tail_cut);
  const bool q_through = has && srow[ga] == srow[gb - 1] && q_tail && gb < n;
  if (has) {
    float* slots = s_slot + 2 * g * a.hp;
    const int r_first = srow[ga], r_last = srow[gb - 1];
    float* last_dst = !q_tail ? a.out + static_cast<long long>(r_last) * H
                      : gb == n ? tail : slots + a.hp;
    float* first_dst = q_head ? (ga == 0 && !q_through ? head : slots)
                       : r_first == r_last ? last_dst
                       : a.out + static_cast<long long>(r_first) * H;
    for (int c = lt * W; c < H; c += a.tu * W) {
      // a short slice in a short batch: fewer idle loads to issue
      if (gb - ga <= kBatch / 4) {
        walk<T, W, kBatch / 4>(a.dZ, a.ld, c, ga, gb, srow, sperm, a.out, H,
                               r_first, first_dst, r_last, last_dst);
      } else {
        walk<T, W, kBatch>(a.dZ, a.ld, c, ga, gb, srow, sperm, a.out, H,
                           r_first, first_dst, r_last, last_dst);
      }
    }
  }

  // a run that began in an earlier group ends in this one (or goes on past
  // the block from here): add its pieces in group order
  if (__syncthreads_or(q_head && ga > 0)) {
    if (q_head && ga > 0 && !q_through) {
      const int r = srow[ga];
      // its first position in the block
      const int lo = first_at_least([&](int k) { return srow[k]; }, 0, ga, r);
      const bool from_before = lo == 0 && head_cut;
      const bool past = gb == n && q_tail && srow[ga] == srow[gb - 1];
      float* dst = from_before ? head : past ? tail
          : a.out + static_cast<long long>(r) * H;
      for (int c = lt * W; c < H; c += a.tu * W) {
        chain<W>(s_slot, a.hp, c, lo / gp, from_before, g, dst);
      }
    }
  }
  // rows no staged position names: 0, dealt over the groups (the marks
  // are complete: a __syncthreads() lies between)
  if (g < a.ng) {
    for (int r = i0 + g; r < i1; r += a.ng) {
      if (!s_named[r - ri0]) {
        float* p = a.out + static_cast<long long>(r) * H;
        const float zero[W] = {};
        for (int c = lt * W; c < H; c += a.tu * W) store<W>(p + c, zero);
      }
    }
  }

  if (!(head_cut || tail_cut)) return;

  // tickets for the runs cut by the block's start and end, the head's on
  // lane 0 and the tail's on lane 1 at once; the block that completes a
  // row's count adds its slots
  __syncthreads();
  if (tid < 2) {
    s_done[tid] = -1;
    const int rh = srow[0];
    const int rt = srow[n - 1];
    const bool whole = rh == rt;
    // the head run ends in this span unless the span lies inside one run
    // that goes on; a run both cut at the start and going on takes one
    // ticket, the head's
    const bool ends_here = !(whole && tail_cut);
    const int r = tid == 0 ? rh : rt;
    const bool take = tid == 0 ? head_cut : tail_cut && !(whole && head_cut);
    if (take) {
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
    float* dst = a.out + static_cast<long long>(r) * H;
    if (g < a.ng) {
      for (int c = lt * W; c < H; c += a.tu * W) {
        float acc[W] = {};
        merge<W>(a.partial, a.hp, c, s_b0[d], s_lo, s_hi, acc);
        store<W>((a.ng == 1 ? dst : s_slot + g * a.hp) + c, acc);
      }
    }
    if (a.ng > 1) {
      __syncthreads();
      if (g == 0) {
        for (int c = lt * W; c < H; c += a.tu * W) {
          float acc[W] = {};
          for (int q = 0; q < a.ng && q * per < count; ++q) {
#pragma unroll
            for (int j = 0; j < W; ++j) acc[j] += s_slot[q * a.hp + c + j];
          }
          store<W>(dst + c, acc);
        }
      }
      __syncthreads();
    }
  }
}

// the widest unit of W columns every row of dZ (stride ld, base dZ) and
// of dU starts on, in bytes of T: 16 (4 f32, 8 bf16), 8 (4 bf16) or one
template <typename T>
int unit_width(long long ld, int H, const void* dZ, const void* out) {
  const auto on = [&](int w, unsigned bytes) {
    return H % w == 0 && ld % w == 0 &&
           reinterpret_cast<uintptr_t>(dZ) % bytes == 0 &&
           reinterpret_cast<uintptr_t>(out) % 16 == 0;
  };
  if (sizeof(T) == 4) return on(4, 16) ? 4 : 1;
  return on(8, 16) ? 8 : on(4, 8) ? 4 : 1;
}

template <typename T, int W>
int launch_w(Args<T> a, int grid, cudaStream_t s) {
  a.nunits = a.H / W;
  // a group: the units of a row, in a power of two of threads up to a
  // warp (so no group straddles two warps), else in whole warps
  int tu = 1;
  while (tu < a.nunits && tu < 32) tu *= 2;
  if (a.nunits > 32) tu = min(kMaxThreads, (a.nunits + 31) / 32 * 32);
  a.tu = tu;
  // as many groups as fit the block's threads and the groups' slots in
  // shared memory, and no more than a block has positions or rows
  const int per_warp = max(1, 32 / tu);
  int ng = min(kMaxThreads / tu, kMaxGroupSmem / (2 * a.hp * 4));
  ng = min(ng, (a.share + a.snap + per_warp - 1) / per_warp * per_warp);
  a.ng = max(1, ng);
  const size_t smem = a.ng > 1 ? 2ull * a.ng * a.hp * sizeof(float) : 0;
  // two warps at least: one for each end of the block's share
  const int threads = max(64, (a.ng * tu + 31) / 32 * 32);
  segsum_kernel<T, W><<<grid, threads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* dZ, long long ld, const void* perm,
           const void* rows_sorted, int E, int H, int R, int share,
           void* out, void* partial, void* counters, void* stream) {
  // a share of at least one position's weight: no block falls inside a
  // run with no position of it, so every block a cut run crosses tickets
  if (E < 0 || H < 0 || R < 0 || share < kPosWeight || share > kMaxShare ||
      ld < H) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long items = R + static_cast<long long>(kPosWeight) * E;
  const long long blocks = items > 0 ? (items + share - 1) / share : 1;
  if (blocks >= kMaxGrid) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(blocks);
  if (R == 0 || H == 0) return static_cast<int>(cudaGetLastError());
  Args<T> a;
  a.dZ = static_cast<const T*>(dZ);
  a.ld = ld;
  a.perm = static_cast<const int*>(perm);
  a.rows = static_cast<const int*>(rows_sorted);
  a.E = E; a.H = H; a.R = R; a.share = share;
  a.hp = (H + kSlotAlign - 1) / kSlotAlign * kSlotAlign;
  a.snap = share <= kShortShare ? kSnap : kSnap / 2;
  a.out = static_cast<float*>(out);
  a.partial = static_cast<float*>(partial);
  a.counters = static_cast<unsigned long long*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w = unit_width<T>(ld, H, dZ, out);
  if constexpr (sizeof(T) == 2) {
    if (w == 8) return launch_w<T, 8>(a, grid, s);
  }
  return w == 4 ? launch_w<T, 4>(a, grid, s) : launch_w<T, 1>(a, grid, s);
}

}  // namespace

extern "C" {

// `partial`: 2 * grid * roundup(H, 4) floats,
// grid = ceil((R + kPosWeight * E) / share)
// (at least 1, below 2^20); `counters`: R 64-bit ints, all 0 before the
// first call (each call leaves them 0)
int expand_segsum_f32(const void* dZ, long long ld, const void* perm,
                      const void* rows_sorted, int E, int H, int R, int share,
                      void* out, void* partial, void* counters,
                      void* stream) {
  return launch<float>(dZ, ld, perm, rows_sorted, E, H, R, share, out,
                       partial, counters, stream);
}

int expand_segsum_bf16(const void* dZ, long long ld, const void* perm,
                       const void* rows_sorted, int E, int H, int R, int share,
                       void* out, void* partial, void* counters,
                       void* stream) {
  return launch<__nv_bfloat16>(dZ, ld, perm, rows_sorted, E, H, R, share,
                               out, partial, counters, stream);
}

}  // extern "C"
