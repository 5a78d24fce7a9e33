// Native ESC featurizer core.
//
// Computes the per-edge structural count rows of the ESC-GNN encoding
// (bucket contract in ../featurize/layout.py, mirroring reference
// utils_edge_efficient.py:20-151): per edge (u, v) of the canonical
// (self-looped) edge list, the union of the h-hop ego-nets of u and v is
// histogrammed over [in-subgraph out-degree | z0 | z1 | int resistance
// distance | base-6 packed edge-label 4-tuples]. Bit-equal to the
// vectorized numpy encoder (escgnn.py esc_encode) — equality-tested in
// tests/test_torch_port_data.py.
//
// Resistance distance uses the connected-Laplacian identity
// pinv(L) = inv(L + J/s) - J/s with Gauss-Jordan inversion; a residual
// check (L X L == L) guards the connectivity assumption and the whole
// call returns status 1 on failure so the Python wrapper falls back to
// the numpy/SVD path.
//
// C ABI + ctypes (see escfeat.py); OpenMP across edges.

#include <omp.h>

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

struct Layout {
  int use_rd;
  int deg_buckets = 200;
  int z_classes = 100;
  int rd_buckets = 100;
  int edge_type_buckets = 1300;
  int z0_off() const { return deg_buckets; }
  int z1_off() const { return deg_buckets + z_classes; }
  int rd_off() const { return deg_buckets + 2 * z_classes; }
  int et_off() const {
    return deg_buckets + 2 * z_classes + (use_rd ? rd_buckets : 0);
  }
  int dim() const { return et_off() + edge_type_buckets; }
};

struct Result {
  int64_t E = 0;
  std::vector<int32_t> edges_src, edges_dst;
  std::vector<uint8_t> loop_mask;
  std::vector<int32_t> enc_idx;
  std::vector<float> enc_cnt;
  std::vector<int64_t> offsets;
  int status = 0;
};

// Gauss-Jordan inverse with partial pivoting; returns false on a
// (near-)singular pivot.
bool invert(std::vector<double> &a, int s) {
  std::vector<double> inv(s * s, 0.0);
  for (int i = 0; i < s; i++) inv[i * s + i] = 1.0;
  for (int col = 0; col < s; col++) {
    int piv = col;
    double best = std::fabs(a[col * s + col]);
    for (int r = col + 1; r < s; r++) {
      double v = std::fabs(a[r * s + col]);
      if (v > best) { best = v; piv = r; }
    }
    if (best < 1e-12) return false;
    if (piv != col) {
      for (int c = 0; c < s; c++) {
        std::swap(a[piv * s + c], a[col * s + c]);
        std::swap(inv[piv * s + c], inv[col * s + c]);
      }
    }
    double d = a[col * s + col];
    for (int c = 0; c < s; c++) { a[col * s + c] /= d; inv[col * s + c] /= d; }
    for (int r = 0; r < s; r++) {
      if (r == col) continue;
      double f = a[r * s + col];
      if (f == 0.0) continue;
      for (int c = 0; c < s; c++) {
        a[r * s + c] -= f * a[col * s + c];
        inv[r * s + c] -= f * inv[col * s + c];
      }
    }
  }
  a = std::move(inv);
  return true;
}

}  // namespace

extern "C" {

// Encode one graph. Returns an opaque Result handle (query via getters,
// free with escfeat_free). status != 0 => caller must fall back.
void *escfeat_encode(const int32_t *src_in, const int32_t *dst_in,
                     int64_t E_in, int64_t n, int h, int self_loop,
                     int use_rd) {
  auto *res = new Result();
  Layout lay{use_rd};
  const int cap = h + 1;

  // --- canonical edges: original non-loops, then (i, i) per node
  std::vector<int32_t> src, dst;
  src.reserve(E_in + n);
  dst.reserve(E_in + n);
  for (int64_t e = 0; e < E_in; e++) {
    if (self_loop && src_in[e] == dst_in[e]) continue;
    src.push_back(src_in[e]);
    dst.push_back(dst_in[e]);
  }
  int64_t base = (int64_t)src.size();
  if (self_loop) {
    for (int32_t i = 0; i < n; i++) { src.push_back(i); dst.push_back(i); }
  }
  const int64_t E = (int64_t)src.size();
  res->E = E;
  res->edges_src = src;
  res->edges_dst = dst;
  res->loop_mask.assign(E, 0);
  for (int64_t e = base; e < E; e++) res->loop_mask[e] = 1;

  // --- adjacency (stored directed edges, multiplicity kept)
  std::vector<int32_t> deg_out(n, 0);
  for (int64_t e = 0; e < E; e++) deg_out[src[e]]++;
  std::vector<int64_t> adj_off(n + 1, 0);
  for (int32_t i = 0; i < n; i++) adj_off[i + 1] = adj_off[i] + deg_out[i];
  std::vector<int32_t> adj(E);
  {
    std::vector<int64_t> cur(adj_off.begin(), adj_off.end() - 1);
    for (int64_t e = 0; e < E; e++) adj[cur[src[e]]++] = dst[e];
  }

  // --- BFS hop distances from every node (capped at h; cap = unreachable)
  std::vector<int16_t> D((size_t)n * n, (int16_t)(cap));
  {
    std::vector<int32_t> q(n);
    for (int32_t s0 = 0; s0 < n; s0++) {
      int16_t *row = &D[(size_t)s0 * n];
      row[s0] = 0;
      int qh = 0, qt = 0;
      q[qt++] = s0;
      while (qh < qt) {
        int32_t u = q[qh++];
        if (row[u] >= h) continue;
        for (int64_t k = adj_off[u]; k < adj_off[u + 1]; k++) {
          int32_t w = adj[k];
          if (row[w] > row[u] + 1) { row[w] = row[u] + 1; q[qt++] = w; }
        }
      }
    }
  }

  // --- per-edge histograms
  std::vector<std::vector<int32_t>> all_idx(E);
  std::vector<std::vector<float>> all_cnt(E);
  int bad = 0;

  // a team costs more than it saves on a molecule-sized graph (tens to
  // hundreds of edges): run those on the calling thread. The rows are
  // independent, so the result is the same either way.
#pragma omp parallel if (E >= 1024)
  {
    std::vector<float> H(lay.dim(), 0.0f);
    std::vector<uint8_t> member(n, 0);
    std::vector<int16_t> z0(n), z1(n);
    std::vector<int32_t> members;

#pragma omp for schedule(dynamic, 8) reduction(| : bad)
    for (int64_t e = 0; e < E; e++) {
      const int32_t u = src[e], v = dst[e];
      std::fill(H.begin(), H.end(), 0.0f);
      members.clear();
      const int16_t *Du = &D[(size_t)u * n];
      const int16_t *Dv = &D[(size_t)v * n];
      for (int32_t w = 0; w < n; w++) {
        bool in_u = Du[w] <= h, in_v = Dv[w] <= h;
        member[w] = in_u || in_v;
        if (member[w]) members.push_back(w);
        z0[w] = in_u ? Du[w] : cap;
        z1[w] = in_v ? Dv[w] : cap;
      }
      // degree + z histograms over members (degree clamped to the last
      // bucket — same rule as the numpy encoder)
      for (int32_t w : members) {
        int d = 0;
        for (int64_t k = adj_off[w]; k < adj_off[w + 1]; k++)
          if (member[adj[k]]) d++;
        if (d >= lay.deg_buckets) d = lay.deg_buckets - 1;
        H[d] += 1.0f;
        H[lay.z0_off() + z0[w]] += 1.0f;
        H[lay.z1_off() + z1[w]] += 1.0f;
      }
      if (res->loop_mask[e]) {
        // phantom duplicate of the self-loop root (escgnn.py:143-147)
        H[0] += 1.0f;
        H[lay.z0_off()] += 1.0f;
        H[lay.z1_off()] += 1.0f;
      }
      // resistance distance
      if (use_rd) {
        const int s = (int)members.size();
        std::vector<int32_t> local(n, -1);
        for (int i = 0; i < s; i++) local[members[i]] = i;
        // Laplacian (off-diagonal multiplicity adjacency; diagonal
        // self-loop entries dropped)
        std::vector<double> L((size_t)s * s, 0.0);
        for (int i = 0; i < s; i++) {
          int32_t w = members[i];
          for (int64_t k = adj_off[w]; k < adj_off[w + 1]; k++) {
            int32_t x = adj[k];
            if (x == w) continue;
            int j = local[x];
            if (j >= 0) { L[(size_t)i * s + j] -= 1.0; L[(size_t)i * s + i] += 1.0; }
          }
        }
        // M = L + J/s (+ exactness residual check below)
        std::vector<double> Lcopy(L);
        std::vector<double> Minv(L);
        const double js = 1.0 / (double)s;
        for (int i = 0; i < s; i++)
          for (int j = 0; j < s; j++) Minv[(size_t)i * s + j] += js;
        if (!invert(Minv, s)) { bad |= 1; continue; }
        // X = inv(M) - J/s
        for (int i = 0; i < s; i++)
          for (int j = 0; j < s; j++) Minv[(size_t)i * s + j] -= js;
        // residual max|L X L - L|
        {
          double worst = 0.0;
          std::vector<double> LX((size_t)s * s, 0.0);
          for (int i = 0; i < s; i++)
            for (int k2 = 0; k2 < s; k2++) {
              double a = Lcopy[(size_t)i * s + k2];
              if (a == 0.0) continue;
              for (int j = 0; j < s; j++)
                LX[(size_t)i * s + j] += a * Minv[(size_t)k2 * s + j];
            }
          for (int i = 0; i < s; i++)
            for (int j = 0; j < s; j++) {
              double vsum = 0.0;
              for (int k2 = 0; k2 < s; k2++)
                vsum += LX[(size_t)i * s + k2] * Lcopy[(size_t)k2 * s + j];
              double r = std::fabs(vsum - Lcopy[(size_t)i * s + j]);
              if (r > worst) worst = r;
            }
          if (!(worst < 1e-6)) { bad |= 1; continue; }
        }
        const int r = local[u];
        const double lrr = (r >= 0) ? Minv[(size_t)r * s + r] : 0.0;
        for (int i = 0; i < s; i++) {
          double rd;
          if (res->loop_mask[e]) {
            rd = Minv[(size_t)i * s + i];  // diag(L+): phantom root
          } else {
            rd = lrr + Minv[(size_t)i * s + i] - Minv[(size_t)r * s + i] -
                 Minv[(size_t)i * s + r];
          }
          int b = (int)(float)rd;  // float32 cast then truncate (numpy parity)
          if (b < 0) b = 0;
          if (b >= lay.rd_buckets) b = lay.rd_buckets - 1;
          H[lay.rd_off() + b] += 1.0f;
        }
        if (res->loop_mask[e]) H[lay.rd_off()] += 1.0f;  // phantom rd = 0
      }
      // subgraph edge-type histogram over stored non-loop edges (with
      // self_loop=False the input list may still carry loops — skip them
      // like the numpy encoder's `edges[0] != edges[1]` mask)
      for (int64_t j = 0; j < base; j++) {
        int32_t a = src[j], b2 = dst[j];
        if (a == b2) continue;
        if (member[a] && member[b2]) {
          int tcode = 216 * z0[a] + 36 * z1[a] + 6 * z0[b2] + z1[b2];
          // labels <= h+1 <= 5 (wrapper declines h > 4) => tcode <= 1295;
          // guard anyway against an out-of-contract caller
          if (tcode < lay.edge_type_buckets)
            H[lay.et_off() + tcode] += 1.0f;
        }
      }
      // sparsify (ascending bucket order)
      for (int c = 0; c < lay.dim(); c++) {
        if (H[c] != 0.0f) {
          all_idx[e].push_back(c);
          all_cnt[e].push_back(H[c]);
        }
      }
    }
  }

  if (bad) { res->status = 1; return res; }
  res->offsets.assign(E + 1, 0);
  for (int64_t e = 0; e < E; e++)
    res->offsets[e + 1] = res->offsets[e] + (int64_t)all_idx[e].size();
  res->enc_idx.reserve(res->offsets[E]);
  res->enc_cnt.reserve(res->offsets[E]);
  for (int64_t e = 0; e < E; e++) {
    res->enc_idx.insert(res->enc_idx.end(), all_idx[e].begin(), all_idx[e].end());
    res->enc_cnt.insert(res->enc_cnt.end(), all_cnt[e].begin(), all_cnt[e].end());
  }
  return res;
}

int escfeat_status(void *h) { return ((Result *)h)->status; }
int64_t escfeat_num_edges(void *h) { return ((Result *)h)->E; }
int64_t escfeat_nnz(void *h) { return (int64_t)((Result *)h)->enc_idx.size(); }

void escfeat_copy(void *h, int32_t *edges_src, int32_t *edges_dst,
                  uint8_t *loop_mask, int32_t *enc_idx, float *enc_cnt,
                  int64_t *offsets) {
  auto *r = (Result *)h;
  std::memcpy(edges_src, r->edges_src.data(), r->E * sizeof(int32_t));
  std::memcpy(edges_dst, r->edges_dst.data(), r->E * sizeof(int32_t));
  std::memcpy(loop_mask, r->loop_mask.data(), r->E * sizeof(uint8_t));
  std::memcpy(enc_idx, r->enc_idx.data(), r->enc_idx.size() * sizeof(int32_t));
  std::memcpy(enc_cnt, r->enc_cnt.data(), r->enc_cnt.size() * sizeof(float));
  std::memcpy(offsets, r->offsets.data(), (r->E + 1) * sizeof(int64_t));
}

void escfeat_free(void *h) { delete (Result *)h; }

// the OpenMP team size of this library's parallel regions (a forked
// featurizer worker sets 1: it inherits the parent's runtime without its
// threads, and a team of one never waits for them)
void escfeat_set_num_threads(int n) { omp_set_num_threads(n); }

}  // extern "C"
