// k-set graph featurizer — native core.
//
// Re-implementation of the capability of the reference's k-gnn C++
// extension (software/k-gnn-master/cpu/{assignment,connect,isomorphism}.h,
// graph.cpp): enumerate 2-/3-element node sets (all or connected),
// compute isomorphism types from sorted node labels + adjacency, and
// build the set-graph ("local": sets sharing k-1 elements via any
// neighbor extension; "malkin": replace one element by a neighbor).
//
// Fresh design, plain C ABI for ctypes (no torch): CSR adjacency with
// sorted neighbor lists, sets keyed by packed u*n^2+v*n+w codes in an
// ordered map (insertion ids, sorted iteration — matching the reference's
// std::map<vector,int64> behavior), outputs returned through an opaque
// result handle with copy-out getters.
//
// Build: g++ -O3 -shared -fPIC -o libkgnn.so kgnn.cpp

#include <algorithm>
#include <cstdint>
#include <map>
#include <vector>

namespace {

struct Csr {
  std::vector<int64_t> ptr, nbr;
};

Csr build_csr(const int64_t *src, const int64_t *dst, int64_t num_edges,
              int64_t n) {
  Csr csr;
  csr.ptr.assign(n + 1, 0);
  for (int64_t e = 0; e < num_edges; ++e) csr.ptr[src[e] + 1]++;
  for (int64_t v = 0; v < n; ++v) csr.ptr[v + 1] += csr.ptr[v];
  csr.nbr.resize(num_edges);
  std::vector<int64_t> fill(csr.ptr.begin(), csr.ptr.end() - 1);
  for (int64_t e = 0; e < num_edges; ++e) csr.nbr[fill[src[e]]++] = dst[e];
  for (int64_t v = 0; v < n; ++v)
    std::sort(csr.nbr.begin() + csr.ptr[v], csr.nbr.begin() + csr.ptr[v + 1]);
  return csr;
}

bool adjacent(const Csr &csr, int64_t u, int64_t v) {
  return std::binary_search(csr.nbr.begin() + csr.ptr[u],
                            csr.nbr.begin() + csr.ptr[u + 1], v);
}

using SetMap = std::map<std::vector<int64_t>, int64_t>;

int64_t iso2(const Csr &csr, int64_t u, int64_t v, const int64_t *lab,
             int64_t nl, bool connected) {
  int64_t a = lab[u], b = lab[v];
  if (a > b) std::swap(a, b);
  int64_t t = a * nl + b;
  if (!connected) t += nl * nl * (adjacent(csr, u, v) ? 1 : 0);
  return t;
}

int64_t iso3(const Csr &csr, const std::vector<int64_t> &s, const int64_t *lab,
             int64_t nl) {
  int64_t l[3] = {lab[s[0]], lab[s[1]], lab[s[2]]};
  std::sort(l, l + 3);
  return nl * nl * nl * (adjacent(csr, s[2], s[0]) ? 1 : 0) + l[0] * nl * nl +
         l[1] * nl + l[2];
}

struct Result {
  std::vector<int64_t> edge_rows, edge_cols;   // set-graph edges
  std::vector<int64_t> assign_nodes, assign_sets;  // node -> set incidences
  std::vector<int64_t> iso_type;
};

void enumerate_sets(const Csr &csr, int64_t n, int k, bool connected,
                    const int64_t *lab, int64_t nl, SetMap &sets,
                    Result &res) {
  int64_t id = 0;
  if (k == 2) {
    if (connected) {
      for (int64_t u = 0; u < n; ++u)
        for (int64_t p = csr.ptr[u]; p < csr.ptr[u + 1]; ++p) {
          int64_t v = csr.nbr[p];
          if (u >= v) continue;
          sets.insert({{u, v}, id});
          res.iso_type.push_back(iso2(csr, u, v, lab, nl, true));
          id++;
        }
    } else {
      for (int64_t u = 0; u < n; ++u)
        for (int64_t v = u + 1; v < n; ++v) {
          sets.insert({{u, v}, id});
          res.iso_type.push_back(iso2(csr, u, v, lab, nl, false));
          id++;
        }
    }
  } else {
    if (connected) {
      for (int64_t u = 0; u < n; ++u)
        for (int64_t p = csr.ptr[u]; p < csr.ptr[u + 1]; ++p) {
          int64_t v = csr.nbr[p];
          for (int64_t q = csr.ptr[v]; q < csr.ptr[v + 1]; ++q) {
            int64_t w = csr.nbr[q];
            if (w == u) continue;
            std::vector<int64_t> s = {u, v, w};
            std::sort(s.begin(), s.end());
            if (sets.find(s) != sets.end()) continue;
            sets.insert({s, id});
            res.iso_type.push_back(iso3(csr, s, lab, nl));
            id++;
          }
        }
    } else {
      for (int64_t u = 0; u < n; ++u)
        for (int64_t v = u + 1; v < n; ++v)
          for (int64_t w = v + 1; w < n; ++w) {
            std::vector<int64_t> s = {u, v, w};
            sets.insert({s, id});
            res.iso_type.push_back(iso3(csr, s, lab, nl));
            id++;
          }
    }
  }
}

void maybe_add(const SetMap &sets, int64_t id, std::vector<int64_t> cand,
               std::vector<int64_t> &rows, std::vector<int64_t> &cols) {
  std::sort(cand.begin(), cand.end());
  auto it = sets.find(cand);
  if (it != sets.end()) {
    rows.push_back(id);
    cols.push_back(it->second);
    rows.push_back(it->second);
    cols.push_back(id);
  }
}

void connect_sets(const Csr &csr, const SetMap &sets, int k, bool malkin,
                  Result &res) {
  std::vector<int64_t> rows, cols;
  for (const auto &item : sets) {
    const auto &s = item.first;
    int64_t id = item.second;
    for (int i = 0; i < k; ++i) {
      for (int64_t p = csr.ptr[s[i]]; p < csr.ptr[s[i] + 1]; ++p) {
        int64_t x = csr.nbr[p];
        if (malkin) {
          // replace element i by the neighbor x
          std::vector<int64_t> cand;
          for (int j = 0; j < k; ++j)
            if (j != i) cand.push_back(s[j]);
          cand.push_back(x);
          maybe_add(sets, id, cand, rows, cols);
        } else {
          // any (k-1)-subset of s extended by x
          for (int drop = 0; drop < k; ++drop) {
            std::vector<int64_t> cand;
            for (int j = 0; j < k; ++j)
              if (j != drop) cand.push_back(s[j]);
            cand.push_back(x);
            maybe_add(sets, id, cand, rows, cols);
          }
        }
      }
    }
  }
  // remove self loops + coalesce (sort unique by (row, col))
  int64_t m = (int64_t)sets.size();
  std::vector<int64_t> keys;
  keys.reserve(rows.size());
  for (size_t e = 0; e < rows.size(); ++e)
    if (rows[e] != cols[e]) keys.push_back(rows[e] * m + cols[e]);
  std::sort(keys.begin(), keys.end());
  keys.erase(std::unique(keys.begin(), keys.end()), keys.end());
  res.edge_rows.reserve(keys.size());
  res.edge_cols.reserve(keys.size());
  for (int64_t key : keys) {
    res.edge_rows.push_back(key / m);
    res.edge_cols.push_back(key % m);
  }
}

void assignment_arrays(const SetMap &sets, Result &res) {
  for (const auto &item : sets)
    for (int64_t node : item.first) {
      res.assign_nodes.push_back(node);
      res.assign_sets.push_back(item.second);
    }
}

}  // namespace

extern "C" {

// Computes the k-set graph. mode: 0 = local, 1 = malkin.
// Returns an opaque handle; query sizes/copy data via getters; free it.
void *kgnn_compute(const int64_t *src, const int64_t *dst, int64_t num_edges,
                   const int64_t *labels, int64_t num_labels, int64_t n,
                   int k, int connected, int malkin) {
  Csr csr = build_csr(src, dst, num_edges, n);
  auto *res = new Result();
  SetMap sets;
  enumerate_sets(csr, n, k, connected != 0, labels, num_labels, sets, *res);
  connect_sets(csr, sets, k, malkin != 0, *res);
  assignment_arrays(sets, *res);
  return res;
}

// 2->3 assignment: incidences between all 2-sets and connected 3-sets.
void *kgnn_assignment_2to3(const int64_t *src, const int64_t *dst,
                           int64_t num_edges, int64_t n) {
  Csr csr = build_csr(src, dst, num_edges, n);
  auto *res = new Result();
  std::vector<int64_t> ones(n, 0);
  SetMap sets2, sets3;
  {
    Result tmp;
    enumerate_sets(csr, n, 2, false, ones.data(), 1, sets2, tmp);
    enumerate_sets(csr, n, 3, true, ones.data(), 1, sets3, tmp);
  }
  for (const auto &it3 : sets3) {
    const auto &s = it3.first;
    for (auto pair : {std::vector<int64_t>{s[0], s[1]},
                      std::vector<int64_t>{s[0], s[2]},
                      std::vector<int64_t>{s[1], s[2]}}) {
      auto it2 = sets2.find(pair);
      res->edge_rows.push_back(it2->second);
      res->edge_cols.push_back(it3.second);
    }
  }
  return res;
}

int64_t kgnn_num_edges(void *h) { return ((Result *)h)->edge_rows.size(); }
int64_t kgnn_num_assign(void *h) { return ((Result *)h)->assign_nodes.size(); }
int64_t kgnn_num_sets(void *h) { return ((Result *)h)->iso_type.size(); }

void kgnn_copy_edges(void *h, int64_t *rows, int64_t *cols) {
  auto *r = (Result *)h;
  std::copy(r->edge_rows.begin(), r->edge_rows.end(), rows);
  std::copy(r->edge_cols.begin(), r->edge_cols.end(), cols);
}
void kgnn_copy_assignment(void *h, int64_t *nodes, int64_t *sets) {
  auto *r = (Result *)h;
  std::copy(r->assign_nodes.begin(), r->assign_nodes.end(), nodes);
  std::copy(r->assign_sets.begin(), r->assign_sets.end(), sets);
}
void kgnn_copy_iso_type(void *h, int64_t *iso) {
  auto *r = (Result *)h;
  std::copy(r->iso_type.begin(), r->iso_type.end(), iso);
}
void kgnn_free(void *h) { delete (Result *)h; }

}  // extern "C"
