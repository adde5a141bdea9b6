// Copy of glimslib_tpu/native/meshops.cpp (facets, cell adjacency, the greedy
// graph partitioner, Reverse Cuthill-McKee and used vertices), kept byte for
// byte below this comment so that the port builds its own library.
//
// Plain C ABI (ctypes-friendly): all buffers are caller-allocated numpy
// arrays; int64 indices, double coordinates.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <numeric>
#include <queue>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Facet enumeration with cell adjacency.
//
// cells:      (n_cells * npe) node ids
// out_facets: (max_facets * nfn) facet node ids   (nfn = npe - 1)
// out_cells:  (max_facets * 2)  adjacent cells, -1 when exterior
// returns number of unique facets (max_facets = n_cells * npe upper bound).
// ---------------------------------------------------------------------------
int64_t meshops_facets(const int64_t* cells, int64_t n_cells, int64_t npe,
                       int64_t* out_facets, int64_t* out_cells) {
  const int64_t nfn = npe - 1;
  const int64_t total = n_cells * npe;

  struct Entry {
    int64_t key[3];  // sorted facet nodes (nfn <= 3)
    int64_t cell;
    int64_t orig;  // index into the per-cell facet list
  };
  std::vector<Entry> entries(total);
  for (int64_t c = 0; c < n_cells; ++c) {
    for (int64_t f = 0; f < npe; ++f) {
      Entry& e = entries[c * npe + f];
      int64_t k = 0;
      for (int64_t j = 0; j < npe; ++j) {
        if (j != f) e.key[k++] = cells[c * npe + j];
      }
      for (; k < 3; ++k) e.key[k] = -1;
      std::sort(e.key, e.key + nfn);
      e.cell = c;
      e.orig = c * npe + f;
    }
  }
  std::sort(entries.begin(), entries.end(), [nfn](const Entry& a, const Entry& b) {
    for (int64_t i = 0; i < nfn; ++i) {
      if (a.key[i] != b.key[i]) return a.key[i] < b.key[i];
    }
    return false;
  });

  int64_t n_facets = 0;
  int64_t i = 0;
  while (i < total) {
    int64_t j = i + 1;
    while (j < total &&
           std::equal(entries[i].key, entries[i].key + nfn, entries[j].key)) {
      ++j;
    }
    for (int64_t k = 0; k < nfn; ++k) {
      out_facets[n_facets * nfn + k] = entries[i].key[k];
    }
    out_cells[n_facets * 2 + 0] = entries[i].cell;
    out_cells[n_facets * 2 + 1] = (j - i > 1) ? entries[i + 1].cell : -1;
    ++n_facets;
    i = j;
  }
  return n_facets;
}

// ---------------------------------------------------------------------------
// Cell adjacency (facet-neighbours) in CSR: call meshops_facets first.
// out_xadj: (n_cells + 1), out_adj: (2 * n_interior_facets)
// returns adjacency length.
// ---------------------------------------------------------------------------
int64_t meshops_cell_adjacency(const int64_t* facet_cells, int64_t n_facets,
                               int64_t n_cells, int64_t* out_xadj,
                               int64_t* out_adj) {
  std::vector<int64_t> degree(n_cells, 0);
  for (int64_t f = 0; f < n_facets; ++f) {
    int64_t a = facet_cells[f * 2], b = facet_cells[f * 2 + 1];
    if (b >= 0) {
      ++degree[a];
      ++degree[b];
    }
  }
  out_xadj[0] = 0;
  for (int64_t c = 0; c < n_cells; ++c) out_xadj[c + 1] = out_xadj[c] + degree[c];
  std::vector<int64_t> pos(n_cells, 0);
  for (int64_t f = 0; f < n_facets; ++f) {
    int64_t a = facet_cells[f * 2], b = facet_cells[f * 2 + 1];
    if (b >= 0) {
      out_adj[out_xadj[a] + pos[a]++] = b;
      out_adj[out_xadj[b] + pos[b]++] = a;
    }
  }
  return out_xadj[n_cells];
}

// ---------------------------------------------------------------------------
// Greedy graph-growing partitioner: n_parts contiguous, balanced regions.
// Lower edge-cut than coordinate sorting; no external METIS dependency.
// out_part: (n_cells) partition id.
// ---------------------------------------------------------------------------
void meshops_partition(const int64_t* xadj, const int64_t* adj,
                       int64_t n_cells, int64_t n_parts, int64_t* out_part) {
  std::fill(out_part, out_part + n_cells, -1);
  const int64_t target = (n_cells + n_parts - 1) / n_parts;
  int64_t seed = 0;
  for (int64_t p = 0; p < n_parts; ++p) {
    while (seed < n_cells && out_part[seed] >= 0) ++seed;
    if (seed >= n_cells) break;
    int64_t count = 0;
    std::queue<int64_t> frontier;
    frontier.push(seed);
    while (!frontier.empty() && count < target) {
      int64_t c = frontier.front();
      frontier.pop();
      if (out_part[c] >= 0) continue;
      out_part[c] = p;
      ++count;
      for (int64_t k = xadj[c]; k < xadj[c + 1]; ++k) {
        if (out_part[adj[k]] < 0) frontier.push(adj[k]);
      }
    }
  }
  for (int64_t c = 0; c < n_cells; ++c) {
    if (out_part[c] < 0) out_part[c] = n_parts - 1;
  }
}

// ---------------------------------------------------------------------------
// Reverse Cuthill-McKee node reordering for gather/scatter locality.
// node adjacency built from cells internally.  out_perm: (n_nodes) with
// new_index = out_perm[old_index].
// ---------------------------------------------------------------------------
void meshops_rcm(const int64_t* cells, int64_t n_cells, int64_t npe,
                 int64_t n_nodes, int64_t* out_perm) {
  // build node adjacency (dedup via sort per node)
  std::vector<std::vector<int64_t>> nbr(n_nodes);
  for (int64_t c = 0; c < n_cells; ++c) {
    for (int64_t i = 0; i < npe; ++i) {
      for (int64_t j = 0; j < npe; ++j) {
        if (i != j) nbr[cells[c * npe + i]].push_back(cells[c * npe + j]);
      }
    }
  }
  for (auto& v : nbr) {
    std::sort(v.begin(), v.end());
    v.erase(std::unique(v.begin(), v.end()), v.end());
  }
  std::vector<int64_t> order;
  order.reserve(n_nodes);
  std::vector<char> visited(n_nodes, 0);
  for (int64_t start = 0; start < n_nodes; ++start) {
    if (visited[start]) continue;
    // find a pseudo-peripheral-ish start: lowest degree in this component
    std::queue<int64_t> q;
    q.push(start);
    visited[start] = 1;
    order.push_back(start);
    while (!q.empty()) {
      int64_t u = q.front();
      q.pop();
      std::vector<int64_t> next;
      for (int64_t v : nbr[u]) {
        if (!visited[v]) {
          visited[v] = 1;
          next.push_back(v);
        }
      }
      std::sort(next.begin(), next.end(), [&](int64_t a, int64_t b) {
        return nbr[a].size() < nbr[b].size();
      });
      for (int64_t v : next) {
        order.push_back(v);
        q.push(v);
      }
    }
  }
  // reverse (RCM) and emit permutation old->new
  for (int64_t i = 0; i < n_nodes; ++i) {
    out_perm[order[n_nodes - 1 - i]] = i;
  }
}

// ---------------------------------------------------------------------------
// Orphaned-vertex detection: marks used[n_nodes] (uint8).
// ---------------------------------------------------------------------------
void meshops_used_vertices(const int64_t* cells, int64_t n_cells, int64_t npe,
                           int64_t n_nodes, uint8_t* used) {
  std::memset(used, 0, n_nodes);
  for (int64_t i = 0; i < n_cells * npe; ++i) used[cells[i]] = 1;
}

}  // extern "C"
