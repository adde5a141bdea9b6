// Copy of the Reverse Cuthill-McKee function of glimslib_tpu/native/meshops.cpp,
// kept byte for byte (with its includes) so that the port builds its own library.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <numeric>
#include <queue>
#include <vector>

extern "C" {

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

}  // extern "C"
