// Native host core of the port (counterpart: flexflow_tpu/native/native.cc):
// the host-side hot paths that stay in C++, the dataloader's batch assembly
// (reference src/dataloader/dataloader.cc's shard scatter) and the graph's
// topological order (include/flexflow/basic_graph.h traversals).
//
// Plain C symbols loaded by ctypes (flexflow_tpu_torch/native/__init__.py),
// which releases the GIL for the call, so a batch is gathered in the
// prefetch thread while the step runs. Built on first use:
//   c++ -O3 -shared -fPIC -std=c++17 -o libff_native_<hash>.so native.cc

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// dst[i] = src[idx[i]] for rows of row_bytes bytes.
// Returns 0, or -1 on an index out of [0, n_src_rows).
int ff_batch_gather(const char* src, int64_t n_src_rows, char* dst,
                    const int64_t* idx, int64_t n_idx, int64_t row_bytes) {
  for (int64_t i = 0; i < n_idx; ++i) {
    const int64_t j = idx[i];
    if (j < 0 || j >= n_src_rows) return -1;
    std::memcpy(dst + i * row_bytes, src + j * row_bytes,
                static_cast<size_t>(row_bytes));
  }
  return 0;
}

// Kahn's topological order with a FIFO seeded in node order, successors
// visited in edge order: the order core/graph.py's topo_order walks.
// edges: n_edges pairs (e_src[e], e_dst[e]); out receives the n_nodes node
// indices. Returns 0, or -1 on a cycle.
int ff_topo_order(int64_t n_nodes, int64_t n_edges, const int64_t* e_src,
                  const int64_t* e_dst, int64_t* out) {
  std::vector<int64_t> indeg(n_nodes, 0);
  std::vector<int64_t> head(n_nodes, -1);  // per-node edge list
  std::vector<int64_t> next(n_edges, -1);
  // built in reverse so a node's list holds its edges in input order
  for (int64_t e = n_edges - 1; e >= 0; --e) {
    next[e] = head[e_src[e]];
    head[e_src[e]] = e;
    indeg[e_dst[e]] += 1;
  }
  std::vector<int64_t> ready;
  ready.reserve(n_nodes);
  for (int64_t n = 0; n < n_nodes; ++n)
    if (indeg[n] == 0) ready.push_back(n);
  size_t qhead = 0;
  int64_t count = 0;
  while (qhead < ready.size()) {
    const int64_t n = ready[qhead++];
    out[count++] = n;
    for (int64_t e = head[n]; e != -1; e = next[e])
      if (--indeg[e_dst[e]] == 0) ready.push_back(e_dst[e]);
  }
  return count == n_nodes ? 0 : -1;
}

}  // extern "C"
