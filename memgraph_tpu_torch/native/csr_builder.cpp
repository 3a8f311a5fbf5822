// Native CSR/CSC graph builder.
//
// The hot host-side step that converts a COO edge list into the padded
// CSR + CSC layout of memgraph_tpu_torch/ops/csr.py (``DeviceGraph``).
// Two stable counting sorts by dense node id run in O(E + N), much faster
// than the numpy lexsort path, and both layouts come out of one call.
// The sorts are stable, so edges with equal (src, dst) keep their input
// order: the arrays are bit-equal to the numpy path's.
//
// Exposed as a plain C ABI for ctypes.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC, at first use, by
// memgraph_tpu_torch/ops/native.py.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Builds CSR ((src,dst)-lexsorted) and CSC ((dst,src)-lexsorted) layouts.
//
// Inputs:
//   src, dst : n_edges int64 node ids in [0, n_nodes)
//   weights  : n_edges float or nullptr (treated as 1.0f)
//   n_pad    : padded node count (>= n_nodes + 1); sink row = n_nodes
//   e_pad    : padded edge count (>= n_edges)
// Outputs (caller-allocated):
//   csr_src, csr_dst : e_pad int32   csr_w : e_pad float
//   csc_src, csc_dst : e_pad int32   csc_w : e_pad float
//   row_ptr  : n_pad + 1 int32
//   out_degree : n_pad float
// Returns 0 on success, nonzero on invalid input.
int build_csr_csc(const int64_t* src, const int64_t* dst,
                  const float* weights,
                  int64_t n_edges, int64_t n_nodes,
                  int64_t n_pad, int64_t e_pad,
                  int32_t* csr_src, int32_t* csr_dst, float* csr_w,
                  int32_t* csc_src, int32_t* csc_dst, float* csc_w,
                  int32_t* row_ptr, float* out_degree) {
  if (n_pad < n_nodes + 1 || e_pad < n_edges) return 1;
  const int32_t sink = static_cast<int32_t>(n_nodes);

  // ---- counting sort #1: stable by dst (minor key) -------------------------
  std::vector<int64_t> count(static_cast<size_t>(n_nodes) + 1, 0);
  for (int64_t e = 0; e < n_edges; ++e) {
    const int64_t d = dst[e];
    if (d < 0 || d >= n_nodes || src[e] < 0 || src[e] >= n_nodes) return 2;
    ++count[d];
  }
  std::vector<int64_t> offset(static_cast<size_t>(n_nodes) + 1, 0);
  for (int64_t v = 1; v <= n_nodes; ++v) offset[v] = offset[v - 1] + count[v - 1];
  std::vector<int32_t> tmp_src(n_edges), tmp_dst(n_edges);
  std::vector<float> tmp_w(n_edges);
  for (int64_t e = 0; e < n_edges; ++e) {
    const int64_t pos = offset[dst[e]]++;
    tmp_src[pos] = static_cast<int32_t>(src[e]);
    tmp_dst[pos] = static_cast<int32_t>(dst[e]);
    tmp_w[pos] = weights ? weights[e] : 1.0f;
  }

  // ---- counting sort #2: stable by src (major key) → (src, dst) order -----
  std::fill(count.begin(), count.end(), 0);
  for (int64_t e = 0; e < n_edges; ++e) ++count[tmp_src[e]];
  offset[0] = 0;
  for (int64_t v = 1; v <= n_nodes; ++v) offset[v] = offset[v - 1] + count[v - 1];
  // row_ptr over the padded node range
  for (int64_t v = 0; v <= n_pad; ++v) {
    row_ptr[v] = static_cast<int32_t>(v <= n_nodes ? offset[v] : n_edges);
  }
  for (int64_t v = 0; v < n_pad; ++v) {
    out_degree[v] = (v < n_nodes) ? static_cast<float>(count[v]) : 0.0f;
  }
  for (int64_t e = 0; e < n_edges; ++e) {
    const int64_t pos = offset[tmp_src[e]]++;
    csr_src[pos] = tmp_src[e];
    csr_dst[pos] = tmp_dst[e];
    csr_w[pos] = tmp_w[e];
  }
  for (int64_t e = n_edges; e < e_pad; ++e) {
    csr_src[e] = sink; csr_dst[e] = sink; csr_w[e] = 0.0f;
  }

  // ---- CSC: stable sort of the (src,dst)-ordered arrays by dst ------------
  std::fill(count.begin(), count.end(), 0);
  for (int64_t e = 0; e < n_edges; ++e) ++count[csr_dst[e]];
  offset[0] = 0;
  for (int64_t v = 1; v <= n_nodes; ++v) offset[v] = offset[v - 1] + count[v - 1];
  for (int64_t e = 0; e < n_edges; ++e) {
    const int64_t pos = offset[csr_dst[e]]++;
    csc_src[pos] = csr_src[e];
    csc_dst[pos] = csr_dst[e];
    csc_w[pos] = csr_w[e];
  }
  for (int64_t e = n_edges; e < e_pad; ++e) {
    csc_src[e] = sink; csc_dst[e] = sink; csc_w[e] = 0.0f;
  }
  return 0;
}

}  // extern "C"
