// Louvain's local-move phase (memgraph_tpu_torch/ops/louvain.py).
//
// The move loop of the host Louvain, one level: nodes in the given order,
// each moved to the neighbouring community of the largest positive
// modularity gain (the first one met on a tie: strict >), until a round
// moves no node by more than min_gain or 20 rounds ran.  The link weights
// of a node's neighbouring communities are summed in its neighbour order,
// and the communities are tried in the order of their first appearance
// there, so every double operation is the python loop's in the same
// order.  Built with -ffp-contract=off: a fused multiply-add would round
// once where the python loop rounds twice.
//
// Exposed as a plain C ABI for ctypes.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -ffp-contract=off, at first
// use, by memgraph_tpu_torch/ops/native.py.

#include <cstddef>
#include <cstdint>
#include <vector>

extern "C" {

// Inputs:
//   n              : node count
//   indptr         : n + 1 int64 offsets of each node's neighbours
//   nbr, nbr_w     : neighbour ids (int64) and summed weights (double),
//                    a node's in order of first occurrence, no self loop
//   k              : n doubles, each node's weighted degree
//   order          : n int64, the visiting order (a permutation)
//   m2             : the sum of all weights (2m), > 0
//   min_gain       : a move counts as an improvement past this gain
// Outputs:
//   comm           : n int64, each node's community (a node id)
//   total_gain     : the sum of the counted gains
// Returns 0.
int louvain_move(int64_t n, const int64_t* indptr, const int64_t* nbr,
                 const double* nbr_w, const double* k,
                 const int64_t* order, double m2, double min_gain,
                 int64_t* comm, double* total_gain) {
  std::vector<double> comm_tot(k, k + n);
  for (int64_t v = 0; v < n; ++v) comm[v] = v;
  std::vector<int64_t> pos(n, -1);
  std::vector<int64_t> link_c;
  std::vector<double> link_w;
  double gain_sum = 0.0;
  bool improved = true;
  int rounds = 0;
  while (improved && rounds < 20) {
    improved = false;
    ++rounds;
    for (int64_t i = 0; i < n; ++i) {
      const int64_t v = order[i];
      const int64_t cv = comm[v];
      const double kv = k[v];
      link_c.clear();
      link_w.clear();
      for (int64_t e = indptr[v]; e < indptr[v + 1]; ++e) {
        const int64_t c = comm[nbr[e]];
        if (pos[c] < 0) {
          pos[c] = static_cast<int64_t>(link_c.size());
          link_c.push_back(c);
          link_w.push_back(0.0);
        }
        link_w[pos[c]] += nbr_w[e];
      }
      comm_tot[cv] -= kv;
      int64_t best_c = cv;
      double best_gain = 0.0;
      const double own = pos[cv] >= 0 ? link_w[pos[cv]] : 0.0;
      const double base = own - comm_tot[cv] * kv / m2;
      for (std::size_t j = 0; j < link_c.size(); ++j) {
        const int64_t c = link_c[j];
        if (c == cv) continue;
        const double gain = (link_w[j] - comm_tot[c] * kv / m2) - base;
        if (gain > best_gain) {
          best_gain = gain;
          best_c = c;
        }
      }
      comm[v] = best_c;
      comm_tot[best_c] += kv;
      if (best_c != cv && best_gain > min_gain) {
        improved = true;
        gain_sum += best_gain;
      }
      for (int64_t c : link_c) pos[c] = -1;
    }
  }
  *total_gain = gain_sum;
  return 0;
}

}  // extern "C"
