// Balanced bipartite edge coloring (Euler split) for shard assignment.
//
// Assigns each edge of a bipartite multigraph (src side, dst side) to one
// of P = 2^levels shards so that EVERY vertex's incident edges split
// floor(d/P)..ceil(d/P) across shards — on both sides simultaneously.
// Random/round-robin assignment leaves a max-of-128-lanes binomial tail
// that inflates the per-shard gather/scatter row padding of the MXU plan
// (memgraph_tpu_torch/ops/spmv_mxu_sharded.py) by ~2x; the balanced split makes
// the per-shard Benes net ~P-fold smaller, which is what the multichip
// speedup projection rides on.
//
// Method, per halving level: pair consecutive incident edges at every
// vertex ((0,1),(2,3),... in incidence order). Each edge carries at most
// one pairing per side, so the pairing relation forms paths and cycles
// over edges; cycles alternate src-/dst-side pairings and are therefore
// even. 2-coloring each path/cycle alternately gives every vertex an
// even split of its paired edges; the odd unpaired edge tips one half by
// exactly one. Recursing log2(P) times yields the floor/ceil bound.
// O(E log P) time, O(E) memory.
//
// Reference analog: none (the reference's cuGraph/NCCL path partitions by
// contiguous vertex ranges); this exists because MXU-plan padding is
// governed by per-row MAX degree, which only balanced splits control.

#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

// Split edges[0..m) into halves by pairing-graph 2-coloring.
// side_key: for each edge, its endpoint id on each side.
// Returns colors in out_color (0/1 per edge index position).
void euler_halve(const int64_t* src, const int64_t* dst,
                 const int32_t* edges, int64_t m, int64_t n_src,
                 int64_t n_dst, uint8_t* out_color,
                 std::vector<int32_t>& scratch) {
  // incidence counts per vertex (src side then dst side)
  const int64_t nv = n_src + n_dst;
  std::vector<int64_t> head(nv, -1);
  // pair links: for edge slot i (position in edges[]), partner via src
  // pairing and via dst pairing; -1 = unpaired on that side.
  std::vector<int32_t>& pair_s = scratch;  // reuse caller scratch
  pair_s.assign(2 * m, -1);
  int32_t* pair_src = pair_s.data();
  int32_t* pair_dst = pair_s.data() + m;

  // walk incidence in order, pairing consecutive edges per vertex
  for (int64_t i = 0; i < m; i++) {
    const int64_t v = src[edges[i]];
    if (head[v] < 0) {
      head[v] = i;
    } else {
      pair_src[head[v]] = static_cast<int32_t>(i);
      pair_src[i] = static_cast<int32_t>(head[v]);
      head[v] = -1;
    }
  }
  for (int64_t v = 0; v < nv; v++) head[v] = -1;
  for (int64_t i = 0; i < m; i++) {
    const int64_t v = n_src + dst[edges[i]];
    if (head[v] < 0) {
      head[v] = i;
    } else {
      pair_dst[head[v]] = static_cast<int32_t>(i);
      pair_dst[i] = static_cast<int32_t>(head[v]);
      head[v] = -1;
    }
  }

  // 2-color paths first (start at edges unpaired on either side), then
  // cycles. colored flag lives in out_color as 0xff sentinel.
  for (int64_t i = 0; i < m; i++) out_color[i] = 0xff;
  for (int pass = 0; pass < 2; pass++) {
    for (int64_t s = 0; s < m; s++) {
      if (out_color[s] != 0xff) continue;
      const bool endpoint = (pair_src[s] < 0) || (pair_dst[s] < 0);
      if (pass == 0 && !endpoint) continue;  // cycles in pass 1
      // walk: alternate colors; at each step leave via the side we did
      // NOT arrive by. Start by leaving via src pairing (or dst if the
      // path starts src-unpaired).
      int64_t cur = s;
      uint8_t color = 0;
      bool via_src = pair_src[s] >= 0;  // first hop side
      while (cur >= 0 && out_color[cur] == 0xff) {
        out_color[cur] = color;
        color ^= 1;
        const int32_t nxt = via_src ? pair_src[cur] : pair_dst[cur];
        via_src = !via_src;
        cur = nxt;
      }
    }
  }
}

}  // namespace

extern "C" {

// src/dst: edge endpoints, 0 <= src[i] < n_src, 0 <= dst[i] < n_dst.
// levels: number of halvings; shards = 2^levels (<= 8 levels supported).
// out_shard: caller-allocated E bytes.
// Returns 0 on success, 1 on invalid arguments.
int balanced_edge_color(const int64_t* src, const int64_t* dst, int64_t E,
                        int64_t n_src, int64_t n_dst, int levels,
                        uint8_t* out_shard) {
  if (E < 0 || E > INT32_MAX || levels < 0 || levels > 8) return 1;
  for (int64_t i = 0; i < E; i++) {
    if (src[i] < 0 || src[i] >= n_src || dst[i] < 0 || dst[i] >= n_dst)
      return 1;
  }
  for (int64_t i = 0; i < E; i++) out_shard[i] = 0;
  if (levels == 0 || E == 0) return 0;

  // groups of edge indices, halved level by level
  std::vector<int32_t> edges(E);
  for (int64_t i = 0; i < E; i++) edges[i] = static_cast<int32_t>(i);
  std::vector<uint8_t> color(E);
  std::vector<int32_t> scratch;

  // offsets of each group within `edges`; starts with one group [0, E)
  std::vector<int64_t> bounds = {0, E};
  for (int lev = 0; lev < levels; lev++) {
    std::vector<int64_t> new_bounds = {0};
    int64_t write = 0;
    std::vector<int32_t> out(edges.size());
    for (std::size_t g = 0; g + 1 < bounds.size(); g++) {
      const int64_t lo = bounds[g], hi = bounds[g + 1], m = hi - lo;
      euler_halve(src, dst, edges.data() + lo, m, n_src, n_dst,
                  color.data(), scratch);
      // stable partition: color 0 first, then color 1
      int64_t w0 = write;
      for (int64_t i = 0; i < m; i++)
        if (color[i] == 0) out[w0++] = edges[lo + i];
      const int64_t mid = w0;
      for (int64_t i = 0; i < m; i++)
        if (color[i] != 0) {
          out[w0++] = edges[lo + i];
          out_shard[edges[lo + i]] |= static_cast<uint8_t>(1 << lev);
        }
      write = w0;
      new_bounds.push_back(mid);
      new_bounds.push_back(write);
    }
    edges.swap(out);
    bounds.swap(new_bounds);
  }
  return 0;
}

}  // extern "C"
