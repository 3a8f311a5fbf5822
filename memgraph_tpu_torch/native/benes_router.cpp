// Benes permutation-network router.
//
// Computes the per-stage swap masks that realize a fixed permutation on a
// power-of-two array as 2*log2(N)-1 masked-swap stages (the edge and node
// routes of memgraph_tpu_torch/ops/spmv_mxu.py; algorithm documented in
// memgraph_tpu_torch/ops/benes.py, which holds the pure-python reference
// implementation). The classic looping algorithm: at every level, elements
// paired at the input stage and elements paired at the output stage form
// even cycles; 2-coloring each cycle assigns elements to the top/bottom
// half-network. O(N log N) total.
//
// Masks are bit-packed MSB-first per byte to match numpy.packbits.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC, at first use, by
// memgraph_tpu_torch/ops/native.py.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline void set_bit(uint8_t* bits, int64_t i, bool v) {
  if (v) bits[i >> 3] |= static_cast<uint8_t>(0x80u >> (i & 7));
}

}  // namespace

extern "C" {

// perm: gather form — output position i receives input position perm[i].
// masks_packed: caller-allocated (2*log2(N)-1) * (N/8) bytes, zeroed here.
// Returns 0 on success, 1 on invalid arguments.
int benes_route(const int64_t* perm, int64_t N, uint8_t* masks_packed) {
  if (N < 2 || (N & (N - 1))) return 1;
  int n = 0;
  while ((int64_t{1} << n) < N) n++;
  const int n_stages = 2 * n - 1;
  const int64_t bytes_per_stage = (N + 7) >> 3;
  std::memset(masks_packed, 0,
              static_cast<size_t>(n_stages) * bytes_per_stage);

  // forward[p] = q: element at input p must reach output q. The cycle
  // walk is cache-miss-bound at large N, so the 2-coloring state rides
  // in the TOP BITS of the fwd entries (bit 31 = colored, bit 30 =
  // color) instead of a separate halves[] array — one cacheline per
  // random access where there used to be two. Requires N < 2^30.
  if (N >= (int64_t{1} << 30)) return 1;
  constexpr uint32_t kColored = 0x80000000u;
  constexpr uint32_t kColor = 0x40000000u;
  constexpr uint32_t kValue = 0x3FFFFFFFu;
  std::vector<uint32_t> fwd(N, kValue), nxt(N);
  std::vector<int32_t> inv(N);
  for (int64_t i = 0; i < N; i++) {
    if (perm[i] < 0 || perm[i] >= N) return 1;
    if (fwd[perm[i]] != kValue) return 1;  // duplicate: not a bijection
    fwd[perm[i]] = static_cast<uint32_t>(i);
  }

  for (int level = 0; level < n - 1; level++) {
    const int64_t B = N >> level;
    const int64_t h = B >> 1;
    uint8_t* in_bits = masks_packed + int64_t(level) * bytes_per_stage;
    uint8_t* out_bits =
        masks_packed + int64_t(n_stages - 1 - level) * bytes_per_stage;
    for (int64_t base = 0; base < N; base += B) {
      uint32_t* f = fwd.data() + base;
      int32_t* iv = inv.data() + base;
      for (int64_t i = 0; i < B; i++)
        iv[f[i] & kValue] = static_cast<int32_t>(i);
      for (int64_t start = 0; start < B; start++) {
        if (f[start] & kColored) continue;
        int64_t i = start;
        uint32_t color = 0;  // 0 = top half, kColor = bottom half
        while (!(f[i] & kColored)) {
          f[i] |= kColored | color;
          const int64_t ip = i ^ h;  // input partner: the other half
          const uint32_t fip = f[ip];
          if (!(fip & kColored)) f[ip] = fip | kColored | (color ^ kColor);
          // ip's output partner: the element sharing ip's output pair
          const int64_t op_out = int64_t(f[ip] & kValue) ^ h;
          i = iv[op_out];
          color = (f[ip] & kColor) ^ kColor;
        }
      }
      // IN stage: element at local input i routed to half color(i); the
      // pair (i, i+h) swaps iff the element in the top slot goes bottom.
      for (int64_t i = 0; i < B; i++) {
        const bool bottom = (f[i] & kColor) != 0;
        set_bit(in_bits, base + i, bottom == (i < h));
      }
      // OUT stage: output o receives its element from half color(iv[o]).
      for (int64_t o = 0; o < B; o++) {
        const bool bottom = (f[iv[o]] & kColor) != 0;
        set_bit(out_bits, base + o, bottom == (o < h));
      }
      // Sub-permutations (forward form, local to each half; color and
      // colored bits are consumed here, nxt starts clean).
      uint32_t* top = nxt.data() + base;
      uint32_t* bot = nxt.data() + base + h;
      for (int64_t i = 0; i < B; i++) {
        const int64_t slot = i & (h - 1);
        const uint32_t val =
            static_cast<uint32_t>(int64_t(f[i] & kValue) & (h - 1));
        if (f[i] & kColor)
          bot[slot] = val;
        else
          top[slot] = val;
      }
    }
    fwd.swap(nxt);
  }
  // middle level: blocks of 2
  uint8_t* mid = masks_packed + int64_t(n - 1) * bytes_per_stage;
  for (int64_t base = 0; base < N; base += 2) {
    const bool sw = (fwd[base] & kValue) == 1;
    set_bit(mid, base, sw);
    set_bit(mid, base + 1, sw);
  }
  return 0;
}

}  // extern "C"
