// Host build of the kernels' per-lane arithmetic (g++, no CUDA): the same
// header code as on the card. A filter-tail lane runs as one emulated warp
// or block (warp_emul.h), a Myers slot as one plain call. The CPU tests
// hold these entry points against the plain torch versions.
#include <vector>

#include "warp_emul.h"

#include "filter_tail_core.h"
#include "myers_core.h"

namespace {

// Lanes one after the other, each as one emulated warp, on one scratch row.
void tail_lanes(int slab, const int32_t* sid, const int32_t* diag, int nb, int G,
                int cap, int cc, int e, int a, int32_t* out_sid,
                int32_t* out_pos, uint8_t* overflow) {
  std::vector<int64_t> scratch(2 * size_t(slab) + cc);
  int64_t* s = scratch.data();
  for (int b = 0; b < nb; ++b)
    warp_emul::run_warp([&](int t) {
      ft::filter_tail_lane(slab, sid, diag, b, G, cap, cc, e, a, s, s + slab,
                           s + 2 * size_t(slab), t, out_sid, out_pos, overflow);
    });
}

// Lanes one after the other, each as one emulated block of T threads.
void tail_block_lanes(int T, const int32_t* sid, const int32_t* diag, int nb,
                      int G, int cap, int cc, int e, int a, int32_t* out_sid,
                      int32_t* out_pos, uint8_t* overflow) {
  std::vector<int64_t> scratch(ft::block_words(cap, cc));
  for (int b = 0; b < nb; ++b)
    warp_emul::run_block(T, [&](int t) {
      ft::filter_tail_block_lane(T, sid, diag, b, G, cap, cc, e, a,
                                 scratch.data(), t, out_sid, out_pos, overflow);
    });
}

}  // namespace

// ft::plan, as fem_filter_tail_plan on the card.
extern "C" int fem_host_filter_tail_plan(int cap, int cc, int* threads,
                                         int64_t* words) {
  ft::Plan p = ft::plan(cap, cc);
  *threads = p.threads;
  *words = p.words;
  return p.route;
}

// The program is chosen as fem_filter_tail chooses it on the card
// (ft::plan): for a width up to 512 the warp lane at the slab width, the
// power of two >= cap_cand + cap_occ, at least 128; above, the block lane
// with `block_threads` threads (a multiple of 32; 0: the card's). Returns 0.
extern "C" int fem_host_filter_tail(const int32_t* sid, const int32_t* diag,
                                    int nb, int G, int cap, int cc, int e,
                                    int a, int32_t* out_sid, int32_t* out_pos,
                                    uint8_t* overflow, int block_threads) {
  ft::Plan p = ft::plan(cap, cc);
  if (p.route != ft::kWarpRoute) {
    tail_block_lanes(block_threads > 0 ? block_threads : p.threads, sid, diag,
                     nb, G, cap, cc, e, a, out_sid, out_pos, overflow);
    return 0;
  }
  int slab = 128;
  while (slab < cc + cap) slab <<= 1;
  tail_lanes(slab, sid, diag, nb, G, cap, cc, e, a, out_sid, out_pos, overflow);
  return 0;
}

extern "C" void fem_host_banded_myers(const uint8_t* ref, int64_t ref_len,
                                      const int64_t* ref_offsets, int num_seqs,
                                      const int32_t* v_sid,
                                      const int32_t* v_pos,
                                      const int32_t* v_lane,
                                      const uint8_t* both, const int32_t* lens,
                                      int nb, int lmax, int e, int num_slots,
                                      int used, int32_t* ed, int32_t* end) {
  for (int v = 0; v < num_slots; ++v)
    myers::verify_slot(ref, ref_len, ref_offsets, num_seqs, v_sid, v_pos,
                       v_lane, both, lens, nb, lmax, e, v, used, ed, end);
}
