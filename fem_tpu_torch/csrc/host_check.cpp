// Host build of the kernels' per-lane arithmetic (g++, no CUDA): the same
// header code as on the card. A filter-tail lane or an occurrence-slab item
// runs as one emulated warp or block (warp_emul.h), a Myers slot as one
// plain call, a compaction's blocks as emulated blocks one after the other
// (in ticket order, so a look-back never waits). The CPU tests hold these entry points against the plain torch
// versions.
#include <vector>

#include "warp_emul.h"

#include "compact_core.h"
#include "filter_tail_core.h"
#include "myers_core.h"
#include "occ_slab_core.h"

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

// A compaction's blocks one after the other, each as one emulated block,
// after zeroing its slab rows and scan state in `buf` (as the card's
// memset does).
template <class Src>
void compact_blocks(const Src& src, int T, int64_t nb, int64_t cap, int rows, void* buf) {
  int64_t words = cpt::slab_words(rows, cap);
  memset(buf, 0, words * sizeof(int32_t) + cpt::state_words(nb, T) * sizeof(uint64_t));
  uint64_t* state = reinterpret_cast<uint64_t*>(static_cast<int32_t*>(buf) + words);
  int64_t sc[cpt::kScratchWords];
  for (int64_t b = 0; b < cpt::blocks(nb, T); ++b)
    warp_emul::run_block(cpt::lanes_per_block(T) * T, [&](int tid) {
      cpt::compact_block(T, tid, src, nb, cap, state, sc);
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

// The occurrence slab's items one after the other, each as one emulated
// warp or block: of occ::threads(cap) threads, as on the card, or of
// `threads` (a multiple of 32). Arguments as fem_occ_slab's. Returns 0.
extern "C" int fem_host_occ_slab(const int64_t* off, const int64_t* lfreq,
                                 const int64_t* start, const uint8_t* lane_ok,
                                 const int64_t* occ_tab, int64_t n_occ,
                                 int64_t items, int S, int cap, int mode,
                                 const int64_t* tkey_in, int32_t* out_sid,
                                 int32_t* out_diag, uint8_t* overflow,
                                 int64_t* tkey_out, int threads) {
  int T = threads > 0 ? threads : occ::threads(cap);
  std::vector<int64_t> scratch(occ::scratch_words(S, T));
  for (int64_t item = 0; item < items; ++item)
    warp_emul::run_block(T, [&](int t) {
      occ::occ_slab_item(T, t, item, S, cap, mode, off, lfreq, start, lane_ok,
                         occ_tab, n_occ, tkey_in, out_sid, out_diag, overflow,
                         tkey_out, scratch.data());
    });
  return 0;
}

// The compactions, arguments as fem_verify_slab's and fem_accept_slab's;
// `threads` a multiple of 32 up to 1,024, 0 for the card's cpt::threads.
// Return 0.
extern "C" int fem_host_verify_slab(const int32_t* sid, const int32_t* pos,
                                    const int32_t* lens, const int32_t* ref_len,
                                    int num_seqs, const int32_t* own_start,
                                    const int32_t* own_end, int64_t nb, int cc, int e,
                                    int64_t cap, void* buf, int32_t* num, int64_t* off,
                                    int64_t* total, int threads) {
  int32_t* slab = static_cast<int32_t*>(buf);
  cpt::VerifySrc src{sid, pos, lens, ref_len, own_start, own_end, num_seqs, cc, e,
                     slab, slab + cap, slab + 2 * cap, num, off, total};
  compact_blocks(src, threads > 0 ? threads : cpt::threads(cc), nb, cap, 3, buf);
  return 0;
}

extern "C" int fem_host_accept_slab(const int32_t* v_sid, const int32_t* v_pos,
                                    const int32_t* ed, const int32_t* end,
                                    const uint8_t* accepted, const int32_t* num,
                                    const int64_t* off, int64_t nb, int cc, int64_t vcap,
                                    int64_t acap, void* buf, uint8_t* ok,
                                    int64_t* n_accepted, int threads) {
  int32_t* slab = static_cast<int32_t*>(buf);
  cpt::AcceptSrc src{v_sid, v_pos, ed, end, accepted, num, off, vcap, acap, slab,
                     slab + acap, slab + 2 * acap, slab + 3 * acap, slab + 4 * acap, ok,
                     n_accepted};
  compact_blocks(src, threads > 0 ? threads : cpt::threads(cc), nb, acap, 5, buf);
  return 0;
}
