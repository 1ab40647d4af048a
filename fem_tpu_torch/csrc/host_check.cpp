// Host build of the kernels' per-lane arithmetic (g++, no CUDA): the same
// header code as on the card. A filter-tail lane runs as one emulated warp
// (warp_emul.h), a Myers slot as one plain call. The CPU tests hold these
// entry points against the plain torch versions.
#include <vector>

#include "warp_emul.h"

#include "filter_tail_core.h"
#include "myers_core.h"

namespace {

template <int kSlab>
void tail_lanes(const int32_t* sid, const int32_t* diag, int nb, int G, int cap,
                int cc, int e, int a, int32_t* out_sid, int32_t* out_pos,
                uint8_t* overflow) {
  std::vector<int64_t> scratch(2 * kSlab + cc);
  int64_t* s = scratch.data();
  for (int b = 0; b < nb; ++b)
    warp_emul::run_warp([&](int t) {
      ft::filter_tail_lane<kSlab>(sid, diag, b, G, cap, cc, e, a, s, s + kSlab,
                                  s + 2 * kSlab, t, out_sid, out_pos, overflow);
    });
}

}  // namespace

// Returns 0, or 1 when cap_cand + cap_occ exceeds the kernel's bound.
extern "C" int fem_host_filter_tail(const int32_t* sid, const int32_t* diag,
                                    int nb, int G, int cap, int cc, int e,
                                    int a, int32_t* out_sid, int32_t* out_pos,
                                    uint8_t* overflow) {
  auto go = [&](auto fn) {
    fn(sid, diag, nb, G, cap, cc, e, a, out_sid, out_pos, overflow);
    return 0;
  };
  if (cc + cap <= 128) return go(tail_lanes<128>);
  if (cc + cap <= 256) return go(tail_lanes<256>);
  if (cc + cap <= ft::kMaxSlab) return go(tail_lanes<ft::kMaxSlab>);
  return 1;
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
