// Host build of the kernels' per-lane arithmetic (g++, no CUDA): each
// lane or slot runs the same header code as on the card, by one thread.
// The CPU tests hold these entry points against the plain torch versions.
#include <vector>

#include "filter_tail_core.h"
#include "myers_core.h"

extern "C" void fem_host_filter_tail(const int32_t* sid, const int32_t* diag,
                                     int nb, int G, int cap, int cc, int e,
                                     int a, int32_t* out_sid, int32_t* out_pos,
                                     uint8_t* overflow) {
  int slabn = 1;
  while (slabn < cc + cap) slabn <<= 1;
  std::vector<int64_t> scratch(2 * slabn + cc);
  int64_t* s = scratch.data();
  for (int b = 0; b < nb; ++b)
    ft::filter_tail_lane(sid, diag, b, G, cap, cc, e, a, slabn, s, s + slabn,
                         s + 2 * slabn, 0, 1, out_sid, out_pos, overflow);
}

extern "C" void fem_host_banded_myers(const uint8_t* ref, int64_t ref_len,
                                      const int64_t* ref_offsets, int num_seqs,
                                      const int32_t* v_sid,
                                      const int32_t* v_pos,
                                      const int32_t* v_lane,
                                      const uint8_t* both, const int32_t* lens,
                                      int nb, int lmax, int e, int num_slots,
                                      int32_t* ed, int32_t* end) {
  for (int v = 0; v < num_slots; ++v)
    myers::verify_slot(ref, ref_len, ref_offsets, num_seqs, v_sid, v_pos,
                       v_lane, both, lens, nb, lmax, e, v, ed, end);
}
