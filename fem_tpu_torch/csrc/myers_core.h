// Per-slot arithmetic of banded Myers verification
// (src/align.c:102-147; fem_tpu/ops/verify_pallas.py:_myers_kernel).
//
// Pattern = the reference window [base, base + L + 2e) of the flat code
// array, text = the read; a band of 2e+1 <= 15 bits in uint32 VP/VN. The
// DP runs while i < length; a final 2e-step band scan returns the least
// edit distance and the first end offset that attains it. No 3e early
// exit: it only rejects what the full run rejects too.
#pragma once

#include "ft_common.h"

namespace myers {

FT_HD void step(uint32_t eq, uint32_t& VP, uint32_t& VN, int32_t& nerr) {
  uint32_t X = eq | VN;
  uint32_t D0 = ((VP + (X & VP)) ^ VP) | X;
  uint32_t HN = VP & D0;
  uint32_t HP = VN | ~(VP | D0);
  uint32_t X2 = D0 >> 1;
  VN = X2 & HP;
  VP = HN | ~(X2 | HP);
  nerr += 1 - int32_t(D0 & 1);
}

// Final band scan (src/align.c:135-146): the end offset records the first
// strict improvement of the running minimum.
FT_HD void band_scan(uint32_t VP, uint32_t VN, int32_t nerr, int32_t length,
                     int e, int32_t* ed, int32_t* end) {
  int32_t min_err = nerr, end_ = length - 1;
  for (int i = 0; i < 2 * e; ++i) {
    nerr += int32_t((VP >> i) & 1) - int32_t((VN >> i) & 1);
    if (nerr < min_err) {
      min_err = nerr;
      end_ = length + i;
    }
  }
  *ed = min_err;
  *end = end_;
}

// Byte g of the flat reference, clamped into [0, n) like the plain gather.
FT_HD uint64_t ref_byte(const uint8_t* ref, int64_t n, int64_t g) {
  return ref[g < 0 ? 0 : (g >= n ? n - 1 : g)];
}

// Slot v: window from ref_offsets[sid] + pos, text = row v_lane[v] of the
// (nb, lmax) read codes. sid and lane are clamped into range.
FT_HD void verify_slot(const uint8_t* ref, int64_t ref_len,
                       const int64_t* ref_offsets, int num_seqs,
                       const int32_t* v_sid, const int32_t* v_pos,
                       const int32_t* v_lane, const uint8_t* both,
                       const int32_t* lens, int nb, int lmax, int e, int v,
                       int32_t* ed, int32_t* end) {
  int sid = v_sid[v] < 0 ? 0 : (v_sid[v] >= num_seqs ? num_seqs - 1 : v_sid[v]);
  int lane = v_lane[v] < 0 ? 0 : (v_lane[v] >= nb ? nb - 1 : v_lane[v]);
  int64_t base = ref_offsets[sid] + v_pos[v];
  const uint8_t* text = both + int64_t(lane) * lmax;
  int32_t length = lens[lane];
  // Window bytes [i, i + 16) at step i, little-endian in (lo, hi): bit j
  // of Eq compares byte j with text[i], and the pair slides one byte a step.
  uint64_t lo = 0, hi = 0;
  for (int j = 0; j < 8; ++j) {
    lo |= ref_byte(ref, ref_len, base + j) << (8 * j);
    hi |= ref_byte(ref, ref_len, base + 8 + j) << (8 * j);
  }
  uint32_t VP = 0, VN = 0;
  int32_t nerr = 0;
  int steps = length < 0 ? 0 : (length < lmax ? length : lmax);
  for (int i = 0; i < steps; ++i) {
    uint64_t t = text[i];
    uint32_t eq = 0;
#pragma unroll
    for (int j = 0; j < 15; ++j) {
      uint64_t byte = j < 8 ? (lo >> (8 * j)) & 0xFF : (hi >> (8 * (j - 8))) & 0xFF;
      if (j <= 2 * e) eq |= uint32_t(byte == t) << j;
    }
    step(eq, VP, VN, nerr);
    lo = (lo >> 8) | (hi << 56);
    hi = (hi >> 8) | (ref_byte(ref, ref_len, base + i + 16) << 56);
  }
  band_scan(VP, VN, nerr, length, e, ed + v, end + v);
}

}  // namespace myers
