// Per-slot arithmetic of banded Myers verification
// (src/align.c:102-147; fem_tpu/ops/verify_pallas.py:_myers_kernel).
//
// Pattern = the reference window [base, base + L + 2e) of the flat code
// array, text = the read; a band of 2e+1 <= 15 bits in uint32 VP/VN. The
// DP runs while i < length; a final 2e-step band scan returns the least
// edit distance and the first end offset that attains it. No 3e early
// exit: it only rejects what the full run rejects too.
//
// Eq comes from bit planes. Codes are below 8 (A C G T = 0..3, N and the
// gap sentinel = 4), so a byte string is three bit strings, one per bit of
// the code. Window and read are read 32 bytes at a time with 16-byte loads
// and turned into plane words; then bit j of Eq at step i is
//   ~((w0 ^ t0) | (w1 ^ t1) | (w2 ^ t2))   at bit i + j of the window planes,
// with tk = bit i of the read's plane k spread over the word: three funnel
// shifts and a few logic operations, and the loop is the recurrence itself.
#pragma once

#include "ft_common.h"

namespace myers {

using ft::funnel_r;

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

// Bit k of 32 consecutive codes, one word per k.
struct Planes {
  uint32_t b0, b1, b2;
};

// Bit k of each of the four bytes of w, as bits 0..3.
FT_HD uint32_t nibble(uint32_t w, int k) {
  return (((w >> k) & 0x01010101u) * 0x01020408u) >> 24;
}

FT_HD Planes planes_of(const uint32_t w[8]) {
  Planes p = {0, 0, 0};
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    p.b0 |= nibble(w[q], 0) << (4 * q);
    p.b1 |= nibble(w[q], 1) << (4 * q);
    p.b2 |= nibble(w[q], 2) << (4 * q);
  }
  return p;
}

// The plane words of an array's bytes [start, start + 32), [start + 32, ...)
// and so on. Chunks are read at 16-byte-aligned addresses and shifted into
// place; an index outside [0, n) reads the nearest byte inside, like the
// plain gather, and such a chunk is assembled byte by byte.
struct Stream {
  const uint8_t* arr;
  int64_t n;
  int64_t g;  // index of the aligned chunk held in `a`
  int o;      // start - g, in [0, 16)
  Planes a;

  FT_HD void fetch(int64_t at, uint32_t w[8]) const {
    if (at >= 0 && at + 32 <= n) {
      ft::load16(arr + at, w);
      ft::load16(arr + at + 16, w + 4);
      return;
    }
    for (int q = 0; q < 8; ++q) w[q] = 0;
    for (int i = 0; i < 32; ++i) {
      int64_t idx = at + i < 0 ? 0 : (at + i >= n ? n - 1 : at + i);
      w[i >> 2] |= uint32_t(arr[idx]) << (8 * (i & 3));
    }
  }
  FT_HD void init(const uint8_t* arr_, int64_t n_, int64_t start) {
    arr = arr_, n = n_;
    o = int((uintptr_t(arr_) + uintptr_t(start)) & 15);
    g = start - o;
    uint32_t w[8];
    fetch(g, w);
    a = planes_of(w);
  }
  FT_HD void fetch_next(uint32_t w[8]) const { fetch(g + 32, w); }
  // The next 32 bytes' planes, given the chunk fetch_next() read.
  FT_HD Planes advance(const uint32_t w[8]) {
    Planes b = planes_of(w), out;
    out.b0 = funnel_r(a.b0, b.b0, o);
    out.b1 = funnel_r(a.b1, b.b1, o);
    out.b2 = funnel_r(a.b2, b.b2, o);
    a = b;
    g += 32;
    return out;
  }
  FT_HD Planes next() {
    uint32_t w[8];
    fetch_next(w);
    return advance(w);
  }
};

// All ones where bit s of x is set, else zero.
FT_HD uint32_t spread(uint32_t x, int s) { return 0u - ((x >> s) & 1u); }

// Slot v: window from ref_offsets[sid] + pos, text = row v_lane[v] of the
// (nb, lmax) read codes. sid and lane are clamped into range. Slots at or
// past `used` are not computed: they get ed = e + 1 and end = -1.
FT_HD void verify_slot(const uint8_t* ref, int64_t ref_len,
                       const int64_t* ref_offsets, int num_seqs,
                       const int32_t* v_sid, const int32_t* v_pos,
                       const int32_t* v_lane, const uint8_t* both,
                       const int32_t* lens, int nb, int lmax, int e, int v,
                       int used, int32_t* ed, int32_t* end) {
  if (v >= used) {
    ed[v] = e + 1;
    end[v] = -1;
    return;
  }
  int sid = v_sid[v] < 0 ? 0 : (v_sid[v] >= num_seqs ? num_seqs - 1 : v_sid[v]);
  int lane = v_lane[v] < 0 ? 0 : (v_lane[v] >= nb ? nb - 1 : v_lane[v]);
  int32_t length = lens[lane];
  int steps = length < 0 ? 0 : (length < lmax ? length : lmax);
  const uint32_t band = (2u << (2 * e)) - 1;

  Stream W, T;
  W.init(ref, ref_len, ref_offsets[sid] + v_pos[v]);
  T.init(both, int64_t(nb) * lmax, int64_t(lane) * lmax);
  // Window bits [i0, i0 + 64) in (wlo, whi), read bits [i0, i0 + 32) in tx.
  Planes wlo = W.next(), whi = W.next(), tx = T.next();
  uint32_t VP = 0, VN = 0;
  int32_t nerr = 0;
  for (int i0 = 0; i0 < steps; i0 += 32) {
    bool more = i0 + 32 < steps;
    uint32_t rw[8], rt[8];
    if (more) {  // the next block's bytes are on their way during this one
      W.fetch_next(rw);
      T.fetch_next(rt);
    }
    int cnt = steps - i0 < 32 ? steps - i0 : 32;
    for (int s = 0; s < cnt; ++s) {
      uint32_t d0 = funnel_r(wlo.b0, whi.b0, s) ^ spread(tx.b0, s);
      uint32_t d1 = funnel_r(wlo.b1, whi.b1, s) ^ spread(tx.b1, s);
      uint32_t d2 = funnel_r(wlo.b2, whi.b2, s) ^ spread(tx.b2, s);
      step(~(d0 | d1 | d2) & band, VP, VN, nerr);
    }
    if (more) {
      wlo = whi;
      whi = W.advance(rw);
      tx = T.advance(rt);
    }
  }
  band_scan(VP, VN, nerr, length, e, ed + v, end + v);
}

}  // namespace myers
