// Per-lane arithmetic of the candidate-filter tail: sort, additional-q-gram
// vote, merge with the carried list, greedy +-e dedup fold
// (src/filter.c:45-144; fem_tpu/ops/filter_tail_pallas.py:_filter_tail_kernel).
//
// A (sid, diag) pair travels as one int64 key sid << 32 | diag: both lie in
// [0, 2^30], so key order is the lexicographic (sid, diag) order and one
// compare-exchange moves both. Invalid slots are (2^30, 2^30), the largest
// key. Worker t of nt shares a lane's work; FT_SYNC separates the steps.
#pragma once

#include "ft_common.h"

namespace ft {

constexpr int64_t kSentinelSid = int64_t(1) << 30;
constexpr int64_t kBig = int64_t(1) << 30;
constexpr int64_t kSentKey = (kSentinelSid << 32) | kBig;
constexpr int kMaxSlab = 512;  // cap_cand + cap_occ rounded up to a power of two

FT_HD int64_t pack(int32_t sid, int32_t diag) {
  return (int64_t(sid) << 32) | int64_t(uint32_t(diag));
}
FT_HD int64_t key_sid(int64_t k) { return k >> 32; }
FT_HD int64_t key_diag(int64_t k) { return k & 0xFFFFFFFFLL; }

// Ascending bitonic sort of n keys (n a power of two): each step is n/2
// independent compare-exchanges, handed round-robin to the workers.
FT_HD void bitonic_sort(int64_t* keys, int n, int t, int nt) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int q = t; q < (n >> 1); q += nt) {
        int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));  // bit j of i clear
        int p = i + j;
        bool asc = (i & k) == 0;
        int64_t x = keys[i], y = keys[p];
        if (x != y && (x > y) == asc) {
          keys[i] = y;
          keys[p] = x;
        }
      }
      FT_SYNC();
    }
  }
}

// Pigeonhole vote on the sorted slab s[0, n) (src/filter.c:118-131): slot
// i survives only if its a-th successor has the same sid and a diagonal
// within e. Returns the key, or the sentinel when voted out.
FT_HD int64_t vote(const int64_t* s, int n, int i, int a, int e) {
  int64_t k = s[i];
  if (a == 0) return k;
  if (key_sid(k) == kSentinelSid || i + a >= n) return kSentKey;
  int64_t k2 = s[i + a];
  bool ok = key_sid(k2) == key_sid(k) && key_diag(k2) <= key_diag(k) + e;
  return ok ? k : kSentKey;
}

// Greedy +-e dedup over the sorted merge m[0, n) (src/filter.c:45-78): a
// key is kept when it opens a new sid or lies more than e past the last
// kept one, so a later group's key can evict an earlier winner. Writes the
// first cc kept keys (ascending) to out, pads with sentinels, and returns
// how many were kept (> cc means overflow).
FT_HD int greedy_fold(const int64_t* m, int n, int e, int64_t* out, int cc) {
  int64_t last_s = -1, last_d = 0;
  int n_keep = 0;
  for (int i = 0; i < n; ++i) {
    int64_t k = m[i];
    int64_t s = key_sid(k), d = key_diag(k);
    if (s == kSentinelSid) break;  // sorted: only sentinels follow
    if (s > last_s || (s == last_s && d > last_d + e)) {
      if (n_keep < cc) out[n_keep] = k;
      ++n_keep;
      last_s = s;
      last_d = d;
    }
  }
  for (int i = n_keep; i < cc; ++i) out[i] = kSentKey;
  return n_keep;
}

// Lane b of the (nb, G, cap) slabs -> its cc candidates and overflow flag.
// Scratch per lane: slab[slabn], merged[slabn], carry[cc], with slabn the
// power of two >= cc + cap. The groups fold in order inside the lane.
FT_HD void filter_tail_lane(const int32_t* sid, const int32_t* diag, int b,
                            int G, int cap, int cc, int e, int a, int slabn,
                            int64_t* slab, int64_t* merged, int64_t* carry,
                            int t, int nt, int32_t* out_sid, int32_t* out_pos,
                            uint8_t* overflow) {
  for (int i = t; i < cc; i += nt) carry[i] = kSentKey;
  bool ovf = false;
  for (int g = 0; g < G; ++g) {
    int64_t row = (int64_t(b) * G + g) * cap;
    for (int i = t; i < slabn; i += nt)
      slab[i] = i < cap ? pack(sid[row + i], diag[row + i]) : kSentKey;
    FT_SYNC();
    bitonic_sort(slab, slabn, t, nt);
    // merged = carried list | voted slab[0, cap) | sentinel fill
    for (int i = t; i < slabn; i += nt) {
      int64_t k = kSentKey;
      if (i < cc)
        k = carry[i];
      else if (i < cc + cap)
        k = vote(slab, slabn, i - cc, a, e);
      merged[i] = k;
    }
    FT_SYNC();
    bitonic_sort(merged, slabn, t, nt);
    if (t == 0) ovf |= greedy_fold(merged, cc + cap, e, carry, cc) > cc;
    FT_SYNC();
  }
  for (int i = t; i < cc; i += nt) {
    out_sid[int64_t(b) * cc + i] = int32_t(key_sid(carry[i]));
    out_pos[int64_t(b) * cc + i] = int32_t(key_diag(carry[i]));
  }
  if (t == 0) overflow[b] = ovf;
}

}  // namespace ft
