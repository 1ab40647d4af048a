// Per-lane arithmetic of the candidate-filter tail: sort, additional-q-gram
// vote, merge with the carried list, greedy +-e dedup fold
// (src/filter.c:45-144; fem_tpu/ops/filter_tail_pallas.py:_filter_tail_kernel).
//
// A (sid, diag) pair travels as one int64 key sid << 32 | diag: both lie in
// [0, 2^30], so key order is the lexicographic (sid, diag) order and one
// compare-exchange moves both. An invalid slot has sid 2^30 and is dropped
// when the slab is read, so only valid keys are ever sorted.
//
// One warp works on one read-strand lane; `t` is the thread's index in the
// warp. Per seed group:
//   1. compact  the slab's valid keys into shared memory (ballot + popc);
//   2. sort     the next power of two of the valid count: in registers by
//               xor-shuffles when it is <= 32, in shared memory above;
//   3. vote     slot i survives if its a-th successor has the same sid and
//               a diagonal within e; the survivors' ranks come from a ballot;
//   4. merge    carried list (ascending) | sentinels | survivors (descending)
//               is a bitonic sequence: one bitonic merge sorts it;
//   5. fold     the greedy scan keeps key 0 and then always the first key
//               more than e past the last kept one, i.e. the orbit of 0
//               under nxt(i) = first j with key[j] > key[i] + e. nxt is a
//               binary search; the orbit is marked by pointer doubling in
//               log2 rounds (registers) or walked by one thread, which stops
//               once cap_cand + 1 keys are kept (shared memory).
// Every count that steers a branch (n, nv, m) is the same in all 32 threads.
#pragma once

#include "ft_common.h"

namespace ft {

constexpr int64_t kSentinelSid = int64_t(1) << 30;
constexpr int64_t kBig = int64_t(1) << 30;
constexpr int64_t kSentKey = (kSentinelSid << 32) | kBig;
// Widest slab (cap_cand + cap_occ rounded up to a power of two) whose
// per-lane scratch fits one block's shared memory; wider slabs take their
// scratch from a global-memory workspace.
constexpr int kMaxSmemSlab = 8192;

// int64 words of scratch a lane needs: buf[slab], merged[slab], carry[cc].
FT_HD int64_t scratch_words(int slab, int cc) { return 2 * int64_t(slab) + cc; }

FT_HD int64_t pack(int32_t sid, int32_t diag) {
  return (int64_t(sid) << 32) | int64_t(uint32_t(diag));
}
FT_HD int64_t key_sid(int64_t k) { return k >> 32; }
FT_HD int64_t key_diag(int64_t k) { return k & 0xFFFFFFFFLL; }
FT_HD int pow2_ge(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}
FT_HD int64_t pick(int64_t x, int64_t y, bool take_min) {
  return (x < y) == take_min ? x : y;
}

// ---- registers: thread t holds key t of at most 32 ------------------------

// Ascending bitonic sort of the keys of threads [0, p), p a power of two.
FT_HD int64_t reg_sort(int64_t k, int p, int t) {
  for (int kk = 2; kk <= p; kk <<= 1)
    for (int j = kk >> 1; j > 0; j >>= 1)
      k = pick(k, warp_shfl_xor(k, j), ((t & kk) == 0) == ((t & j) == 0));
  return k;
}

// Threads [0, p) hold a bitonic sequence; afterwards it ascends.
FT_HD int64_t reg_merge(int64_t k, int p, int t) {
  for (int j = p >> 1; j > 0; j >>= 1)
    k = pick(k, warp_shfl_xor(k, j), (t & j) == 0);
  return k;
}

// Greedy fold of the m <= 32 ascending keys held by threads [0, m). Writes
// the first cc kept keys to carry and returns how many were kept.
FT_HD int reg_fold(int64_t x, int m, int e, int cc, int t, int64_t* carry) {
  // nxt: how many keys are <= x + e, found by a binary search over threads.
  int64_t target = x + e;
  int pos = 0;
  for (int step = 32; step > 0; step >>= 1) {
    int64_t probe = warp_shfl(x, pos + step - 1);
    if (pos + step <= m && probe <= target) pos += step;
  }
  int ptr = (t < m && pos < m) ? pos : 32;  // 32: no successor
  uint32_t kept = m > 0 ? 1u : 0u;
  for (int span = 1; span < m; span <<= 1) {
    bool mine = (kept >> t) & 1;
    kept |= warp_or(mine && ptr < 32 ? 1u << ptr : 0u);
    int hop = warp_shfl(int32_t(ptr), ptr);
    ptr = ptr < 32 ? hop : 32;
  }
  int rank = popc(kept & ((1u << t) - 1));
  if (((kept >> t) & 1) && rank < cc) carry[rank] = x;
  return popc(kept);
}

// ---- shared memory: 32 threads share n keys -------------------------------

// Threads share the n/2 compare-exchanges of one step of a bitonic network.
FT_HD void smem_step(int64_t* keys, int n, int k, int j, int t) {
  for (int q = t; q < (n >> 1); q += 32) {
    int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));  // bit j of i clear
    int64_t x = keys[i], y = keys[i + j];
    if ((x > y) == ((i & k) == 0) && x != y) {
      keys[i] = y;
      keys[i + j] = x;
    }
  }
  warp_sync();
}

FT_HD void smem_sort(int64_t* keys, int n, int t) {
  for (int k = 2; k <= n; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) smem_step(keys, n, k, j, t);
}

FT_HD void smem_merge(int64_t* keys, int n, int t) {
  for (int j = n >> 1; j > 0; j >>= 1) smem_step(keys, n, 2 * n, j, t);
}

// Pigeonhole vote on the sorted keys s[0, n) (src/filter.c:118-131).
FT_HD bool vote(const int64_t* s, int n, int i, int a, int e) {
  if (i >= n) return false;
  if (a == 0) return true;
  if (i + a >= n) return false;
  int64_t k = s[i], k2 = s[i + a];
  return key_sid(k2) == key_sid(k) && key_diag(k2) <= key_diag(k) + e;
}

// Greedy fold of the m ascending keys s[0, m); nxt[0, m) is scratch.
FT_HD int smem_fold(const int64_t* s, int64_t* nxt, int m, int e, int cc, int t,
                    int64_t* carry) {
  for (int i = t; i < m; i += 32) {
    int64_t target = s[i] + e;
    int lo = i + 1, hi = m;  // first j in [lo, hi] with s[j] > target
    while (lo < hi) {
      int mid = (lo + hi) >> 1;
      if (s[mid] <= target) lo = mid + 1; else hi = mid;
    }
    nxt[i] = lo;
  }
  warp_sync();
  int n_keep = 0;
  if (t == 0) {
    for (int i = 0; i < m && n_keep <= cc; i = int(nxt[i])) {
      if (n_keep < cc) carry[n_keep] = s[i];
      ++n_keep;
    }
  }
  return warp_shfl(int32_t(n_keep), 0);
}

// ---- one lane ---------------------------------------------------------------

// Valid keys of one (lane, group) slab row, compacted into buf (any order).
FT_HD int compact_row(const int32_t* sid, const int32_t* diag, int cap, int t,
                      int64_t* buf) {
  const uint32_t below = (1u << t) - 1;
  int n = 0;
  bool quads = (cap & 3) == 0 && ((uintptr_t(sid) | uintptr_t(diag)) & 15) == 0;
  if (quads) {  // 16-byte loads: thread t takes slots [4t, 4t + 4) of each 128
    for (int i0 = 0; i0 < cap; i0 += 128) {
      int i = i0 + 4 * t;
      int32_t s[4] = {int32_t(kSentinelSid), int32_t(kSentinelSid),
                      int32_t(kSentinelSid), int32_t(kSentinelSid)};
      int32_t d[4] = {0, 0, 0, 0};
      if (i < cap) {
        load_quad(sid + i, s);
        load_quad(diag + i, d);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bool valid = s[j] != int32_t(kSentinelSid);
        uint32_t m = warp_ballot(valid);
        if (valid) buf[n + popc(m & below)] = pack(s[j], d[j]);
        n += popc(m);
      }
    }
  } else {
    for (int i0 = 0; i0 < cap; i0 += 32) {
      int i = i0 + t;
      int32_t s = i < cap ? sid[i] : int32_t(kSentinelSid);
      bool valid = s != int32_t(kSentinelSid);
      uint32_t m = warp_ballot(valid);
      if (valid) buf[n + popc(m & below)] = pack(s, diag[i]);
      n += popc(m);
    }
  }
  warp_sync();
  return n;
}

// Lane b of the (nb, G, cap) slabs -> its cc candidates and overflow flag.
// Scratch per lane: buf[kSlab], merged[kSlab], carry[cc], with kSlab a power
// of two >= cc + cap, in shared or in global memory: the steps only see
// pointers. The groups fold in order inside the lane. kSlab is a compile-time
// constant where the caller has one (the function is inlined).
FT_HD void filter_tail_lane(const int kSlab, const int32_t* sid,
                            const int32_t* diag, int b,
                            int G, int cap, int cc, int e, int a,
                            int64_t* buf, int64_t* merged, int64_t* carry,
                            int t, int32_t* out_sid, int32_t* out_pos,
                            uint8_t* overflow) {
  const uint32_t below = (1u << t) - 1;
  int nc = 0;  // keys carried so far, ascending in carry[0, nc)
  bool ovf = false;
  for (int g = 0; g < G; ++g) {
    int64_t row = (int64_t(b) * G + g) * cap;
    int n = compact_row(sid + row, diag + row, cap, t, buf);

    // sort + vote; survivor of rank r goes to merged[kSlab - 1 - r]
    int nv = 0;
    if (n <= 32) {
      int64_t k = reg_sort(t < n ? buf[t] : kSentKey, pow2_ge(n), t);
      bool keep = t < n;
      if (a > 0) {
        int64_t k2 = warp_shfl(k, t + a);
        keep = t + a < n && key_sid(k2) == key_sid(k) &&
               key_diag(k2) <= key_diag(k) + e;
      }
      uint32_t m = warp_ballot(keep);
      if (keep) merged[kSlab - 1 - popc(m & below)] = k;
      nv = popc(m);
    } else {
      int p = pow2_ge(n);
      for (int i = n + t; i < p; i += 32) buf[i] = kSentKey;
      warp_sync();
      smem_sort(buf, p, t);
      for (int i0 = 0; i0 < n; i0 += 32) {
        bool keep = vote(buf, n, i0 + t, a, e);
        uint32_t m = warp_ballot(keep);
        if (keep) merged[kSlab - 1 - (nv + popc(m & below))] = buf[i0 + t];
        nv += popc(m);
      }
    }
    warp_sync();
    if (nv == 0) continue;  // folding the carried list alone changes nothing

    // merge with the carried list, then fold
    int m = nc + nv, p = pow2_ge(m), n_keep;
    if (m <= 32) {
      int64_t x = kSentKey;
      if (t < nc) x = carry[t];
      else if (t >= p - nv && t < p) x = merged[kSlab - p + t];
      x = reg_merge(x, p, t);
      n_keep = reg_fold(x, m, e, cc, t, carry);
    } else {
      for (int i = t; i < p; i += 32)
        buf[i] = i < nc ? carry[i] : (i >= p - nv ? merged[kSlab - p + i] : kSentKey);
      warp_sync();
      smem_merge(buf, p, t);
      n_keep = smem_fold(buf, merged, m, e, cc, t, carry);
    }
    ovf |= n_keep > cc;
    nc = n_keep < cc ? n_keep : cc;
    warp_sync();
  }
  for (int i = t; i < cc; i += 32) {
    int64_t k = i < nc ? carry[i] : kSentKey;
    out_sid[int64_t(b) * cc + i] = int32_t(key_sid(k));
    out_pos[int64_t(b) * cc + i] = int32_t(key_diag(k));
  }
  if (t == 0) overflow[b] = ovf;
}

}  // namespace ft
