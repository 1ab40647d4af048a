// Per-lane arithmetic of the candidate-filter tail: sort, additional-q-gram
// vote, merge with the carried list, greedy +-e dedup fold
// (src/filter.c:45-144; fem_tpu/ops/filter_tail_pallas.py:_filter_tail_kernel).
//
// A (sid, diag) pair travels as one int64 key sid << 32 | diag: both lie in
// [0, 2^30], so key order is the lexicographic (sid, diag) order and one
// compare-exchange moves both. An invalid slot has sid 2^30 and is dropped
// when the slab is read, so only valid keys are ever sorted.
//
// Two lane programs share the steps. Up to cap_cand + cap_occ = 512
// (`filter_tail_lane`) one warp works on one read-strand lane; `t` is the
// thread's index in the warp. Per seed group:
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
//
// Wider slabs (`filter_tail_block_lane`) take a block of T threads a lane,
// and every step is block-wide: the compaction's and the vote's ranks and
// the fold's kept count are block prefix sums (warp shuffles, then one
// barrier over the warps' totals); the sort's steps with partners 32 or
// more apart stride by T between barriers, and the others of a stage run
// in registers by shuffles, one pass without barriers; the survivors, kept
// ascending, merge with the carried list by merge path (each thread finds
// where its share of the output starts by a co-rank binary search: no
// padding, no sentinels); the fold's orbit of 0 is marked by pointer
// doubling over shared memory, one barrier a round, and the kept keys are
// ranked by a prefix sum. `plan` decides which program and scratch a width
// takes, for the card and for the host build alike.
#pragma once

#include "ft_common.h"

namespace ft {

constexpr int64_t kSentinelSid = int64_t(1) << 30;
constexpr int64_t kBig = int64_t(1) << 30;
constexpr int64_t kSentKey = (kSentinelSid << 32) | kBig;

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

// ---- a block per lane: T threads share one lane ----------------------------

// Where a width goes (`plan`): cap_cand + cap_occ up to kWarpWidth takes the
// warp program above, four lanes a block; wider takes a block a lane, with
// its scratch in dynamic shared memory while it fits kMaxBlockSmem and in a
// global-memory workspace row above.
constexpr int64_t kWarpWidth = 512;
constexpr int64_t kMaxBlockSmem = 232448;  // Hopper: 227 KB a block, opt-in
constexpr int kRedWords = 32;              // block_scan's 64 int32, first
enum Route { kWarpRoute = 0, kBlockRoute = 1, kWorkspaceRoute = 2 };

struct Plan {
  int route;
  int threads;      // threads a lane: a warp, or the block
  int64_t words;    // a lane's scratch in int64 words (block routes; 0 else)
};

FT_HHD int64_t pow2_ge64(int64_t n) {
  int64_t p = 1;
  while (p < n) p <<= 1;
  return p;
}

// A block lane's scratch, in int64 words after the kRedWords of block_scan:
//   sort[S]    the group's valid keys, padded to a power of two and sorted;
//              in the fold, nxt as int32 (ping)
//   surv[V]    the survivors of the vote, ascending; in the fold, nxt (pong)
//   carry[cc]  the carried list, ascending
//   merged[cc + cap]
// S and V also hold cc + cap int32 each, for the fold.
FT_HHD int64_t sort_words(int cap, int cc) {
  int64_t half = (int64_t(cc) + cap + 1) / 2;
  int64_t p = pow2_ge64(cap);
  return p > half ? p : half;
}
FT_HHD int64_t surv_words(int cap, int cc) {
  int64_t half = (int64_t(cc) + cap + 1) / 2;
  return cap > half ? cap : half;
}
FT_HHD int64_t block_words(int cap, int cc) {
  return kRedWords + sort_words(cap, cc) + surv_words(cap, cc) + 2 * int64_t(cc) + cap;
}

// The one rule of which program, block size and scratch a width takes.
FT_HHD Plan plan(int cap, int cc) {
  int64_t width = int64_t(cc) + cap;
  if (width <= kWarpWidth) return {kWarpRoute, 32, 0};
  int threads = width <= 2048 ? 256 : 1024;
  int64_t words = block_words(cap, cc);
  return {words * 8 <= kMaxBlockSmem ? kBlockRoute : kWorkspaceRoute, threads, words};
}

// Exclusive prefix sum of x over the block's T threads; `total` gets the sum.
// red holds 2 x 32 int32; `flip` alternates the halves, so that one barrier
// a scan is enough: a half is written again only after the next scan's
// barrier, which every reader of this one has passed.
FT_HD int block_scan(int x, int T, int tid, int32_t* red, int& flip, int& total) {
  int lane = tid & 31, warp = tid >> 5;
  int inc = x;
  for (int d = 1; d < 32; d <<= 1) {
    int32_t y = warp_shfl(int32_t(inc), lane >= d ? lane - d : 0);
    if (lane >= d) inc += y;
  }
  int32_t* r = red + 32 * flip;
  flip ^= 1;
  if (lane == 31) r[warp] = inc;
  block_sync();
  int w = lane < (T >> 5) ? r[lane] : 0;
  for (int d = 1; d < 32; d <<= 1) {
    int32_t y = warp_shfl(int32_t(w), lane >= d ? lane - d : 0);
    if (lane >= d) w += y;
  }
  total = warp_shfl(int32_t(w), 31);
  int32_t before = warp_shfl(int32_t(w), warp > 0 ? warp - 1 : 0);
  return (warp > 0 ? before : 0) + inc - x;
}

// [lo, hi): thread tid's contiguous share of n items.
FT_HD void share(int n, int T, int tid, int& lo, int& hi) {
  int per = (n + T - 1) / T;
  lo = tid * per < n ? tid * per : n;
  hi = lo + per < n ? lo + per : n;
}

// Valid keys of one (lane, group) slab row, compacted into buf (any order).
FT_HD int block_compact_row(const int32_t* sid, const int32_t* diag, int cap,
                            int T, int tid, int32_t* red, int& flip,
                            int64_t* buf) {
  int n = 0;
  bool quads = (cap & 3) == 0 && ((uintptr_t(sid) | uintptr_t(diag)) & 15) == 0;
  for (int i0 = 0; i0 < cap; i0 += quads ? 4 * T : T) {
    int32_t s[4] = {int32_t(kSentinelSid), int32_t(kSentinelSid),
                    int32_t(kSentinelSid), int32_t(kSentinelSid)};
    int32_t d[4] = {0, 0, 0, 0};
    if (quads) {  // 16-byte loads: thread tid takes slots [4 tid, 4 tid + 4)
      int i = i0 + 4 * tid;
      if (i < cap) {
        load_quad(sid + i, s);
        load_quad(diag + i, d);
      }
    } else if (i0 + tid < cap) {
      s[0] = sid[i0 + tid];
      d[0] = diag[i0 + tid];
    }
    uint32_t valid = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) valid |= uint32_t(s[j] != int32_t(kSentinelSid)) << j;
    int total;
    int at = n + block_scan(popc(valid), T, tid, red, flip, total);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if ((valid >> j) & 1) buf[at + popc(valid & ((1u << j) - 1))] = pack(s[j], d[j]);
    n += total;
  }
  block_sync();
  return n;
}

// Bitonic steps of stages k_lo..k_hi whose partners lie within aligned runs
// of 32 keys (j <= 16), in registers: warp w takes the runs w, w + W, ...,
// one key a thread, and needs no barrier between steps. Keys at or past n
// (n < 32 only) are sentinels that pair among themselves.
FT_HD void reg_steps(int64_t* keys, int n, int k_lo, int k_hi, int T, int tid) {
  int lane = tid & 31;
  for (int r = (tid >> 5) * 32; r < (n < 32 ? 32 : n); r += T) {
    int g = r + lane;
    int64_t x = g < n ? keys[g] : kSentKey;
    for (int k = k_lo; k <= k_hi; k <<= 1)
      for (int j = (k < 32 ? k : 32) >> 1; j > 0; j >>= 1)
        x = pick(x, warp_shfl_xor(x, j), ((g & k) == 0) == ((g & j) == 0));
    if (g < n) keys[g] = x;
  }
}

// Ascending bitonic sort of keys[0, n), n a power of two: the steps with
// partners 32 or more apart in shared memory, one barrier each; the others
// of a stage in one register pass.
FT_HD void block_sort(int64_t* keys, int n, int T, int tid) {
  reg_steps(keys, n, 2, n < 32 ? n : 32, T, tid);
  block_sync();
  for (int k = 64; k <= n; k <<= 1) {
    for (int j = k >> 1; j >= 32; j >>= 1) {
      for (int q = tid; q < (n >> 1); q += T) {
        int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));  // bit j of i clear
        int64_t x = keys[i], y = keys[i + j];
        if ((x > y) == ((i & k) == 0) && x != y) {
          keys[i] = y;
          keys[i + j] = x;
        }
      }
      block_sync();
    }
    reg_steps(keys, n, k, k, T, tid);
    block_sync();
  }
}

// Merge path: out[k0, k1) of the ascending merge of x[0, nx) and y[0, ny),
// ties taken from x first. The co-rank binary search finds how many of the
// first k0 outputs come from x.
FT_HD void merge_share(const int64_t* x, int nx, const int64_t* y, int ny,
                       int k0, int k1, int64_t* out) {
  int lo = k0 > ny ? k0 - ny : 0, hi = k0 < nx ? k0 : nx;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (x[mid] <= y[k0 - 1 - mid]) lo = mid + 1; else hi = mid;
  }
  int i = lo, j = k0 - lo;
  for (int k = k0; k < k1; ++k)
    out[k] = (j >= ny || (i < nx && x[i] <= y[j])) ? x[i++] : y[j++];
}

// Greedy fold of the m ascending keys s[0, m), block-wide: the first cc kept
// keys go to carry; returns how many were kept. A key is marked kept by
// bit 62 of its word (a valid key lies below 2^62). nxt and jump are
// scratch of m int32 each: entry i is i's successor (m: none),
// pointer-doubled each round.
FT_HD int block_fold(int64_t* s, int32_t* nxt, int32_t* jump, int m, int e,
                     int cc, int T, int tid, int32_t* red, int& flip,
                     int64_t* carry) {
  constexpr int64_t kKept = int64_t(1) << 62;
  int lo, hi;
  share(m, T, tid, lo, hi);
  // nxt over the thread's share: nxt is monotone, so each search gallops
  // from the last one's answer j, where s[j - 1] <= target already holds.
  for (int i = lo, j = lo + 1; i < hi; ++i) {
    int64_t target = s[i] + e;
    if (j < i + 1) j = i + 1;
    int end = j, step = 1;  // s[end] > target, or end = m
    while (end < m && s[end] <= target) {
      j = end + 1;
      end += step;
      step <<= 1;
    }
    if (end > m) end = m;
    while (j < end) {  // first index in [j, end] with s[index] > target
      int mid = (j + end) >> 1;
      if (s[mid] <= target) j = mid + 1; else end = mid;
    }
    nxt[i] = j;
  }
  if (tid == 0 && m > 0) s[0] |= kKept;  // no search reads s[0]
  block_sync();
  // After round r every key within 2^r hops of key 0 along nxt is marked,
  // so one barrier a round is enough: marks land on the orbit only and
  // never go away, so a mark seen early changes nothing, and the jumps
  // read one array and write the other.
  int32_t *A = nxt, *B = jump;
  for (int span = 1; span < m; span <<= 1) {
    for (int i = tid; i < m; i += T) {
      int p = A[i];
      if (p < m && (s[i] & kKept)) s[p] |= kKept;
      B[i] = p < m ? A[p] : m;
    }
    block_sync();
    int32_t* t = A;
    A = B;
    B = t;
  }
  int c = 0, n_keep;
  for (int i = lo; i < hi; ++i) c += (s[i] & kKept) != 0;
  int at = block_scan(c, T, tid, red, flip, n_keep);
  for (int i = lo; i < hi; ++i)
    if (s[i] & kKept) {
      if (at < cc) carry[at] = s[i] & ~kKept;
      ++at;
    }
  block_sync();
  return n_keep;
}

// Lane b of the (nb, G, cap) slabs -> its cc candidates and overflow flag,
// run by the T threads of one block (tid its thread). `scratch` holds
// block_words(cap, cc) int64 words, in shared or in global memory: the
// steps only see pointers. T is a compile-time constant where the caller
// has one (the function is inlined).
FT_HD void filter_tail_block_lane(const int T, const int32_t* sid,
                                  const int32_t* diag, int b, int G, int cap,
                                  int cc, int e, int a, int64_t* scratch,
                                  int tid, int32_t* out_sid, int32_t* out_pos,
                                  uint8_t* overflow) {
  int32_t* red = reinterpret_cast<int32_t*>(scratch);
  int64_t* buf = scratch + kRedWords;
  int64_t* surv = buf + sort_words(cap, cc);
  int64_t* carry = surv + surv_words(cap, cc);
  int64_t* merged = carry + cc;
  int flip = 0;
  int nc = 0;  // keys carried so far, ascending in carry[0, nc)
  bool ovf = false;
  for (int g = 0; g < G; ++g) {
    int64_t row = (int64_t(b) * G + g) * cap;
    int n = block_compact_row(sid + row, diag + row, cap, T, tid, red, flip, buf);
    int p = pow2_ge(n);
    for (int i = n + tid; i < p; i += T) buf[i] = kSentKey;
    block_sync();
    block_sort(buf, p, T, tid);

    // vote: each thread its contiguous share, survivors ascending
    int lo, hi, c = 0, nv;
    share(n, T, tid, lo, hi);
    for (int i = lo; i < hi; ++i) c += vote(buf, n, i, a, e);
    int at = block_scan(c, T, tid, red, flip, nv);
    for (int i = lo; i < hi; ++i)
      if (vote(buf, n, i, a, e)) surv[at++] = buf[i];
    block_sync();
    if (nv == 0) continue;  // folding the carried list alone changes nothing

    int m = nc + nv;
    share(m, T, tid, lo, hi);
    merge_share(carry, nc, surv, nv, lo, hi, merged);
    block_sync();
    int n_keep = block_fold(merged, reinterpret_cast<int32_t*>(buf),
                            reinterpret_cast<int32_t*>(surv), m, e, cc, T, tid,
                            red, flip, carry);
    ovf |= n_keep > cc;
    nc = n_keep < cc ? n_keep : cc;
  }
  for (int i = tid; i < cc; i += T) {
    int64_t k = i < nc ? carry[i] : kSentKey;
    out_sid[int64_t(b) * cc + i] = int32_t(key_sid(k));
    out_pos[int64_t(b) * cc + i] = int32_t(key_diag(k));
  }
  if (tid == 0) overflow[b] = ovf;
}

}  // namespace ft
