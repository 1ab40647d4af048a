// Per-item arithmetic of the occurrence slab (ops/occ_slab.py has the
// rules: src/filter.c:80-106 and the last-seed truncation of
// src/filter.c:85). An item is one (read-strand lane, seed group); T
// threads work on it, a warp (T = 32) or a block, and `t` is the thread's
// index among them. Shared by csrc/occ_slab.cu and host_check.cpp, whose
// g++ build runs the same code through warp_emul.h for the CPU tests.
//
// The slab's rows of 8 slots are what the work is cut by: seed j owns
// the rows [pfx8[j] / 8, pfx8[j + 1] / 8), so a row belongs to one seed,
// found once a row, and its 8 int32 of either slab are one 32-byte store.
// Steps:
//   1. the item's seed table (CSR row start, row offset, clamped run
//      length, read offset) into scratch, its 8-aligned row starts pfx8 by
//      one thread's scan of the S row sizes;
//   2. each thread walks rows t, t + T, ...: a row of seeds 0 .. S - 2 is
//      gathered (occurrences read only for slots inside the run) and
//      written, and its valid keys raise the thread's bound; a row past
//      the last seed's is written as sentinels;
//   3. the bound is reduced over the item's threads (xor shuffles, then
//      one word a warp in scratch), and the last seed's rows are gathered
//      and written truncated at it.
// Modes (ops/occ_slab.py): the item's own bound and the slab (a whole
// index), the bound alone (a shard, before the reduction over shards), or
// the slab truncated at a given bound (a shard, after it), where the last
// seed's rows are written in step 2 and step 3 is skipped.
#pragma once

#include "ft_common.h"

namespace occ {

constexpr int kWarpMaxCap = 256;    // up to here a warp an item
constexpr int kBlockThreads = 256;  // above, a block of 256 threads an item
constexpr int kWarpsPerBlock = 8;   // items of a warp: eight to a block
constexpr int kMaxSeeds = 128;      // scratch of 8 warps' tables < 48 KB
constexpr int32_t kSentinelSid = 1 << 30;
constexpr int32_t kBig = 1 << 30;

enum Mode { kOwnBound = 0, kBoundOnly = 1, kGivenBound = 2 };

// Threads an item takes at cap_occ `cap`: a warp while a thread has at
// most one row, a block of 256 threads above (tier 1's 2,048 slots: a row
// a thread; tier 2's 16,384: eight).
FT_HHD int threads(int cap) { return cap <= kWarpMaxCap ? 32 : kBlockThreads; }

// int64 words of an item's scratch: pfx8, row base, row offset, clamped
// length and read offset of S seeds, the slab's end, a word a warp.
FT_HHD int64_t scratch_words(int S, int T) { return 5 * int64_t(S) + 1 + (T + 31) / 32; }

FT_HD int64_t load_occ(const int64_t* p) {
#ifdef __CUDACC__
  return __ldg(reinterpret_cast<const long long*>(p));
#else
  return *p;
#endif
}

// Eight int32 to a 32-byte-aligned address.
FT_HD void store8(int32_t* p, const int32_t v[8]) {
#ifdef __CUDACC__
  reinterpret_cast<int4*>(p)[0] = make_int4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<int4*>(p)[1] = make_int4(v[4], v[5], v[6], v[7]);
#else
  memcpy(p, v, 8 * sizeof(int32_t));
#endif
}

FT_HD void team_sync(int T) {
  if (T == 32)
    ft::warp_sync();
  else
    ft::block_sync();
}

// The maximum of m over the item's T threads, in every thread.
FT_HD int64_t team_max(int64_t m, int T, int t, int64_t* red) {
  for (int d = 16; d > 0; d >>= 1) {
    int64_t o = ft::warp_shfl_xor(m, d);
    m = o > m ? o : m;
  }
  if (T == 32) return m;
  if ((t & 31) == 0) red[t >> 5] = m;
  ft::block_sync();
  m = red[0];
  for (int w = 1; w < T / 32; ++w) m = red[w] > m ? red[w] : m;
  return m;
}

// The seed that owns slot `slot` < pfx8[S - 1]: the last of seeds 0 .. S - 2
// whose rows start at or before it (a seed with no rows owns none).
FT_HD int owner(const int64_t* pfx8, int S, int64_t slot) {
  int j = 0;
  for (int i = 1; i < S - 1; ++i) j += slot >= pfx8[i];
  return j;
}

// Row r of seed j: each slot's key sid << 32 | diag, and a bit for each
// valid slot (a mappable lane with a complete DP, inside the run, the
// occurrence at or after the seed's read offset: src/filter.c:89-90).
// Occurrences are read only for slots inside the run.
FT_HD uint32_t gather_row(const int64_t* sc, int S, int j, int64_t r, bool lane_ok,
                          const int64_t* occ, int64_t n_occ, int64_t key[8]) {
  const int64_t rel0 = 8 * r - sc[j], base = sc[S + j], srow = sc[2 * S + j],
                fc = sc[3 * S + j], start = sc[4 * S + j];
  uint32_t ok = 0;
  for (int k = 0; k < 8; ++k) {
    int64_t rel = rel0 + k;
    key[k] = 0;
    if (!lane_ok || rel < srow || rel >= srow + fc) continue;
    int64_t i = base + rel;
    i = i >= n_occ ? n_occ - 1 : i;
    int64_t o = load_occ(occ + (i < 0 ? 0 : i));
    int64_t pos = o & 0xFFFFFFFFLL;
    if (pos < start) continue;
    key[k] = int64_t((uint64_t(o >> 32) << 32) | uint64_t(pos - start));
    ok |= 1u << k;
  }
  return ok;
}

// Row r of both slabs: the valid slots' sid and diag as int32, the others
// (SENTINEL_SID, BIG).
FT_HD void store_row(int32_t* sid, int32_t* diag, int64_t r, const int64_t key[8],
                     uint32_t ok) {
  int32_t s[8], d[8];
  for (int k = 0; k < 8; ++k) {
    bool v = (ok >> k) & 1;
    s[k] = v ? int32_t(key[k] >> 32) : kSentinelSid;
    d[k] = v ? int32_t(uint32_t(key[k])) : kBig;
  }
  store8(sid + 8 * r, s);
  store8(diag + 8 * r, d);
}

// The last seed's row r, truncated at `bound` (src/filter.c:85).
FT_HD void last_row(const int64_t* sc, int S, int64_t r, bool lane_ok, const int64_t* occ,
                    int64_t n_occ, int64_t bound, int32_t* sid, int32_t* diag) {
  int64_t key[8];
  uint32_t ok = gather_row(sc, S, S - 1, r, lane_ok, occ, n_occ, key);
  for (int k = 0; k < 8; ++k)
    if (key[k] > bound) ok &= ~(1u << k);
  store_row(sid, diag, r, key, ok);
}

// One item: off, lfreq and start are the (items, S) seed tables, lane_ok
// the (items,) flags; writes the item's rows of the (items, cap) slabs
// (not in kBoundOnly), its overflow flag and bound (not in kGivenBound,
// which reads tkey_in). sc: scratch_words(S, T) words of the item's own.
FT_HD void occ_slab_item(int T, int t, int64_t item, int S, int cap, int mode,
                         const int64_t* off, const int64_t* lfreq, const int64_t* start,
                         const uint8_t* lane_ok, const int64_t* occ, int64_t n_occ,
                         const int64_t* tkey_in, int32_t* out_sid, int32_t* out_diag,
                         uint8_t* overflow, int64_t* tkey_out, int64_t* sc) {
  int64_t* pfx8 = sc;
  int64_t* endp = sc + 5 * S;
  const int64_t at = item * S;
  for (int j = t; j < S; j += T) {
    int64_t o = off[at + j], f = lfreq[at + j];
    f = f < cap + 1 ? f : cap + 1;
    pfx8[j] = f > 0 ? (((o & 7) + f + 7) / 8) * 8 : 0;  // rows' slots; scanned below
    sc[S + j] = o & ~int64_t(7);
    sc[2 * S + j] = o & 7;
    sc[3 * S + j] = f;
    sc[4 * S + j] = start[at + j];
  }
  team_sync(T);
  if (t == 0) {
    int64_t acc = 0;
    for (int j = 0; j < S; ++j) {
      int64_t n = pfx8[j];
      pfx8[j] = acc;
      acc += n;
    }
    *endp = acc;
  }
  team_sync(T);
  const int64_t P = pfx8[S - 1], end = *endp;
  const bool ok_lane = lane_ok[item] != 0;
  if (t == 0 && mode != kGivenBound) overflow[item] = end > cap;
  const int64_t rows = cap / 8;
  const int64_t rows_a = (P < cap ? P : cap) / 8;        // rows of seeds 0 .. S - 2
  const int64_t rows_b = (end < cap ? end : cap) / 8;    // then the last seed's
  const bool write = mode != kBoundOnly;
  int32_t* os = write ? out_sid + item * cap : nullptr;
  int32_t* od = write ? out_diag + item * cap : nullptr;
  int64_t m = -1;
  int64_t key[8] = {};
  for (int64_t r = t; r < (write ? rows : rows_a); r += T) {
    if (r < rows_a) {
      uint32_t ok = gather_row(sc, S, owner(pfx8, S, 8 * r), r, ok_lane, occ, n_occ, key);
      for (int k = 0; k < 8; ++k)
        if (((ok >> k) & 1) && key[k] > m) m = key[k];
      if (write) store_row(os, od, r, key, ok);
    } else if (r >= rows_b) {
      store_row(os, od, r, key, 0);
    } else if (mode == kGivenBound) {
      last_row(sc, S, r, ok_lane, occ, n_occ, tkey_in[item], os, od);
    }
  }
  if (mode == kGivenBound) return;
  m = team_max(m, T, t, endp + 1);
  if (t == 0) tkey_out[item] = m;
  if (mode == kOwnBound)
    for (int64_t r = rows_a + t; r < rows_b; r += T)
      last_row(sc, S, r, ok_lane, occ, n_occ, m, os, od);
}

}  // namespace occ
