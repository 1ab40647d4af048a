// Per-block code of the slab compactions (ops/compact.py has the rules:
// the range filter of src/filter.c:133-144 and the verify-slab and accept
// compactions of fem_tpu's map_core). Shared by csrc/compact.cu and
// host_check.cpp, whose g++ build runs the same code through warp_emul.h
// for the CPU tests.
//
// One algorithm, two sources. A compaction takes NB lanes, each a list of
// items, and a predicate; it writes every lane's passing items, in order,
// at the lane's offset plus the item's rank among them, below `cap`, and
// reports each lane's count, offset and whatever else its source keeps.
// The offsets are an exclusive scan of the NB lane counts, not of the
// items. A team of T threads takes a lane: a warp (T = 32, eight lanes to
// a block) up to a width of 512, a whole block of 256 or 1,024 threads
// above (cpt::threads). Steps of a block:
//   1. a ticket (an atomic counter) numbers the block in the order blocks
//      start, so every block it waits for below has started;
//   2. each team counts its lane's passing items, T at a time (a ballot a
//      warp, then the block's warps' counts in scratch); a verify lane
//      stops at its first sentinel, since the filter tail writes each list
//      ascending with its sentinels last;
//   3. warp 0 publishes the block's sum and walks back over the blocks
//      before it, 32 at a time, adding their sums until one whose
//      inclusive prefix is known (a decoupled look-back), then publishes
//      its own inclusive prefix: the block's exclusive offset;
//   4. each team walks its lane again and writes each passing item at its
//      offset plus its rank, where below cap; its first thread writes the
//      lane's count and offset, and the last lane's the total.
// The caller zeroes the slab and the scan's state first (one memset), so
// the slots past the total hold 0.
#pragma once

#include "ft_common.h"

namespace cpt {

constexpr int32_t kSentinelSid = 1 << 30;
constexpr int kWarpMaxWidth = 512;  // up to here a warp a lane
constexpr int kLanesPerBlock = 8;   // lanes of a warp each, to a block
constexpr int kScratchWords = 2 + kLanesPerBlock + 32;
constexpr uint64_t kAggregate = 1ull << 62;  // a block's own sum is known
constexpr uint64_t kInclusive = 2ull << 62;  // its inclusive prefix is known
constexpr uint64_t kValue = (1ull << 62) - 1;

// Threads a lane at list width `width`: a warp, or a block of 256 (up to
// tier 1's 2,048) or 1,024 (tier 2's 16,384).
FT_HHD int threads(int width) { return width <= kWarpMaxWidth ? 32 : (width <= 4096 ? 256 : 1024); }
FT_HHD int lanes_per_block(int T) { return T == 32 ? kLanesPerBlock : 1; }
FT_HHD int64_t blocks(int64_t nb, int T) {
  return (nb + lanes_per_block(T) - 1) / lanes_per_block(T);
}
// int32 words of `rows` slab rows of `cap` slots, rounded up to whole
// int64 words: the scan's state follows them in the caller's buffer.
FT_HHD int64_t slab_words(int rows, int64_t cap) { return (rows * cap + 1) & ~int64_t(1); }
// int64 words of the scan's state: the ticket, then a status word a block.
FT_HHD int64_t state_words(int64_t nb, int T) { return 1 + blocks(nb, T); }

FT_HD uint64_t take_ticket(uint64_t* p) {
#ifdef __CUDACC__
  return atomicAdd(reinterpret_cast<unsigned long long*>(p), 1ull);
#else
  return (*p)++;
#endif
}

FT_HD uint64_t load_status(const uint64_t* p) {
#ifdef __CUDACC__
  return *reinterpret_cast<const volatile unsigned long long*>(p);
#else
  return *p;
#endif
}

FT_HD void store_status(uint64_t* p, uint64_t v) {
#ifdef __CUDACC__
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
#else
  *p = v;
#endif
}

FT_HD int lowest_bit(uint32_t x) {
#ifdef __CUDACC__
  return __ffs(x) - 1;
#else
  return __builtin_ffs(x) - 1;
#endif
}

struct Chunk {
  int rank;   // this thread's rank among the chunk's passing items
  int count;  // the chunk's passing items
  bool end;   // some thread of the team met the list's end
};

// One chunk of T items across the team (a warp, or the whole block with
// `red`, T / 32 words of scratch).
FT_HD Chunk team_chunk(int T, int t, bool pass, bool end, int64_t* red) {
  uint32_t m = ft::warp_ballot(pass), s = ft::warp_ballot(end);
  int below = ft::popc(m & ((1u << (t & 31)) - 1u));
  if (T == 32) return {below, ft::popc(m), s != 0};
  if ((t & 31) == 0) red[t >> 5] = ft::popc(m) | (s ? 64 : 0);
  ft::block_sync();
  int before = 0, count = 0;
  bool any = false;
  for (int w = 0; w < T / 32; ++w) {
    int c = int(red[w] & 63);
    before += w < (t >> 5) ? c : 0;
    count += c;
    any = any || (red[w] & 64) != 0;
  }
  ft::block_sync();  // red is written again by the next chunk
  return {before + below, count, any};
}

// One walk over a lane's items by its team. Returns the lane's passing
// items; with `write`, each goes to slot offset + its rank, where below cap.
template <class Src>
FT_HD int64_t lane_pass(int T, int t, const Src& src, int64_t lane, bool write,
                        int64_t offset, int64_t cap, int64_t* red) {
  const int64_t n = src.size(lane);
  int64_t run = 0;
  for (int64_t base = 0; base < n; base += T) {
    const int64_t i = base + t;
    bool pass = false, end = false;
    if (i < n) src.test(lane, i, pass, end);
    Chunk c = team_chunk(T, t, pass, end, red);
    if (write && pass && offset + run + c.rank < cap) src.put(lane, i, offset + run + c.rank);
    run += c.count;
    if (c.end) break;
  }
  return run;
}

// The exclusive prefix of block `vb`'s sum `agg` over the blocks before it,
// by the 32 threads of the warp that calls it (`l` its lane): publishes
// the sum, adds the sums of the blocks before it, 32 at a time, down to
// the nearest whose inclusive prefix is known, and publishes its own.
FT_HD int64_t look_back(uint64_t* status, int64_t vb, int64_t agg, int l) {
  if (l == 0) store_status(status + vb, (vb == 0 ? kInclusive : kAggregate) | uint64_t(agg));
  int64_t excl = 0;
  for (int64_t i = vb - 1; i >= 0; i -= 32) {
    const int64_t j = i - l;
    uint64_t s = j >= 0 ? load_status(status + j) : kInclusive;
    while (ft::warp_ballot((s >> 62) == 0))
      if ((s >> 62) == 0) s = load_status(status + j);
    uint32_t inc = ft::warp_ballot((s >> 62) == 2);
    int k = inc ? lowest_bit(inc) : 31;  // the nearest known prefix, or all 32
    int64_t v = l <= k ? int64_t(s & kValue) : 0;
    for (int d = 16; d > 0; d >>= 1) v += ft::warp_shfl_xor(v, d);
    excl += v;
    if (inc) break;
  }
  if (l == 0 && vb > 0) store_status(status + vb, kInclusive | uint64_t(excl + agg));
  return excl;
}

// One block of a compaction: thread `tid` of T * lanes_per_block(T);
// `state` the zeroed ticket and status words, `sc` kScratchWords of the
// block's shared scratch.
template <class Src>
FT_HD void compact_block(int T, int tid, const Src& src, int64_t nb, int64_t cap,
                         uint64_t* state, int64_t* sc) {
  const int team = tid / T, t = tid % T;
  const int lanes = lanes_per_block(T);
  int64_t* counts = sc + 2;
  int64_t* red = sc + 2 + kLanesPerBlock;
  if (tid == 0) sc[0] = int64_t(take_ticket(state));
  ft::block_sync();
  const int64_t vb = sc[0];
  const int64_t lane = vb * lanes + team;
  const bool live = lane < nb;  // the team's own; a block team's is the block's
  const int64_t count = live ? lane_pass(T, t, src, lane, false, 0, 0, red) : 0;
  if (t == 0) counts[team] = count;
  ft::block_sync();
  if (tid < 32) {
    int64_t agg = 0;
    for (int k = 0; k < lanes; ++k) agg += counts[k];
    int64_t excl = look_back(state + 1, vb, agg, tid);
    if (tid == 0) sc[1] = excl;
  }
  ft::block_sync();
  int64_t offset = sc[1];
  for (int k = 0; k < team; ++k) offset += counts[k];
  if (!live) return;
  lane_pass(T, t, src, lane, true, offset, cap, red);
  if (t == 0) src.lane_done(lane, offset, count, lane == nb - 1);
}

// The verify slab: lane b's items are its (cc,) candidate list; an item
// passes the range filter (src/filter.c:133-144): not the sentinel, at or
// past e, its band's end inside the chromosome, and on a shard of a
// coordinate-sharded index inside the shard's owned range. A passing
// candidate goes to the slab shifted by -e to its band start, with its
// lane. A lane's count is its num_candidates.
struct VerifySrc {
  const int32_t* sid;        // (nb, cc) filter-tail lists
  const int32_t* pos;        // (nb, cc) their diagonals
  const int32_t* lens;       // (nb,) read lengths
  const int32_t* ref_len;    // (num_seqs,) chromosome lengths
  const int32_t* own_start;  // (num_seqs,) or null on a whole index
  const int32_t* own_end;
  int num_seqs, cc, e;
  int32_t *v_sid, *v_pos, *v_lane;  // (cap,) each
  int32_t* num;                     // (nb,) lane counts
  int64_t* off;                     // (nb,) lane offsets
  int64_t* total;                   // one word

  FT_HD int64_t size(int64_t) const { return cc; }
  FT_HD void test(int64_t lane, int64_t i, bool& pass, bool& end) const {
    const int64_t at = lane * cc + i;
    const int32_t s = sid[at];
    end = s == kSentinelSid;
    if (end) return;
    const int32_t p = pos[at];
    const int c = s < 0 ? 0 : (s >= num_seqs ? num_seqs - 1 : s);
    pass = p >= e && int64_t(p) + lens[lane] + e < ref_len[c];
    if (own_start) pass = pass && p >= own_start[c] && p < own_end[c];
  }
  FT_HD void put(int64_t lane, int64_t i, int64_t slot) const {
    const int64_t at = lane * cc + i;
    v_sid[slot] = sid[at];
    v_pos[slot] = pos[at] - e;
    v_lane[slot] = int32_t(lane);
  }
  FT_HD void lane_done(int64_t lane, int64_t offset, int64_t count, bool last) const {
    num[lane] = int32_t(count);
    off[lane] = offset;
    if (last) *total = offset + count;
  }
};

// The accept slab: lane b's items are its verify-slab slots [off[b],
// off[b] + num[b]) cut at vcap; an item passes where Myers accepted it. A
// lane is whole (ok) where both its verify span and its accept span end
// within their caps.
struct AcceptSrc {
  const int32_t *v_sid, *v_pos, *ed, *end;  // (vcap,) each
  const uint8_t* accepted;                  // (vcap,)
  const int32_t* num;                       // (nb,) verify lane counts
  const int64_t* off;                       // (nb,) verify lane offsets
  int64_t vcap, acap;
  int32_t *a_lane, *a_sid, *a_pos, *a_ed, *a_end;  // (acap,) each
  uint8_t* ok;                                     // (nb,)
  int64_t* n_accepted;                             // one word

  FT_HD int64_t size(int64_t lane) const {
    const int64_t lo = off[lane], end = lo + num[lane], hi = end < vcap ? end : vcap;
    return hi > lo ? hi - lo : 0;
  }
  FT_HD void test(int64_t lane, int64_t i, bool& pass, bool& end) const {
    pass = accepted[off[lane] + i] != 0;
    end = false;
  }
  FT_HD void put(int64_t lane, int64_t i, int64_t slot) const {
    const int64_t v = off[lane] + i;
    a_lane[slot] = int32_t(lane);
    a_sid[slot] = v_sid[v];
    a_pos[slot] = v_pos[v];
    a_ed[slot] = ed[v];
    a_end[slot] = end[v];
  }
  FT_HD void lane_done(int64_t lane, int64_t offset, int64_t count, bool last) const {
    ok[lane] = off[lane] + num[lane] <= vcap && offset + count <= acap;
    if (last) *n_accepted = offset + count;
  }
};

}  // namespace cpt
