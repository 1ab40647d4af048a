// The occurrence slab on Hopper: each (read-strand lane, seed group)'s
// selected seeds' CSR runs gathered into cap_occ int32 slots, the slabs
// the filter tail reads, with the last-seed truncation applied.
//
// Replaces no Pallas kernel: fem_tpu builds this slab with XLA ops
// (fem_tpu/ops/candidates.py). Its plain torch version (ops/occ_slab.py)
// is some 45 passes over an (NB, G, cap_occ) int64 slab (the owning seed
// of each slot, five gathers of the seed tables, the occurrence gather,
// shifts, masks, compares, the key, the truncation, two int64 -> int32
// copies): 15.36 M slots a 10,000-read batch at tier 0, each pass 123 MB,
// and those passes took the largest share of the card's time in both
// benchmark cells, while a group holds a few valid occurrences.
//
// What bounds it: bytes. It must write the two int32 slabs (8 B a slot)
// and read the seed tables (24 B a seed) and the valid occurrences (8 B
// each); nothing else. Design (occ_slab_core.h has the steps): a warp an
// item up to cap_occ 256 (tier 0: a row of 8 slots a thread), a block of
// 256 threads above (occ::threads); a thread gathers only the slots
// inside a run, writes each row of both slabs as two 16-byte stores, and
// the item's bound is a shuffle reduction, so the slab is written once,
// already truncated: one launch a step on a whole index. On a shard of a
// coordinate-sharded index the bound is reduced over the shards between
// two launches: the bound alone, then the slab at the reduced bound.
// Offsets into the occurrence table stay 64-bit (3.0 Gb: 999,999,915
// occurrences).
#include <cuda_runtime.h>

#include "occ_slab_core.h"

namespace {

template <int T>
__global__ void __launch_bounds__(T == 32 ? 32 * occ::kWarpsPerBlock : T)
occ_slab_kernel(const int64_t* off, const int64_t* lfreq, const int64_t* start,
                const uint8_t* lane_ok, const int64_t* occ_tab, int64_t n_occ,
                int64_t items, int S, int cap, int mode, const int64_t* tkey_in,
                int32_t* out_sid, int32_t* out_diag, uint8_t* overflow,
                int64_t* tkey_out) {
  extern __shared__ int64_t smem[];
  const int64_t words = occ::scratch_words(S, T);
  int64_t item = blockIdx.x;
  int t = threadIdx.x;
  int64_t* sc = smem;
  if (T == 32) {  // a warp an item, several to a block
    int warp = threadIdx.x >> 5;
    item = int64_t(blockIdx.x) * occ::kWarpsPerBlock + warp;
    if (item >= items) return;  // warp-uniform: the whole warp leaves
    t = threadIdx.x & 31;
    sc = smem + warp * words;
  }
  occ::occ_slab_item(T, t, item, S, cap, mode, off, lfreq, start, lane_ok,
                     occ_tab, n_occ, tkey_in, out_sid, out_diag, overflow,
                     tkey_out, sc);
}

// An item a warp, eight warps a block (T = 32), or an item a block.
template <int T>
int launch(const void* off, const void* lfreq, const void* start,
           const void* lane_ok, const void* occ_tab, int64_t n_occ,
           int64_t items, int S, int cap, int mode, const void* tkey_in,
           void* out_sid, void* out_diag, void* overflow, void* tkey_out,
           cudaStream_t stream) {
  int per_block = T == 32 ? occ::kWarpsPerBlock : 1;
  int64_t blocks = (items + per_block - 1) / per_block;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  size_t smem = per_block * occ::scratch_words(S, T) * sizeof(int64_t);
  occ_slab_kernel<T><<<(unsigned)blocks, T * per_block, smem, stream>>>(
      (const int64_t*)off, (const int64_t*)lfreq, (const int64_t*)start,
      (const uint8_t*)lane_ok, (const int64_t*)occ_tab, n_occ, items, S, cap,
      mode, (const int64_t*)tkey_in, (int32_t*)out_sid, (int32_t*)out_diag,
      (uint8_t*)overflow, (int64_t*)tkey_out);
  return (int)cudaGetLastError();
}

}  // namespace

// off, lfreq, start: (items, S) int64; lane_ok: (items,) bool; occ: n_occ
// int64 keys. mode 0 (own bound) and 2 (given bound, tkey_in) write the
// (items, cap) int32 slabs; modes 0 and 1 (bound only) write overflow and
// tkey_out, (items,) each.
extern "C" int fem_occ_slab(const void* off, const void* lfreq, const void* start,
                            const void* lane_ok, const void* occ_tab, int64_t n_occ,
                            int64_t items, int S, int cap, int mode,
                            const void* tkey_in, void* out_sid, void* out_diag,
                            void* overflow, void* tkey_out, void* stream) {
  bool given = mode == occ::kGivenBound, slab = mode != occ::kBoundOnly;
  if (items < 1 || S < 1 || S > occ::kMaxSeeds || cap < 8 || cap % 8 ||
      n_occ < 0 || mode < 0 || mode > 2 || given != (tkey_in != nullptr) ||
      slab != (out_sid != nullptr && out_diag != nullptr) ||
      given == (overflow != nullptr && tkey_out != nullptr))
    return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  auto go = occ::threads(cap) == 32 ? launch<32> : launch<occ::kBlockThreads>;
  return go(off, lfreq, start, lane_ok, occ_tab, n_occ, items, S, cap, mode,
            tkey_in, out_sid, out_diag, overflow, tkey_out, st);
}
