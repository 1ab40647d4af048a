// Candidate-filter tail on Hopper: sort + pigeonhole vote + greedy dedup
// fold of each read-strand lane's seed-group slabs.
//
// Replaces fem_tpu/ops/filter_tail_pallas.py: filter_tail_pallas /
// _filter_tail_kernel (with its bitonic _sort2).
//
// What bounds it: bytes. Each lane reads its G * cap_occ * 8 bytes once and
// writes cap_cand * 8 + 1; the arithmetic on the few valid keys of a slab
// is small beside that, so the least time is the slabs' bytes over the
// memory rate. What kept the first version far from it was work on
// sentinels: two 128-key shared-memory sorts per group whatever the slab
// held, and a one-thread scan.
// Design (filter_tail_core.h has the steps): one warp per lane; the slab is
// read with 16-byte loads and its valid keys compacted by ballot, so all
// later work is in the valid count. Up to 32 keys are sorted, voted, merged
// with the carried list and folded entirely in registers by shuffles; the
// carried list is already sorted, so it is merged (log n steps), not
// sorted again; the greedy fold is a binary search plus pointer doubling.
// Larger counts take the same steps in shared memory. The TPU kernel
// carried the list from one grid step to the next along a sequential grid
// axis; GPU blocks run in no order, so the warp loops over the G groups
// itself. The slab width kSlab (cap_cand + cap_occ rounded up to a power of
// two) is a template parameter, 128 to 8192: the retry tiers' wide slabs are
// further instantiations of the same lane code. A lane's scratch is
// (2 * kSlab + cap_cand) * 8 bytes of dynamic shared memory, so the warps a
// block holds follow the width: four while their scratch fits 48 KB, one
// above (163,840 bytes at kSlab = 8192, cap_cand = 4096, of the 232,448 a
// block may ask for). Above 8192 the scratch is a global-memory workspace
// the caller allocates, one row per block, and each one-warp block walks
// over lanes: the same lane code on other pointers.
#include <cuda_runtime.h>

#include "filter_tail_core.h"

namespace {

constexpr int kWarpsPerBlock = 4;           // while the block's scratch fits
constexpr size_t kPlainSmem = 48 * 1024;    // what a block gets without opt-in
constexpr size_t kMaxBlockSmem = 232448;    // Hopper: 227 KB a block, opt-in

// Scratch in shared memory: one warp per lane.
template <int kSlab>
__global__ void filter_tail_kernel(const int32_t* sid, const int32_t* diag,
                                   int nb, int G, int cap, int cc, int e,
                                   int a, int32_t* out_sid, int32_t* out_pos,
                                   uint8_t* overflow) {
  extern __shared__ int64_t smem[];
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= nb) return;  // warp-uniform: the whole warp leaves
  int64_t* buf = smem + warp * ft::scratch_words(kSlab, cc);
  ft::filter_tail_lane(kSlab, sid, diag, b, G, cap, cc, e, a, buf, buf + kSlab,
                       buf + 2 * kSlab, lane, out_sid, out_pos, overflow);
}

// Scratch in a global-memory workspace: block i owns row i of it and takes
// lanes i, i + gridDim.x, ... (one warp a block).
__global__ void filter_tail_ws_kernel(const int32_t* sid, const int32_t* diag,
                                      int nb, int G, int cap, int cc, int e,
                                      int a, int slab, int64_t* ws,
                                      int32_t* out_sid, int32_t* out_pos,
                                      uint8_t* overflow) {
  int64_t* buf = ws + blockIdx.x * ft::scratch_words(slab, cc);
  for (int b = blockIdx.x; b < nb; b += gridDim.x) {
    ft::filter_tail_lane(slab, sid, diag, b, G, cap, cc, e, a, buf, buf + slab,
                         buf + 2 * int64_t(slab), threadIdx.x, out_sid, out_pos,
                         overflow);
    ft::warp_sync();  // the next lane reuses the row
  }
}

template <int kSlab>
int launch(const int32_t* sid, const int32_t* diag, int nb, int G, int cap,
           int cc, int e, int a, int32_t* out_sid, int32_t* out_pos,
           uint8_t* overflow, cudaStream_t stream) {
  size_t per_warp = (2 * size_t(kSlab) + cc) * sizeof(int64_t);
  int warps = kWarpsPerBlock * per_warp <= kPlainSmem ? kWarpsPerBlock : 1;
  size_t smem = warps * per_warp;
  if (smem > kMaxBlockSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      filter_tail_kernel<kSlab>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = (nb + warps - 1) / warps;
  filter_tail_kernel<kSlab><<<blocks, warps * 32, smem, stream>>>(
      sid, diag, nb, G, cap, cc, e, a, out_sid, out_pos, overflow);
  return (int)cudaGetLastError();
}

}  // namespace

// `ws` is the workspace of the slabs too wide for shared memory: ws_rows rows
// of 2 * slab + cc int64, slab the power of two >= cc + cap; unused (null)
// for cc + cap <= 8192.
extern "C" int fem_filter_tail(const void* sid, const void* diag, int nb,
                               int G, int cap, int cc, int e, int a,
                               void* out_sid, void* out_pos, void* overflow,
                               void* ws, int ws_rows, void* stream) {
  auto go = [&](auto fn) {
    return fn((const int32_t*)sid, (const int32_t*)diag, nb, G, cap, cc, e, a,
              (int32_t*)out_sid, (int32_t*)out_pos, (uint8_t*)overflow,
              (cudaStream_t)stream);
  };
  int64_t width = int64_t(cc) + cap;
  if (width <= 128) return go(launch<128>);
  if (width <= 256) return go(launch<256>);
  if (width <= 512) return go(launch<512>);
  if (width <= 1024) return go(launch<1024>);
  if (width <= 2048) return go(launch<2048>);
  if (width <= 4096) return go(launch<4096>);
  if (width <= ft::kMaxSmemSlab) return go(launch<ft::kMaxSmemSlab>);
  if (ws == nullptr || ws_rows < 1 || width > (int64_t(1) << 30))
    return (int)cudaErrorInvalidValue;
  int blocks = nb < ws_rows ? nb : ws_rows;
  int slab = ft::kMaxSmemSlab;
  while (slab < width) slab <<= 1;
  filter_tail_ws_kernel<<<blocks, 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)sid, (const int32_t*)diag, nb, G, cap, cc, e, a,
      slab, (int64_t*)ws, (int32_t*)out_sid,
      (int32_t*)out_pos, (uint8_t*)overflow);
  return (int)cudaGetLastError();
}
