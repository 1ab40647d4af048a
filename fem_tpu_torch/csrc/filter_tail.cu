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
// Design (filter_tail_core.h has the steps). Up to cap_cand + cap_occ =
// 512 (tier 0): one warp per lane, four lanes a block; the slab is read
// with 16-byte loads and its valid keys compacted by ballot, so all later
// work is in the valid count. Up to 32 keys are sorted, voted, merged with
// the carried list and folded entirely in registers by shuffles; the
// carried list is already sorted, so it is merged (log n steps), not
// sorted again; the greedy fold is a binary search plus pointer doubling.
// Larger counts take the same steps in shared memory. The TPU kernel
// carried the list from one grid step to the next along a sequential grid
// axis; GPU blocks run in no order, so the lane loops over the G groups
// itself.
// Wider slabs (the retry tiers: 640 + 512, 5120 + 4096) take a block of T
// threads a lane, 256 up to 2048 keys and 1024 above (ft::plan: the
// fastest of 128-1024 on the satellite stream's own tier slabs, where the
// heaviest lane sets the time; chip_smoke.py phase 6), because a warp
// alone left the SMs nearly empty there (one warp an SM at tier 2) and
// walked the fold with one thread. Every step is block-wide: prefix sums
// for the ranks, a bitonic sort whose steps within 32 keys run in
// registers, a merge-path merge with no padding, the fold's orbit marked by
// pointer doubling. A lane's scratch is sized by those steps
// (ft::block_words): 26,880 bytes at 640 + 512, so eight lanes share an SM
// and tier 1's 1,024 lanes are resident at once, and 213,248 at 5120 +
// 4096, inside the 232,448 a block may ask for. What bounds a block lane is
// not bytes but its chain of barriers, each behind dependent shared-memory
// loads: a group of n keys pays (L - 4)(L - 3) / 2 sort barriers, L =
// log2 of n's power of two (10 at 256 keys), log2(cap_cand + n) fold
// rounds and a few scans, and tiers
// 1 and 2 launch too few lanes to hide that latency. Widths whose scratch
// does not fit shared memory run the same block lane code on a
// global-memory workspace the caller allocates, one row a block, each
// block walking over lanes. ft::plan decides the route; the wrapper asks it
// through fem_filter_tail_plan.
#include <cuda_runtime.h>

#include "filter_tail_core.h"

namespace {

constexpr int kWarpsPerBlock = 4;           // while the block's scratch fits
constexpr size_t kPlainSmem = 48 * 1024;    // what a block gets without opt-in

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

template <int kSlab>
int launch(const int32_t* sid, const int32_t* diag, int nb, int G, int cap,
           int cc, int e, int a, int32_t* out_sid, int32_t* out_pos,
           uint8_t* overflow, cudaStream_t stream) {
  size_t per_warp = (2 * size_t(kSlab) + cc) * sizeof(int64_t);
  int warps = kWarpsPerBlock * per_warp <= kPlainSmem ? kWarpsPerBlock : 1;
  size_t smem = warps * per_warp;
  if (smem > ft::kMaxBlockSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      filter_tail_kernel<kSlab>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = (nb + warps - 1) / warps;
  filter_tail_kernel<kSlab><<<blocks, warps * 32, smem, stream>>>(
      sid, diag, nb, G, cap, cc, e, a, out_sid, out_pos, overflow);
  return (int)cudaGetLastError();
}

// Scratch in shared memory: block b owns lane b.
template <int T>
__global__ void __launch_bounds__(T)
filter_tail_block_kernel(const int32_t* sid, const int32_t* diag, int G,
                         int cap, int cc, int e, int a, int32_t* out_sid,
                         int32_t* out_pos, uint8_t* overflow) {
  extern __shared__ int64_t smem[];
  ft::filter_tail_block_lane(T, sid, diag, blockIdx.x, G, cap, cc, e, a, smem,
                             threadIdx.x, out_sid, out_pos, overflow);
}

template <int T>
int launch_block(const int32_t* sid, const int32_t* diag, int nb, int G,
                 int cap, int cc, int e, int a, int32_t* out_sid,
                 int32_t* out_pos, uint8_t* overflow, size_t smem,
                 cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      filter_tail_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  filter_tail_block_kernel<T><<<nb, T, smem, stream>>>(
      sid, diag, G, cap, cc, e, a, out_sid, out_pos, overflow);
  return (int)cudaGetLastError();
}

// Scratch in a global-memory workspace: block i owns row i of it and takes
// lanes i, i + gridDim.x, ... (block_scan's words too lie in the row).
template <int T>
__global__ void __launch_bounds__(T)
filter_tail_ws_kernel(const int32_t* sid, const int32_t* diag, int nb, int G,
                      int cap, int cc, int e, int a, int64_t words,
                      int64_t* ws, int32_t* out_sid, int32_t* out_pos,
                      uint8_t* overflow) {
  int64_t* row = ws + blockIdx.x * words;
  for (int b = blockIdx.x; b < nb; b += gridDim.x) {
    ft::filter_tail_block_lane(T, sid, diag, b, G, cap, cc, e, a, row,
                               threadIdx.x, out_sid, out_pos, overflow);
    __syncthreads();  // the next lane reuses the row
  }
}

}  // namespace

// Which program, block size and scratch the width cap_cand + cap_occ takes
// (ft::plan): returns the route (0 a warp a lane, 1 a block a lane in shared
// memory, 2 a block a lane on a workspace), and the threads a lane and the
// int64 words of a lane's scratch (a workspace row) through the pointers.
extern "C" int fem_filter_tail_plan(int cap, int cc, int* threads,
                                    int64_t* words) {
  ft::Plan p = ft::plan(cap, cc);
  *threads = p.threads;
  *words = p.words;
  return p.route;
}

// `ws` is the workspace of route 2: ws_rows rows of the plan's words each;
// unused (null) for the other routes. A width of route 2 without one is
// refused, never run another way. `threads` (128, 256, 512 or 1024; 0: the
// plan's) sets a block lane's T, for timing the choice.
extern "C" int fem_filter_tail(const void* sid, const void* diag, int nb,
                               int G, int cap, int cc, int e, int a,
                               void* out_sid, void* out_pos, void* overflow,
                               void* ws, int ws_rows, int threads,
                               void* stream) {
  auto in_sid = (const int32_t*)sid, in_diag = (const int32_t*)diag;
  auto o_sid = (int32_t*)out_sid, o_pos = (int32_t*)out_pos;
  auto o_ovf = (uint8_t*)overflow;
  auto st = (cudaStream_t)stream;
  int64_t width = int64_t(cc) + cap;
  if (nb < 1 || width > (int64_t(1) << 30)) return (int)cudaErrorInvalidValue;
  ft::Plan p = ft::plan(cap, cc);
  if (p.route == ft::kWarpRoute) {
    auto go = [&](auto fn) {
      return fn(in_sid, in_diag, nb, G, cap, cc, e, a, o_sid, o_pos, o_ovf, st);
    };
    if (width <= 128) return go(launch<128>);
    if (width <= 256) return go(launch<256>);
    return go(launch<512>);
  }
  int T = threads ? threads : p.threads;
  if (p.route == ft::kBlockRoute) {
    auto go = [&](auto fn) {
      return fn(in_sid, in_diag, nb, G, cap, cc, e, a, o_sid, o_pos, o_ovf,
                p.words * sizeof(int64_t), st);
    };
    if (T == 128) return go(launch_block<128>);
    if (T == 256) return go(launch_block<256>);
    if (T == 512) return go(launch_block<512>);
    if (T == 1024) return go(launch_block<1024>);
    return (int)cudaErrorInvalidValue;
  }
  if (ws == nullptr || ws_rows < 1 || T != 1024)
    return (int)cudaErrorInvalidValue;
  int blocks = nb < ws_rows ? nb : ws_rows;
  filter_tail_ws_kernel<1024><<<blocks, 1024, 0, st>>>(
      in_sid, in_diag, nb, G, cap, cc, e, a, p.words, (int64_t*)ws, o_sid,
      o_pos, o_ovf);
  return (int)cudaGetLastError();
}
