// Candidate-filter tail on Hopper: sort + pigeonhole vote + greedy dedup
// fold of each read-strand lane's seed-group slabs.
//
// Replaces fem_tpu/ops/filter_tail_pallas.py: filter_tail_pallas /
// _filter_tail_kernel (with its bitonic _sort2).
//
// What bounds it: per lane and group a bitonic sort of slabn int64 keys
// (slabn = 128 at cap_cand 16 + cap_occ 80) twice, then a sequential
// greedy scan over at most cap_cand + cap_occ keys — shared-memory
// traffic and the serial scan, not device memory (each lane reads its
// G * cap_occ * 8 bytes once and writes cap_cand * 8 + 1).
// Design: one warp per lane, its keys in shared memory. The TPU kernel
// carried the candidate list from one grid step to the next along a
// sequential grid axis; GPU blocks run in no order, so the warp loops over
// the G groups itself and keeps the list in shared memory. One lane of
// the warp runs the greedy scan; it stops at the first sentinel key and
// writes the kept keys in order, so no third sort compacts them.
#include <cuda_runtime.h>

#include "filter_tail_core.h"

namespace {

constexpr int kWarpsPerBlock = 4;

__global__ void filter_tail_kernel(const int32_t* sid, const int32_t* diag,
                                   int nb, int G, int cap, int cc, int e,
                                   int a, int slabn, int32_t* out_sid,
                                   int32_t* out_pos, uint8_t* overflow) {
  extern __shared__ int64_t smem[];
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= nb) return;  // warp-uniform: the whole warp leaves
  int64_t* slab = smem + int64_t(warp) * (2 * slabn + cc);
  ft::filter_tail_lane(sid, diag, b, G, cap, cc, e, a, slabn, slab,
                       slab + slabn, slab + 2 * slabn, lane, 32, out_sid,
                       out_pos, overflow);
}

}  // namespace

extern "C" int fem_filter_tail(const void* sid, const void* diag, int nb,
                               int G, int cap, int cc, int e, int a,
                               void* out_sid, void* out_pos, void* overflow,
                               void* stream) {
  int slabn = 1;
  while (slabn < cc + cap) slabn <<= 1;
  if (slabn > ft::kMaxSlab) return (int)cudaErrorInvalidValue;
  size_t smem = size_t(kWarpsPerBlock) * (2 * slabn + cc) * sizeof(int64_t);
  cudaError_t err = cudaFuncSetAttribute(
      filter_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = (nb + kWarpsPerBlock - 1) / kWarpsPerBlock;
  filter_tail_kernel<<<blocks, kWarpsPerBlock * 32, smem,
                       (cudaStream_t)stream>>>(
      (const int32_t*)sid, (const int32_t*)diag, nb, G, cap, cc, e, a, slabn,
      (int32_t*)out_sid, (int32_t*)out_pos, (uint8_t*)overflow);
  return (int)cudaGetLastError();
}
