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
// itself. The slab width kSlab is a template parameter: wider slabs are
// one more instantiation.
#include <cuda_runtime.h>

#include "filter_tail_core.h"

namespace {

constexpr int kWarpsPerBlock = 4;

template <int kSlab>
__global__ void filter_tail_kernel(const int32_t* sid, const int32_t* diag,
                                   int nb, int G, int cap, int cc, int e,
                                   int a, int32_t* out_sid, int32_t* out_pos,
                                   uint8_t* overflow) {
  extern __shared__ int64_t smem[];
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= nb) return;  // warp-uniform: the whole warp leaves
  int64_t* buf = smem + int64_t(warp) * (2 * kSlab + cc);
  ft::filter_tail_lane<kSlab>(sid, diag, b, G, cap, cc, e, a, buf, buf + kSlab,
                              buf + 2 * kSlab, lane, out_sid, out_pos, overflow);
}

template <int kSlab>
int launch(const int32_t* sid, const int32_t* diag, int nb, int G, int cap,
           int cc, int e, int a, int32_t* out_sid, int32_t* out_pos,
           uint8_t* overflow, cudaStream_t stream) {
  size_t smem = size_t(kWarpsPerBlock) * (2 * kSlab + cc) * sizeof(int64_t);
  cudaError_t err = cudaFuncSetAttribute(
      filter_tail_kernel<kSlab>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = (nb + kWarpsPerBlock - 1) / kWarpsPerBlock;
  filter_tail_kernel<kSlab><<<blocks, kWarpsPerBlock * 32, smem, stream>>>(
      sid, diag, nb, G, cap, cc, e, a, out_sid, out_pos, overflow);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fem_filter_tail(const void* sid, const void* diag, int nb,
                               int G, int cap, int cc, int e, int a,
                               void* out_sid, void* out_pos, void* overflow,
                               void* stream) {
  auto go = [&](auto fn) {
    return fn((const int32_t*)sid, (const int32_t*)diag, nb, G, cap, cc, e, a,
              (int32_t*)out_sid, (int32_t*)out_pos, (uint8_t*)overflow,
              (cudaStream_t)stream);
  };
  if (cc + cap <= 128) return go(launch<128>);
  if (cc + cap <= 256) return go(launch<256>);
  if (cc + cap <= ft::kMaxSlab) return go(launch<ft::kMaxSlab>);
  return (int)cudaErrorInvalidValue;
}
