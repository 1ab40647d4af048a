// Banded Myers verification on Hopper.
//
// Replaces fem_tpu/ops/verify_pallas.py: banded_myers_pallas/_myers_kernel
// together with the window fetch of fem_tpu/ops/verify.py:gather_windows.
//
// What bounds it: each slot is a 100-odd step dependent chain of ~30
// integer ops on registers, and its inputs are ~240 bytes (window + text),
// so the kernel is latency-bound per thread and wants many slots in flight.
// Design: one thread per (read, candidate) slot with VP, VN and nerr in
// registers; the window is read straight from the flat reference at
// ref_offsets[sid] + pos (no gathered window array), slid through a
// 16-byte register pair one byte a step, and the text is read in place
// from row v_lane[v] of the batch (no per-slot text copy). The TPU's int32
// widening, (8, 128) tiling and 64-byte-row barrel shift are not needed.
#include <cuda_runtime.h>

#include "myers_core.h"

namespace {

__global__ void banded_myers_kernel(const uint8_t* ref, int64_t ref_len,
                                    const int64_t* ref_offsets, int num_seqs,
                                    const int32_t* v_sid, const int32_t* v_pos,
                                    const int32_t* v_lane, const uint8_t* both,
                                    const int32_t* lens, int nb, int lmax,
                                    int e, int num_slots, int32_t* ed,
                                    int32_t* end) {
  int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= num_slots) return;
  myers::verify_slot(ref, ref_len, ref_offsets, num_seqs, v_sid, v_pos, v_lane,
                     both, lens, nb, lmax, e, v, ed, end);
}

}  // namespace

extern "C" int fem_banded_myers(const void* ref, int64_t ref_len,
                                const void* ref_offsets, int num_seqs,
                                const void* v_sid, const void* v_pos,
                                const void* v_lane, const void* both,
                                const void* lens, int nb, int lmax, int e,
                                int num_slots, void* ed, void* end,
                                void* stream) {
  const int threads = 128;
  int blocks = (num_slots + threads - 1) / threads;
  banded_myers_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)ref, ref_len, (const int64_t*)ref_offsets, num_seqs,
      (const int32_t*)v_sid, (const int32_t*)v_pos, (const int32_t*)v_lane,
      (const uint8_t*)both, (const int32_t*)lens, nb, lmax, e, num_slots,
      (int32_t*)ed, (int32_t*)end);
  return (int)cudaGetLastError();
}

extern "C" const char* fem_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
