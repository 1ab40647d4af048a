// Banded Myers verification on Hopper.
//
// Replaces fem_tpu/ops/verify_pallas.py: banded_myers_pallas/_myers_kernel
// together with the window fetch of fem_tpu/ops/verify.py:gather_windows.
//
// What bounds it: integer operations. A slot moves some 250 bytes (window,
// read, indices, two results) but runs a chain of `length` dependent Myers
// steps. A step cannot do with fewer than 17 32-bit instructions: 11 for
// the recurrence of myers_core.h:step with three-input logic (LOP3), 6 for
// the least Eq from bit planes (three funnel shifts, three logic operations
// over the xors and the band mask). The least time is the slots' steps
// times 17 over the card's int32 rate (chip_smoke.py: MYERS_OPS_PER_STEP).
// Design (myers_core.h): one thread per (read, candidate) slot with VP, VN
// and nerr in registers. The window comes straight from the flat reference
// at ref_offsets[sid] + pos and the read from row v_lane[v] of the batch,
// both by 16-byte loads of 32-byte chunks that are turned into bit planes
// once; the next chunk is requested before the 32 steps that hide its
// latency. A step's Eq is then three funnel shifts and a few logic
// operations instead of a 15-way byte compare. Slots at or past the
// device-side count `used` return at once, so an under-filled slab costs
// what it holds. The TPU's int32 widening, (8, 128) tiling and 64-byte-row
// barrel shift are not needed.
#include <cuda_runtime.h>

#include "myers_core.h"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
banded_myers_kernel(const uint8_t* ref, int64_t ref_len,
                    const int64_t* ref_offsets, int num_seqs,
                    const int32_t* v_sid, const int32_t* v_pos,
                    const int32_t* v_lane, const uint8_t* both,
                    const int32_t* lens, int nb, int lmax, int e,
                    int num_slots, const int64_t* used, int32_t* ed,
                    int32_t* end) {
  int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= num_slots) return;
  int64_t u = used ? *used : num_slots;
  int in_use = u < 0 ? 0 : (u < num_slots ? int(u) : num_slots);
  myers::verify_slot(ref, ref_len, ref_offsets, num_seqs, v_sid, v_pos, v_lane,
                     both, lens, nb, lmax, e, v, in_use, ed, end);
}

}  // namespace

// `used` is null (every slot is in use) or a device pointer to one int64.
extern "C" int fem_banded_myers(const void* ref, int64_t ref_len,
                                const void* ref_offsets, int num_seqs,
                                const void* v_sid, const void* v_pos,
                                const void* v_lane, const void* both,
                                const void* lens, int nb, int lmax, int e,
                                int num_slots, const void* used, void* ed,
                                void* end, void* stream) {
  int blocks = (num_slots + kThreads - 1) / kThreads;
  banded_myers_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)ref, ref_len, (const int64_t*)ref_offsets, num_seqs,
      (const int32_t*)v_sid, (const int32_t*)v_pos, (const int32_t*)v_lane,
      (const uint8_t*)both, (const int32_t*)lens, nb, lmax, e, num_slots,
      (const int64_t*)used, (int32_t*)ed, (int32_t*)end);
  return (int)cudaGetLastError();
}

extern "C" const char* fem_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
