// The verify-slab and accept compactions on Hopper: the range filter and
// the two compactions of the mapping step between the filter tail and
// banded Myers, and after Myers.
//
// Replaces no Pallas kernel: fem_tpu compacts with XLA ops in map_core
// (fem_tpu/pipeline/engine.py). The plain torch version (ops/compact.py)
// is some 90 passes over the (NB, cap_cand) candidate slots (5.12 M at
// tier 0 on a 10,000-read batch): the range filter's gather, compares and
// shift, a prefix sum over every slot in int64, three scatters of every
// slot into the verify slab and five of every slab slot into the accept
// slab, each sending its rejected entries to one dump address (over 99%
// of them), and an atomic add a slab slot for the accepted hits a lane.
//
// What bounds it: bytes. Each lane's list must be read up to its first
// sentinel (8 B an entry), and the slabs written once: the verify slab's
// 12 B a slot and the accept slab's 20 B, each zeroed past its total,
// with 12 B of counts and offsets a lane. Design (compact_core.h has the
// steps): a lane a warp at tier 0 (256 slots: eight ballots of 32, most
// lanes done after the first, which holds the sentinel), a block a lane
// for the ladder's wider lists; lane offsets by an exclusive scan of the
// NB lane counts, inside the same launch, through a decoupled look-back
// over the blocks, each block numbered by an atomic ticket. A compaction
// is one memset (the slab and the scan's state) and one launch, with no
// host read, so it is captured in the step's CUDA graph. The accept slab
// reads only each lane's own verify span, so no atomics and no pass over
// the unused slab slots.
#include <cuda_runtime.h>

#include "compact_core.h"

namespace {

template <int T>
__global__ void __launch_bounds__(T == 32 ? 32 * cpt::kLanesPerBlock : T)
verify_slab_kernel(cpt::VerifySrc src, int64_t nb, int64_t cap, uint64_t* state) {
  __shared__ int64_t sc[cpt::kScratchWords];
  cpt::compact_block(T, threadIdx.x, src, nb, cap, state, sc);
}

template <int T>
__global__ void __launch_bounds__(T == 32 ? 32 * cpt::kLanesPerBlock : T)
accept_slab_kernel(cpt::AcceptSrc src, int64_t nb, int64_t cap, uint64_t* state) {
  __shared__ int64_t sc[cpt::kScratchWords];
  cpt::compact_block(T, threadIdx.x, src, nb, cap, state, sc);
}

// Zero `rows` slab rows and the scan's state, which follow them in `buf`,
// then launch the T-thread program over nb lanes.
template <class Src, class K32, class K256, class K1024>
int launch(K32 k32, K256 k256, K1024 k1024, const Src& src, int T, int64_t nb,
           int64_t cap, int rows, void* buf, cudaStream_t stream) {
  int64_t blocks = cpt::blocks(nb, T);
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  int64_t words = cpt::slab_words(rows, cap);
  uint64_t* state = reinterpret_cast<uint64_t*>(static_cast<int32_t*>(buf) + words);
  cudaError_t err = cudaMemsetAsync(
      buf, 0, words * sizeof(int32_t) + cpt::state_words(nb, T) * sizeof(uint64_t), stream);
  if (err != cudaSuccess) return (int)err;
  unsigned g = (unsigned)blocks, b = (unsigned)cpt::lanes_per_block(T) * T;
  if (T == 32)
    k32<<<g, b, 0, stream>>>(src, nb, cap, state);
  else if (T == 256)
    k256<<<g, b, 0, stream>>>(src, nb, cap, state);
  else
    k1024<<<g, b, 0, stream>>>(src, nb, cap, state);
  return (int)cudaGetLastError();
}

}  // namespace

// sid, pos: (nb, cc) int32 filter-tail lists; lens: (nb,) int32; ref_len,
// own_start, own_end: (num_seqs,) int32, the last two null on a whole
// index. buf: int32, cpt::slab_words(3, cap) of them (the slab's sid, pos
// and lane rows, each of cap) then cpt::state_words(nb, cpt::threads(cc))
// int64; num: (nb,) int32; off: (nb,) int64; total: one int64.
extern "C" int fem_verify_slab(const void* sid, const void* pos, const void* lens,
                               const void* ref_len, int num_seqs, const void* own_start,
                               const void* own_end, int64_t nb, int cc, int e, int64_t cap,
                               void* buf, void* num, void* off, void* total, void* stream) {
  if (nb < 1 || cc < 1 || cap < 1 || num_seqs < 1 || e < 0 ||
      (own_start == nullptr) != (own_end == nullptr))
    return (int)cudaErrorInvalidValue;
  int32_t* slab = static_cast<int32_t*>(buf);
  cpt::VerifySrc src{(const int32_t*)sid, (const int32_t*)pos, (const int32_t*)lens,
                     (const int32_t*)ref_len, (const int32_t*)own_start,
                     (const int32_t*)own_end, num_seqs, cc, e, slab, slab + cap,
                     slab + 2 * cap, (int32_t*)num, (int64_t*)off, (int64_t*)total};
  return launch(verify_slab_kernel<32>, verify_slab_kernel<256>, verify_slab_kernel<1024>,
                src, cpt::threads(cc), nb, cap, 3, buf, (cudaStream_t)stream);
}

// v_sid, v_pos, ed, end: (vcap,) int32; accepted: (vcap,) bool; num, off:
// the verify slab's (nb,) lane counts (int32) and offsets (int64). buf:
// int32, cpt::slab_words(5, acap) of them (lane, sid, pos, ed and end rows)
// then cpt::state_words(nb, cpt::threads(cc)) int64, cc the lists' width;
// ok: (nb,) bool; n_accepted: one int64.
extern "C" int fem_accept_slab(const void* v_sid, const void* v_pos, const void* ed,
                               const void* end, const void* accepted, const void* num,
                               const void* off, int64_t nb, int cc, int64_t vcap,
                               int64_t acap, void* buf, void* ok, void* n_accepted,
                               void* stream) {
  if (nb < 1 || cc < 1 || vcap < 1 || acap < 1) return (int)cudaErrorInvalidValue;
  int32_t* slab = static_cast<int32_t*>(buf);
  cpt::AcceptSrc src{(const int32_t*)v_sid, (const int32_t*)v_pos, (const int32_t*)ed,
                     (const int32_t*)end, (const uint8_t*)accepted, (const int32_t*)num,
                     (const int64_t*)off, vcap, acap, slab, slab + acap, slab + 2 * acap,
                     slab + 3 * acap, slab + 4 * acap, (uint8_t*)ok, (int64_t*)n_accepted};
  return launch(accept_slab_kernel<32>, accept_slab_kernel<256>, accept_slab_kernel<1024>,
                src, cpt::threads(cc), nb, acap, 5, buf, (cudaStream_t)stream);
}
