// Shared by the CUDA kernels and by host_check.cpp, which g++ compiles so
// that the CPU tests run the kernels' exact per-lane arithmetic.
//
// The per-lane code is written once, as the scalar program of one thread
// of a warp or a block. Everything a warp or a block does together goes
// through the few inline functions below. On the card they are the
// shuffle, ballot and reduce intrinsics and __syncthreads; in the host
// build they hand the value to warp_emul (warp_emul.h), which runs the
// threads of a block as coroutines, each warp's 32 in lockstep, so the
// same source gives the same values.
#pragma once

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define FT_HD __device__ __forceinline__
#define FT_HHD __host__ __device__ __forceinline__  // also the host's launch code
#else
#define FT_HD inline
#define FT_HHD inline
namespace warp_emul {
// All 32 lanes call gather() at the same point of the program; each gets
// the 32 values handed in, indexed by lane. lane() is the caller's lane.
const uint64_t* gather(uint64_t mine);
int lane();
// Returns once every thread of the block has called it (__syncthreads).
void barrier();
}  // namespace warp_emul
#endif

namespace ft {

constexpr unsigned kFullWarp = 0xFFFFFFFFu;

#ifdef __CUDACC__

FT_HD void warp_sync() { __syncwarp(); }
FT_HD void block_sync() { __syncthreads(); }
FT_HD uint32_t warp_ballot(bool p) { return __ballot_sync(kFullWarp, p); }
FT_HD uint32_t warp_or(uint32_t x) { return __reduce_or_sync(kFullWarp, x); }
FT_HD int64_t warp_shfl(int64_t v, int src) {
  return __shfl_sync(kFullWarp, (long long)v, src);
}
FT_HD int32_t warp_shfl(int32_t v, int src) { return __shfl_sync(kFullWarp, v, src); }
FT_HD int64_t warp_shfl_xor(int64_t v, int m) {
  return __shfl_xor_sync(kFullWarp, (long long)v, m);
}
// (hi:lo) >> s for 0 <= s < 32, the low 32 bits.
FT_HD uint32_t funnel_r(uint32_t lo, uint32_t hi, int s) {
  return __funnelshift_r(lo, hi, s);
}
// 16 bytes from a 16-byte-aligned address, as four little-endian words.
FT_HD void load16(const uint8_t* p, uint32_t w[4]) {
  uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
}
// Four int32 from a 16-byte-aligned address.
FT_HD void load_quad(const int32_t* p, int32_t w[4]) {
  int4 v = __ldg(reinterpret_cast<const int4*>(p));
  w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
}

#else  // host emulation

FT_HD void warp_sync() { warp_emul::gather(0); }
FT_HD void block_sync() { warp_emul::barrier(); }
FT_HD uint32_t warp_ballot(bool p) {
  const uint64_t* all = warp_emul::gather(p);
  uint32_t m = 0;
  for (int l = 0; l < 32; ++l) m |= uint32_t(all[l] & 1) << l;
  return m;
}
FT_HD uint32_t warp_or(uint32_t x) {
  const uint64_t* all = warp_emul::gather(x);
  uint32_t m = 0;
  for (int l = 0; l < 32; ++l) m |= uint32_t(all[l]);
  return m;
}
FT_HD int64_t warp_shfl(int64_t v, int src) {
  return int64_t(warp_emul::gather(uint64_t(v))[src & 31]);
}
FT_HD int32_t warp_shfl(int32_t v, int src) {
  return int32_t(warp_emul::gather(uint32_t(v))[src & 31]);
}
FT_HD int64_t warp_shfl_xor(int64_t v, int m) {
  return int64_t(warp_emul::gather(uint64_t(v))[(warp_emul::lane() ^ m) & 31]);
}
FT_HD uint32_t funnel_r(uint32_t lo, uint32_t hi, int s) {
  return uint32_t(((uint64_t(hi) << 32) | lo) >> (s & 31));
}
FT_HD void load16(const uint8_t* p, uint32_t w[4]) { memcpy(w, p, 16); }
FT_HD void load_quad(const int32_t* p, int32_t w[4]) { memcpy(w, p, 16); }

#endif

FT_HD int popc(uint32_t x) {
#ifdef __CUDACC__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

}  // namespace ft
