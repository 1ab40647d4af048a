// Shared by the CUDA kernels and by host_check.cpp, which g++ compiles so
// that the CPU tests run the kernels' exact per-lane arithmetic.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define FT_HD __host__ __device__ __forceinline__
#else
#define FT_HD inline
#endif

// Warp barrier between the cooperative steps of one lane's work; a
// no-op when one host thread does the whole lane.
#ifdef __CUDA_ARCH__
#define FT_SYNC() __syncwarp()
#else
#define FT_SYNC() ((void)0)
#endif
