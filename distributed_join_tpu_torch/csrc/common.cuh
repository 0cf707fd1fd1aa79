// Shared by every kernel library of the port. Each .cu file builds into
// its own shared library with a plain C interface (ops/_kernels.py loads
// it with ctypes); each entry point returns the cudaError_t of its
// launches, 0 on success, and never synchronises.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* djt_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

#define DJT_CHECK_LAUNCH()                         \
  do {                                             \
    cudaError_t djt_err_ = cudaGetLastError();     \
    if (djt_err_ != cudaSuccess) return djt_err_;  \
  } while (0)

// The most lanes one launch carries (the join's widest call site is the
// run-record compaction: S, key, probe payload, lo). Wider calls are
// split by the Python wrapper.
constexpr int DJT_MAX_LANES = 8;

static inline unsigned djt_blocks(long long n, int threads) {
  long long b = (n + threads - 1) / threads;
  const long long cap = 132LL * 64;  // grid-stride beyond ~64 blocks/SM
  return static_cast<unsigned>(b < 1 ? 1 : (b > cap ? cap : b));
}
