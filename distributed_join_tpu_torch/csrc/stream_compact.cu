// Order-preserving stream compaction of uint64 lanes:
//   out[l][pos[e]] = cols[l][e]  where mask[e] and 0 <= pos[e] < capacity.
// Slots at or past the survivor count are left untouched (undefined).
//
// Replaces: _compact_kernel of distributed_join_tpu/ops/compact_planes.py
// (:53, wrapped by plane_stream_compact :241) and _compact_kernel of
// distributed_join_tpu/ops/compact_pallas.py (:62, wrapped by
// stream_compact :110) — one contract, two TPU mechanisms.
//
// What bounds it on the H100: bytes. Every position reads its mask byte
// and, where set, its int32 position and k lanes; every survivor writes
// k lanes. The join's caller already holds `pos` (the fused scans'
// rec_pos / mb_pos), so the whole contract is one predicated scatter:
// no scan, no shared memory. Positions are monotone in e, so a warp's
// surviving writes land in one contiguous run of output slots and
// coalesce; the one-hot matmuls, log-shift networks and aligned VMEM
// windows the TPU needed to route rows have no counterpart here.

#include "common.cuh"

namespace {

struct Lanes {
  const int64_t* src[DJT_MAX_LANES];
  int64_t* dst[DJT_MAX_LANES];
};

__global__ void compact_kernel(const uint8_t* __restrict__ mask,
                               const int* __restrict__ pos, Lanes lanes,
                               int k, long long n, int capacity) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < n; e += stride) {
    if (!mask[e]) continue;
    const int p = pos[e];
    if (p < 0 || p >= capacity) continue;
    for (int l = 0; l < k; ++l) lanes.dst[l][p] = lanes.src[l][e];
  }
}

}  // namespace

// srcs/dsts: HOST arrays of k device pointers ((n,) and (capacity,)
// int64 lanes).
extern "C" int djt_stream_compact(const uint8_t* mask, const int* pos,
                                  const int64_t* const* srcs,
                                  int64_t* const* dsts, int k, long long n,
                                  int capacity, void* stream) {
  if (k < 1 || k > DJT_MAX_LANES) return cudaErrorInvalidValue;
  if (n <= 0 || capacity <= 0) return 0;
  Lanes lanes;
  for (int l = 0; l < k; ++l) {
    lanes.src[l] = srcs[l];
    lanes.dst[l] = dsts[l];
  }
  compact_kernel<<<djt_blocks(n, 256), 256, 0,
                   static_cast<cudaStream_t>(stream)>>>(mask, pos, lanes, k,
                                                        n, capacity);
  DJT_CHECK_LAUNCH();
  return 0;
}
