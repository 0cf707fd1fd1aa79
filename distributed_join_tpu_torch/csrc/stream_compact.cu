// Order-preserving stream compaction of uint64 lanes:
//   out[l][pos[e]] = cols[l][e]  where mask[e] and pos[e] < capacity,
// for pos == cumsum(mask) - 1 exactly (the wrapper's contract). Slots at
// or past the survivor count are left untouched (undefined).
//
// Replaces: _compact_kernel of distributed_join_tpu/ops/compact_planes.py
// (:53, wrapped by plane_stream_compact :241) and _compact_kernel of
// distributed_join_tpu/ops/compact_pallas.py (:62, wrapped by
// stream_compact :110) — one contract, two TPU mechanisms.
//
// What bounds it on the H100: bytes. The least traffic is one read of
// every mask byte, the survivors' lanes, and one write of the kept
// lanes. Design, per tile of TILE positions (one block of THREADS
// threads, VEC mask bytes each):
// - each thread reads its VEC mask bytes with 16-byte loads; tiles
//   are cut at VEC-byte addresses of the mask, so only the partial
//   chunks at the head and the tail of an unaligned view take a byte
//   path;
// - a tile without survivors returns right after that read
//   (__syncthreads_or): a sparse mask costs one pass over its bytes;
// - survivors are ranked inside the tile by popcounts of the thread's
//   32-bit flag word and ballots of its count's bit planes across the
//   warp, and their tile offsets are staged in shared memory;
// - because pos grows by exactly one per survivor, the tile's output is
//   the one window [pos[first survivor], + count): the block reads that
//   one pos, cuts the window at capacity, and writes each lane's window
//   with coalesced stores, gathering the survivors through the staged
//   offsets (ascending addresses).
// The one-hot matmuls, log-shift networks and aligned VMEM windows that
// the TPU needed to route rows have no counterpart here.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 32;  // mask bytes per thread: 16-byte loads, <= 32
constexpr int TILE = THREADS * VEC;
constexpr int WARPS = THREADS / 32;

struct Lanes {
  const int64_t* src[DJT_MAX_LANES];
  int64_t* dst[DJT_MAX_LANES];
};

// Bit j set where byte j of the 16 bytes is non-zero.
__device__ __forceinline__ unsigned flags_of(uint4 v) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  unsigned bits = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      bits |= static_cast<unsigned>(((w[q] >> (8 * b)) & 0xFFu) != 0u)
              << (4 * q + b);
    }
  }
  return bits;
}

// tile_e0: the (possibly negative) position of the tile's first byte;
// positions outside [0, n) are not survivors.
__global__ void __launch_bounds__(THREADS)
    compact_kernel(const uint8_t* __restrict__ mask,
                   const int* __restrict__ pos, Lanes lanes, int k,
                   long long n, long long head, int capacity) {
  __shared__ unsigned short s_idx[TILE];
  __shared__ unsigned s_warp[WARPS];
  __shared__ int s_base;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long tile_e0 = static_cast<long long>(blockIdx.x) * TILE - head;
  const long long e0 = tile_e0 + static_cast<long long>(tid) * VEC;

  unsigned bits = 0;
  if (e0 >= 0 && e0 + VEC <= n) {
    const uint4* v = reinterpret_cast<const uint4*>(mask + e0);
#pragma unroll
    for (int q = 0; q < VEC / 16; ++q) bits |= flags_of(v[q]) << (16 * q);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const long long e = e0 + j;
      if (e >= 0 && e < n && mask[e]) bits |= 1u << j;
    }
  }
  if (!__syncthreads_or(bits)) return;

  // the thread's survivors before it in the warp: its count's bit
  // planes, balloted and counted below this lane
  const unsigned c = __popc(bits);
  const unsigned below = (1u << lane) - 1u;
  unsigned excl = 0, wtotal = 0;
#pragma unroll
  for (int b = 0; 1 << b <= VEC; ++b) {
    const unsigned plane = __ballot_sync(0xFFFFFFFFu, (c >> b) & 1u);
    excl += __popc(plane & below) << b;
    wtotal += __popc(plane) << b;
  }
  if (lane == 0) s_warp[warp] = wtotal;
  __syncthreads();
  unsigned rank = excl, total = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const unsigned t = s_warp[w];
    rank += w < warp ? t : 0u;
    total += t;
  }
  if (rank == 0 && c != 0) s_base = pos[e0 + (__ffs(bits) - 1)];
  for (unsigned rest = bits; rest; rest &= rest - 1) {
    s_idx[rank++] =
        static_cast<unsigned short>(tid * VEC + (__ffs(rest) - 1));
  }
  __syncthreads();

  const int base = s_base;
  if (base < 0 || base >= capacity) return;
  const int len = min(static_cast<int>(total), capacity - base);
  for (int r = tid; r < len; r += THREADS) {
    const long long e = tile_e0 + s_idx[r];
#pragma unroll
    for (int l = 0; l < DJT_MAX_LANES; ++l) {
      if (l < k) lanes.dst[l][base + r] = lanes.src[l][e];
    }
  }
}

}  // namespace

// srcs/dsts: HOST arrays of k device pointers ((n,) and (capacity,)
// int64 lanes). mask may start at any byte address.
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
  const long long head = reinterpret_cast<uintptr_t>(mask) % VEC;
  const long long tiles = (n + head + TILE - 1) / TILE;
  if (tiles > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  compact_kernel<<<static_cast<unsigned>(tiles), THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      mask, pos, lanes, k, n, head, capacity);
  DJT_CHECK_LAUNCH();
  return 0;
}
