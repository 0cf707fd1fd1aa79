// Expand-gather: the join's output expansion and, in build mode, its
// build-side materialization, in one kernel.
//
// For each output slot j in [0, out_capacity): the covering record
//   r = max{r : S[r] <= j}   (S sorted ascending; INT32_MAX sentinels
//                             after the real records are past any j)
// copies each record lane at r; record mode also writes the run's first
// slot start_b[j] = S[r]; build mode gathers each build lane at
//   rank = clip(lo[r] + (j - S[r]), 0, nb - 1).
// A slot no record covers (j < S[0]) reads record 0 with start 0, as
// the scatter+cummax reference does; such slots lie past the join's
// total and are masked by `valid`.
//
// Replaces: _expand_kernel (record mode, :264) and _expand_kernel_b8
// (build mode, :335), wrapped by expand_gather
// (distributed_join_tpu/ops/expand_pallas.py:701), and _expand_kernel of
// expand_pull (distributed_join_tpu/ops/expand_planes.py:58).
//
// What bounds it on the H100: bytes. Each live record is read once (S,
// lo, its lanes), each matched build row once, and each slot writes its
// record and build lanes (8 bytes each) and, in record mode, start_b.
// The contract hands the kernel no total, so all out_capacity slots are
// written (the join's bound counts only the true total's).
//
// Design: a tiled load-balanced search. One block owns one tile of
// TILE = THREADS * ITEMS = 1024 consecutive slots.
//   1. Two warps find the tile's first and last covering records,
//      r0 = max{r : S[r] <= j0} and r1, by a 32-way search over S (one
//      ballot a round). With unique S the window [r0, r1] holds at most
//      TILE records; it is clamped to TILE, so S that breaks the
//      contract (duplicates) can give wrong slots but never an access
//      out of bounds.
//   2. The block loads the window's S, lo and record lanes into shared
//      memory, 16 bytes a thread where the pointers allow it.
//   3. Merge path: each thread takes ITEMS consecutive slots, finds its
//      first slot's record by a binary search of the window and walks
//      forward for the rest, and writes the slot's window index to
//      shared memory.
//   4. Output: each thread takes pairs of consecutive slots strided by
//      the block, so every warp store instruction writes 512 contiguous
//      bytes (16 a thread; start_b 8 a thread). The build lanes are
//      gathered at consecutive ranks within a run, so neighbouring
//      threads read neighbouring rows of the dense matched-build pack.
// Shared memory is 8 * k + 12 bytes a slot (build mode; 8 * k + 8 in
// record mode): 28,672 bytes a block at the join's k = 2, 77,824 at
// k = 8. It is dynamic shared memory, so above 48 KB (k >= 5 lanes)
// every launch first raises the kernel's limit with
// cudaFuncSetAttribute. Tiles of 2048 slots (57,344 bytes, three blocks
// an SM) and of 512 (twice the searches) measured slower at the join's
// shapes. S, lo, every record lane and every output must start on a
// 16-byte boundary (the wrapper raises otherwise, and the entry point
// returns cudaErrorMisalignedAddress); the build lanes are gathered one
// element at a time and need only their own alignment.
//
// A GPU gather has no window bound, so the TPU kernel's two-window
// build scheme, its build_windows_ok gate and its fallback branch have
// no counterpart: any rank, matched-dense or not, is read directly.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 4;                      // slots a thread resolves
constexpr int TILE = THREADS * ITEMS;         // slots a block writes
constexpr int PAIRS = TILE / 2 / THREADS;     // slot pairs a thread writes
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const int64_t* rec[DJT_MAX_LANES];
  int64_t* rec_out[DJT_MAX_LANES];
  const int64_t* bld[DJT_MAX_LANES];
  int64_t* bld_out[DJT_MAX_LANES];
};

// The number of entries of S[0, m) that are <= j (S ascending), found by
// one warp: each round every lane probes one of 32 evenly spaced
// positions and a ballot keeps the piece that holds the boundary.
__device__ long long warp_count_le(const int* __restrict__ S, long long m,
                                   int j, int lane) {
  long long lo = 0, hi = m;  // the count lies in [lo, hi]
  while (hi > lo) {
    const long long span = hi - lo;
    const bool le = S[lo + span * lane / 32] <= j;
    const int c = __popc(__ballot_sync(FULL, le));
    if (c == 0) {
      hi = lo;
    } else {
      const long long q = lo + span * (c - 1) / 32;
      hi = c < 32 ? lo + span * c / 32 : hi;
      lo = q + 1;
    }
  }
  return lo;
}

// The window g[ws, ws + wn) into s[0, wn), V elements a load (type VT;
// g is 16-byte aligned), never reading past g[m - 1].
template <typename T, typename VT>
__device__ void load_window(const T* __restrict__ g, T* s, long long ws,
                            int wn, long long m) {
  constexpr int V = sizeof(VT) / sizeof(T);
  const long long v0 = ws / V, v1 = (ws + wn - 1) / V;
  for (long long v = v0 + threadIdx.x; v <= v1; v += THREADS) {
    const long long e0 = v * V;
    alignas(sizeof(VT)) T x[V];
    if (e0 + V <= m) {
      *reinterpret_cast<VT*>(x) = *reinterpret_cast<const VT*>(g + e0);
    } else {
#pragma unroll
      for (int c = 0; c < V; ++c) x[c] = e0 + c < m ? g[e0 + c] : T(0);
    }
#pragma unroll
    for (int c = 0; c < V; ++c) {
      const long long e = e0 + c;
      if (e >= ws && e < ws + wn) s[e - ws] = x[c];
    }
  }
}

// Two values at out[j], out[j + 1] (one store of VT, j even), or only
// the first when `two` is false (the ragged last slot).
template <typename T, typename VT>
__device__ __forceinline__ void store_pair(T* out, long long j, T a, T b,
                                           bool two) {
  if (two) {
    *reinterpret_cast<VT*>(out + j) = VT{a, b};
  } else {
    out[j] = a;
  }
}

__global__ void __launch_bounds__(THREADS)
expand_kernel(const int* __restrict__ S, long long m,
              const int* __restrict__ lo, Args a, int k, int kb,
              long long nb, int out_capacity, int* __restrict__ start_b) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long s_count[2];
  int64_t* s_rec = reinterpret_cast<int64_t*>(smem);  // [k][TILE]
  int* s_S = reinterpret_cast<int*>(s_rec + k * TILE);
  int* s_w = s_S + TILE;   // each slot's window index (-1: j < S[0])
  int* s_lo = s_w + TILE;  // build mode only

  const int tid = threadIdx.x;
  const long long j0 = static_cast<long long>(blockIdx.x) * TILE;
  const int ns = static_cast<int>(
      out_capacity - j0 < TILE ? out_capacity - j0 : TILE);

  // 1. the window: records covering the tile's first and last slot
  if (tid < 64) {
    const int j = static_cast<int>(j0) + (tid < 32 ? 0 : ns - 1);
    const long long c = warp_count_le(S, m, j, tid & 31);
    if ((tid & 31) == 0) s_count[tid >> 5] = c;
  }
  __syncthreads();
  const long long ws = s_count[0] > 0 ? s_count[0] - 1 : 0;
  const long long we = s_count[1] > 0 ? s_count[1] - 1 : 0;
  const long long span = we - ws + 1;
  const int wn = static_cast<int>(span < 1 ? 1 : (span > TILE ? TILE : span));

  // 2. the window into shared memory
  load_window<int, int4>(S, s_S, ws, wn, m);
  if (kb > 0) load_window<int, int4>(lo, s_lo, ws, wn, m);
  for (int l = 0; l < k; ++l)
    load_window<int64_t, longlong2>(a.rec[l], s_rec + l * TILE, ws, wn, m);
  __syncthreads();

  // 3. merge path: ITEMS consecutive slots a thread (slots past the
  //    tile's end repeat its last, so that j stays inside int32)
  const int i0 = tid * ITEMS;
  if (i0 < ns) {
    const int jt = static_cast<int>(j0) + i0;
    int b = 0, e = wn;  // first window index with S > jt
    while (b < e) {
      const int mid = (b + e) >> 1;
      if (s_S[mid] <= jt)
        b = mid + 1;
      else
        e = mid;
    }
    int w = b - 1;
    int wi[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int j = static_cast<int>(j0) + (i0 + i < ns ? i0 + i : ns - 1);
      while (w + 1 < wn && s_S[w + 1] <= j) ++w;
      wi[i] = w;
    }
#pragma unroll
    for (int i = 0; i < ITEMS; i += 4)
      *reinterpret_cast<int4*>(s_w + i0 + i) =
          make_int4(wi[i], wi[i + 1], wi[i + 2], wi[i + 3]);
  }
  __syncthreads();

  // 4. outputs: pairs of consecutive slots, strided by the block
  int r[PAIRS][2], sb[PAIRS][2];
#pragma unroll
  for (int p = 0; p < PAIRS; ++p) {
    const int i = 2 * (tid + p * THREADS);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int w = i + h < ns ? s_w[i + h] : 0;
      r[p][h] = w < 0 ? 0 : w;
      sb[p][h] = w < 0 ? 0 : s_S[w];
    }
  }
  for (int l = 0; l < k; ++l) {
    const int64_t* sr = s_rec + l * TILE;
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
      const int i = 2 * (tid + p * THREADS);
      if (i < ns)
        store_pair<int64_t, longlong2>(a.rec_out[l], j0 + i, sr[r[p][0]],
                                       sr[r[p][1]], i + 1 < ns);
    }
  }
  if (start_b != nullptr) {
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
      const int i = 2 * (tid + p * THREADS);
      if (i < ns)
        store_pair<int, int2>(start_b, j0 + i, sb[p][0], sb[p][1],
                              i + 1 < ns);
    }
  }
  if (kb > 0) {
    long long rank[PAIRS][2];
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
      const long long j = j0 + 2 * (tid + p * THREADS);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long x = static_cast<long long>(s_lo[r[p][h]]) +
                            (j + h - sb[p][h]);
        rank[p][h] = x < 0 ? 0 : (x > nb - 1 ? nb - 1 : x);
      }
    }
    for (int l = 0; l < kb; ++l) {
      const int64_t* g = a.bld[l];
#pragma unroll
      for (int p = 0; p < PAIRS; ++p) {
        const int i = 2 * (tid + p * THREADS);
        if (i < ns) {
          const bool two = i + 1 < ns;
          const int64_t v0 = g[rank[p][0]];
          const int64_t v1 = two ? g[rank[p][1]] : 0;
          store_pair<int64_t, longlong2>(a.bld_out[l], j0 + i, v0, v1, two);
        }
      }
    }
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// S: (m,) int32; recs/rec_outs: HOST arrays of k device pointers to (m,)
// and (out_capacity,) int64 lanes. Record mode: kb = 0, lo and the build
// arrays unused, start_b (out_capacity,) int32 written. Build mode:
// kb >= 1 lanes of length nb, lo (m,) int32, start_b may be null.
extern "C" int djt_expand_gather(const int* S, long long m, const int* lo,
                                 const int64_t* const* recs,
                                 int64_t* const* rec_outs, int k,
                                 const int64_t* const* blds,
                                 int64_t* const* bld_outs, int kb,
                                 long long nb, int out_capacity,
                                 int* start_b, void* stream) {
  if (k < 0 || k > DJT_MAX_LANES || kb < 0 || kb > DJT_MAX_LANES)
    return cudaErrorInvalidValue;
  if (out_capacity <= 0) return 0;
  if (m <= 0 || (kb > 0 && (nb <= 0 || lo == nullptr)))
    return cudaErrorInvalidValue;
  Args a;
  bool ok = aligned16(S) && (kb == 0 || aligned16(lo)) &&
            (start_b == nullptr || aligned16(start_b));
  for (int l = 0; l < k; ++l) {
    a.rec[l] = recs[l];
    a.rec_out[l] = rec_outs[l];
    ok = ok && aligned16(recs[l]) && aligned16(rec_outs[l]);
  }
  for (int l = 0; l < kb; ++l) {
    a.bld[l] = blds[l];
    a.bld_out[l] = bld_outs[l];
    ok = ok && aligned16(bld_outs[l]);
  }
  if (!ok) return cudaErrorMisalignedAddress;
  const size_t smem = static_cast<size_t>(TILE) *
                      (8 * k + 4 * (kb > 0 ? 3 : 2));
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        expand_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  const unsigned blocks =
      static_cast<unsigned>((static_cast<long long>(out_capacity) + TILE -
                             1) / TILE);
  expand_kernel<<<blocks, THREADS, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      S, m, lo, a, k, kb, nb, out_capacity, start_b);
  DJT_CHECK_LAUNCH();
  return 0;
}
