// Merge sort of fixed-width unsigned keys, carrying the row index:
// after the sort, idx[i] is the input row at sorted position i. Keys are
// W words of 64 bits (W = 1..4), compared lexicographically, most
// significant word first; the row index breaks ties, so the order is
// total and the result equals a stable sort.
//
// Replaces: _merge_tile_kernel of distributed_join_tpu/ops/sort_pallas.py
// (:314, wrapped by _merge_level :430, merge_sort_planes :489 and
// pallas_merged_sort :659). The contract is the TPU kernel's: sorted
// u32 planes equal to lax.sort(operands, num_keys); ties may be permuted
// there, and here they are not. The mechanism is not the TPU's: its
// alternating orientation, roll-built bitonic tiles, 128-aligned DMA
// windows and diagonal search in XLA work around the missing `rev`
// lowering and VMEM windows, which Hopper does not have.
//
// What bounds it on the H100: bytes. Each level reads and writes every
// key and index once, (8W + 4) bytes a row each way, and there are
// ceil(log2(n / T)) levels after the tile sort; the ideal is one read of
// the input and one write of the output. This first version is the
// simple one: a bitonic sort of each T-row tile in shared memory, then
// one merge-path launch per level between ping-pong buffers in global
// memory, each block merging T output rows of one pair of runs through
// shared memory. The values are gathered afterwards by the final index
// (djt_gather_planes), once, instead of riding every level.

#include "common.cuh"

namespace {

constexpr int MERGE_THREADS = 256;
constexpr int GATHER_THREADS = 256;

template <int W>
struct Key {
  unsigned long long w[W];
};

template <int W>
struct Tile {
  // T rows of (W words + index) fit in 48 KB of static shared memory
  static constexpr int T = W <= 2 ? 2048 : 1024;
};

template <int W>
__device__ __forceinline__ bool key_less(const Key<W>& a, unsigned ia,
                                         const Key<W>& b, unsigned ib) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if (a.w[i] != b.w[i]) return a.w[i] < b.w[i];
  }
  return ia < ib;
}

// Sort one tile of T rows per block: a bitonic network over shared
// memory, one compare-exchange per thread per stage. Rows past n are
// padding with all-ones words and index 0xFFFFFFFF, which sort after
// every real row (a real index is below n < 0xFFFFFFFF).
template <int W>
__global__ void __launch_bounds__(Tile<W>::T / 2)
    tile_sort_kernel(Key<W>* __restrict__ keys, unsigned* __restrict__ idx,
                     long long n) {
  constexpr int T = Tile<W>::T;
  __shared__ Key<W> sk[T];
  __shared__ unsigned si[T];
  const long long base = static_cast<long long>(blockIdx.x) * T;
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    const long long g = base + t;
    if (g < n) {
      sk[t] = keys[g];
      si[t] = static_cast<unsigned>(g);
    } else {
#pragma unroll
      for (int w = 0; w < W; ++w) sk[t].w[w] = ~0ULL;
      si[t] = 0xFFFFFFFFu;
    }
  }
  __syncthreads();
  const int t = threadIdx.x;
  for (int k = 2; k <= T; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int i = 2 * j * (t / j) + (t % j);  // bit j of i is clear
      const int l = i + j;
      const Key<W> a = sk[i], b = sk[l];
      const unsigned ia = si[i], ib = si[l];
      const bool up = (i & k) == 0;
      if (up ? key_less(b, ib, a, ia) : key_less(a, ia, b, ib)) {
        sk[i] = b;
        sk[l] = a;
        si[i] = ib;
        si[l] = ia;
      }
      __syncthreads();
    }
  }
  for (int u = threadIdx.x; u < T; u += blockDim.x) {
    const long long g = base + u;
    if (g < n) {
      keys[g] = sk[u];
      idx[g] = si[u];
    }
  }
}

// Merge path: how many of the first d merged rows come from A, i.e. the
// least i with B[d-1-i] < A[i] (rows are distinct, so no tie rule).
template <int W>
__device__ long long merge_path(const Key<W>* ka, const unsigned* ia,
                                long long a_len, const Key<W>* kb,
                                const unsigned* ib, long long b_len,
                                long long d) {
  long long lo = d > b_len ? d - b_len : 0;
  long long hi = d < a_len ? d : a_len;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (key_less(kb[d - 1 - mid], ib[d - 1 - mid], ka[mid], ia[mid]))
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

// One merge level: sorted runs of `run` rows pair up into runs of
// 2*run. Block b writes output rows [b*T, (b+1)*T), which lie in one
// pair because T divides run. Two threads find the block's diagonals in
// global memory; the block stages the at most T input rows it needs in
// shared memory; each thread merges T / MERGE_THREADS consecutive
// output rows from its own diagonal. A last run without a partner is
// copied through (b_len == 0).
template <int W>
__global__ void __launch_bounds__(MERGE_THREADS)
    merge_kernel(const Key<W>* __restrict__ kin,
                 const unsigned* __restrict__ iin, Key<W>* __restrict__ kout,
                 unsigned* __restrict__ iout, long long n, long long run) {
  constexpr int T = Tile<W>::T;
  constexpr int E = T / MERGE_THREADS;
  __shared__ Key<W> sk[T];
  __shared__ unsigned si[T];
  __shared__ long long s_a[2];
  const long long out0 = static_cast<long long>(blockIdx.x) * T;
  const long long out1 = out0 + T < n ? out0 + T : n;
  const long long pbase = out0 / (2 * run) * (2 * run);
  const long long rest = n - pbase;
  const long long a_len = rest < run ? rest : run;
  const long long b_len =
      rest - run <= 0 ? 0 : (rest - run < run ? rest - run : run);
  const Key<W>* ka = kin + pbase;
  const unsigned* ia = iin + pbase;
  const Key<W>* kb = kin + pbase + run;
  const unsigned* ib = iin + pbase + run;
  const long long d0 = out0 - pbase, d1 = out1 - pbase;
  if (threadIdx.x == 0)
    s_a[0] = merge_path<W>(ka, ia, a_len, kb, ib, b_len, d0);
  if (threadIdx.x == 32)
    s_a[1] = merge_path<W>(ka, ia, a_len, kb, ib, b_len, d1);
  __syncthreads();
  const long long a0 = s_a[0], b0 = d0 - s_a[0];
  const int na = static_cast<int>(s_a[1] - a0);
  const int nb = static_cast<int>((d1 - s_a[1]) - b0);
  for (int t = threadIdx.x; t < na; t += blockDim.x) {
    sk[t] = ka[a0 + t];
    si[t] = ia[a0 + t];
  }
  for (int t = threadIdx.x; t < nb; t += blockDim.x) {
    sk[na + t] = kb[b0 + t];
    si[na + t] = ib[b0 + t];
  }
  __syncthreads();
  const int total = na + nb;
  const int d = threadIdx.x * E;
  if (d >= total) return;
  int ai = static_cast<int>(merge_path<W>(sk, si, na, sk + na, si + na, nb, d));
  int bi = d - ai;
  const int end = d + E < total ? d + E : total;
  Key<W>* ko = kout + out0;
  unsigned* io = iout + out0;
  for (int o = d; o < end; ++o) {
    const bool take_a =
        bi >= nb ||
        (ai < na && key_less(sk[ai], si[ai], sk[na + bi], si[na + bi]));
    const int src = take_a ? ai++ : na + bi++;
    ko[o] = sk[src];
    io[o] = si[src];
  }
}

template <int W>
int run_sort(unsigned long long* k0, unsigned long long* k1, unsigned* i0,
             unsigned* i1, long long n, int* result_in_1, cudaStream_t s) {
  constexpr int T = Tile<W>::T;
  Key<W>* keys[2] = {reinterpret_cast<Key<W>*>(k0),
                     reinterpret_cast<Key<W>*>(k1)};
  unsigned* idx[2] = {i0, i1};
  const long long tiles = (n + T - 1) / T;
  tile_sort_kernel<W><<<static_cast<unsigned>(tiles), T / 2, 0, s>>>(
      keys[0], idx[0], n);
  DJT_CHECK_LAUNCH();
  int cur = 0;
  for (long long run = T; run < n; run *= 2) {
    merge_kernel<W><<<static_cast<unsigned>(tiles), MERGE_THREADS, 0, s>>>(
        keys[cur], idx[cur], keys[cur ^ 1], idx[cur ^ 1], n, run);
    DJT_CHECK_LAUNCH();
    cur ^= 1;
  }
  *result_in_1 = cur;
  return 0;
}

struct Planes {
  const int* src[DJT_MAX_LANES];
  int* dst[DJT_MAX_LANES];
};

__global__ void gather_kernel(const unsigned* __restrict__ idx, Planes p,
                              int k, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < n; e += stride) {
    const unsigned r = idx[e];
    for (int l = 0; l < k; ++l) p.dst[l][e] = p.src[l][r];
  }
}

}  // namespace

// The tile length for keys of `words` 64-bit words (0 if unsupported).
extern "C" int djt_merge_sort_tile(int words) {
  switch (words) {
    case 1: return Tile<1>::T;
    case 2: return Tile<2>::T;
    case 3: return Tile<3>::T;
    case 4: return Tile<4>::T;
    default: return 0;
  }
}

// keys0/keys1: (n, words) uint64 row-major, keys0 holding the input;
// idx0/idx1: (n,) uint32. Both pairs are overwritten; on return
// *result_in_1 says which pair (0 or 1) holds the sorted keys and the
// sorting permutation. n < 2^32 - 1.
extern "C" int djt_merge_sort(unsigned long long* keys0,
                              unsigned long long* keys1, unsigned* idx0,
                              unsigned* idx1, long long n, int words,
                              int* result_in_1, void* stream) {
  *result_in_1 = 0;
  if (n < 0 || n >= 0xFFFFFFFFLL) return cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (words) {
    case 1: return run_sort<1>(keys0, keys1, idx0, idx1, n, result_in_1, s);
    case 2: return run_sort<2>(keys0, keys1, idx0, idx1, n, result_in_1, s);
    case 3: return run_sort<3>(keys0, keys1, idx0, idx1, n, result_in_1, s);
    case 4: return run_sort<4>(keys0, keys1, idx0, idx1, n, result_in_1, s);
    default: return cudaErrorInvalidValue;
  }
}

// dsts[l][e] = srcs[l][idx[e]] for k <= DJT_MAX_LANES 32-bit planes;
// srcs/dsts are HOST arrays of device pointers.
extern "C" int djt_gather_planes(const unsigned* idx, const int* const* srcs,
                                 int* const* dsts, int k, long long n,
                                 void* stream) {
  if (k < 1 || k > DJT_MAX_LANES) return cudaErrorInvalidValue;
  if (n <= 0) return 0;
  Planes p;
  for (int l = 0; l < k; ++l) {
    p.src[l] = srcs[l];
    p.dst[l] = dsts[l];
  }
  gather_kernel<<<djt_blocks(n, GATHER_THREADS), GATHER_THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(idx, p, k, n);
  DJT_CHECK_LAUNCH();
  return 0;
}
