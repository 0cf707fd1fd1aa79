// Radix sort of rows by up to 8 key planes of 32 bits, least significant
// digit first, giving the sorting permutation; then a gather of every
// operand by it. The key operands (1, 2, 4 or 8 bytes wide) are read in
// their own dtype and mapped to unsigned order as the plane codecs of
// ops/merge_sort.py map them (sign bit flipped for signed integers, the
// IEEE-754 monotone map for float32), two planes to a 64-bit word, W
// words a row (W = 1..4), most significant first. Every scatter pass is
// stable, so ties keep their input order and the result equals a stable
// sort (merge_sort_planes_reference) bit for bit.
//
// Replaces: _merge_tile_kernel of distributed_join_tpu/ops/sort_pallas.py
// (:314, wrapped by _merge_level :430, merge_sort_planes :489 and
// pallas_merged_sort :659). The contract is the TPU kernel's: sorted u32
// planes equal to lax.sort(operands, num_keys); ties may be permuted
// there, and here they are not. The mechanism is not the TPU's: its
// bitonic tiles and merge levels work around a machine without fast
// scatter; Hopper scatters well, and a sort there is bound by its passes
// over device memory.
//
// What bounds it on the H100: bytes, counted in passes over device
// memory. The join's keys carry few live bits (a key in [0, 2^25) and a
// 2-bit tag in two 64-bit words), so the design counts passes:
// 1. pack: the key operands into W words a row, one array per word;
// 2. one histogram pass reads every key once and builds all 8W digit
//    histograms (shared memory, merged into global memory by atomics);
//    a one-block scan writes each digit position's bin offsets, whether
//    it is live (no bin holds all n rows), which ping-pong buffer its
//    pass reads (the parity of the live passes before it), whether it is
//    the first live pass, and how many words later passes still need;
// 3. one scatter pass per digit position, all launched by the host; a
//    dead digit's pass returns at once, so the skipping stays on the
//    device and the host never synchronises. A live pass is onesweep:
//    each block takes its tile from an atomic counter (so a tile only
//    waits on tiles that already run), ranks its rows by digit with
//    __match_any_sync and per-warp histograms (stable: item-major, lane
//    order), publishes its per-digit counts and looks back across the
//    tiles before it for its global offsets (decoupled look-back; each
//    status word carries the pass's tag, so no reset between passes),
//    and writes the row index and the words later passes need through
//    shared memory, so each digit's run leaves the block as contiguous
//    stores. The first live pass makes the index from the row number;
// 4. one gather of every operand in its own width by the final
//    permutation, whose buffer (and whether any pass ran) it reads from
//    the device-side metadata. A random gather reads a 32-byte sector per
//    element, so an 8-byte operand gathered whole costs half of its two
//    planes gathered apart; and the last live pass also writes its own
//    word (and the dead words above it), so the key operands in those
//    words are read in order from the sorted words, with no gather.

#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int RADIX = 256;
constexpr int MAX_WORDS = 4;
constexpr int MAX_DIGITS = 8 * MAX_WORDS;
constexpr int SORT_THREADS = RADIX;  // one thread per digit value
constexpr int ITEMS = 16;
constexpr int TILE = SORT_THREADS * ITEMS;
constexpr int WARPS = SORT_THREADS / 32;
constexpr int HIST_THREADS = 256;
constexpr int HIST_BLOCKS = 6 * 132;  // 6 blocks an SM: 192 KB of bins
constexpr int HIST_ROWS = 4;    // rows a thread loads at once
constexpr int GATHER_ROWS = 8;  // rows a thread gathers at once
constexpr int THREADS = 256;
constexpr int MAX_OPS = 2 * MAX_WORDS;

// How a key operand's bits map to unsigned order.
constexpr int KIND_RAW = 0, KIND_SIGNED = 1, KIND_FLOAT = 2;

// A look-back status word: bits 63..34 the pass tag (digit position + 1),
// bits 33..32 the flag, bits 31..0 the count.
constexpr unsigned long long FLAG_AGG = 1ULL << 32;
constexpr unsigned long long FLAG_INCL = 2ULL << 32;
constexpr int TAG_SHIFT = 34;

struct Meta {
  unsigned live[MAX_DIGITS];
  unsigned src[MAX_DIGITS];    // buffer (0 or 1) the pass reads
  unsigned first[MAX_DIGITS];  // first live pass: index = row number
  unsigned carry[MAX_DIGITS];  // words 0..carry-1 written for later passes
  unsigned tiles_taken[MAX_DIGITS];
  unsigned any_live;
  unsigned final_buf;
  unsigned sorted_words;  // words 0..sorted_words-1 sorted in final_buf
};

constexpr long long align256(long long x) { return (x + 255) / 256 * 256; }
constexpr long long OFFS_AT = align256(sizeof(Meta));

long long status_at(int words) {
  return OFFS_AT + align256(8LL * words * RADIX * sizeof(unsigned));
}

long long scratch_bytes(long long n, int words) {
  const long long tiles = (n + TILE - 1) / TILE;
  return status_at(words) + tiles * RADIX * 8;
}

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// Exclusive sum of one value per thread over a block of 256 threads.
__device__ __forceinline__ unsigned block_exclusive_sum(unsigned x,
                                                        unsigned* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  unsigned before = 0;
  for (int w = 0; w < warp; ++w) before += s_warp[w];
  __syncthreads();
  return before + inc - x;
}

struct KeyOps {
  const void* ptr[MAX_OPS];
  int width[MAX_OPS];  // bytes: 1, 2, 4 or 8
  int kind[MAX_OPS];
  int plane[MAX_OPS];  // the operand's first plane
};

__device__ __forceinline__ unsigned long long load_bits(const void* p,
                                                        int width,
                                                        long long e) {
  switch (width) {
    case 8: return static_cast<const unsigned long long*>(p)[e];
    case 4: return static_cast<const unsigned*>(p)[e];
    case 2: return static_cast<const unsigned short*>(p)[e];
    default: return static_cast<const unsigned char*>(p)[e];
  }
}

// An operand's bits in unsigned order (key_to_planes of ops/merge_sort.py).
__device__ __forceinline__ unsigned long long ordered(unsigned long long b,
                                                      int width, int kind) {
  if (kind == KIND_FLOAT)  // float32: negatives reversed, sign flipped
    return b >> 31 ? ~b & 0xFFFFFFFFull : b | 0x80000000ull;
  if (kind == KIND_SIGNED) return b ^ (1ull << (8 * width - 1));
  return b;
}

// keys[w * n + e]: planes 2w and 2w + 1 of row e (high, low; 0 past the
// last plane). The words are four scalars, so they stay in registers.
__global__ void pack_kernel(KeyOps ops, int num_ops, int words, long long n,
                            unsigned long long* keys) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < n; e += stride) {
    unsigned long long w0 = 0, w1 = 0, w2 = 0, w3 = 0;
#pragma unroll
    for (int i = 0; i < MAX_OPS; ++i) {
      if (i < num_ops) {
        const int width = ops.width[i];
        const unsigned long long v =
            ordered(load_bits(ops.ptr[i], width, e), width, ops.kind[i]);
        // an 8-byte operand fills planes j, j + 1; a narrower one plane j
        const int j = ops.plane[i];
        const unsigned long long hi =
            width == 8 ? (j & 1 ? v >> 32 : v) : (j & 1 ? v : v << 32);
        const unsigned long long lo = width == 8 && (j & 1) ? v << 32 : 0;
        const int w = j >> 1;
        w0 |= w == 0 ? hi : 0;
        w1 |= w == 1 ? hi : w == 0 ? lo : 0;
        w2 |= w == 2 ? hi : w == 1 ? lo : 0;
        w3 |= w == 3 ? hi : w == 2 ? lo : 0;
      }
    }
    keys[e] = w0;
    if (words > 1) keys[n + e] = w1;
    if (words > 2) keys[2 * n + e] = w2;
    if (words > 3) keys[3 * n + e] = w3;
  }
}

// All 8W digit histograms in one read of the keys. Digit position
// d = 8 * (W - 1 - w) + b is byte b of word w (0 least significant). A
// warp ANDs and ORs its rows' words: a byte where the two agree is one
// digit on every row (every dead digit), added once; any other byte is
// added lane by lane.
__global__ void __launch_bounds__(HIST_THREADS)
    hist_kernel(const unsigned long long* __restrict__ keys, int words,
                long long n, unsigned* __restrict__ hist) {
  __shared__ unsigned sh[MAX_DIGITS * RADIX];
  const int nbins = 8 * words * RADIX;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < nbins; i += HIST_THREADS) sh[i] = 0;
  __syncthreads();
  constexpr int CHUNK = HIST_THREADS * HIST_ROWS;
  for (long long chunk = static_cast<long long>(blockIdx.x) * CHUNK;
       chunk < n; chunk += static_cast<long long>(gridDim.x) * CHUNK) {
    for (int w = 0; w < words; ++w) {
      unsigned long long key[HIST_ROWS];
#pragma unroll
      for (int j = 0; j < HIST_ROWS; ++j) {
        const long long e = chunk + j * HIST_THREADS + threadIdx.x;
        key[j] = e < n ? keys[w * n + e] : 0;
      }
      unsigned* h = sh + 8 * (words - 1 - w) * RADIX;
#pragma unroll
      for (int j = 0; j < HIST_ROWS; ++j) {
        const bool ok = chunk + j * HIST_THREADS + threadIdx.x < n;
        const unsigned rows = __popc(__ballot_sync(FULL, ok));
        const unsigned hi = static_cast<unsigned>(key[j] >> 32);
        const unsigned lo = static_cast<unsigned>(key[j]);
        const unsigned long long all =
            static_cast<unsigned long long>(
                __reduce_and_sync(FULL, ok ? hi : ~0u)) << 32 |
            __reduce_and_sync(FULL, ok ? lo : ~0u);
        const unsigned long long any =
            static_cast<unsigned long long>(
                __reduce_or_sync(FULL, ok ? hi : 0u)) << 32 |
            __reduce_or_sync(FULL, ok ? lo : 0u);
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const unsigned dig =
              static_cast<unsigned>(key[j] >> (8 * b)) & 0xFFu;
          if (((all ^ any) >> (8 * b) & 0xFFu) == 0) {
            if (lane == 0 && rows)
              atomicAdd(h + b * RADIX + (all >> (8 * b) & 0xFFu), rows);
          } else if (ok) {
            atomicAdd(h + b * RADIX + dig, 1u);
          }
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nbins; i += HIST_THREADS) {
    if (sh[i]) atomicAdd(hist + i, sh[i]);
  }
}

// One block of RADIX threads: bin offsets and the pass plan.
__global__ void __launch_bounds__(RADIX)
    plan_kernel(unsigned* offs, int words, long long n, Meta* meta) {
  __shared__ unsigned s_warp[WARPS];
  __shared__ unsigned s_live[MAX_DIGITS];
  const int digits = 8 * words;
  for (int d = 0; d < digits; ++d) {
    const unsigned c = offs[d * RADIX + threadIdx.x];
    offs[d * RADIX + threadIdx.x] = block_exclusive_sum(c, s_warp);
    const int dead = __syncthreads_or(static_cast<long long>(c) == n);
    if (threadIdx.x == 0) s_live[d] = !dead;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  unsigned parity = 0, none_yet = 1;
  for (int d = 0; d < digits; ++d) {
    meta->live[d] = s_live[d];
    meta->src[d] = parity;
    meta->first[d] = s_live[d] && none_yet;
    if (s_live[d]) {
      parity ^= 1u;
      none_yet = 0;
    }
  }
  meta->any_live = !none_yet;
  meta->final_buf = parity;
  // a pass writes the words the next live pass reads; the last live pass
  // writes its own word and the (dead) words above it, so the final
  // buffer holds those words sorted and the key operands in them need no
  // gather
  int next_word = -1;  // the word of the next live pass
  for (int d = digits - 1; d >= 0; --d) {
    const int w = words - 1 - d / 8;
    meta->carry[d] = static_cast<unsigned>((next_word < 0 ? w : next_word)
                                           + 1);
    if (s_live[d]) {
      if (next_word < 0) meta->sorted_words = static_cast<unsigned>(w + 1);
      next_word = w;
    }
  }
  if (none_yet) meta->sorted_words = static_cast<unsigned>(words);
}

// One scatter pass over digit position d (see the header). Keys are W
// arrays of n words in each of the buffers k0 and k1; the index is i0 or
// i1. Row of item i of lane l of warp v in a tile: v*32*ITEMS + i*32 + l.
// A row's digit lives packed in digs (four a register); its key word is
// read again, from L2, where the pass stages it.
__global__ void __launch_bounds__(SORT_THREADS, 3)
    pass_kernel(unsigned long long* k0, unsigned long long* k1,
                unsigned* i0, unsigned* i1, long long n, int words, int d,
                Meta* meta, const unsigned* __restrict__ offs,
                unsigned long long* status) {
  if (!meta->live[d]) return;
  __shared__ unsigned s_hist[WARPS][RADIX];
  __shared__ unsigned long long s_stage[TILE];
  __shared__ unsigned char s_digit[TILE];
  __shared__ unsigned s_loff[RADIX];
  __shared__ int s_goff[RADIX];
  __shared__ unsigned s_warp[WARPS];
  __shared__ unsigned s_tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(&meta->tiles_taken[d], 1u);
#pragma unroll
  for (int v = 0; v < WARPS; ++v) s_hist[v][tid] = 0;
  __syncthreads();

  const unsigned tile = s_tile;
  const long long base = static_cast<long long>(tile) * TILE;
  const int tile_n = static_cast<int>(min(static_cast<long long>(TILE),
                                          n - base));
  const unsigned src = meta->src[d];
  const bool first = meta->first[d] != 0;
  const int carry = static_cast<int>(meta->carry[d]);
  const unsigned long long* kin = src ? k1 : k0;
  unsigned long long* kout = src ? k0 : k1;
  const unsigned* iin = src ? i1 : i0;
  unsigned* iout = src ? i0 : i1;
  const int w = words - 1 - d / 8;
  const int shift = 8 * (d % 8);
  const int row0 = warp * 32 * ITEMS + lane;
  const unsigned below = (1u << lane) - 1u;

  unsigned digs[ITEMS / 4] = {};
  {
    unsigned long long key[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int r = row0 + i * 32;
      key[i] = r < tile_n ? kin[w * n + base + r] : 0;
    }
#pragma unroll
    for (int i = 0; i < ITEMS; ++i)
      digs[i / 4] |= (static_cast<unsigned>(key[i] >> shift) & 0xFFu)
                     << (8 * (i % 4));
  }
  unsigned rank[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const bool ok = row0 + i * 32 < tile_n;
    const unsigned dig =
        ok ? (digs[i / 4] >> (8 * (i % 4))) & 0xFFu : RADIX;
    const unsigned peers = __match_any_sync(FULL, dig);
    const unsigned prior = ok ? s_hist[warp][dig] : 0u;
    __syncwarp();
    if (ok && (peers & below) == 0)
      s_hist[warp][dig] = prior + __popc(peers);
    __syncwarp();
    rank[i] = prior + __popc(peers & below);
  }
  __syncthreads();

  // thread tid owns digit value tid: warp offsets, the tile's count,
  // its publication and the look-back
  unsigned count = 0;
#pragma unroll
  for (int v = 0; v < WARPS; ++v) {
    const unsigned t = s_hist[v][tid];
    s_hist[v][tid] = count;
    count += t;
  }
  unsigned long long* mine = status + static_cast<long long>(tile) * RADIX +
                             tid;
  const unsigned long long tag =
      static_cast<unsigned long long>(d + 1) << TAG_SHIFT;
  st_relaxed(mine, tag | (tile == 0 ? FLAG_INCL : FLAG_AGG) | count);
  const unsigned loff = block_exclusive_sum(count, s_warp);
  unsigned before = 0;
  if (tile > 0) {
    long long p = static_cast<long long>(tile) - 1;
    while (true) {
      const unsigned long long s = ld_relaxed(status + p * RADIX + tid);
      if ((s >> TAG_SHIFT) != static_cast<unsigned long long>(d + 1))
        continue;  // the tile before has not published in this pass yet
      before += static_cast<unsigned>(s);
      if (s & FLAG_INCL) break;
      --p;
    }
    st_relaxed(mine, tag | FLAG_INCL | (before + count));
  }
  s_loff[tid] = loff;
  s_goff[tid] = static_cast<int>(static_cast<long long>(
                    offs[d * RADIX + tid]) + before - loff);
  __syncthreads();

  // local positions: the tile's rows in digit order, stable
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (row0 + i * 32 < tile_n) {
      const unsigned dig = (digs[i / 4] >> (8 * (i % 4))) & 0xFFu;
      rank[i] += s_loff[dig] + s_hist[warp][dig];
      s_digit[rank[i]] = static_cast<unsigned char>(dig);
    }
  }
  unsigned* stage32 = reinterpret_cast<unsigned*>(s_stage);
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int r = row0 + i * 32;
    if (r < tile_n)
      stage32[rank[i]] = first ? static_cast<unsigned>(base + r)
                               : iin[base + r];
  }
  __syncthreads();
  for (int j = tid; j < tile_n; j += SORT_THREADS)
    iout[s_goff[s_digit[j]] + j] = stage32[j];
  for (int v = 0; v < carry; ++v) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int r = row0 + i * 32;
      if (r < tile_n) s_stage[rank[i]] = kin[v * n + base + r];
    }
    __syncthreads();
    for (int j = tid; j < tile_n; j += SORT_THREADS)
      kout[v * n + s_goff[s_digit[j]] + j] = s_stage[j];
  }
}

struct Lanes {
  const void* src[DJT_MAX_LANES];
  void* dst[DJT_MAX_LANES];
  int width[DJT_MAX_LANES];
  int plane[DJT_MAX_LANES];  // a key operand's first plane, else -1
  int kind[DJT_MAX_LANES];
};

// Inverse of ordered().
__device__ __forceinline__ unsigned long long unordered(unsigned long long u,
                                                        int width, int kind) {
  if (kind == KIND_FLOAT) return u >> 31 ? u & 0x7FFFFFFFull
                                         : ~u & 0xFFFFFFFFull;
  if (kind == KIND_SIGNED) return u ^ (1ull << (8 * width - 1));
  return u;
}

// One thread's GATHER_ROWS rows: e0 + j * THREADS.
using RowBits = unsigned long long[GATHER_ROWS];
using RowIdx = long long[GATHER_ROWS];

template <typename T>
__device__ __forceinline__ void store_rows(void* dst, const RowBits& v,
                                           long long e0, long long n) {
#pragma unroll
  for (int j = 0; j < GATHER_ROWS; ++j) {
    if (e0 + j * THREADS < n)
      static_cast<T*>(dst)[e0 + j * THREADS] = static_cast<T>(v[j]);
  }
}

template <typename T>
__device__ __forceinline__ void gather_rows(const void* src, RowBits& v,
                                            const RowIdx& r, long long e0,
                                            long long n) {
#pragma unroll
  for (int j = 0; j < GATHER_ROWS; ++j) {
    if (e0 + j * THREADS < n) v[j] = static_cast<const T*>(src)[r[j]];
  }
}

// dst[l][e] = src[l][perm[e]], GATHER_ROWS rows a thread so that their
// random reads are in flight together. A key operand whose planes lie in
// the words the last pass left sorted is read from them instead (in
// order, and mapped back from unsigned order).
__global__ void __launch_bounds__(THREADS)
    gather_kernel(const Meta* __restrict__ meta,
                  const unsigned long long* __restrict__ k0,
                  const unsigned long long* __restrict__ k1,
                  const unsigned* __restrict__ i0,
                  const unsigned* __restrict__ i1, Lanes lanes, int k,
                  long long n) {
  const bool any = meta->any_live != 0;
  const unsigned* perm = meta->final_buf ? i1 : i0;
  const unsigned long long* keys = meta->final_buf ? k1 : k0;
  const int sorted_words = static_cast<int>(meta->sorted_words);
  const long long e0 =
      static_cast<long long>(blockIdx.x) * THREADS * GATHER_ROWS +
      threadIdx.x;
  RowIdx r;
#pragma unroll
  for (int j = 0; j < GATHER_ROWS; ++j) {
    const long long e = e0 + j * THREADS;
    r[j] = e < n ? (any ? perm[e] : e) : 0;
  }
#pragma unroll
  for (int l = 0; l < DJT_MAX_LANES; ++l) {
    if (l >= k) break;
    const int width = lanes.width[l], p = lanes.plane[l];
    RowBits v;
    if (p >= 0 && (p + (width == 8)) / 2 < sorted_words) {
      const unsigned long long* hi = keys + (p >> 1) * n;
#pragma unroll
      for (int j = 0; j < GATHER_ROWS; ++j) {
        const long long e = e0 + j * THREADS;
        if (e >= n) continue;
        const unsigned long long a = hi[e];
        const unsigned long long u =
            width == 8 ? (p & 1 ? a << 32 | hi[n + e] >> 32 : a)
                       : (p & 1 ? a & 0xFFFFFFFFull : a >> 32);
        v[j] = unordered(u, width, lanes.kind[l]);
      }
    } else {
      const void* src = lanes.src[l];
      switch (width) {
        case 8: gather_rows<unsigned long long>(src, v, r, e0, n); break;
        case 4: gather_rows<unsigned>(src, v, r, e0, n); break;
        case 2: gather_rows<unsigned short>(src, v, r, e0, n); break;
        default: gather_rows<unsigned char>(src, v, r, e0, n);
      }
    }
    switch (width) {
      case 8: store_rows<unsigned long long>(lanes.dst[l], v, e0, n); break;
      case 4: store_rows<unsigned>(lanes.dst[l], v, e0, n); break;
      case 2: store_rows<unsigned short>(lanes.dst[l], v, e0, n); break;
      default: store_rows<unsigned char>(lanes.dst[l], v, e0, n);
    }
  }
}

}  // namespace

// Rows per block of a scatter pass (0 if `words` is unsupported).
extern "C" int djt_radix_sort_tile(int words) {
  return words >= 1 && words <= MAX_WORDS ? TILE : 0;
}

extern "C" long long djt_radix_sort_scratch_bytes(long long n, int words) {
  return scratch_bytes(n, words);
}

// keys/widths/kinds: HOST arrays of num_ops key operands, most
// significant first: (n,) device arrays of 1, 2, 4 or 8 bytes, each with
// its KIND_*; together at most 8 planes (an 8-byte operand is two).
// keys0/keys1: (W, n) u64, W = ceil(planes / 2); idx0/idx1: (n,) u32;
// scratch: djt_radix_sort_scratch_bytes(n, W) bytes. All are
// overwritten; the permutation's buffer is recorded in the scratch for
// djt_gather_sorted. 0 < n < 2^31 - 1.
extern "C" int djt_radix_sort(const void* const* keys, const int* widths,
                              const int* kinds, int num_ops,
                              unsigned long long* keys0,
                              unsigned long long* keys1, unsigned* idx0,
                              unsigned* idx1, void* scratch, long long n,
                              void* stream) {
  if (num_ops < 1 || num_ops > MAX_OPS) return cudaErrorInvalidValue;
  if (n <= 0 || n >= 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  KeyOps ops = {};
  int planes = 0;
  for (int i = 0; i < num_ops; ++i) {
    const int w = widths[i];
    if ((w != 1 && w != 2 && w != 4 && w != 8) || kinds[i] < KIND_RAW ||
        kinds[i] > KIND_FLOAT || (kinds[i] == KIND_FLOAT && w != 4))
      return cudaErrorInvalidValue;
    ops.ptr[i] = keys[i];
    ops.width[i] = w;
    ops.kind[i] = kinds[i];
    ops.plane[i] = planes;
    planes += w == 8 ? 2 : 1;
  }
  if (planes > 2 * MAX_WORDS) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (planes + 1) / 2;
  char* base = static_cast<char*>(scratch);
  Meta* meta = reinterpret_cast<Meta*>(base);
  unsigned* offs = reinterpret_cast<unsigned*>(base + OFFS_AT);
  unsigned long long* status =
      reinterpret_cast<unsigned long long*>(base + status_at(words));
  cudaError_t err = cudaMemsetAsync(scratch, 0, scratch_bytes(n, words), s);
  if (err != cudaSuccess) return err;
  pack_kernel<<<djt_blocks(n, THREADS), THREADS, 0, s>>>(ops, num_ops, words,
                                                         n, keys0);
  DJT_CHECK_LAUNCH();
  hist_kernel<<<HIST_BLOCKS, HIST_THREADS, 0, s>>>(keys0, words, n, offs);
  DJT_CHECK_LAUNCH();
  plan_kernel<<<1, RADIX, 0, s>>>(offs, words, n, meta);
  DJT_CHECK_LAUNCH();
  const unsigned tiles = static_cast<unsigned>((n + TILE - 1) / TILE);
  for (int d = 0; d < 8 * words; ++d) {
    pass_kernel<<<tiles, SORT_THREADS, 0, s>>>(keys0, keys1, idx0, idx1, n,
                                               words, d, meta, offs, status);
    DJT_CHECK_LAUNCH();
  }
  return 0;
}

// dsts[l][e] = srcs[l][perm[e]] for k <= DJT_MAX_LANES operands of
// widths[l] bytes (1, 2, 4 or 8), perm the permutation djt_radix_sort
// left (the identity if no digit was live). A key operand gives its
// first plane in planes[l] and its KIND_* in kinds[l] (a value -1 and
// any kind): where the sort left its words sorted in keys0/keys1, it is
// read from there. srcs/dsts/widths/planes/kinds are HOST arrays.
extern "C" int djt_gather_sorted(const void* scratch,
                                 const unsigned long long* keys0,
                                 const unsigned long long* keys1,
                                 const unsigned* idx0, const unsigned* idx1,
                                 const void* const* srcs, void* const* dsts,
                                 const int* widths, const int* planes,
                                 const int* kinds, int k, long long n,
                                 void* stream) {
  if (k < 1 || k > DJT_MAX_LANES) return cudaErrorInvalidValue;
  if (n <= 0) return 0;
  Lanes lanes;
  for (int l = 0; l < k; ++l) {
    const int w = widths[l];
    if ((w != 1 && w != 2 && w != 4 && w != 8) || planes[l] < -1 ||
        planes[l] + (w == 8) >= 2 * MAX_WORDS)
      return cudaErrorInvalidValue;
    lanes.src[l] = srcs[l];
    lanes.dst[l] = dsts[l];
    lanes.width[l] = w;
    lanes.plane[l] = planes[l];
    lanes.kind[l] = kinds[l];
  }
  const long long rows = static_cast<long long>(THREADS) * GATHER_ROWS;
  gather_kernel<<<static_cast<unsigned>((n + rows - 1) / rows), THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Meta*>(scratch), keys0, keys1, idx0, idx1, lanes, k,
      n);
  DJT_CHECK_LAUNCH();
  return 0;
}
