// Fused join scans: every per-position scan of the sort-merge join over
// the merged-sorted domain, bit-exact with join_scans_reference.
//
// Replaces: _scan_r_kernel and _scan_f_kernel, wrapped by join_scans
// (distributed_join_tpu/ops/scan_pallas.py:106, :150, :205).
//
// What bounds it on the H100: bytes. It reads tag (int8) and first
// (bool) twice and writes six int32 outputs: about 26 bytes per merged
// position, ~0.5 GB at 20 M positions, ~0.16 ms at 3.35 TB/s. The
// arithmetic per position is a few dozen integer operations.
//
// Design. The TPU kernels walk their grid in order and carry scalars in
// SMEM from block to block; here tiles run in any order, so each pass is
// three launches over one associative "span summary" (a monoid):
//   1. tile aggregates: each tile folds its positions into one summary;
//   2. one 256-thread block scans the ~10^4 tile summaries (each thread
//      folds a contiguous chunk, then a Hillis-Steele scan in shared
//      memory), writing each tile's exclusive prefix (suffix for the
//      reverse pass);
//   3. tile rescan: each tile scans its threads' summaries in shared
//      memory, then every thread walks its ITEMS positions in order,
//      emitting the outputs from the running summary.
// The forward carry is not a plain sum: `cnt` before a tile's first run
// start depends on the builds still open from earlier tiles, and
// `start_out` sums that `cnt`. The forward summary therefore records
// how its pre-start probes' counts depend on the incoming open-run
// build count (linear in it, plus a record count that depends only on
// whether it is zero), which closes the family under composition.
// Sums that the reference takes in int32 wrap here the same way
// (unsigned arithmetic).

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;
constexpr int SCAN_THREADS = 256;

// ---------------------------------------------------------------------
// Reverse pass: matched[i] = is_build[i] & (probes in [i, next run
// start after i) > 0). Summary of a span: q = probes from the span's
// left edge up to its first run start (all of them if it has none),
// has = the span holds a run start.
struct RAgg {
  int q;
  int has;
};

__device__ __forceinline__ RAgg r_identity() { return RAgg{0, 0}; }

// Span l followed by span r.
__device__ __forceinline__ RAgg r_combine(RAgg l, RAgg r) {
  RAgg o;
  o.q = l.has ? l.q : l.q + r.q;
  o.has = l.has | r.has;
  return o;
}

__device__ __forceinline__ RAgg r_element(int8_t tag, uint8_t first) {
  RAgg o;
  o.has = first != 0;
  o.q = (!first && tag == 1) ? 1 : 0;
  return o;
}

// ---------------------------------------------------------------------
// Forward pass. Summary of a span read with an empty incoming state:
//   nB, nM       builds / matched builds in the span
//   has          the span holds a run start
//   endOpenB     builds from its last run start to its end (if has)
//   endLM        matched builds before its last run start (if has)
//   npre         probes before its first run start
//   sumPre       sum over those probes of the span's builds before them
//   nrecPre0     how many of those have a build before them in the span
//   sumPost      sum of cnt over probes at/after its first run start
//   nrecPost     records (probes with cnt > 0) among those
// A pre-start probe's cnt is (open builds entering the span) + (the
// span's builds before it).
struct FAgg {
  int nB, nM, has, endOpenB, endLM, npre, nrecPre0, nrecPost;
  unsigned sumPre, sumPost;
};

__device__ __forceinline__ FAgg f_identity() {
  FAgg o;
  o.nB = o.nM = o.has = o.endOpenB = o.endLM = 0;
  o.npre = o.nrecPre0 = o.nrecPost = 0;
  o.sumPre = o.sumPost = 0u;
  return o;
}

__device__ __forceinline__ FAgg f_combine(FAgg l, FAgg r) {
  FAgg o;
  o.nB = l.nB + r.nB;
  o.nM = l.nM + r.nM;
  o.has = l.has | r.has;
  o.endOpenB = r.has ? r.endOpenB : (l.has ? l.endOpenB + r.nB : 0);
  o.endLM = r.has ? l.nM + r.endLM : (l.has ? l.endLM : 0);
  if (l.has) {
    // r's pre-start probes continue l's last run: open builds known.
    o.npre = l.npre;
    o.sumPre = l.sumPre;
    o.nrecPre0 = l.nrecPre0;
    o.sumPost = l.sumPost + r.sumPost + r.sumPre +
                static_cast<unsigned>(r.npre) *
                    static_cast<unsigned>(l.endOpenB);
    o.nrecPost = l.nrecPost + r.nrecPost +
                 (l.endOpenB > 0 ? r.npre : r.nrecPre0);
  } else {
    // r's pre-start probes are pre-start for the whole span too.
    o.npre = l.npre + r.npre;
    o.sumPre = l.sumPre + r.sumPre +
               static_cast<unsigned>(r.npre) * static_cast<unsigned>(l.nB);
    o.nrecPre0 = l.nrecPre0 + (l.nB > 0 ? r.npre : r.nrecPre0);
    o.sumPost = l.sumPost + r.sumPost;
    o.nrecPost = l.nrecPost + r.nrecPost;
  }
  return o;
}

__device__ __forceinline__ FAgg f_element(int8_t tag, uint8_t first,
                                          int matched) {
  FAgg o = f_identity();
  o.nB = tag == 0;
  o.nM = matched != 0;
  o.has = first != 0;
  o.endOpenB = first ? (tag == 0) : 0;
  o.npre = (!first && tag == 1) ? 1 : 0;
  return o;
}

// ---------------------------------------------------------------------
// Block-wide exclusive scans of one summary per thread (Hillis-Steele,
// double-buffered in shared memory). Forward: combine of the threads
// left of t. Reverse: combine of the threads right of t.
template <typename Agg, typename Comb, int N>
__device__ Agg block_exclusive_scan(Agg v, Agg (&buf)[2][N], Agg ident,
                                    Comb comb, bool reverse) {
  const int t = threadIdx.x;
  int src = 0;
  buf[src][t] = v;
  for (int d = 1; d < N; d <<= 1) {
    __syncthreads();
    Agg x = buf[src][t];
    if (!reverse && t >= d) x = comb(buf[src][t - d], x);
    if (reverse && t + d < N) x = comb(x, buf[src][t + d]);
    buf[1 - src][t] = x;
    src = 1 - src;
  }
  __syncthreads();
  Agg out;
  if (reverse)
    out = (t == N - 1) ? ident : buf[src][t + 1];
  else
    out = (t == 0) ? ident : buf[src][t - 1];
  __syncthreads();  // buf may be reused by the caller
  return out;
}

struct RComb {
  __device__ RAgg operator()(RAgg a, RAgg b) const { return r_combine(a, b); }
};
struct FComb {
  __device__ FAgg operator()(FAgg a, FAgg b) const { return f_combine(a, b); }
};

// Phase 2: exclusive prefix (forward) or suffix (reverse) of the tile
// summaries, in one block.
template <typename Agg, typename Comb>
__global__ void scan_tiles(const Agg* __restrict__ aggs, Agg* __restrict__ out,
                           int ntiles, Agg ident, bool reverse) {
  __shared__ Agg buf[2][SCAN_THREADS];
  Comb comb;
  const int t = threadIdx.x;
  const int per = (ntiles + SCAN_THREADS - 1) / SCAN_THREADS;
  const int lo = min(t * per, ntiles);
  const int hi = min(lo + per, ntiles);
  Agg acc = ident;
  for (int i = lo; i < hi; ++i) acc = comb(acc, aggs[i]);
  Agg ctx = block_exclusive_scan<Agg, Comb, SCAN_THREADS>(acc, buf, ident,
                                                          comb, reverse);
  if (!reverse) {
    for (int i = lo; i < hi; ++i) {
      out[i] = ctx;
      ctx = comb(ctx, aggs[i]);
    }
  } else {
    for (int i = hi - 1; i >= lo; --i) {
      out[i] = ctx;
      ctx = comb(aggs[i], ctx);
    }
  }
}

// ---------------------------------------------------------------------
// Reverse pass kernels.

__device__ __forceinline__ RAgg r_thread_agg(const int8_t* tag,
                                             const uint8_t* first,
                                             long long base, long long n) {
  RAgg acc = r_identity();
  for (int k = 0; k < ITEMS; ++k) {
    long long i = base + k;
    if (i < n) acc = r_combine(acc, r_element(tag[i], first[i]));
  }
  return acc;
}

__global__ void r_tile_agg(const int8_t* __restrict__ tag,
                           const uint8_t* __restrict__ first, long long n,
                           RAgg* __restrict__ aggs) {
  __shared__ RAgg red[THREADS];
  const long long base =
      static_cast<long long>(blockIdx.x) * TILE + threadIdx.x * ITEMS;
  red[threadIdx.x] = r_thread_agg(tag, first, base, n);
  for (int s = 1; s < THREADS; s <<= 1) {
    __syncthreads();
    if ((threadIdx.x % (2 * s)) == 0)
      red[threadIdx.x] = r_combine(red[threadIdx.x], red[threadIdx.x + s]);
  }
  if (threadIdx.x == 0) aggs[blockIdx.x] = red[0];
}

__global__ void r_tile_rescan(const int8_t* __restrict__ tag,
                              const uint8_t* __restrict__ first, long long n,
                              const RAgg* __restrict__ suffix,
                              int* __restrict__ matched) {
  __shared__ RAgg buf[2][THREADS];
  const long long base =
      static_cast<long long>(blockIdx.x) * TILE + threadIdx.x * ITEMS;
  RAgg mine = r_thread_agg(tag, first, base, n);
  RAgg right = block_exclusive_scan<RAgg, RComb, THREADS>(
      mine, buf, r_identity(), RComb(), true);
  // probes from just right of this thread's last position up to the
  // next run start
  int q = r_combine(right, suffix[blockIdx.x]).q;
  for (int k = ITEMS - 1; k >= 0; --k) {
    long long i = base + k;
    if (i >= n) continue;
    const int8_t tg = tag[i];
    const int c = q + (tg == 1);
    matched[i] = (tg == 0 && c > 0) ? 1 : 0;
    q = first[i] ? 0 : c;
  }
}

// ---------------------------------------------------------------------
// Forward pass kernels.

__device__ __forceinline__ FAgg f_thread_agg(const int8_t* tag,
                                             const uint8_t* first,
                                             const int* matched,
                                             long long base, long long n) {
  FAgg acc = f_identity();
  for (int k = 0; k < ITEMS; ++k) {
    long long i = base + k;
    if (i < n) acc = f_combine(acc, f_element(tag[i], first[i], matched[i]));
  }
  return acc;
}

__global__ void f_tile_agg(const int8_t* __restrict__ tag,
                           const uint8_t* __restrict__ first,
                           const int* __restrict__ matched, long long n,
                           FAgg* __restrict__ aggs) {
  __shared__ FAgg red[THREADS];
  const long long base =
      static_cast<long long>(blockIdx.x) * TILE + threadIdx.x * ITEMS;
  red[threadIdx.x] = f_thread_agg(tag, first, matched, base, n);
  for (int s = 1; s < THREADS; s <<= 1) {
    __syncthreads();
    if ((threadIdx.x % (2 * s)) == 0)
      red[threadIdx.x] = f_combine(red[threadIdx.x], red[threadIdx.x + s]);
  }
  if (threadIdx.x == 0) aggs[blockIdx.x] = red[0];
}

__global__ void f_tile_rescan(const int8_t* __restrict__ tag,
                              const uint8_t* __restrict__ first,
                              const int* __restrict__ matched, long long n,
                              const FAgg* __restrict__ prefix,
                              int* __restrict__ cnt,
                              int* __restrict__ start_out,
                              int* __restrict__ lo_m,
                              int* __restrict__ rec_pos,
                              int* __restrict__ mb_pos) {
  __shared__ FAgg buf[2][THREADS];
  const long long base =
      static_cast<long long>(blockIdx.x) * TILE + threadIdx.x * ITEMS;
  FAgg mine = f_thread_agg(tag, first, matched, base, n);
  FAgg left = block_exclusive_scan<FAgg, FComb, THREADS>(
      mine, buf, f_identity(), FComb(), false);
  FAgg acc = f_combine(prefix[blockIdx.x], left);
  for (int k = 0; k < ITEMS; ++k) {
    long long i = base + k;
    if (i >= n) break;
    const int8_t tg = tag[i];
    const uint8_t fs = first[i];
    const int m = matched[i];
    // state after everything before i, from an empty start
    const int open_b = acc.has ? acc.endOpenB : acc.nB;
    const unsigned csum = acc.sumPre + acc.sumPost;
    const int recs = acc.nrecPre0 + acc.nrecPost;
    const int lm = acc.has ? acc.endLM : 0;
    const int c = (tg == 1) ? (fs ? 0 : open_b) : 0;
    cnt[i] = c;
    start_out[i] = static_cast<int>(csum);
    rec_pos[i] = recs + ((tg == 1 && c > 0) ? 1 : 0) - 1;
    mb_pos[i] = acc.nM + (m != 0) - 1;
    lo_m[i] = fs ? acc.nM : lm;
    acc = f_combine(acc, f_element(tg, fs, m));
  }
}

struct Scratch {
  RAgg* r_aggs;
  RAgg* r_suffix;
  FAgg* f_aggs;
  FAgg* f_prefix;
};

__host__ long long align_up(long long x) { return (x + 255) / 256 * 256; }

__host__ Scratch carve(void* base, long long ntiles) {
  char* p = static_cast<char*>(base);
  Scratch s;
  const long long rb = align_up(ntiles * sizeof(RAgg));
  const long long fb = align_up(ntiles * sizeof(FAgg));
  s.r_aggs = reinterpret_cast<RAgg*>(p);
  s.r_suffix = reinterpret_cast<RAgg*>(p + rb);
  s.f_aggs = reinterpret_cast<FAgg*>(p + 2 * rb);
  s.f_prefix = reinterpret_cast<FAgg*>(p + 2 * rb + fb);
  return s;
}

}  // namespace

extern "C" long long djt_join_scans_scratch_bytes(long long n) {
  const long long ntiles = (n + TILE - 1) / TILE;
  return 2 * align_up(ntiles * sizeof(RAgg)) +
         2 * align_up(ntiles * sizeof(FAgg));
}

// tag: (n,) int8 (0 build, 1 probe, 2 padding); first: (n,) bool run
// starts. Outputs: six (n,) int32 arrays. scratch: a device buffer of
// djt_join_scans_scratch_bytes(n) bytes.
extern "C" int djt_join_scans(const int8_t* tag, const uint8_t* first,
                              int* matched, int* cnt, int* start_out,
                              int* lo_m, int* rec_pos, int* mb_pos,
                              long long n, void* scratch, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long ntiles = (n + TILE - 1) / TILE;
  const int nt = static_cast<int>(ntiles);
  Scratch s = carve(scratch, ntiles);

  r_tile_agg<<<nt, THREADS, 0, st>>>(tag, first, n, s.r_aggs);
  DJT_CHECK_LAUNCH();
  scan_tiles<RAgg, RComb><<<1, SCAN_THREADS, 0, st>>>(
      s.r_aggs, s.r_suffix, nt, RAgg{0, 0}, true);
  DJT_CHECK_LAUNCH();
  r_tile_rescan<<<nt, THREADS, 0, st>>>(tag, first, n, s.r_suffix, matched);
  DJT_CHECK_LAUNCH();

  FAgg ident;
  ident.nB = ident.nM = ident.has = ident.endOpenB = ident.endLM = 0;
  ident.npre = ident.nrecPre0 = ident.nrecPost = 0;
  ident.sumPre = ident.sumPost = 0u;
  f_tile_agg<<<nt, THREADS, 0, st>>>(tag, first, matched, n, s.f_aggs);
  DJT_CHECK_LAUNCH();
  scan_tiles<FAgg, FComb><<<1, SCAN_THREADS, 0, st>>>(
      s.f_aggs, s.f_prefix, nt, ident, false);
  DJT_CHECK_LAUNCH();
  f_tile_rescan<<<nt, THREADS, 0, st>>>(tag, first, matched, n, s.f_prefix,
                                        cnt, start_out, lo_m, rec_pos,
                                        mb_pos);
  DJT_CHECK_LAUNCH();
  return 0;
}
