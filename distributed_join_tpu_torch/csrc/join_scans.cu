// Fused join scans: every per-position scan of the sort-merge join over
// the merged-sorted domain, bit-exact with join_scans_reference.
//
// Replaces: _scan_r_kernel and _scan_f_kernel, wrapped by join_scans
// (distributed_join_tpu/ops/scan_pallas.py:106, :150, :205).
//
// What bounds it on the H100: bytes. The function reads tag (int8) and
// first (bool) and writes six int32 outputs: 26 bytes a merged position,
// ~0.52 GB at 20 M positions, 0.155 ms at 3.35 TB/s. The arithmetic per
// position is a few dozen integer operations.
//
// Design: two single-pass scans with decoupled look-back, one launch
// each, after one memset of their status words (three launches a call).
// The TPU kernels walk their grid in order and carry scalars in SMEM from
// block to block; here tiles run in any order, so each pass scans one
// associative span summary (a monoid) and a tile learns the summary of
// the tiles before it from their published status.
// - A tile is TILE = 4096 positions: 256 threads of 16 consecutive
//   positions, each byte array read with one 16-byte load a thread (an
//   input that does not start on a 16-byte boundary takes a byte path for
//   the whole call, as does the ragged last chunk). Each thread folds its
//   positions into a summary; warps scan them by shuffles, and warp 0
//   scans the 8 warp totals the same way: no shared-memory scan rounds.
// - Tiles are claimed from an atomic counter in scan order (the reverse
//   pass from the last tile), so a tile only waits on tiles that already
//   run. Warp 0 publishes the tile's total, reads 32 earlier tiles'
//   status at once, combines them up to the nearest inclusive prefix,
//   and publishes its own inclusive prefix.
// - Reverse pass (matched): the summary is (q = probes before the span's
//   first run start, has = it holds a run start); with a 2-bit flag it
//   fits one 64-bit word, stored and loaded relaxed. It writes matched as
//   int32, and a byte copy for the forward pass
//   (1 byte a position read back instead of 4).
// - Forward pass (cnt, start_out, lo_m, rec_pos, mb_pos): `cnt` before a
//   tile's first run start depends on the builds still open from earlier
//   tiles, and `start_out` sums that `cnt`, so the summary records how its
//   pre-start probes' counts depend on the incoming open-run build count
//   (linear in it, plus a record count that depends only on whether it
//   is zero), which closes the family under composition: 10 fields. It
//   does not fit one status word, so each tile has two slots, AGG and
//   INCL (a reader never sees one overwritten by the other), of five
//   64-bit words; each word carries a valid bit beside its payload and is
//   written once, relaxed. A reader loads all ten words of a tile at once
//   and takes a slot when its five words are valid: no flag word, no
//   fence, one round trip to L2. (On an H100 at 20 M positions, a flag
//   word written with release semantics after the summary, and read with
//   acquire semantics before it, cost 0.04 ms more.)
//   One chained look-back over this summary, rather than two over split
//   monoids, keeps the AGG publication independent of the look-back.
// - Each output is written through a per-warp staging buffer in shared
//   memory, so that every 16-byte store of a warp covers 512 contiguous
//   bytes (a thread's own 16 consecutive positions would put the warp's
//   stores 64 bytes apart).
// - The status words and tile counters are zeroed by cudaMemsetAsync in
//   the stream before the passes: the scratch comes from PyTorch's
//   caching allocator and may still hold the last call's words.
// Traffic: about 2 + 4 + 1 B a position in the reverse pass and
// 3 + 20 B in the forward pass, 30 B against the function's 26.
// Sums that the reference takes in int32 wrap here the same way
// (unsigned arithmetic). Counts take 31 bits in the status words, so a
// call takes every n < 2^31 positions: the int32 domain of the join.

#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int THREADS = 256;
constexpr int ITEMS = 16;  // positions a thread: one 16-byte load a byte array
constexpr int TILE = THREADS * ITEMS;
constexpr int WARPS = THREADS / 32;

// ---------------------------------------------------------------------
// Reverse pass: matched[i] = is_build[i] & (probes in [i, next run
// start after i) > 0). Summary of a span: q = probes from the span's
// left edge up to its first run start (all of them if it has none),
// has = the span holds a run start.
struct RAgg {
  int q;
  int has;
};

__device__ __forceinline__ RAgg identity(RAgg) { return RAgg{0, 0}; }

// Span l followed by span r.
__device__ __forceinline__ RAgg combine(RAgg l, RAgg r) {
  return RAgg{l.has ? l.q : l.q + r.q, l.has | r.has};
}

__device__ __forceinline__ RAgg shfl_up(RAgg v, int d) {
  return RAgg{__shfl_up_sync(FULL, v.q, d), __shfl_up_sync(FULL, v.has, d)};
}

__device__ __forceinline__ RAgg shfl_down(RAgg v, int d) {
  return RAgg{__shfl_down_sync(FULL, v.q, d),
              __shfl_down_sync(FULL, v.has, d)};
}

__device__ __forceinline__ RAgg shfl_idx(RAgg v, int d) {
  return RAgg{__shfl_sync(FULL, v.q, d), __shfl_sync(FULL, v.has, d)};
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

__device__ __forceinline__ FAgg identity(FAgg) {
  FAgg o;
  o.nB = o.nM = o.has = o.endOpenB = o.endLM = 0;
  o.npre = o.nrecPre0 = o.nrecPost = 0;
  o.sumPre = o.sumPost = 0u;
  return o;
}

__device__ __forceinline__ FAgg combine(FAgg l, FAgg r) {
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

#define DJT_SHFL_FAGG(op)                                     \
  FAgg o;                                                     \
  o.nB = op(FULL, v.nB, d);                                   \
  o.nM = op(FULL, v.nM, d);                                   \
  o.has = op(FULL, v.has, d);                                 \
  o.endOpenB = op(FULL, v.endOpenB, d);                       \
  o.endLM = op(FULL, v.endLM, d);                             \
  o.npre = op(FULL, v.npre, d);                               \
  o.nrecPre0 = op(FULL, v.nrecPre0, d);                       \
  o.nrecPost = op(FULL, v.nrecPost, d);                       \
  o.sumPre = op(FULL, v.sumPre, d);                           \
  o.sumPost = op(FULL, v.sumPost, d);                         \
  return o;

__device__ __forceinline__ FAgg shfl_up(FAgg v, int d) {
  DJT_SHFL_FAGG(__shfl_up_sync)
}

__device__ __forceinline__ FAgg shfl_down(FAgg v, int d) {
  DJT_SHFL_FAGG(__shfl_down_sync)
}

__device__ __forceinline__ FAgg shfl_idx(FAgg v, int d) {
  DJT_SHFL_FAGG(__shfl_sync)
}

#undef DJT_SHFL_FAGG

// ---------------------------------------------------------------------
// Byte chunks: ITEMS consecutive positions, one 16-byte load where the
// array is 16-byte aligned and the chunk lies inside [0, n); positions
// at or past n read as `fill`.

__device__ __forceinline__ unsigned byte_at(const uint4& v, int j) {
  const unsigned w = j < 4 ? v.x : j < 8 ? v.y : j < 12 ? v.z : v.w;
  return (w >> (8 * (j & 3))) & 0xFFu;
}

template <bool VEC>
__device__ __forceinline__ uint4 load_chunk(const uint8_t* __restrict__ p,
                                            long long e0, long long n,
                                            unsigned fill) {
  if (VEC && e0 + ITEMS <= n)
    return *reinterpret_cast<const uint4*>(p + e0);
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const unsigned b = e0 + j < n ? p[e0 + j] : fill;
    w[j / 4] |= b << (8 * (j % 4));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void store4(int* __restrict__ out, long long e,
                                       long long n, bool full, int a, int b,
                                       int c, int d) {
  if (full) {
    *reinterpret_cast<int4*>(out + e) = make_int4(a, b, c, d);
  } else {
    if (e < n) out[e] = a;
    if (e + 1 < n) out[e + 1] = b;
    if (e + 2 < n) out[e + 2] = c;
    if (e + 3 < n) out[e + 3] = d;
  }
}

// ---------------------------------------------------------------------
// Scans of one summary per lane by shuffles, over the first LANES
// lanes of the warp (the others hold the identity). Forward (REV
// false): the inclusive scan from lane 0 up; reverse: from the last
// lane down.
template <bool REV, int LANES, typename Agg>
__device__ __forceinline__ Agg warp_scan(Agg v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < LANES; d <<= 1) {
    const Agg o = REV ? shfl_down(v, d) : shfl_up(v, d);
    if (REV ? lane + d < LANES : lane >= d)
      v = REV ? combine(v, o) : combine(o, v);
  }
  return v;
}

// The exclusive scan from the inclusive one.
template <bool REV, int LANES, typename Agg>
__device__ __forceinline__ Agg warp_exclusive(Agg inc) {
  const int lane = threadIdx.x & 31;
  const Agg ex = REV ? shfl_down(inc, 1) : shfl_up(inc, 1);
  return lane == (REV ? LANES - 1 : 0) ? identity(inc) : ex;
}

// ---------------------------------------------------------------------
// Per-thread folds of the ITEMS positions.

__device__ __forceinline__ RAgg r_fold(const uint4& tg, const uint4& fs) {
  RAgg a{0, 0};
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    a.has |= byte_at(fs, j) != 0;
    a.q += !a.has && byte_at(tg, j) == 1;
  }
  return a;
}

__device__ __forceinline__ FAgg f_fold(const uint4& tg, const uint4& fs,
                                       const uint4& mt) {
  FAgg a = identity(FAgg{});
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const unsigned t = byte_at(tg, j);
    const int b = t == 0;
    if (byte_at(fs, j)) {
      a.has = 1;
      a.endOpenB = 0;
      a.endLM = a.nM;
    } else if (t == 1) {
      if (a.has) {
        a.sumPost += static_cast<unsigned>(a.endOpenB);
        a.nrecPost += a.endOpenB > 0;
      } else {
        a.npre += 1;
        a.sumPre += static_cast<unsigned>(a.nB);
        a.nrecPre0 += a.nB > 0;
      }
    }
    a.nB += b;
    a.nM += byte_at(mt, j) != 0;
    a.endOpenB += a.has ? b : 0;
  }
  return a;
}

// Per-warp staging of one output: lane l's 16 values at word
// 16 l + 4 (l >> 1) + j (conflict-free 16-byte writes and reads), read
// back so that each 16-byte store of the warp covers 512 contiguous bytes.
constexpr int STAGE_WORDS = 32 * ITEMS + 4 * 16;

__device__ __forceinline__ void stage_store(int* __restrict__ out,
                                            int* s, const int (&v)[ITEMS],
                                            long long e_w, long long n) {
  const int lane = threadIdx.x & 31;
  int* mine = s + 16 * lane + 4 * (lane >> 1);
#pragma unroll
  for (int g = 0; g < ITEMS / 4; ++g)
    *reinterpret_cast<int4*>(mine + 4 * g) =
        make_int4(v[4 * g], v[4 * g + 1], v[4 * g + 2], v[4 * g + 3]);
  __syncwarp();
#pragma unroll
  for (int k = 0; k < ITEMS / 4; ++k) {
    const int p = 128 * k + 4 * lane;  // word of the warp's 512
    const int t = p >> 4;
    const int4 x = *reinterpret_cast<const int4*>(s + 16 * t + 4 * (t >> 1) +
                                                  (p & 15));
    store4(out, e_w + p, n, e_w + p + 4 <= n, x.x, x.y, x.z, x.w);
  }
  __syncwarp();
}

// The reverse pass over one thread's positions, right to left, given
// the summary of everything right of them: matched as int32 (staged) and
// as bytes (one 16-byte store a thread).
__device__ __forceinline__ void r_emit(const uint4& tg, const uint4& fs,
                                       RAgg right, long long e0, long long n,
                                       int* __restrict__ matched,
                                       uint8_t* __restrict__ mbytes, int* s) {
  int q = right.q;  // probes right of the current position, to a run start
  int m[ITEMS];
#pragma unroll
  for (int j = ITEMS - 1; j >= 0; --j) {
    const unsigned t = byte_at(tg, j);
    const int c = q + (t == 1);
    m[j] = t == 0 && c > 0;
    q = byte_at(fs, j) ? 0 : c;
  }
  if (e0 + ITEMS <= n) {
    unsigned w[4];
#pragma unroll
    for (int g = 0; g < 4; ++g)
      w[g] = m[4 * g] | m[4 * g + 1] << 8 | m[4 * g + 2] << 16 |
             m[4 * g + 3] << 24;
    *reinterpret_cast<uint4*>(mbytes + e0) = make_uint4(w[0], w[1], w[2],
                                                        w[3]);
  } else {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
      if (e0 + j < n) mbytes[e0 + j] = static_cast<uint8_t>(m[j]);
  }
  stage_store(matched, s, m, e0 - (threadIdx.x & 31) * ITEMS, n);
}

struct FOut {
  int* cnt;
  int* start_out;
  int* lo_m;
  int* rec_pos;
  int* mb_pos;
};

// The forward pass over one thread's positions, left to right, given
// the summary of everything before them; one output at a time, staged.
__device__ __forceinline__ void f_emit(const uint4& tg, const uint4& fs,
                                       const uint4& mt, FAgg acc,
                                       long long e0, long long n, FOut out,
                                       int* s) {
  const long long e_w = e0 - (threadIdx.x & 31) * ITEMS;
  int* dst[5] = {out.cnt, out.start_out, out.lo_m, out.rec_pos, out.mb_pos};
#pragma unroll
  for (int o = 0; o < 5; ++o) {
    int open = acc.has ? acc.endOpenB : acc.nB;
    unsigned csum = acc.sumPre + acc.sumPost;
    int recs = acc.nrecPre0 + acc.nrecPost;
    int nm = acc.nM;
    int lm = acc.has ? acc.endLM : 0;
    int v[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const unsigned t = byte_at(tg, j);
      if (byte_at(fs, j)) {
        open = 0;
        lm = nm;
      }
      const int c = t == 1 ? open : 0;
      recs += c > 0;
      nm += byte_at(mt, j) != 0;
      v[j] = o == 0 ? c : o == 1 ? static_cast<int>(csum) : o == 2 ? lm
             : o == 3 ? recs - 1 : nm - 1;
      csum += static_cast<unsigned>(c);
      open += t == 0;
    }
    stage_store(dst[o], s, v, e_w, n);
  }
}

// ---------------------------------------------------------------------
// Decoupled look-back. A tile publishes its own summary (AGG) as soon as
// its block has scanned it, then the summary of everything before it
// (INCL, in scan order) once its look-back is done; the first tile in
// scan order publishes INCL at once. Warp 0 of a tile reads the status
// of the 32 tiles before it at once, waits until each has published
// something, combines them up to the nearest INCL, and goes on 32 tiles
// further while there is none. Tiles are claimed from an atomic counter
// in scan order, so a tile only ever waits on tiles that already run.
constexpr unsigned FLAG_AGG = 1u, FLAG_INCL = 2u;

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

// Reverse status word: bits 34..33 the flag, bit 32 has, bits 31..0 q.
__device__ __forceinline__ unsigned long long r_word(RAgg a, unsigned flag) {
  return static_cast<unsigned long long>(flag) << 33 |
         static_cast<unsigned long long>(a.has != 0) << 32 |
         static_cast<unsigned>(a.q);
}

// Summary of the tiles right of `tile` (reverse scan order: the last
// tile first), on every lane of warp 0. Lane l reads tile p + l.
__device__ RAgg r_lookback(const unsigned long long* status, long long tile,
                           long long ntiles) {
  const int lane = threadIdx.x & 31;
  RAgg acc{0, 0};
  for (long long p = tile + 1;; p += 32) {
    const long long i = p + lane;
    unsigned long long w = static_cast<unsigned long long>(FLAG_INCL) << 33;
    if (i < ntiles) {
      do {
        w = ld_relaxed(status + i);
      } while ((w >> 33) == 0);
    }
    const unsigned incl = __ballot_sync(FULL, (w >> 33) == FLAG_INCL);
    const int stop = __ffs(incl) - 1;  // -1: no INCL in this window
    RAgg v{0, 0};
    if (incl == 0 || lane <= stop)
      v = RAgg{static_cast<int>(static_cast<unsigned>(w)),
               static_cast<int>(w >> 32) & 1};
    acc = combine(acc, shfl_idx(warp_scan<true, 32>(v), 0));
    if (incl) return acc;
  }
}

// A forward summary in device memory: five 64-bit words, each with a
// valid bit (63) beside up to 63 bits of payload, written relaxed and
// once a call each. A reader takes the summary only when all five words
// are valid, so neither a flag word nor a fence is needed, and one round
// trip to L2 brings flag and payload together. Counts take 31 bits
// (n < 2^31), the wrapping sums 32:
//   word 0: sumPre << 31 | nB          word 1: sumPost << 31 | nM
//   word 2: endOpenB << 31 | endLM     word 3: npre << 31 | nrecPre0
//   word 4: has << 31 | nrecPost
constexpr unsigned long long VALID = 1ull << 63;
constexpr unsigned long long M31 = (1ull << 31) - 1;
constexpr int FWORDS = 5;

// Two fields of a word: hi (up to 32 bits) at bit 31, lo (31 bits) below.
__device__ __forceinline__ unsigned long long f_word(unsigned hi,
                                                     unsigned lo) {
  return VALID | static_cast<unsigned long long>(hi) << 31 | lo;
}

__device__ __forceinline__ void f_put(unsigned long long* r, const FAgg& a) {
  st_relaxed(r, f_word(a.sumPre, static_cast<unsigned>(a.nB)));
  st_relaxed(r + 1, f_word(a.sumPost, static_cast<unsigned>(a.nM)));
  st_relaxed(r + 2, f_word(static_cast<unsigned>(a.endOpenB),
                           static_cast<unsigned>(a.endLM)));
  st_relaxed(r + 3, f_word(static_cast<unsigned>(a.npre),
                           static_cast<unsigned>(a.nrecPre0)));
  st_relaxed(r + 4, f_word(static_cast<unsigned>(a.has),
                           static_cast<unsigned>(a.nrecPost)));
}

__device__ __forceinline__ unsigned f_hi(unsigned long long w) {
  return static_cast<unsigned>(w >> 31);  // VALID falls off the top
}

__device__ __forceinline__ int f_lo(unsigned long long w) {
  return static_cast<int>(w & M31);
}

__device__ __forceinline__ FAgg f_unpack(const unsigned long long (&w)[5]) {
  FAgg o;
  o.sumPre = f_hi(w[0]);
  o.nB = f_lo(w[0]);
  o.sumPost = f_hi(w[1]);
  o.nM = f_lo(w[1]);
  o.endOpenB = static_cast<int>(f_hi(w[2]) & M31);
  o.endLM = f_lo(w[2]);
  o.npre = static_cast<int>(f_hi(w[3]) & M31);
  o.nrecPre0 = f_lo(w[3]);
  o.has = static_cast<int>(f_hi(w[4]) & 1u);
  o.nrecPost = f_lo(w[4]);
  return o;
}

// Forward status: two summary slots a tile, AGG and INCL, so that a
// reader never sees one half overwritten by the other.
struct FStatus {
  unsigned long long* agg;
  unsigned long long* incl;
};

// Summary of the tiles left of `tile`, on every lane of warp 0. Lane l
// reads tile p - 31 + l, so that lanes run left to right as the tiles do.
__device__ FAgg f_lookback(FStatus st, long long tile) {
  const int lane = threadIdx.x & 31;
  FAgg acc = identity(FAgg{});
  for (long long p = tile - 1;; p -= 32) {
    const long long i = p - 31 + lane;
    bool incl = true;
    FAgg v = identity(FAgg{});
    if (i >= 0) {
      unsigned long long wi[FWORDS], wa[FWORDS];
      while (true) {
        // both slots' words in flight at once
#pragma unroll
        for (int k = 0; k < FWORDS; ++k) {
          wi[k] = ld_relaxed(st.incl + FWORDS * i + k);
          wa[k] = ld_relaxed(st.agg + FWORDS * i + k);
        }
        incl = (wi[0] & wi[1] & wi[2] & wi[3] & wi[4] & VALID) != 0;
        if (incl || (wa[0] & wa[1] & wa[2] & wa[3] & wa[4] & VALID)) break;
      }
#pragma unroll
      for (int k = 0; k < FWORDS; ++k) wi[k] = incl ? wi[k] : wa[k];
      v = f_unpack(wi);
    }
    const unsigned incls = __ballot_sync(FULL, incl);
    const int from = incls ? 31 - __clz(incls) : 0;  // the nearest INCL
    if (lane < from) v = identity(FAgg{});
    acc = combine(shfl_idx(warp_scan<false, 32>(v), 31), acc);
    if (incls) return acc;
  }
}

// ---------------------------------------------------------------------
// The two passes. A tile is TILE positions, ITEMS a thread.

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    r_pass(const uint8_t* __restrict__ tag,
           const uint8_t* __restrict__ first, long long n, long long ntiles,
           unsigned* counter, unsigned long long* status,
           int* __restrict__ matched, uint8_t* __restrict__ mbytes) {
  __shared__ RAgg s_warp[WARPS];
  __shared__ long long s_tile;
  __shared__ __align__(16) int s_stage[WARPS][STAGE_WORDS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = ntiles - 1 - atomicAdd(counter, 1u);
  __syncthreads();
  const long long tile = s_tile;
  const long long e0 = tile * TILE + threadIdx.x * ITEMS;
  const uint4 tg = load_chunk<VEC>(tag, e0, n, 2u);
  const uint4 fs = load_chunk<VEC>(first, e0, n, 0u);
  const RAgg inc = warp_scan<true, 32>(r_fold(tg, fs));
  const RAgg ex = warp_exclusive<true, 32>(inc);
  if (lane == 0) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    // the warps' summaries, scanned from the last warp down
    const RAgg w = warp_scan<true, WARPS>(
        lane < WARPS ? s_warp[lane] : RAgg{0, 0});
    const RAgg wex = warp_exclusive<true, WARPS>(w);
    const bool last = tile == ntiles - 1;
    if (lane == 0)
      st_relaxed(status + tile, r_word(w, last ? FLAG_INCL : FLAG_AGG));
    RAgg right{0, 0};
    if (!last) {
      right = r_lookback(status, tile, ntiles);
      if (lane == 0)
        st_relaxed(status + tile, r_word(combine(w, right), FLAG_INCL));
    }
    __syncwarp();
    if (lane < WARPS) s_warp[lane] = combine(wex, right);
  }
  __syncthreads();
  r_emit(tg, fs, combine(ex, s_warp[warp]), e0, n, matched, mbytes,
         s_stage[warp]);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    f_pass(const uint8_t* __restrict__ tag,
           const uint8_t* __restrict__ first,
           const uint8_t* __restrict__ mbytes, long long n,
           unsigned* counter, FStatus st, FOut out) {
  __shared__ FAgg s_warp[WARPS];
  __shared__ long long s_tile;
  __shared__ __align__(16) int s_stage[WARPS][STAGE_WORDS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicAdd(counter, 1u);
  __syncthreads();
  const long long tile = s_tile;
  const long long e0 = tile * TILE + threadIdx.x * ITEMS;
  const uint4 tg = load_chunk<VEC>(tag, e0, n, 2u);
  const uint4 fs = load_chunk<VEC>(first, e0, n, 0u);
  const uint4 mt = load_chunk<true>(mbytes, e0, n, 0u);
  const FAgg inc = warp_scan<false, 32>(f_fold(tg, fs, mt));
  const FAgg ex = warp_exclusive<false, 32>(inc);
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const FAgg w = warp_scan<false, WARPS>(
        lane < WARPS ? s_warp[lane] : identity(FAgg{}));
    const FAgg wex = warp_exclusive<false, WARPS>(w);
    const FAgg total = shfl_idx(w, WARPS - 1);
    if (lane == 0)
      f_put((tile == 0 ? st.incl : st.agg) + FWORDS * tile, total);
    FAgg left = identity(FAgg{});
    if (tile > 0) {
      left = f_lookback(st, tile);
      if (lane == 0) f_put(st.incl + FWORDS * tile, combine(left, total));
    }
    __syncwarp();
    if (lane < WARPS) s_warp[lane] = combine(left, wex);
  }
  __syncthreads();
  f_emit(tg, fs, mt, combine(s_warp[warp], ex), e0, n, out, s_stage[warp]);
}

constexpr long long align256(long long x) { return (x + 255) / 256 * 256; }

// Scratch: the tile counters and the status words (zeroed each call),
// and `matched` as bytes.
struct Scratch {
  unsigned* counters;  // [0] reverse, [1] forward
  unsigned long long* r_status;
  FStatus f;
  uint8_t* mbytes;
  long long zeroed;  // bytes from the start zeroed each call
  long long total;
};

Scratch carve(void* base, long long n, long long ntiles) {
  char* p = static_cast<char*>(base);
  Scratch s;
  long long at = 0;
  s.counters = reinterpret_cast<unsigned*>(p);
  at += 256;
  s.r_status = reinterpret_cast<unsigned long long*>(p + at);
  at += align256(ntiles * 8);
  s.f.agg = reinterpret_cast<unsigned long long*>(p + at);
  at += align256(ntiles * FWORDS * 8);
  s.f.incl = reinterpret_cast<unsigned long long*>(p + at);
  at += align256(ntiles * FWORDS * 8);
  s.zeroed = at;
  s.mbytes = reinterpret_cast<uint8_t*>(p + at);
  at += align256(n);
  s.total = at;
  return s;
}

template <bool VEC>
void launch(const uint8_t* tag, const uint8_t* first, int* matched,
            FOut out, long long n, long long ntiles, const Scratch& s,
            cudaStream_t st) {
  const unsigned nt = static_cast<unsigned>(ntiles);
  r_pass<VEC><<<nt, THREADS, 0, st>>>(tag, first, n, ntiles, s.counters,
                                      s.r_status, matched, s.mbytes);
  f_pass<VEC><<<nt, THREADS, 0, st>>>(tag, first, s.mbytes, n,
                                      s.counters + 1, s.f, out);
}

}  // namespace

extern "C" long long djt_join_scans_scratch_bytes(long long n) {
  return carve(nullptr, n, (n + TILE - 1) / TILE).total;
}

// tag: (n,) int8 (0 build, 1 probe, 2 padding); first: (n,) bool run
// starts; either may start at any byte address (off a 16-byte boundary
// every load takes the byte path). Outputs: six (n,) int32 arrays,
// 16-byte aligned. scratch: a device buffer of
// djt_join_scans_scratch_bytes(n) bytes, 256-byte aligned, in any state:
// its status words are zeroed here, in the stream, before the passes.
extern "C" int djt_join_scans(const int8_t* tag, const uint8_t* first,
                              int* matched, int* cnt, int* start_out,
                              int* lo_m, int* rec_pos, int* mb_pos,
                              long long n, void* scratch, void* stream) {
  if (n <= 0) return 0;
  if (n > static_cast<long long>(M31)) return cudaErrorInvalidValue;
  int* outs[6] = {matched, cnt, start_out, lo_m, rec_pos, mb_pos};
  for (int* o : outs)
    if (reinterpret_cast<uintptr_t>(o) % 16) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(scratch) % 256)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long ntiles = (n + TILE - 1) / TILE;
  const Scratch s = carve(scratch, n, ntiles);
  cudaError_t err = cudaMemsetAsync(scratch, 0, s.zeroed, st);
  if (err != cudaSuccess) return err;
  const FOut out{cnt, start_out, lo_m, rec_pos, mb_pos};
  const uint8_t* tg = reinterpret_cast<const uint8_t*>(tag);
  if ((reinterpret_cast<uintptr_t>(tg) |
       reinterpret_cast<uintptr_t>(first)) % 16 == 0)
    launch<true>(tg, first, matched, out, n, ntiles, s, st);
  else
    launch<false>(tg, first, matched, out, n, ntiles, s, st);
  DJT_CHECK_LAUNCH();
  return 0;
}
