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
// (distributed_join_tpu/ops/expand_pallas.py:701).
//
// What bounds it on the H100: bytes — each slot writes its record and
// build lanes (8 bytes each) and reads the same amount; the covering
// records and the build ranks of neighbouring slots are neighbours, so
// the reads coalesce. A thread per slot binary-searches S (~log2 m
// probes, the upper levels shared by the whole grid in L2). A GPU
// gather has no window bound, so the TPU kernel's two-window build
// scheme, its build_windows_ok gate and its fallback branch have no
// counterpart: any rank, matched-dense or not, is read directly.

#include "common.cuh"

namespace {

struct Args {
  const int64_t* rec[DJT_MAX_LANES];
  int64_t* rec_out[DJT_MAX_LANES];
  const int64_t* bld[DJT_MAX_LANES];
  int64_t* bld_out[DJT_MAX_LANES];
};

__global__ void expand_kernel(const int* __restrict__ S, long long m,
                              const int* __restrict__ lo, Args a, int k,
                              int kb, long long nb, int out_capacity,
                              int* __restrict__ start_b) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long jj = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
       jj < out_capacity; jj += stride) {
    const int j = static_cast<int>(jj);
    long long lo_i = 0, hi = m;  // first index with S > j
    while (lo_i < hi) {
      const long long mid = (lo_i + hi) >> 1;
      if (S[mid] <= j)
        lo_i = mid + 1;
      else
        hi = mid;
    }
    long long r = lo_i - 1;
    int sb = 0;
    if (r < 0)
      r = 0;
    else
      sb = S[r];
    for (int l = 0; l < k; ++l) a.rec_out[l][j] = a.rec[l][r];
    if (start_b != nullptr) start_b[j] = sb;
    if (kb > 0) {
      long long rank = static_cast<long long>(lo[r]) + (j - sb);
      rank = rank < 0 ? 0 : (rank > nb - 1 ? nb - 1 : rank);
      for (int l = 0; l < kb; ++l) a.bld_out[l][j] = a.bld[l][rank];
    }
  }
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
  for (int l = 0; l < k; ++l) {
    a.rec[l] = recs[l];
    a.rec_out[l] = rec_outs[l];
  }
  for (int l = 0; l < kb; ++l) {
    a.bld[l] = blds[l];
    a.bld_out[l] = bld_outs[l];
  }
  expand_kernel<<<djt_blocks(out_capacity, 256), 256, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      S, m, lo, a, k, kb, nb, out_capacity, start_b);
  DJT_CHECK_LAUNCH();
  return 0;
}
