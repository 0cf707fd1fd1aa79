// Native benchmark driver of the PyTorch/CUDA port: a libtorch C++ main.
//
// The reference's driver is a native executable (MPI init -> device bind
// -> generate -> warm-up -> timed join -> rows/s report); the JAX
// package's is a thin C++ main over the PJRT C API
// (native/pjrt_join_main.cc). This one runs the inner join of the
// one-rank step (ops/join.py `_join_kernel_path`, what `make_join_step`
// does at one rank and one batch) with no Python in the loop: the large
// plain operations (the stable merged sort, gathers, cumsums) are ATen
// calls, and the three hand-written kernels of the pipeline are called
// through their `extern "C"` entry points, dlopen'ed from the libraries
// that native/export_join.py built and listed in the meta:
//
//   djt_join_scans      (csrc/join_scans.cu)      the merged-domain scans
//   djt_stream_compact  (csrc/stream_compact.cu)  run records, build pack
//   djt_expand_gather   (csrc/expand_gather.cu)   expand, build mode
//
// `--device cpu` runs ATen mirrors of the kernels' plain twins
// (ops/scan.py, ops/compact.py, ops/expand.py) instead; only that flag
// selects them. There is no fallback: without a card and without the
// flag the driver exits 1, and a kernel call that fails exits 1 with the
// CUDA error string.
//
// Timing (the JAX driver's protocol): a warm-up run of the whole loop,
// then one run of `iterations` dependent joins (both sides' keys shifted
// by the loop counter), timed on the host clock up to one host read of
// the summed match count.
//
// Build and run (native/export_join.py compiles this file with g++
// against the installed torch), on one line each:
//   python -m distributed_join_tpu_torch.native.export_join
//       --build-table-nrows 1000000 --probe-table-nrows 1000000
//       --iterations 8 -o build/native/artifacts --build-driver
//   build/native/join_main-<digest> --artifact-dir build/native/artifacts

#include <dlfcn.h>

#include <ATen/ATen.h>
#include <torch/cuda.h>

#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <filesystem>
#include <fstream>
#include <limits>
#include <map>
#include <random>
#include <string>
#include <utility>
#include <vector>

namespace {

[[noreturn]] void Die(const std::string& msg) {
  std::fprintf(stderr, "join_main: %s\n", msg.c_str());
  std::exit(1);
}

std::map<std::string, std::string> ReadMeta(const std::string& path) {
  std::ifstream f(path);
  if (!f)
    Die("cannot read " + path +
        " (run python -m distributed_join_tpu_torch.native.export_join "
        "first)");
  std::map<std::string, std::string> kv;
  std::string line;
  while (std::getline(f, line)) {
    auto eq = line.find('=');
    if (eq != std::string::npos) kv[line.substr(0, eq)] = line.substr(eq + 1);
  }
  return kv;
}

std::string MetaAt(const std::map<std::string, std::string>& meta,
                   const std::string& key) {
  auto it = meta.find(key);
  if (it == meta.end()) Die("join_step.meta has no " + key);
  return it->second;
}

// -- the kernels' C entry points (signatures as in csrc/*.cu) -----------

using ErrorStringFn = const char* (*)(int);
using ScansScratchFn = long long (*)(long long);
using ScansFn = int (*)(const int8_t*, const uint8_t*, int*, int*, int*,
                        int*, int*, int*, long long, void*, void*);
using CompactFn = int (*)(const uint8_t*, const int*, const int64_t* const*,
                          int64_t* const*, int, long long, int, void*);
using ExpandFn = int (*)(const int*, long long, const int*,
                         const int64_t* const*, int64_t* const*, int,
                         const int64_t* const*, int64_t* const*, int,
                         long long, int, int*, void*);

struct Library {
  void* handle = nullptr;
  ErrorStringFn error_string = nullptr;

  void Open(const std::string& path) {
    handle = dlopen(path.c_str(), RTLD_NOW | RTLD_LOCAL);
    if (!handle)
      Die("dlopen " + path + " failed: " + dlerror() +
          " (export_join.py builds the kernels on a machine with nvcc)");
    error_string = reinterpret_cast<ErrorStringFn>(Sym("djt_error_string"));
  }
  void* Sym(const char* name) {
    void* s = dlsym(handle, name);
    if (!s) Die(std::string("symbol ") + name + " not found");
    return s;
  }
  void Check(int rc, const char* what) const {
    if (rc != 0)
      Die(std::string(what) + ": CUDA error " + std::to_string(rc) + " (" +
          error_string(rc) + ")");
  }
};

// Every entry point takes a stream; nullptr is the legacy default stream,
// which is ATen's current stream in a main that sets none, so the kernels
// run in order with the ATen operations around them.
void* const kStream = nullptr;

struct Kernels {
  Library scans_lib, compact_lib, expand_lib;
  ScansScratchFn scans_scratch = nullptr;
  ScansFn scans = nullptr;
  CompactFn compact = nullptr;
  ExpandFn expand = nullptr;
  // Launch counts, raised where each entry point is called.
  long long n_scans = 0, n_compact_records = 0, n_compact_pack = 0,
            n_expand = 0;

  void Load(const std::map<std::string, std::string>& meta) {
    scans_lib.Open(MetaAt(meta, "lib_join_scans"));
    compact_lib.Open(MetaAt(meta, "lib_stream_compact"));
    expand_lib.Open(MetaAt(meta, "lib_expand_gather"));
    scans_scratch = reinterpret_cast<ScansScratchFn>(
        scans_lib.Sym("djt_join_scans_scratch_bytes"));
    scans = reinterpret_cast<ScansFn>(scans_lib.Sym("djt_join_scans"));
    compact =
        reinterpret_cast<CompactFn>(compact_lib.Sym("djt_stream_compact"));
    expand = reinterpret_cast<ExpandFn>(expand_lib.Sym("djt_expand_gather"));
  }
};

template <typename T>
T* Ptr(const at::Tensor& t) {
  return reinterpret_cast<T*>(t.data_ptr());
}

// -- the three kernel stages: the kernel on CUDA, the plain twin on CPU --

struct Scans {
  at::Tensor cnt, start_out, lo_m, rec_pos, matched, mb_pos;
};

Scans JoinScansReference(const at::Tensor& tag, const at::Tensor& first) {
  auto i32 = at::kInt;
  auto zero = at::zeros({}, tag.options().dtype(i32));
  auto cumsum = [&](const at::Tensor& x) { return at::cumsum(x, 0, i32); };
  auto cummax = [](const at::Tensor& x) {
    return std::get<0>(at::cummax(x, 0));
  };
  auto is_b = tag.eq(0), is_p = tag.eq(1);
  auto b_incl = cumsum(is_b.to(i32));
  auto b_before = b_incl - is_b.to(i32);
  auto lo_raw = cummax(at::where(first, b_before, zero));
  Scans s;
  s.cnt = at::where(is_p, b_before - lo_raw, zero);
  auto csum = cumsum(s.cnt);
  auto is_rec = is_p.logical_and(s.cnt.gt(0));
  s.rec_pos = cumsum(is_rec.to(i32)) - 1;
  auto P = at::flip(cumsum(at::flip(is_p.to(i32), {0})), {0});
  auto masked = at::where(first, P, zero);
  auto nxt = at::cat({masked.slice(0, 1), zero.reshape({1})});
  auto NR = at::flip(cummax(at::flip(nxt, {0})), {0});
  s.matched = is_b.logical_and((P - NR).gt(0)).to(i32);
  auto mb_incl = cumsum(s.matched);
  s.lo_m = cummax(at::where(first, mb_incl - s.matched, zero));
  s.start_out = csum - s.cnt;
  s.mb_pos = mb_incl - 1;
  return s;
}

Scans JoinScans(Kernels* k, const at::Tensor& tag, const at::Tensor& first) {
  if (k == nullptr) return JoinScansReference(tag, first);
  const long long n = tag.size(0);
  auto opts = tag.options().dtype(at::kInt);
  Scans s{at::empty({n}, opts), at::empty({n}, opts), at::empty({n}, opts),
          at::empty({n}, opts), at::empty({n}, opts), at::empty({n}, opts)};
  auto scratch =
      at::empty({k->scans_scratch(n)}, tag.options().dtype(at::kByte));
  k->scans_lib.Check(
      k->scans(Ptr<int8_t>(tag), Ptr<uint8_t>(first), Ptr<int>(s.matched),
               Ptr<int>(s.cnt), Ptr<int>(s.start_out), Ptr<int>(s.lo_m),
               Ptr<int>(s.rec_pos), Ptr<int>(s.mb_pos), n,
               scratch.data_ptr(), kStream),
      "djt_join_scans");
  k->n_scans += 1;
  return s;
}

std::vector<at::Tensor> StreamCompactReference(
    const at::Tensor& mask, const at::Tensor& pos,
    const std::vector<at::Tensor>& cols, int64_t capacity) {
  auto keep = mask.logical_and(pos.ge(0)).logical_and(pos.lt(capacity));
  auto idx = at::where(keep, pos, at::full_like(pos, capacity)).to(at::kLong);
  std::vector<at::Tensor> outs;
  for (const auto& c : cols) {
    auto out = at::zeros({capacity + 1}, c.options());
    out.scatter_(0, idx, c);
    outs.push_back(out.slice(0, 0, capacity));
  }
  return outs;
}

// The two stream_compact call sites of the inner join: the run records
// (`compact_records`) and the matched-build pack (`pack_matched_builds`).
std::vector<at::Tensor> StreamCompact(Kernels* k, const at::Tensor& mask,
                                      const at::Tensor& pos,
                                      const std::vector<at::Tensor>& cols,
                                      int64_t capacity, long long* counter) {
  if (k == nullptr) return StreamCompactReference(mask, pos, cols, capacity);
  std::vector<at::Tensor> outs;
  std::vector<const int64_t*> srcs;
  std::vector<int64_t*> dsts;
  for (const auto& c : cols) {
    outs.push_back(at::empty({capacity}, c.options()));
    srcs.push_back(Ptr<int64_t>(c));
    dsts.push_back(Ptr<int64_t>(outs.back()));
  }
  k->compact_lib.Check(
      k->compact(Ptr<uint8_t>(mask), Ptr<int>(pos), srcs.data(), dsts.data(),
                 static_cast<int>(cols.size()), mask.size(0),
                 static_cast<int>(capacity), kStream),
      "djt_stream_compact");
  *counter += 1;
  return outs;
}

// Build mode: (record lanes at each slot's covering record, build lanes
// at each slot's in-run rank).
std::pair<std::vector<at::Tensor>, std::vector<at::Tensor>>
ExpandGatherReference(const at::Tensor& S,
                      const std::vector<at::Tensor>& cols,
                      int64_t out_capacity, const at::Tensor& lo,
                      const std::vector<at::Tensor>& build_cols) {
  const int64_t m = S.size(0);
  auto i32 = S.options().dtype(at::kInt);
  auto r = at::arange(m, i32);
  auto keep = S.ge(0).logical_and(S.lt(out_capacity));
  auto idx = at::where(keep, S, at::full_like(S, out_capacity)).to(at::kLong);
  auto raw = at::zeros({out_capacity + 1}, i32);
  raw.scatter_(0, idx, r + 1);
  raw = raw.slice(0, 0, out_capacity);
  auto ridx = (std::get<0>(at::cummax(raw, 0)) - 1).clamp(0, m - 1)
                  .to(at::kLong);
  std::vector<at::Tensor> rec_outs, build_outs;
  for (const auto& c : cols) rec_outs.push_back(c.index_select(0, ridx));
  auto j = at::arange(out_capacity, i32);
  auto start_b = std::get<0>(
      at::cummax(at::where(raw.gt(0), j, at::zeros_like(j)), 0));
  const int64_t nb = build_cols[0].size(0);
  auto rank = lo.index_select(0, ridx).to(at::kLong) +
              (j - start_b).to(at::kLong);
  auto safe = rank.clamp(0, nb - 1);
  for (const auto& b : build_cols) build_outs.push_back(b.index_select(0, safe));
  return {rec_outs, build_outs};
}

std::pair<std::vector<at::Tensor>, std::vector<at::Tensor>> ExpandGather(
    Kernels* k, const at::Tensor& S, const std::vector<at::Tensor>& cols,
    int64_t out_capacity, const at::Tensor& lo,
    const std::vector<at::Tensor>& build_cols) {
  if (k == nullptr)
    return ExpandGatherReference(S, cols, out_capacity, lo, build_cols);
  std::vector<at::Tensor> rec_outs, build_outs;
  std::vector<const int64_t*> rs, bs;
  std::vector<int64_t*> ro, bo;
  for (const auto& c : cols) {
    rec_outs.push_back(at::empty({out_capacity}, c.options()));
    rs.push_back(Ptr<int64_t>(c));
    ro.push_back(Ptr<int64_t>(rec_outs.back()));
  }
  for (const auto& b : build_cols) {
    build_outs.push_back(at::empty({out_capacity}, b.options()));
    bs.push_back(Ptr<int64_t>(b));
    bo.push_back(Ptr<int64_t>(build_outs.back()));
  }
  k->expand_lib.Check(
      k->expand(Ptr<int>(S), S.size(0), Ptr<int>(lo), rs.data(), ro.data(),
                static_cast<int>(rs.size()), bs.data(), bo.data(),
                static_cast<int>(bs.size()), build_cols[0].size(0),
                static_cast<int>(out_capacity), nullptr, kStream),
      "djt_expand_gather");
  k->n_expand += 1;
  return {rec_outs, build_outs};
}

// -- the one-rank inner join (ops/join.py `_join_kernel_path`) ----------

struct Side {
  at::Tensor key, payload, valid;
};

struct JoinOut {
  at::Tensor total, overflow, checksum;
};

at::Tensor U64Lane32(const at::Tensor& x) {  // lanes.to_u64_lane(int32)
  return x.to(at::kLong).bitwise_and(0xFFFFFFFFLL);
}

// Inner join of `build` and `probe` on `key`, both payloads int64; returns
// the true match count, the overflow flag and `consume_all_columns` of
// the result (utils/benchmarking.py): the sum of every output column over
// the valid rows.
JoinOut InnerJoin(Kernels* k, const Side& build, const Side& probe,
                  int64_t out_cap) {
  const int64_t nb = build.key.size(0);
  auto i8 = build.key.options().dtype(at::kChar);
  const int64_t kMax = std::numeric_limits<int64_t>::max();
  const int32_t kI32Max = std::numeric_limits<int32_t>::max();

  // _masked_keys: invalid rows sort last under the dtype's max; side tag
  // 0 build, 1 probe, 2 padding
  auto m_key = at::cat({at::where(build.valid, build.key,
                                  at::full_like(build.key, kMax)),
                        at::where(probe.valid, probe.key,
                                  at::full_like(probe.key, kMax))});
  auto two = at::full({}, 2, i8);
  auto tag = at::cat({at::where(build.valid, at::zeros({}, i8), two),
                      at::where(probe.valid, at::ones({}, i8), two)});
  // _lexsort([key, tag]): stable sorts from the least significant operand
  auto perm = std::get<1>(at::sort(tag, /*stable=*/true, 0, false));
  auto by_key = std::get<1>(
      at::sort(m_key.index_select(0, perm), /*stable=*/true, 0, false));
  perm = perm.index_select(0, by_key);
  // the (probe, build) payloads share one lane (same dtype)
  auto lane = at::cat({build.payload, probe.payload}).index_select(0, perm);
  auto skey = m_key.index_select(0, perm);
  auto stag = tag.index_select(0, perm);
  const int64_t n = skey.size(0);
  auto first = at::cat({at::ones({1}, skey.options().dtype(at::kBool)),
                        skey.slice(0, 1).ne(skey.slice(0, 0, n - 1))});

  Scans sc = JoinScans(k, stag, first);
  auto total = sc.cnt.sum(at::kLong);
  auto rec_total = sc.rec_pos.select(0, n - 1) + 1;
  auto is_rec = stag.eq(1).logical_and(sc.cnt.gt(0));

  // run records: S, key, probe payload, build rank of the run start
  std::vector<at::Tensor> rec_lanes = {U64Lane32(sc.start_out), skey, lane,
                                       U64Lane32(sc.lo_m)};
  auto compacted = StreamCompact(k, is_rec, sc.rec_pos, rec_lanes, out_cap,
                                 k ? &k->n_compact_records : nullptr);
  auto j = at::arange(out_cap, skey.options().dtype(at::kInt));
  auto live = j.lt(at::clamp_max(rec_total, out_cap));
  auto S = at::where(live, compacted[0].to(at::kInt),
                     at::full_like(j, kI32Max));
  auto lo_rec = at::where(live, compacted[3].to(at::kInt), at::zeros_like(j));
  // the matched-build pack: dense, key-ordered
  auto pack = StreamCompact(k, sc.matched.ne(0), sc.mb_pos, {lane}, nb,
                            k ? &k->n_compact_pack : nullptr);
  auto [rec_outs, build_outs] =
      ExpandGather(k, S, {compacted[1], compacted[2]}, out_cap, lo_rec, pack);

  auto valid = j.to(at::kLong).lt(total);
  auto checksum = at::zeros({}, total.options());
  for (const auto& c : {rec_outs[0], build_outs[0], rec_outs[1]})
    checksum = checksum + at::where(valid, c, at::zeros_like(c)).sum();
  return {total, total.gt(out_cap), checksum};
}

// `iterations` dependent joins with both keys shifted by the loop counter
// (the JAX program's fori_loop): the summed totals, the OR of the
// overflows, the summed checksums. Nothing is read back here.
JoinOut LoopedJoin(Kernels* k, const Side& b, const Side& p, long iters,
                   int64_t out_cap) {
  auto opts = b.key.options();
  JoinOut acc{at::zeros({}, opts), at::zeros({}, opts.dtype(at::kBool)),
              at::zeros({}, opts)};
  for (long i = 0; i < iters; ++i) {
    JoinOut r = InnerJoin(k, {b.key + i, b.payload, b.valid},
                          {p.key + i, p.payload, p.valid}, out_cap);
    acc.total = acc.total + r.total;
    acc.overflow = acc.overflow.logical_or(r.overflow);
    acc.checksum = acc.checksum + r.checksum;
  }
  return acc;
}

void DumpColumn(const std::string& dir, const std::string& name,
                const void* data, size_t bytes) {
  std::ofstream f(dir + "/" + name + ".bin", std::ios::binary);
  if (!f) Die("cannot write " + dir + "/" + name + ".bin");
  f.write(static_cast<const char*>(data), static_cast<std::streamsize>(bytes));
}

}  // namespace

int main(int argc, char** argv) {
  std::string artifact_dir = "build/native/artifacts";
  std::string device_flag = "cuda";
  std::string communicator = "local";
  std::string dump_dir;
  bool selftest = false;
  long flag_build_rows = -1, flag_probe_rows = -1;
  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    auto next = [&]() -> std::string {
      if (i + 1 >= argc) Die("missing value for " + a);
      return argv[++i];
    };
    if (a == "--selftest") selftest = true;
    else if (a == "--artifact-dir") artifact_dir = next();
    else if (a == "--device") device_flag = next();
    else if (a == "--dump-tables") dump_dir = next();
    else if (a == "--communicator") communicator = next();
    else if (a == "--build-table-nrows") flag_build_rows = std::stol(next());
    else if (a == "--probe-table-nrows") flag_probe_rows = std::stol(next());
    else if (a == "--plugin" || a == "--selftest-exec")
      Die(a + " is a PJRT mechanism of the JAX package's driver; this "
              "driver links libtorch and loads no plugin");
    else if (a == "--key-type" || a == "--payload-type") {
      if (next() != "int64") Die(a + " takes int64 only");
    } else if (a == "--registration-method") {
      (void)next();  // reference parity: no RDMA registration here
    } else if (a == "--compression") {
      // reference parity: the one-rank join has no wire to compress
    } else {
      Die("unknown flag " + a);
    }
  }
  if (communicator == "tpu")
    Die("communicator 'tpu' is the JAX package's TPU backend; this "
        "driver runs one rank on one CUDA device (--communicator local)");
  if (communicator != "local")
    Die("communicator '" + communicator +
        "' is a multi-rank backend: run it through the Python launcher "
        "(python -m distributed_join_tpu_torch.benchmarks.launch); this "
        "driver runs --communicator local only");
  if (device_flag != "cuda" && device_flag != "cpu")
    Die("--device takes cuda or cpu, not " + device_flag);
  const bool on_cuda = device_flag == "cuda";
  if (on_cuda && !torch::cuda::is_available())
    Die("CUDA is not available: this driver runs on a CUDA device (pass "
        "--device cpu for the plain ATen twins)");
  const at::Device device = on_cuda ? at::Device(at::kCUDA, 0)
                                    : at::Device(at::kCPU);

  if (selftest) {
    // h2d -> d2h round trip on the card only
    if (!on_cuda) Die("--selftest checks the card's data path: run it on CUDA");
    int64_t vals[4] = {11, 22, 33, 44};
    auto host = at::from_blob(vals, {4}, at::kLong);
    auto back = host.to(device).cpu();
    const int64_t* b = back.data_ptr<int64_t>();
    std::printf("selftest roundtrip: %ld %ld %ld %ld\n", (long)b[0],
                (long)b[1], (long)b[2], (long)b[3]);
    return b[0] == 11 && b[1] == 22 && b[2] == 33 && b[3] == 44 ? 0 : 1;
  }

  const auto meta = ReadMeta(artifact_dir + "/join_step.meta");
  const long b_rows = std::stol(MetaAt(meta, "build_table_nrows"));
  const long p_rows = std::stol(MetaAt(meta, "probe_table_nrows"));
  const long iters = std::stol(MetaAt(meta, "iterations"));
  const double selectivity = std::stod(MetaAt(meta, "selectivity"));
  const int64_t out_rows = std::stoll(MetaAt(meta, "out_rows"));
  if (flag_build_rows >= 0 && flag_build_rows != b_rows)
    Die("--build-table-nrows mismatches the meta (" +
        MetaAt(meta, "build_table_nrows") + "); re-run export_join");
  if (flag_probe_rows >= 0 && flag_probe_rows != p_rows)
    Die("--probe-table-nrows mismatches the meta (" +
        MetaAt(meta, "probe_table_nrows") + "); re-run export_join");
  if (b_rows < 1 || p_rows < 1 || iters < 1)
    Die("the meta's sizes and iterations must be >= 1");
  // make_join_step at one rank: the output block rounded up to 8
  const int64_t out_cap = (out_rows + 7) / 8 * 8;

  Kernels kernels;
  Kernels* k = nullptr;
  if (on_cuda) {
    kernels.Load(meta);
    k = &kernels;
  }

  // -- the tables (the JAX driver's generator): unique build keys
  //    0..nb-1 shuffled, payload 2 x key; probe hits at `selectivity`
  //    drawn from the build range, misses from the disjoint range above.
  std::mt19937_64 rng(42);
  std::vector<int64_t> build_key(b_rows), build_pay(b_rows);
  std::vector<uint8_t> build_valid(b_rows, 1);
  for (long i = 0; i < b_rows; ++i) {
    build_key[i] = i;
    build_pay[i] = i * 2;
  }
  for (long i = b_rows - 1; i > 0; --i)
    std::swap(build_key[i], build_key[rng() % (i + 1)]);
  std::vector<int64_t> probe_key(p_rows), probe_pay(p_rows);
  std::vector<uint8_t> probe_valid(p_rows, 1);
  long probe_hits = 0;
  for (long i = 0; i < p_rows; ++i) {
    bool hit = (rng() % 1000000) < (uint64_t)(selectivity * 1000000);
    probe_hits += hit;
    probe_key[i] = hit ? (int64_t)(rng() % b_rows)
                       : (int64_t)(b_rows + rng() % b_rows);
    probe_pay[i] = i;
  }
  if (!dump_dir.empty()) {
    std::filesystem::create_directories(dump_dir);
    DumpColumn(dump_dir, "build_key", build_key.data(), b_rows * 8);
    DumpColumn(dump_dir, "build_payload", build_pay.data(), b_rows * 8);
    DumpColumn(dump_dir, "build_valid", build_valid.data(), b_rows);
    DumpColumn(dump_dir, "probe_key", probe_key.data(), p_rows * 8);
    DumpColumn(dump_dir, "probe_payload", probe_pay.data(), p_rows * 8);
    DumpColumn(dump_dir, "probe_valid", probe_valid.data(), p_rows);
  }
  auto put = [&](void* data, long rows, at::ScalarType dt) {
    return at::from_blob(data, {rows}, dt).to(device);
  };
  Side build{put(build_key.data(), b_rows, at::kLong),
             put(build_pay.data(), b_rows, at::kLong),
             put(build_valid.data(), b_rows, at::kBool)};
  Side probe{put(probe_key.data(), p_rows, at::kLong),
             put(probe_pay.data(), p_rows, at::kLong),
             put(probe_valid.data(), p_rows, at::kBool)};

  // warm-up: the whole loop once (allocator steady state), read back
  (void)LoopedJoin(k, build, probe, iters, out_cap).total.item<int64_t>();
  kernels.n_scans = kernels.n_compact_records = kernels.n_compact_pack =
      kernels.n_expand = 0;
  auto t0 = std::chrono::steady_clock::now();
  JoinOut out = LoopedJoin(k, build, probe, iters, out_cap);
  const int64_t total_x_iters = out.total.item<int64_t>();  // the one read
  auto t1 = std::chrono::steady_clock::now();
  const bool overflow = out.overflow.item<bool>();
  const int64_t checksum = out.checksum.item<int64_t>();

  const double sec_per_join =
      std::chrono::duration<double>(t1 - t0).count() / (double)iters;
  const double rows = (double)(b_rows + p_rows);
  const double rows_per_sec = rows / sec_per_join;
  const std::string dev_name =
      on_cuda ? (meta.count("device") ? meta.at("device") : "cuda") : "cpu";
  std::printf(
      "distributed join (native): %ld rows in %.6f s -> %.2f M rows/s over "
      "1 rank(s)%s\n",
      (long)rows, sec_per_join, rows_per_sec / 1e6,
      overflow ? " [OVERFLOW]" : "");
  std::printf(
      "{\"benchmark\": \"distributed_join_native\", \"communicator\": "
      "\"local\", \"n_ranks\": 1, \"build_table_nrows\": %ld, "
      "\"probe_table_nrows\": %ld, \"iterations\": %ld, "
      "\"matches_per_join\": %ld, \"overflow\": %s, "
      "\"elapsed_per_join_s\": %.9f, \"rows_per_sec\": %.1f, "
      "\"m_rows_per_sec_per_rank\": %.3f, \"total_matches_x_iters\": %lld, "
      "\"dce_guard_checksum\": %lld, \"probe_hits\": %ld, "
      "\"device\": \"%s\", \"kernel_launches\": {\"djt_join_scans\": %lld, "
      "\"djt_stream_compact\": %lld, \"djt_expand_gather\": %lld}, "
      "\"kernel_launches_by_site\": {\"join_scans\": %lld, "
      "\"compact_records\": %lld, \"pack_matched_builds\": %lld, "
      "\"expand_gather\": %lld}}\n",
      b_rows, p_rows, iters, (long)(total_x_iters / iters),
      overflow ? "true" : "false", sec_per_join, rows_per_sec,
      rows_per_sec / 1e6, (long long)total_x_iters, (long long)checksum,
      probe_hits, dev_name.c_str(), kernels.n_scans,
      kernels.n_compact_records + kernels.n_compact_pack, kernels.n_expand,
      kernels.n_scans, kernels.n_compact_records, kernels.n_compact_pack,
      kernels.n_expand);
  return 0;
}
