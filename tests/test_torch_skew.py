"""PyTorch port vs the JAX package: the skew sidecar (BASELINE config 3)
on the CPU. Heavy-hitter detection, marking and extraction, the Zipf
generator, the ladder's skew rungs, the 8-rank skew join against JAX's
8-device one, and the port's config driver. Inputs are made with numpy
from a seed and reach both packages as numpy arrays; result rows are
compared as sorted multisets."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import distributed_join_tpu  # noqa: F401  (enables JAX x64)
from distributed_join_tpu.parallel import communicator as jcomm
from distributed_join_tpu.parallel import distributed_join as jdist
from distributed_join_tpu.parallel import skew as jskew
from distributed_join_tpu.table import Table as JTable
from distributed_join_tpu.utils import generators as jgen
from distributed_join_tpu_torch.benchmarks import distributed_join as tdriver
from distributed_join_tpu_torch.ops.kernel_config import KernelConfig
from distributed_join_tpu_torch.parallel import distributed_join as tdist
from distributed_join_tpu_torch.parallel import skew as tskew
from distributed_join_tpu_torch.parallel.communicator import (
    EmulatedCommunicator,
    LocalCommunicator,
)
from distributed_join_tpu_torch.table import Table
from distributed_join_tpu_torch.utils import generators as tgen

NAMES = ["key", "build_payload", "probe_payload"]


def _u64_torch(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.view(np.int64).copy()).view(torch.uint64)


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.uint64:
        return t.view(torch.int64).numpy().view(np.uint64)
    return t.numpy()


def _rows(cols, valid, names=NAMES) -> np.ndarray:
    valid = np.asarray(valid)
    a = np.stack([np.asarray(cols[n])[valid].astype(np.int64)
                  for n in names], axis=1)
    return a[np.lexsort(a.T[::-1])]


# -- detection ------------------------------------------------------------


LOCAL_TOP_CASES = {
    # the JAX package's own cases (tests/test_skew.py:24-41)
    "runs": (np.array([5, 5, 5, 9, 9, 2, 5, 9, 7, 7], np.int64),
             np.array([1, 1, 1, 1, 1, 1, 1, 1, 0, 1], bool), 3),
    "invalid_runs": (np.array([3, 3, 3, 3, 1], np.int64),
                     np.array([1, 0, 0, 0, 1], bool), 2),
    "more_slots_than_rows": (np.array([4, -4, 4], np.int64),
                             np.ones(3, bool), 5),
}


@pytest.mark.parametrize("case", sorted(LOCAL_TOP_CASES))
def test_local_top_keys_matches_jax(case):
    keys, valid, k = LOCAL_TOP_CASES[case]
    wk, wc = jskew.local_top_keys(jnp.asarray(keys), jnp.asarray(valid), k)
    gk, gc = tskew.local_top_keys(torch.from_numpy(keys),
                                  torch.from_numpy(valid), k)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))


def test_local_top_keys_uint64_hashes_with_the_high_bit():
    """uint64 hashes (high bit set on about half) sort in unsigned order,
    with the all-ones sentinel last, as in JAX; ties in count go to the
    lower sorted position."""
    rng = np.random.default_rng(5)
    pool = rng.integers(0, 2**64, 40, dtype=np.uint64)
    pool[:3] = [2**64 - 1, 2**63, 2**63 - 1]
    keys = pool[rng.zipf(1.6, 3000) % 40]
    valid = rng.random(3000) < 0.9
    wk, wc = jskew.local_top_keys(jnp.asarray(keys), jnp.asarray(valid), 16)
    gk, gc = tskew.local_top_keys(_u64_torch(keys), torch.from_numpy(valid),
                                  16)
    assert gk.dtype == torch.uint64
    np.testing.assert_array_equal(_np(gk), np.asarray(wk))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    assert (np.asarray(wk) >= 2**63).any()


@pytest.fixture(scope="module")
def jcomm8():
    return jcomm.make_communicator("tpu", n_ranks=8)


def test_global_heavy_hitters_planted_key_matches_jax(jcomm8):
    """The planted key at 8 ranks (tests/test_skew.py:44-73): the HH set
    (keys, counts, slot_valid) and every rank's marking identical."""
    n_local, k = 128, 8
    rows = 8 * n_local
    hot = np.where(np.arange(rows) % 2 == 0, 77,
                   np.arange(rows, dtype=np.int64) + 1000)

    def jstep(keys):
        hh = jskew.global_heavy_hitters(
            jcomm8, keys, jnp.ones_like(keys, dtype=bool), k=k,
            threshold=jnp.int32(n_local // 2))
        return hh.keys, hh.counts, hh.slot_valid, jskew.mark_heavy(keys, hh)

    want = jcomm8.spmd(jstep, sharded_out=False)(jnp.asarray(hot))
    tcomm = EmulatedCommunicator(8)

    def tstep(keys):
        hh = tskew.global_heavy_hitters(
            tcomm, keys, torch.ones_like(keys, dtype=torch.bool), k,
            threshold=n_local // 2)
        return hh.keys, hh.counts, hh.slot_valid, tskew.mark_heavy(keys, hh)

    got = tcomm.spmd(tstep, sharded_out=False)(torch.from_numpy(hot))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0][0] == 77 and got[2][:k].sum() == 1


def test_sampled_detection_of_a_periodic_key_matches_jax():
    """Sampling on (n >= 64*k*16): a heavy key at odd positions only is
    found through the index mix, with the same scaled count as JAX."""
    n = 1 << 17
    hot = np.where(np.arange(n) % 2 == 1, 7, np.arange(n, dtype=np.int64))
    want = jskew.global_heavy_hitters(
        jcomm.make_communicator("local"), jnp.asarray(hot),
        jnp.ones(n, bool), 64, threshold=jnp.int32(n // 10), sample=16)
    got = tskew.global_heavy_hitters(
        LocalCommunicator(), torch.from_numpy(hot),
        torch.ones(n, dtype=torch.bool), 64, threshold=n // 10, sample=16)
    for g, w in ((got.keys, want.keys), (got.counts, want.counts),
                 (got.slot_valid, want.slot_valid)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert 7 in got.keys[got.slot_valid].tolist()


def test_mark_heavy_matches_jax_and_guards_the_sentinel():
    """Invalid slots hold the sentinel: a row whose hash is the sentinel
    is heavy only when a valid slot holds it."""
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 2**64, 500, dtype=np.uint64)
    keys[::50] = 2**64 - 1
    for slot_keys, slot_valid in (
            ([keys[3], keys[7], 2**64 - 1], [True, True, False]),
            ([keys[3], 2**64 - 1, 2**64 - 1], [True, True, False])):
        sk = np.array(slot_keys, np.uint64)
        sv = np.array(slot_valid)
        want = jskew.mark_heavy(jnp.asarray(keys), jskew.HeavyHitters(
            jnp.asarray(sk), jnp.zeros(3, jnp.int64), jnp.asarray(sv)))
        got = tskew.mark_heavy(_u64_torch(keys), tskew.HeavyHitters(
            _u64_torch(sk), torch.zeros(3, dtype=torch.int64),
            torch.from_numpy(sv)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,density,capacity,mode", [
    (4096, 0.05, 512, "kernel"),   # n >= 2*cap: the kernel branch's twin
    (4096, 0.05, 512, "auto"),     # the sort branch on the CPU
    (4096, 0.3, 512, "kernel"),    # overflow, kernel branch
    (1000, 0.4, 700, "kernel"),    # n < 2*cap: the sort branch
    (300, 0.5, 1024, "auto"),      # capacity beyond the rows
])
def test_extract_prefix_matches_jax(n, density, capacity, mode):
    rng = np.random.default_rng(n + capacity)
    sel = rng.random(n) < density
    cols = {"key": rng.integers(-50, 50, n), "v": np.arange(n)}
    want, wc, wovf = jskew.extract_prefix(
        JTable({k: jnp.asarray(v) for k, v in cols.items()},
               jnp.ones(n, bool)), jnp.asarray(sel), capacity)
    got, gc, govf = tskew.extract_prefix(
        Table.from_numpy(cols, np.ones(n, bool), device="cpu"),
        torch.from_numpy(sel), capacity,
        kernel_config=KernelConfig(mode))
    assert int(gc) == int(wc) and bool(govf) == bool(wovf)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    gv = got.valid.numpy()
    for c in cols:
        np.testing.assert_array_equal(got.columns[c].numpy()[gv],
                                      np.asarray(want.columns[c])[gv])


@pytest.mark.parametrize("alpha,n_keys,k", [
    (1.5, 50_000_000, 64), (1.1, 2048, 32), (2.0, 10, 64), (1.5, 0, 4)])
def test_zipf_top_k_mass_matches_jax(alpha, n_keys, k):
    assert tskew.zipf_top_k_mass(alpha, n_keys, k) == pytest.approx(
        jskew.zipf_top_k_mass(alpha, n_keys, k), abs=1e-12)


# -- the ladder and the generator ------------------------------------------


LADDER_FIELDS = ("attempt", "action", "overflow", "shuffle_capacity_factor",
                 "out_capacity_factor", "out_rows_per_rank",
                 "hh_build_capacity", "hh_probe_capacity", "hh_out_capacity")


@pytest.mark.parametrize("opts", [
    dict(skew_threshold=0.01),
    dict(skew_threshold=0.01, hh_slots=8, hh_probe_capacity=3000),
    dict(skew_threshold=0.01, hh_out_capacity=10, out_rows_per_rank=100),
    dict(out_capacity_factor=0.5),
])
def test_ladder_skew_rungs_match_jax(opts):
    """The same shapes give the same rungs: the HH defaults resolved as
    in JAX, doubled, the probe/output blocks jumping to the local rows."""
    def shapes(table_cls, mk):
        return (table_cls({"key": mk(np.arange(40_000))},
                          mk(np.ones(40_000, bool))),
                table_cls({"key": mk(np.arange(80_000))},
                          mk(np.ones(80_000, bool))))

    reports = []
    for resolve, tcls, mk in (
            (jdist.resolve_join_ladder, JTable, jnp.asarray),
            (tdist.resolve_join_ladder, Table, torch.from_numpy)):
        b, p = shapes(tcls, mk)
        ladder = resolve(b, p, 4, dict(opts))
        for overflow in (True, True, False):
            ladder.note(overflow)
            if overflow:
                ladder.escalate()
        reports.append([{f: getattr(a, f) for f in LADDER_FIELDS}
                        for a in ladder.report().attempts])
    assert reports[0] == reports[1]


def test_zipf_generator_distribution():
    """The bounded Zipf holds JAX's distribution: key 0 takes
    P(u > 1/sqrt 2) of the rows at alpha 1.5, keys stay in range, and
    the huge values of a small u clip to rand_max - 1 instead of
    wrapping to key 0."""
    n, rand_max = 400_000, 1000
    g = torch.Generator()
    g.manual_seed(3)
    t = tgen.zipf_keys(g, n, 1.5, rand_max).numpy()
    j = np.asarray(jgen.zipf_keys(jax.random.PRNGKey(3), n, 1.5, rand_max))
    for keys in (t, j):
        assert keys.min() >= 0 and keys.max() == rand_max - 1
        assert abs((keys == 0).mean() - (1 - 2 ** -0.5)) < 0.005
        assert abs((keys == rand_max - 1).mean()
                   - rand_max ** -0.5) < 0.004
    # alpha 1.1: u^-10 overflows int64 for u < 1.3e-2 (about 1 % of rows)
    t = tgen.zipf_keys(g, n, 1.1, 1 << 40).numpy()
    assert t.min() >= 0 and (t == (1 << 40) - 1).mean() > 0.005
    assert (t == 0).mean() == pytest.approx(1 - 2 ** -0.1, abs=0.005)


# -- the skew join ----------------------------------------------------------


def _zipf_tables(seed, build_rows, probe_rows, rand_max, alpha=1.5):
    rng = np.random.default_rng(seed)
    u = rng.uniform(1e-12, 1.0, probe_rows)
    pk = np.clip(np.minimum(u ** (-1 / (alpha - 1)), rand_max)
                 .astype(np.int64) - 1, 0, rand_max - 1)
    bcols = {"key": np.arange(build_rows, dtype=np.int64),
             "build_payload": rng.integers(-(1 << 40), 1 << 40, build_rows)}
    pcols = {"key": pk, "probe_payload": np.arange(probe_rows)}
    return (bcols, np.ones(build_rows, bool)), (pcols,
                                                np.ones(probe_rows, bool))


def _both(bc, bv, pc, pv):
    jt = (JTable({k: jnp.asarray(v) for k, v in bc.items()}, jnp.asarray(bv)),
          JTable({k: jnp.asarray(v) for k, v in pc.items()}, jnp.asarray(pv)))
    tt = (Table.from_numpy(bc, bv, device="cpu"),
          Table.from_numpy(pc, pv, device="cpu"))
    return jt, tt


def _oracle(bc, pc) -> int:
    bk, counts = np.unique(bc["key"], return_counts=True)
    hit = np.searchsorted(bk, pc["key"]).clip(0, len(bk) - 1)
    return int(np.where(bk[hit] == pc["key"], counts[hit], 0).sum())


SKEW_JOIN_OPTS = dict(skew_threshold=0.05, hh_slots=32, auto_retry=1,
                      out_capacity_factor=2.0)


@pytest.fixture(scope="module")
def skew_join_case(jcomm8):
    """The tables of the 8-rank skew join and JAX's result on them (one
    JAX join serves every port mode)."""
    (bc, bv), (pc, pv) = _zipf_tables(1, 4096, 16384, 4096)
    (jb, jp), tables = _both(bc, bv, pc, pv)
    want = jdist.distributed_inner_join(jb, jp, jcomm8, **SKEW_JOIN_OPTS)
    return bc, pc, tables, want


@pytest.mark.parametrize("port_mode", ["auto", "kernel"])
def test_skew_join_8_ranks_matches_jax(skew_join_case, port_mode):
    """An 8-rank Zipf join with the skew sidecar: the first attempt's
    default HH blocks overflow at alpha 1.5, one retry jumps them to the
    local probe rows; total, overflow, the retry trail and the rows equal
    JAX's."""
    bc, pc, (tb, tp), want = skew_join_case
    opts = SKEW_JOIN_OPTS
    got = tdist.distributed_inner_join(
        tb, tp, EmulatedCommunicator(8),
        kernel_config=KernelConfig(port_mode), **opts)
    assert int(got.total) == int(want.total) == _oracle(bc, pc)
    assert bool(got.overflow) == bool(want.overflow) is False
    jatt = [{f: getattr(a, f) for f in LADDER_FIELDS}
            for a in want.retry_report.attempts]
    tatt = [{f: getattr(a, f) for f in LADDER_FIELDS}
            for a in got.retry_report.attempts]
    assert len(tatt) == 2 and tatt == jatt
    assert got.table.capacity == np.asarray(want.table.valid).shape[0]
    cols, valid = got.table.to_numpy()
    np.testing.assert_array_equal(
        _rows(cols, valid),
        _rows({k: np.asarray(v) for k, v in want.table.columns.items()},
              want.table.valid))


def test_skew_relieves_the_padded_shuffle():
    """JAX's test_zipf_skew_relieves_shuffle_padding on the port: at
    shuffle factor 1.3 the naive join overflows, the skew join (one retry
    for its HH output block, none for the shuffle) fits and equals the
    oracle."""
    (bc, bv), (pc, pv) = _zipf_tables(4, 2048, 8192, 2048)
    b, p = Table.from_numpy(bc, bv, device="cpu"), Table.from_numpy(
        pc, pv, device="cpu")
    comm = EmulatedCommunicator(8)
    naive = tdist.distributed_inner_join(b, p, comm,
                                         shuffle_capacity_factor=1.3,
                                         out_capacity_factor=2.0)
    assert bool(naive.overflow)
    skewed = tdist.distributed_inner_join(
        b, p, comm, shuffle_capacity_factor=1.3, out_capacity_factor=2.0,
        skew_threshold=0.05, hh_slots=32, auto_retry=1)
    assert not bool(skewed.overflow)
    assert int(skewed.total) == _oracle(bc, pc)
    trail = skewed.retry_report.attempts
    assert all(a.shuffle_capacity_factor <= 2.6 for a in trail)


def test_skew_path_is_a_no_op_on_uniform_keys():
    rng = np.random.default_rng(7)
    bc = {"key": rng.integers(0, 4096, 4096),
          "build_payload": np.arange(4096)}
    pc = {"key": rng.integers(0, 8192, 8192),
          "probe_payload": np.arange(8192)}
    b = Table.from_numpy(bc, np.ones(4096, bool), device="cpu")
    p = Table.from_numpy(pc, np.ones(8192, bool), device="cpu")
    comm = EmulatedCommunicator(8)
    plain = tdist.distributed_inner_join(b, p, comm, out_capacity_factor=3.0)
    skewed = tdist.distributed_inner_join(b, p, comm, out_capacity_factor=3.0,
                                          skew_threshold=0.1)
    assert int(plain.total) == int(skewed.total) == _oracle(bc, pc)
    assert not bool(skewed.overflow)
    np.testing.assert_array_equal(_rows(*plain.table.to_numpy()),
                                  _rows(*skewed.table.to_numpy()))


def test_one_rank_skew_join_puts_the_heavy_block_first():
    """With one rank (nb == 1) the sidecar still runs: the HH block comes
    first, then the normal join's block, and together they equal the
    naive join."""
    (bc, bv), (pc, pv) = _zipf_tables(9, 3000, 6000, 3000)
    b, p = Table.from_numpy(bc, bv, device="cpu"), Table.from_numpy(
        pc, pv, device="cpu")
    step = tdist.make_join_step(LocalCommunicator(), skew_threshold=0.01,
                                hh_probe_capacity=6000, hh_out_capacity=6000)
    res = step(b, p)
    naive = tdist.make_join_step(LocalCommunicator())(b, p)
    assert int(res.total) == int(naive.total) == 6000
    keys = res.table.columns["key"].numpy()
    valid = res.table.valid.numpy()
    heavy = set(keys[:6000][valid[:6000]].tolist())
    normal = set(keys[6000:][valid[6000:]].tolist())
    # at threshold 60 rows the heavy keys are the small ones, ~73 % of
    # the probe rows (P(key < 12) = 1 - 13**-0.5), and the clipped top key
    # (P = 3000**-0.5, 110 rows)
    assert valid[:6000].sum() > 0.6 * 6000 and max(heavy - {2999}) < 20
    assert heavy and not heavy & normal
    np.testing.assert_array_equal(_rows(*res.table.to_numpy()),
                                  _rows(*naive.table.to_numpy()))


# -- the config driver --------------------------------------------------------


def test_config_driver_skew_policy_and_record():
    """BASELINE config 3's protocol at a small size on the CPU: the
    auto-policy (threshold 0.001, HH blocks from the top-K mass) fits on
    the first attempt; an explicit threshold keeps the generic 1/8 probe
    block, which overflows at alpha 1.5 as the JAX driver's does; 0
    forces the naive path."""
    base = ["--build-table-nrows", "40000", "--probe-table-nrows", "40000",
            "--zipf-alpha", "1.5", "--hh-out-capacity", "38400",
            "--iterations", "1"]
    rec = tdriver.run(tdriver.parse_args(base), device="cpu")
    assert rec["skew_threshold"] == 0.001 and not rec["overflow"]
    assert rec["matches_per_join"] == 40000 and rec["retry"] is None
    pol = rec["skew_policy"]
    mass = tskew.zipf_top_k_mass(1.5, 40000, 64)
    assert pol["top_k_mass"] == round(mass, 4)
    assert pol["hh_probe_capacity"] == min(40000, int(1.3 * mass * 40000)
                                           + 1024)
    assert pol["hh_out_capacity"] == 38400
    for key in ("matches_per_join", "overflow", "elapsed_per_join_s",
                "rows_per_sec", "m_rows_per_sec_per_rank", "zipf_alpha",
                "skew_threshold", "skew_policy", "retry"):
        assert key in rec
    explicit = tdriver.run(tdriver.parse_args(
        base + ["--skew-threshold", "0.001", "--auto-retry", "1"]),
        device="cpu")
    assert explicit["skew_policy"] is None and not explicit["overflow"]
    first = explicit["retry"]["attempts"][0]
    assert first["overflow"] and first["hh_probe_capacity"] == 5000
    assert explicit["retry"]["attempts"][1]["hh_probe_capacity"] == 40000
    naive = tdriver.run(tdriver.parse_args(base + ["--skew-threshold", "0"]),
                        device="cpu")
    assert naive["skew_threshold"] is None
    assert naive["matches_per_join"] == 40000 and not naive["overflow"]


def test_explicit_threshold_overflows_the_generic_hh_probe_block_in_both():
    """Config 3's explicit form (``--skew-threshold 0.001``, which turns
    the drivers' alpha auto-policy off) keeps the generic HH probe block,
    1/8 of the probe rows. At alpha 1.5 the heavy keys hold most of the
    probe rows, so the first attempt overflows in the JAX package as in
    the port, and one retry (the block jumps to every local probe row)
    fits in both, with the same trail and rows."""
    (bc, bv), (pc, pv) = _zipf_tables(11, 40000, 40000, 40000)
    (jb, jp), (tb, tp) = _both(bc, bv, pc, pv)
    opts = dict(skew_threshold=0.001, hh_slots=64, hh_out_capacity=38400,
                auto_retry=1)
    want = jdist.distributed_inner_join(
        jb, jp, jcomm.make_communicator("local"), **opts)
    got = tdist.distributed_inner_join(tb, tp, LocalCommunicator(), **opts)
    trails = []
    for res in (want, got):
        att = res.retry_report.attempts
        assert len(att) == 2 and att[0].overflow and not att[1].overflow
        assert (att[0].hh_probe_capacity, att[1].hh_probe_capacity) == (
            5000, 40000)
        assert not bool(res.overflow)
        trails.append([{f: getattr(a, f) for f in LADDER_FIELDS}
                       for a in att])
    assert trails[0] == trails[1]
    assert int(got.total) == int(want.total) == 40000
    np.testing.assert_array_equal(
        _rows(*got.table.to_numpy()),
        _rows({k: np.asarray(v) for k, v in want.table.columns.items()},
              want.table.valid))


def test_config_driver_emulated_ranks_and_refusals(capsys):
    rec = tdriver.run(tdriver.parse_args([
        "--communicator", "emulated", "--n-ranks", "4",
        "--build-table-nrows", "8000", "--probe-table-nrows", "8000",
        "--rand-max", "4000", "--duplicate-build-keys",
        "--over-decomposition-factor", "2", "--out-capacity-factor", "4",
        "--iterations", "1"]), device="cpu")
    assert rec["n_ranks"] == 4 and rec["communicator"] == "emulated"
    assert rec["skew_threshold"] is None and rec["matches_per_join"] > 0
    for argv in (["--expand-kernel=xla"], ["--platform", "cpu"],
                 ["--chaos-seed", "3"]):
        with pytest.raises(SystemExit):
            tdriver.parse_args(argv)
        assert argv[0].split("=")[0] in capsys.readouterr().err
    # --auto-tune is ported: the driver takes it as the JAX driver does
    assert tdriver.parse_args(["--auto-tune"]).auto_tune == ""
    # --agg-ab is ported: with the skew sidecar on it records the JAX
    # driver's skip reason (the pushdown refuses the heavy-hitter path)
    import argparse
    from distributed_join_tpu.benchmarks import distributed_join as jdriver
    rec = tdriver.run(tdriver.parse_args([
        "--communicator", "emulated", "--n-ranks", "4",
        "--build-table-nrows", "8000", "--probe-table-nrows", "8000",
        "--zipf-alpha", "1.5", "--iterations", "1", "--agg-ab", "2"]),
        device="cpu")
    assert rec["skew_threshold"] is not None
    assert rec["agg_ab"] == jdriver._agg_ab(
        None, None, None, "key", 2, {"skew_threshold": 0.001},
        argparse.Namespace(string_key_bytes=0))
    with pytest.raises(SystemExit, match="n-ranks"):
        tdriver.run(tdriver.parse_args(["--communicator", "emulated"]),
                    device="cpu")
