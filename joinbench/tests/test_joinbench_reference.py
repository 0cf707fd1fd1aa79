"""The plain reference against known answers, the comparison, and the
controls that have to fail."""

import itertools
from types import SimpleNamespace

import pytest
import torch

from joinbench.frozen.tpch import generate_query_tables, query_filters
from joinbench.reference.compare import row_diff
from joinbench.reference.join import fingerprint32, inner_join
from joinbench.reference.query import group_by, query_reference
from joinbench.systems.synth_join import System as SynthJoin


def synth_shard(seed, rank, world, build_rows, probe_rows, rand_max,
                selectivity, unique_keys):
    """Rank ``rank``'s ``(build, probe)`` as a run makes them on the CPU."""
    config = {"build_rows_per_gpu": build_rows,
              "probe_rows_per_gpu": probe_rows, "rand_max": rand_max,
              "selectivity": selectivity, "unique_build_keys": unique_keys}
    ctx = SimpleNamespace(world=world, rank=rank,
                          device=torch.device("cpu"))
    return SynthJoin(config, {}, ctx)._shard(seed, rank)


def brute_join(bk, bp, pk, pp):
    return sorted((int(k2), int(b), int(p))
                  for k2, p in zip(pk.tolist(), pp.tolist())
                  for k1, b in zip(bk.tolist(), bp.tolist()) if k1 == k2)


def rows(d, names):
    return sorted(zip(*(d[n].tolist() for n in names)))


def test_join_known_answer():
    bk = torch.tensor([5, 1, 5, 9, 3])
    bp = torch.tensor([10, 11, 12, 13, 14])
    pk = torch.tensor([5, 2, 9, 5, 3, 3])
    pp = torch.tensor([0, 1, 2, 3, 4, 5])
    out = inner_join(bk, {"bp": bp}, pk, {"pp": pp})
    assert rows(out, ["key", "bp", "pp"]) == [
        (3, 14, 4), (3, 14, 5), (5, 10, 0), (5, 10, 3), (5, 12, 0),
        (5, 12, 3), (9, 13, 2)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_join_against_brute_force_in_blocks(seed):
    g = torch.Generator().manual_seed(seed)
    bk = torch.randint(0, 40, (300,), generator=g)
    pk = torch.randint(0, 60, (200,), generator=g)
    bp, pp = torch.arange(300) + 1000, torch.arange(200)
    out = inner_join(bk, {"bp": bp}, pk, {"pp": pp}, block_rows=17)
    assert rows(out, ["key", "bp", "pp"]) == brute_join(bk, bp, pk, pp)


def test_row_diff_counts_missing_and_extra_with_multiplicity():
    a = {"x": torch.tensor([1, 2, 2, 3]), "y": torch.tensor([0, 0, 0, 1])}
    b = {"x": torch.tensor([2, 1, 4]), "y": torch.tensor([0, 0, 0])}
    assert row_diff(a, b, ["x", "y"]) == {"missing": 1, "extra": 2}
    assert row_diff(a, a, ["x", "y"]) == {"missing": 0, "extra": 0}
    empty = {"x": torch.tensor([], dtype=torch.int64),
             "y": torch.tensor([], dtype=torch.int64)}
    assert row_diff(empty, empty, ["x", "y"]) == {"missing": 0, "extra": 0}


def test_group_by_known_answer_and_float32_control():
    keys = torch.tensor([7, 3, 7, 3, 9])
    vals = torch.tensor([1, 2, 3, 4, 5])
    carry = torch.tensor([70, 30, 70, 30, 90])
    g = group_by(keys, vals, carry)
    assert g["key"].tolist() == [3, 7, 9]
    assert g["revenue"].tolist() == [6, 4, 5]
    assert g["n_lines"].tolist() == [2, 2, 1]
    assert g["carry"].tolist() == [30, 70, 90]
    big = torch.tensor([2 ** 24 + 1, 2])
    g32 = group_by(torch.tensor([1, 1]), big, torch.tensor([0, 0]),
                   float32_sums=True)
    assert g32["revenue"].tolist() == [2 ** 24 + 2]   # not 2^24 + 3


def test_shards_follow_the_global_rule():
    parts = [synth_shard(5, r, 4, 1000, 800, 4000, 0.3, True)
             for r in range(4)]
    bk = torch.cat([b["key"] for b, _ in parts])
    assert torch.equal(bk, torch.arange(4000))
    # each rank's payloads are its row ids, in an order of their own
    for r, (b, _) in enumerate(parts):
        assert torch.equal(b["build_payload"].sort().values,
                           torch.arange(r * 1000, (r + 1) * 1000))
        assert int((b["build_payload"] == b["key"]).sum()) < 10
    pk = torch.cat([p["key"] for _, p in parts])
    hits = pk < 4000
    assert 0.25 < hits.float().mean() < 0.35
    assert bool((pk[~hits] < 8000).all())
    assert torch.equal(torch.cat([p["probe_payload"] for _, p in parts]),
                       torch.arange(3200))
    again = synth_shard(5, 2, 4, 1000, 800, 4000, 0.3, True)
    assert torch.equal(again[1]["key"], parts[2][1]["key"])
    other = synth_shard(6, 2, 4, 1000, 800, 4000, 0.3, True)
    assert not torch.equal(other[1]["key"], parts[2][1]["key"])
    with pytest.raises(ValueError):
        synth_shard(5, 0, 4, 1000, 800, 4000, 0.3, False)


def _brute(tables):
    """Q3 groups by order, carrying its date, over the filtered join of
    the three tables."""
    (c, cv), (o, ov), (li, lv) = (tables["customer"], tables["orders"],
                                  tables["lineitem"])
    cust = {int(k) for k, v in zip(c["custkey"], cv) if v}
    orders = {int(k): int(d) for k, ck, d, v in zip(
        o["orderkey"], o["custkey"], o["o_orderdate"], ov)
        if v and int(ck) in cust}
    groups = {}
    for k, p, v in zip(li["orderkey"].tolist(),
                       li["l_extendedprice"].tolist(), lv.tolist()):
        if v and k in orders:
            rev, n, _ = groups.get(k, (0, 0, orders[k]))
            groups[k] = (rev + p, n + 1, orders[k])
    return sorted((g, r, n, c) for g, (r, n, c) in groups.items())


def test_query_reference_against_a_brute_force_group_by():
    tables = query_filters(generate_query_tables(9, 0.002, "cpu"), "q3")
    ref = query_reference(tables, "q3")
    g = ref["groups"]
    got = sorted(zip(g["key"].tolist(), g["revenue"].tolist(),
                     g["n_lines"].tolist(), g["carry"].tolist()))
    assert got == _brute(tables)
    assert ref["j2_rows"] == sum(n for _, _, n, _ in got)


def test_q3_control_fails_the_comparison():
    """The control (revenue summed in float32) fails the check at a size
    a test holds: an order's revenue passes 2^24 cents."""
    tables = query_filters(generate_query_tables(9, 0.01, "cpu"), "q3")
    ref = query_reference(tables, "q3")["groups"]
    ctl = query_reference(tables, "q3", float32_sums=True)["groups"]
    d = row_diff(ctl, ref, ["key", "revenue", "n_lines", "carry"])
    assert d["missing"] > 0 and d["extra"] > 0


def test_join_control_fails_the_comparison():
    """The control (the key compared by a 32-bit fingerprint) fails the
    check at 2^18 rows a side: misses collide with build keys."""
    n = 1 << 18
    build, probe = synth_shard(13, 0, 1, n, n, n, 0.03, True)
    names = ["key", "build_payload", "probe_payload"]
    ref = inner_join(build["key"], {"build_payload": build["build_payload"]},
                     probe["key"], {"probe_payload": probe["probe_payload"]})
    ctl = inner_join(build["key"], {"build_payload": build["build_payload"]},
                     probe["key"], {"probe_payload": probe["probe_payload"]},
                     match_key=fingerprint32)
    d = row_diff(ctl, ref, names)
    assert d["extra"] > 0 and d["missing"] == 0


def test_fingerprint_is_32_bits_and_spreads():
    x = torch.arange(1 << 16, dtype=torch.int64)
    f = fingerprint32(x)
    assert int(f.min()) >= 0 and int(f.max()) < 2 ** 32
    assert torch.unique(f).shape[0] == x.shape[0]
    for a, b in itertools.islice(itertools.combinations(range(5), 2), 5):
        assert int(fingerprint32(torch.tensor([a]))) != \
            int(fingerprint32(torch.tensor([b])))
