"""The port's program-cache disk tier (service/programs.py) against the
JAX package's, on the CPU.

The JAX package persists a serialised XLA executable; the port persists
an entry of what a build resolves (the signature with every option, the
backend, the kernels' digests) and binds the step from it. What is held
to the reference (``tests/test_service.py:265-286``,
``tests/test_explain.py:407-416`` and ``:455``): a fresh cache on the same
directory answers a persisted signature with no new trace
(``traces`` 0, ``disk_loads`` 1, ``source == "disk"``) and the same
totals, with the JAX cache's counters exactly; eviction removes the entry
and counts; ``explain`` predicts a persisted program. Besides: a foreign
or stale entry is a counted miss that builds (never a silent build inside
a "disk load"), a fresh PROCESS binds what another process wrote, the
daemon's ``--persist-dir`` restarts warm with its history beside the
entries, the probe-only and query programs enter the tier, and a
fault-injecting communicator's programs never do. Counts are exact.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp

import distributed_join_tpu  # noqa: F401  (enables JAX x64)
from distributed_join_tpu.parallel import communicator as jcomm
from distributed_join_tpu.service import programs as jprog
from distributed_join_tpu.table import Table as JTable
from distributed_join_tpu_torch import telemetry
from distributed_join_tpu_torch.parallel import distributed_join as tdist
from distributed_join_tpu_torch.parallel.communicator import (
    EmulatedCommunicator,
    LocalCommunicator,
)
from distributed_join_tpu_torch.parallel.faults import (
    FaultInjectingCommunicator,
    FaultPlan,
)
from distributed_join_tpu_torch.service import programs as tprog
from distributed_join_tpu_torch.service import server as ts
from distributed_join_tpu_torch.table import Table

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = [1, 4]
OPTS = dict(key="key", out_capacity_factor=4.0)


def _side(seed, rows, kmax, payload):
    rng = np.random.default_rng(seed)
    return {"key": rng.integers(0, kmax, rows).astype(np.int64),
            payload: rng.integers(-(1 << 40), 1 << 40, rows).astype(np.int64)}


def _tables(seed=11):
    b = _side(seed, 512, 256, "build_payload")
    p = _side(seed + 1000, 1024, 256, "probe_payload")
    counts = np.bincount(b["key"], minlength=256)
    want = int(counts[p["key"]].sum())

    def both(cols):
        valid = np.ones(len(cols["key"]), bool)
        return (JTable({k: jnp.asarray(v) for k, v in cols.items()},
                       jnp.asarray(valid)),
                Table.from_numpy(cols, valid, device="cpu"))

    return both(b), both(p), want


def _tcomm(n):
    return LocalCommunicator() if n == 1 else EmulatedCommunicator(n)


def _jcomm(n):
    return (jcomm.make_communicator("local") if n == 1
            else jcomm.make_communicator("tpu", n_ranks=n))


def _entries(d):
    return sorted(f for f in os.listdir(d) if f.endswith(tprog.PROGRAM_SUFFIX))


@pytest.mark.parametrize("n", RANKS)
def test_persisted_program_restarts_with_zero_traces(n, tmp_path):
    """A fresh cache on the directory (a restarted server) binds the
    persisted program: no trace, one disk load, ``source == "disk"``,
    the same total; the counters equal the JAX cache's over its own
    directory."""
    (jb, tb), (jp, tp), want = _tables()
    td, jd = str(tmp_path / "torch"), str(tmp_path / "jax")
    tc1 = tprog.JoinProgramCache(_tcomm(n), persist_dir=td, device="cpu")
    e1, hit = tc1.get(tb, tp, **OPTS)
    assert not hit and e1.source == "trace" and e1.persisted
    assert int(e1(tb, tp).total) == want
    assert _entries(td) == [e1.signature.digest() + ".joinprog"]

    tc2 = tprog.JoinProgramCache(_tcomm(n), persist_dir=td, device="cpu")
    e2, hit = tc2.get(tb, tp, **OPTS)
    assert not hit and e2.source == "disk" and e2.persisted
    assert int(e2(tb, tp).total) == want
    st2 = tc2.stats()
    assert (st2["traces"], st2["disk_loads"], st2["misses"]) == (0, 1, 1)
    assert tc2.get(tb, tp, **OPTS)[1]           # then a memory hit

    # The JAX cache over the same calls: equal counters on both sides
    # of the restart. Its loaded blob is not run: on jax 0.9.0 an XLA:CPU
    # blob expects the runtime's 8 devices whatever mesh compiled it
    # (the reference's own red case, tests/test_fleet.py:596).
    jc1 = jprog.JoinProgramCache(_jcomm(n), persist_dir=jd)
    je1, _ = jc1.get(jb, jp, **OPTS)
    assert je1.persisted and int(je1(jb, jp).total) == want
    jc2 = jprog.JoinProgramCache(_jcomm(n), persist_dir=jd)
    je2, _ = jc2.get(jb, jp, **OPTS)
    assert je2.source == "disk"
    assert tc1.stats() == jc1.stats()
    jc2.get(jb, jp, **OPTS)
    assert tc2.stats() == jc2.stats()


def test_cache_eviction_and_disk_counters(tmp_path):
    """Eviction drops the memory entry AND the disk entry (a program
    whose run failed a check must not be bound again from disk), counted
    by reason as in the JAX package; a re-get then builds."""
    (_, tb), (_, tp), _ = _tables()
    d = str(tmp_path)
    cache = tprog.JoinProgramCache(EmulatedCommunicator(2), persist_dir=d,
                                   device="cpu")
    fn, hit = cache.get(tb, tp, **OPTS)
    assert not hit
    st = cache.stats()
    assert st["integrity_evictions"] == 0 and st["occupancy"] is None
    assert st["disk_persists"] == 1 and st["disk_load_failures"] == 0
    assert cache.evict(fn.signature)
    assert cache.stats()["integrity_evictions"] == 1
    assert _entries(d) == []
    assert not cache.evict(fn.signature)        # nothing left to drop
    assert not cache.get(tb, tp, **OPTS)[1]
    assert cache.stats()["traces"] == 2 and cache.stats()["disk_loads"] == 0


def test_explain_predicts_a_persisted_program(tmp_path):
    """``explain`` (the dry run) predicts a persisted program as
    ``persisted`` and not ``would_trace`` before any memory entry
    exists, in a fresh service on the directory; the stats op and the
    Prometheus text carry the disk counters."""
    from distributed_join_tpu_torch.planning.plan import abstract_tables

    d = str(tmp_path / "programs")
    q = {"op": "join", "build_nrows": 512, "probe_nrows": 512, "seed": 3,
         "out_capacity_factor": 3.0}
    svc = ts.JoinService(LocalCommunicator(), ts.ServiceConfig(
        persist_dir=d, max_programs=16), device="cpu")
    server, port = ts.start_daemon(svc, "127.0.0.1", 0)
    client = ts.ServiceClient("127.0.0.1", port)
    try:
        assert client.send(q)["ok"]
        st = client.send({"op": "stats"})["cache"]
        assert st["disk_persists"] == 1 and st["traces"] == 1
    finally:
        client.close()
        server.shutdown()
        server.server_close()
    fresh = ts.JoinService(LocalCommunicator(), ts.ServiceConfig(
        persist_dir=d), device="cpu")
    out = fresh.explain(*abstract_tables(512, 512), out_capacity_factor=3.0)
    assert out["cache"] == {"resident": False, "persisted": True,
                            "would_trace": False}
    prom = fresh.prometheus_metrics()
    for gauge in ("djtpu_program_cache_disk_loads 0",
                  "djtpu_program_cache_disk_load_failures 0",
                  "djtpu_program_cache_disk_persists 0"):
        assert gauge in prom, gauge


FOREIGN = {
    "backend": lambda doc: doc["backend"].update(torch="0.0.0"),
    "card": lambda doc: doc["backend"].update(device_type="cuda",
                                              device_name="another card"),
    "kernel_digest": lambda doc: doc.update(
        kernels={"join_scans": "join_scans-0000000000000000.so"}),
    "signature": lambda doc: doc["signature"].update(rung=9),
    "schema": lambda doc: doc.update(schema_version=0),
}


@pytest.mark.parametrize("how", sorted(FOREIGN) + ["torn"])
def test_foreign_or_stale_entry_is_a_counted_miss(how, tmp_path,
                                                  monkeypatch):
    """An entry of another backend, another card, another kernel digest,
    another signature or schema, or a torn file is a miss: counted in
    ``disk_load_failures``, reported as ``program_cache_load_failed``,
    then built as a trace (the JAX package's miss path, :486-512)."""
    (_, tb), (_, tp), want = _tables()
    d = str(tmp_path / "programs")
    c1 = tprog.JoinProgramCache(LocalCommunicator(), persist_dir=d,
                                device="cpu")
    e1, _ = c1.get(tb, tp, **OPTS)
    (name,) = _entries(d)
    path = os.path.join(d, name)
    if how == "torn":
        with open(path, "w") as fh:
            fh.write('{"kind": "join_pro')
    else:
        doc = json.load(open(path))
        FOREIGN[how](doc)
        tprog.atomic_write_json(path, doc)
    events = []
    monkeypatch.setattr(telemetry, "event",
                        lambda name, **kw: events.append(dict(kw, name=name)))
    c2 = tprog.JoinProgramCache(LocalCommunicator(), persist_dir=d,
                                device="cpu")
    e2, hit = c2.get(tb, tp, **OPTS)
    assert not hit and e2.source == "trace"
    st = c2.stats()
    assert (st["traces"], st["disk_loads"], st["disk_load_failures"],
            st["disk_persists"]) == (1, 0, 1, 1)
    assert int(e2(tb, tp).total) == want
    failed = [e for e in events
              if e.get("name") == "program_cache_load_failed"]
    assert len(failed) == 1 and failed[0]["path"] == path
    # the build rewrote a good entry: the next fresh cache binds it
    c3 = tprog.JoinProgramCache(LocalCommunicator(), persist_dir=d,
                                device="cpu")
    assert c3.get(tb, tp, **OPTS)[0].source == "disk"


_CHILD = r"""
import json, sys
import numpy as np
from distributed_join_tpu_torch.parallel.communicator import EmulatedCommunicator
from distributed_join_tpu_torch.service.programs import JoinProgramCache
from distributed_join_tpu_torch.table import Table
rng = np.random.default_rng(11)
b = {"key": rng.integers(0, 256, 512).astype(np.int64),
     "build_payload": rng.integers(0, 1 << 40, 512).astype(np.int64)}
p = {"key": rng.integers(0, 256, 1024).astype(np.int64),
     "probe_payload": rng.integers(0, 1 << 40, 1024).astype(np.int64)}
tb = Table.from_numpy(b, np.ones(512, bool), device="cpu")
tp = Table.from_numpy(p, np.ones(1024, bool), device="cpu")
cache = JoinProgramCache(EmulatedCommunicator(2), persist_dir=sys.argv[1],
                         device="cpu")
fn, hit = cache.get(tb, tp, key="key", out_capacity_factor=4.0)
print(json.dumps({"source": fn.source, "total": int(fn(tb, tp).total),
                  "stats": cache.stats()}))
"""


def test_a_fresh_process_binds_what_another_wrote(tmp_path):
    """Across processes: the second process's cache binds the first's
    entry with no trace and the same total (the replacement replica's
    case)."""
    d = str(tmp_path / "programs")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = []
    for _ in range(2):
        proc = subprocess.run([sys.executable, "-c", _CHILD, d], env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        out.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    first, second = out
    assert first["source"] == "trace" and second["source"] == "disk"
    assert first["total"] == second["total"] > 0
    assert (first["stats"]["traces"], first["stats"]["disk_persists"]) \
        == (1, 1)
    assert (second["stats"]["traces"], second["stats"]["disk_loads"],
            second["stats"]["disk_load_failures"]) == (0, 1, 0)


def test_daemon_restart_with_persist_dir_is_warm(tmp_path):
    """The daemon's ``--persist-dir``: a restarted service answers the
    first repeat of a join, a probe-only join and a query with
    ``new_traces`` 0 (their programs bound from disk), and its history
    lands beside the entries (``history_dir`` defaults to
    ``persist_dir``, JAX :213)."""
    d = str(tmp_path / "programs")
    args = ts.parse_args(["--persist-dir", d, "--device", "cpu",
                          "--communicator", "emulated", "--n-ranks", "2"])
    args.request_deadline_s = None
    reqs = [
        {"op": "join", "build_nrows": 1024, "probe_nrows": 1024,
         "seed": 5, "selectivity": 0.4, "out_capacity_factor": 3.0},
        {"op": "register", "name": "dim", "rows": 1024, "seed": 5,
         "unique_keys": True},
        {"op": "join", "table": "dim", "probe_nrows": 512, "seed": 5,
         "selectivity": 0.4, "out_capacity_factor": 3.0},
        {"op": "query", "query": "q3", "scale_factor": 0.002, "seed": 3},
    ]
    answers = []
    for _ in range(2):
        svc = ts._service_from_args(args)
        assert svc.config.persist_dir == d
        assert svc.history.path == os.path.join(d, "history.jsonl")
        server, port = ts.start_daemon(svc, "127.0.0.1", 0)
        client = ts.ServiceClient("127.0.0.1", port)
        try:
            answers.append([client.send(r) for r in reqs])
            answers[-1].append(client.send({"op": "stats"}))
        finally:
            client.close()
            server.shutdown()
            server.server_close()
        svc.history.close()
    cold, warm = answers
    for i in (0, 2, 3):
        assert cold[i]["ok"] and warm[i]["ok"], (cold[i], warm[i])
        assert cold[i]["new_traces"] >= 1 and warm[i]["new_traces"] == 0
    for i in (0, 2):
        assert warm[i]["matches"] == cold[i]["matches"] > 0
    assert warm[3]["rows"] == cold[3]["rows"]
    st = warm[4]["cache"]
    assert st["disk_loads"] == 3 and st["disk_load_failures"] == 0
    assert os.path.getsize(os.path.join(d, "history.jsonl")) > 0


def test_fault_injected_programs_never_enter_the_tier(tmp_path):
    """A program built over a ``FaultInjectingCommunicator`` is neither
    persisted nor bound from disk (the JAX package's fault-wrapped
    ``spmd`` has no AOT path): a corrupted program must not reach the
    replicas that share the directory."""
    (_, tb), (_, tp), want = _tables()
    d = str(tmp_path / "programs")
    clean = tprog.JoinProgramCache(EmulatedCommunicator(2), persist_dir=d,
                                   device="cpu")
    clean.get(tb, tp, **OPTS)
    faulty = tprog.JoinProgramCache(
        FaultInjectingCommunicator(EmulatedCommunicator(2), FaultPlan()),
        persist_dir=d, device="cpu")
    fn, _ = faulty.get(tb, tp, **OPTS)
    assert fn.source == "trace" and not fn.persisted
    assert int(fn(tb, tp).total) == want
    st = faulty.stats()
    assert (st["traces"], st["disk_loads"], st["disk_persists"]) == (1, 0, 0)
    other = dict(OPTS, out_capacity_factor=8.0)
    faulty.get(tb, tp, **other)
    assert len(_entries(d)) == 1
    assert faulty.preload() == 0


def test_entry_binds_the_backend_and_the_kernels(tmp_path):
    """What an entry binds besides the signature: on the CPU no kernel
    (the twins launch none), the torch version and the device type; on a
    card the three join kernels by their source digests. A tier with no
    device to bind to refuses loudly (the GPU is the default)."""
    ident = tprog.backend_identity("cpu")
    assert ident["device_type"] == "cpu" and ident["device_name"] is None
    assert ident["torch"]
    assert tprog.program_kernels("cpu") == {}
    assert tprog.PROGRAM_KERNELS == ("join_scans", "stream_compact",
                                     "expand_gather")
    (_, tb), (_, tp), _ = _tables()
    cache = tprog.JoinProgramCache(LocalCommunicator(),
                                   persist_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cache.get(tb, tp, **OPTS)


@pytest.mark.parametrize("present", [True, False])
def test_preload_loads_present_binaries_and_never_builds(present, tmp_path,
                                                         monkeypatch):
    """``preload`` dlopens the kernels an entry names only when their
    binaries exist: a missing binary is skipped there (loading it would
    build it with nvcc) and counted as a miss when a request reaches the
    entry. The kernels are faked here: on the CPU an entry names none."""
    from distributed_join_tpu_torch.ops import _kernels

    lib = tmp_path / "join_scans-abc.so"
    if present:
        lib.write_bytes(b"")
    monkeypatch.setattr(tprog, "program_kernels",
                        lambda device: {"join_scans": lib.name})
    monkeypatch.setattr(_kernels, "_library_path", lambda name: lib)
    loads = []
    monkeypatch.setattr(tprog.JoinProgramCache, "_load_kernels",
                        lambda self, names: loads.append(sorted(names)))
    (_, tb), (_, tp), want = _tables()
    d = str(tmp_path / "programs")
    lib.write_bytes(b"")            # the writer's own binary
    c1 = tprog.JoinProgramCache(LocalCommunicator(), persist_dir=d,
                                device="cpu")
    assert c1.get(tb, tp, **OPTS)[0].persisted
    if not present:
        lib.unlink()
    loads.clear()
    c2 = tprog.JoinProgramCache(LocalCommunicator(), persist_dir=d,
                                device="cpu")
    assert c2.preload() == int(present)
    assert loads == ([["join_scans"]] if present else [])
    e2, _ = c2.get(tb, tp, **OPTS)
    st = c2.stats()
    assert e2.source == ("disk" if present else "trace")
    assert (st["traces"], st["disk_loads"], st["disk_load_failures"]) == (
        (0, 1, 0) if present else (1, 0, 1))
    assert int(e2(tb, tp).total) == want
