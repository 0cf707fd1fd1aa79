"""The serving fleet over the cards of one machine: one daemon replica a
card behind the router, and what a request costs through it.

    python3 scripts/fleet_cards.py [--replicas N] [--rows R]
        [--seconds S] [--repeats K] [--device cuda|cpu]

Starts a fleet of N process replicas (``process_fleet_factory``: replica
i a ``local``-communicator daemon on ``cuda:i``) and the router's TCP
daemon in this process, then picks N wire-join workloads of about R x R
rows (config 2's shape: int64 key and payload, selectivity 0.3) whose
signatures land on the N replicas, one each (the router's affinity is a
hash of the signature, so the build's row count is nudged until every
replica has one).

The load comes from N client processes, never from this one: a client
thread here would share the router's interpreter lock. Each client opens
its connections (one to the router, one to every replica) before any
clock starts. After a cold and a warm request of each workload, every
burst is S seconds of back-to-back requests, all clients released
together at a barrier:

- ``routed_spread``: client j sends workload j through the router (N
  replicas, N cards);
- ``routed_one``: every client sends workload 0 through the router (one
  replica, one card);
- ``direct_spread`` and ``direct_one``: the same, each client straight to
  the replica (no router);
- ``routed_solo`` and ``direct_solo``: client 0 alone, workload 0,
  through the router and straight to replica 0.

The six run K times each, their order rotating from one round to the
next. A burst's requests a second are its requests over the span from
the first client's start to the last client's end. The record keeps,
for every burst, that rate, the client's median ms, the replica's median
join ms (its own clock, ``elapsed_s``), and the router process's CPU
seconds a wall second over the burst (this process does nothing else
while a burst runs). It also keeps each round's ratios
``routed_spread / routed_one`` and ``direct_spread / direct_one``, and
their median and range over the rounds.

Every answer is checked against its workload's first (equal matches, no
program built after the cold request). Prints the card's name and power
limit, then one JSON line. Needs N cards (``--device cpu`` runs the same
protocol on the CPU, at a small ``--rows``, to try the script).
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import resource
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

MODES = ("routed_spread", "routed_one", "direct_spread", "direct_one",
         "routed_solo", "direct_solo")


def _smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", " | ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def _client(j, addrs, cmds, results, barrier):
    """Client process j: its connections opened first, then one burst a
    command ``(target, spec, want, seconds)`` (``target`` None: idle for
    this burst), its requests timed on the client's clock."""
    from distributed_join_tpu_torch.service.server import ServiceClient

    clients = {name: ServiceClient(host, port)
               for name, (host, port) in addrs.items()}
    try:
        results.put(("ready", j))
        while True:
            cmd = cmds.get()
            if cmd is None:
                return
            target, spec, want, seconds = cmd
            barrier.wait(timeout=600)
            lat, srv, reps, bad = [], [], set(), []
            t0 = end = time.perf_counter()
            while target is not None:
                t = time.perf_counter()
                r = clients[target].send(dict(spec))
                end = time.perf_counter()
                if not (r.get("ok") and r.get("matches") == want
                        and r.get("new_traces") == 0):
                    bad.append(json.dumps(r)[:300])
                lat.append(end - t)
                srv.append(r.get("elapsed_s"))
                reps.add((r.get("fleet") or {}).get("replica", target))
                if end - t0 >= seconds:
                    break
            results.put((j, t0, end, lat, srv, sorted(map(str, reps)),
                         bad[:3]))
    finally:
        for c in clients.values():
            c.close()


def _spread(xs):
    return {"median": statistics.median(xs), "min": min(xs),
            "max": max(xs)}


def main(argv=None) -> int:
    import torch

    from distributed_join_tpu_torch.service import fleet
    from distributed_join_tpu_torch.service.server import ServiceClient

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--replicas", type=int, default=4)
    p.add_argument("--rows", type=int, default=10_000_000)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    n = args.replicas
    if args.device != "cpu" and (not torch.cuda.is_available()
                                 or torch.cuda.device_count() < n):
        print(f"needs {n} cards", file=sys.stderr)
        return 2
    smi = _smi()
    print(f"[gpu] {smi}", flush=True)
    specs, slots = [], set()
    for extra in range(10_000):
        spec = {"op": "join", "build_nrows": args.rows + extra,
                "probe_nrows": args.rows, "seed": 42, "selectivity": 0.3}
        slot = fleet.affine_replica(spec, 1, n)
        if slot not in slots:
            slots.add(slot)
            specs.append((slot, spec))
        if len(slots) == n:
            break
    specs = [spec for _, spec in sorted(specs, key=lambda x: x[0])]
    tmp = tempfile.mkdtemp(prefix="fleet_cards_")
    cfg = fleet.FleetConfig(n_replicas=n, replica_ranks=1,
                            persist_dir=os.path.join(tmp, "programs"),
                            probe_interval_s=30.0,
                            max_inflight_per_replica=2 * n)
    t0 = time.perf_counter()
    router = fleet.FleetRouter(
        fleet.process_fleet_factory(cfg, device=args.device), cfg)
    router.start()
    spawn_s = time.perf_counter() - t0
    server, port = fleet.start_router_daemon(router)
    out = {"replicas": n, "rows": args.rows, "seconds": args.seconds,
           "repeats": args.repeats, "device": args.device,
           "spawn_s": spawn_s, "gpu": smi}
    ctx = mp.get_context("spawn")
    procs = []
    try:
        client = ServiceClient("127.0.0.1", port)
        want = []
        for slot, spec in enumerate(specs):
            cold = client.send(dict(spec))
            warm = client.send(dict(spec))
            assert cold["ok"] and warm["ok"], (cold, warm)
            assert warm["new_traces"] == 0
            assert cold["fleet"]["replica"] == warm["fleet"]["replica"] \
                == slot
            want.append(cold["matches"])
        client.close()
        addrs = {"router": ("127.0.0.1", port)}
        for rep in router.replicas:
            addrs[f"r{rep.index}"] = rep.addr()
        barrier = ctx.Barrier(n + 1)
        cmds = [ctx.Queue() for _ in range(n)]
        results = ctx.Queue()
        procs = [ctx.Process(target=_client,
                             args=(j, addrs, cmds[j], results, barrier),
                             daemon=True) for j in range(n)]
        for proc in procs:
            proc.start()
        for _ in range(n):
            tag, _ = results.get(timeout=300)
            assert tag == "ready"

        def burst(mode):
            for j in range(n):
                slot = 0 if mode.endswith(("_one", "_solo")) else j
                target = ("router" if mode.startswith("routed")
                          else f"r{slot}")
                if mode.endswith("_solo") and j:
                    target = None
                cmds[j].put((target, specs[slot], want[slot],
                             args.seconds))
            barrier.wait(timeout=600)
            ru0 = resource.getrusage(resource.RUSAGE_SELF)
            w0 = time.perf_counter()
            got = [results.get(timeout=args.seconds + 300)
                   for _ in range(n)]
            wall = time.perf_counter() - w0
            ru1 = resource.getrusage(resource.RUSAGE_SELF)
            got = [g for g in got if g[3]]
            bad = [b for g in got for b in g[6]]
            assert not bad, bad
            lat = [x for g in got for x in g[3]]
            srv = [x for g in got for x in g[4] if x is not None]
            span = max(g[2] for g in got) - min(g[1] for g in got)
            return {"requests": len(lat),
                    "requests_per_s": len(lat) / span,
                    "span_s": span,
                    "client_ms_median": statistics.median(lat) * 1e3,
                    "replica_join_ms_median": (
                        statistics.median(srv) * 1e3 if srv else None),
                    "router_cpu_per_wall_s": (
                        (ru1.ru_utime + ru1.ru_stime - ru0.ru_utime
                         - ru0.ru_stime) / wall),
                    "replicas": sorted({r for g in got for r in g[5]})}

        bursts = {m: [] for m in MODES}
        for k in range(args.repeats):
            for i in range(len(MODES)):
                mode = MODES[(i + k) % len(MODES)]
                rec = burst(mode)
                bursts[mode].append(rec)
                print(f"[burst] round {k} {mode}: "
                      f"{rec['requests_per_s']:.2f} requests/s, client "
                      f"{rec['client_ms_median']:.3f} ms, replica "
                      f"{rec['replica_join_ms_median']:.3f} ms, router "
                      f"cpu {rec['router_cpu_per_wall_s']:.3f} s/s",
                      flush=True)
        out["bursts"] = bursts
        ratios = {}
        for side in ("routed", "direct"):
            rs = [a["requests_per_s"] / b["requests_per_s"] for a, b in zip(
                bursts[f"{side}_spread"], bursts[f"{side}_one"])]
            ratios[f"{side}_spread_over_one"] = {"rounds": rs,
                                                 **_spread(rs)}
        rs = [a["requests_per_s"] / b["requests_per_s"] for a, b in zip(
            bursts["routed_spread"], bursts["direct_spread"])]
        ratios["routed_over_direct_spread"] = {"rounds": rs, **_spread(rs)}
        out["ratios"] = ratios
        out["replica_memory"] = fleet._replica_memory(router)
    finally:
        for q in (cmds if procs else []):
            q.put(None)
        for proc in procs:
            proc.join(timeout=30)
            if proc.is_alive():
                proc.kill()
        server.shutdown()
        server.server_close()
        router.stop()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
