"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. The card's name and power limit (nvidia-smi); the build of every
   kernel in distributed_join_tpu_torch/csrc (one nvcc each, in
   parallel), with its wall time.
2. Each kernel against its plain PyTorch twin at the headline's shapes
   (10 M x 10 M rows, selectivity 0.3, seed 42): the fused join scans
   over the 20 M merged positions, the stream compaction at each of the
   join's two call sites (run records, matched-build pack),
   the expand-gather in build mode and record mode, the radix sort (B6)
   on the join's merged-sort operand set (int64 key + int8 tag as keys,
   int64 value; and one int64 key with one int64 value, each with its
   live digit passes counted from the keys), and
   expand_pull in both modes. Outputs must be bit-identical over the
   prefix each contract defines. Times with CUDA events: kernel, plain
   twin, one PyTorch library call where one computes the same function,
   and the bound (bytes this data needs over 3.35 TB/s, or operations
   over the scalar rate, whichever is larger); and the kernel's device
   time alone (torch.profiler), without the host's gaps between calls.
3. The headline protocol (python -m distributed_join_tpu_torch.bench):
   no overflow, every kernel launched, and an order-independent digest of
   the result rows equal to the same join forced through the plain path;
   plus a small join held against the CPU path.
4. A join without build payloads (the expand's record mode) against the
   plain path.
5. An emulated 4-rank join on the one card (hash -> partition -> padded
   shuffle -> local join) at 2 M x 2 M rows, equal to the 1-rank join.
6. BASELINE config 3 on one card (50 M x 50 M rows, Zipf alpha 1.5,
   unique build keys, skew threshold 0.001, 64 heavy-hitter slots, HH
   output block 48 M): first the config driver's protocol with the skew
   path and without it (python -m distributed_join_tpu_torch.benchmarks.
   distributed_join), alone on the card so that its peak memory is its
   own: no overflow, 50 M matches, every kernel of the path launched.
   Then, on tables of its own, the compaction at the skew call site
   against its twin (the HH build mask at capacity 2048, the shape the
   path launches; and, off the path, the HH probe mask at n/8), and one
   untimed join of each kind through the kernels and through the plain
   twins: the four row digests must be equal, which holds the join
   kernels against their twins at config 3's shapes (100 M merged
   positions in the normal join, 50 M in the HH join).
7. An emulated 4-rank Zipf join on the card (2 M x 2 M, alpha 1.5,
   shuffle capacity factor 1.6): the naive join's first attempt
   overflows and the ladder relieves it; the skew join with the driver's
   auto-policy capacities fits on its first attempt; both equal the
   1-rank join.
8. The radix sort (B6) and expand_pull through their own entry points
   (``merged_sort``, ``expand_pull``), which no join path calls, each at
   the shapes of phase 2.
9. The scan's int32 domain: one ``join_scans`` call on 2^30 + 2^20
   positions (above its old 2^30 - 1 limit), every output exactly equal
   to its closed form, with its time and byte bound.
10. BASELINE config 5 at its size (5 M x 5 M rows, a 2-column composite
   key, a 16-byte string payload) through the config driver: no
   overflow, every join kernel launched; then one join of its tables
   through the kernels and one through the plain formulation, with
   equal row digests (the 2-D byte columns included).
11. Types and strings, each as phase 10: the headline in float64 keys
   and payloads (10 M x 10 M), a 16-byte string key (5 M x 5 M) and a
   float32 join (8 M x 8 M, keys below 2^24); then 4 emulated ranks at
   2 M x 2 M with a string key beside an int64 key and a string
   payload, equal to the 1-rank join.
12. The join types: left, right, full outer, semi and anti joins of the
   headline's tables (10 M x 10 M) through ``distributed_inner_join``,
   each with an output block of its expected rows plus 25 %, the rows
   counted from the tables alone (matches by binary search, unmatched
   rows by ``torch.isin``): no overflow on the first rung, that total,
   the scans, the compactions and the expand launched (record mode on
   semi and anti), and a row digest equal to the plain formulation's;
   each timed as benchmarks/distributed_join.py times a join (4 warm-up
   and 4 timed joins, CUDA events), the full outer join profiled. The kernels at the typed
   shapes the headline does not have (the full outer record block and
   expand, the valid-build pack, the anti join's record-mode expand)
   against their twins, their inputs taken from one join of each. Then
   4 emulated ranks at 2 M x 2 M for the full outer and anti joins,
   equal to the 1-rank join.
13. The join over NCCL, one process a card on every card of the machine
   (a world of 1 on one card), started by the port's launcher
   (benchmarks/launch.py) once: each process is a worker rank of this
   script (``--nccl-rank-worker JOB``), which runs the config driver in
   its own process, then its own checks. The config driver at BASELINE
   config 2's shape with 10 M x 10 M rows a rank, at over-decomposition
   1 and 4 (with 4 even one card partitions into 4 buckets and sends
   each batch through NCCL's all_to_all_single): no overflow, the match
   count of the plain 1-rank join of the same global tables, ms a join
   and M rows/s a rank; at 1 with ``--resident-ab 2`` (phase 18(f)):
   the probe-only matches equal to that join's, digests equal, no warm
   build; the same driver with ``--profile 3`` (rank 0); then the
   worker runs one untimed
   ``distributed_inner_join`` at over-decomposition 4 in every rank:
   the scans, both compaction sites and the build-mode expand launched
   on every rank, and the ranks' row digests combined equal to the
   plain 1-rank join's; rank 0 then holds the scans, both compaction
   sites and the expand against their twins on the inputs the last
   bucket's local join gave them (the padded bucket's shapes), and
   every rank times the partition and shuffle of such a join alone.
   The same launch runs phase 17(e)'s Q10 at SF-1 through the tpch
   driver (its groups digest against the 1-rank one this process
   computes). Last, the all-to-all benchmark at 64 and 256 MiB a rank
   with two cards or more (the median of 5 timed windows, each window
   printed); on one card its refusal (it needs two ranks), inside the
   same launch. ``python3
   chip_smoke.py --phase 13`` runs this phase alone (after the build).
14. The wires over NCCL, one process a card as in phase 13, at config
   2's shape (10 M x 10 M rows a rank, over-decomposition 4): first the
   codec (ops/compression.py) on one such batch's padded key and payload
   blocks of this card's rows at 16 and 32 bits (encode and decode ms,
   the bytes saved, the wire rate at which the saving pays for the
   codec); then the config driver on each wire (padded, ragged,
   ppermute, compressed at 32 bits, and compressed at 16 bits with
   ``--auto-retry 2``, whose trail must widen the bits): no overflow, the
   plain 1-rank join's matches, ms a join, and the rows, bytes and host
   reads of a join on rank 0 as the driver counts them; then the worker
   (one launch for the whole phase, as in phase 13) joins once in each
   wire (the ranks' digests combined equal to the plain 1-rank
   join's, every join kernel launched on every rank) and times that
   wire's partition and shuffle alone; last, BASELINE config 5 at 5 M x
   5 M rows a rank on the padded wire and on the ragged wire with fixed
   and variable-length strings: the padded run's matches, and
   ``byte_exact_on_wire`` on the ragged wire. ``python3 chip_smoke.py
   --phase 14`` runs this phase alone (after the build).

15. BASELINE config 4, TPC-H lineitem ⋈ orders (the Q3 join pattern):
   the driver (python -m distributed_join_tpu_torch.benchmarks.tpch_join)
   at SF-10 on the host generator in 4 key-range batches, in this
   process: 15,000,000 orders, 60,000,261 lines and as many matches (the
   numpy generator is the JAX package's, bit for bit), no overflow, the
   phase seconds (generate, pad, put, dispatch, fetch wait) and peak host
   memory, every join kernel launched; the scans, both compaction sites
   and the build-mode expand against their twins on the inputs the last
   batch's join gave them. Then the batch loop at SF-1 with Q3's
   filters, a manifest and a consumer that digests each fetched batch:
   the total equal to numpy's count (a sparse key maps back to its
   order), the manifest holding every batch, every join kernel launched
   on every dispatch, and the digest equal to the same batches joined
   through the plain path. Last, the single-shot and key-range paths on
   the card's generator at SF-1 (1 and 4 batches): as many matches as
   lines. ``python3 chip_smoke.py --phase 15`` runs this phase alone
   (after the build).

16. The segmented sort and the hierarchical wire. (a) Config 2's shape
   (10 M x 10 M rows a rank, over-decomposition 4) with ``--sort-mode
   segmented`` through the config driver over NCCL, one process a card
   (128 segments): no overflow, the plain 1-rank join's matches, ms a
   join; the same run's ``--sort-ab 5`` (min and median ms of each mode,
   totals and row digests equal); ``--profile 3`` of each mode (the
   sorts' device ms); on one card, one in-process segmented join of the
   same tables on a local communicator at k = 4, digest-equal to the
   plain 1-rank join and launching no hand kernel (the batched
   formulation). (b) 4 emulated ranks as 2 slices x 2 on the card at
   2 M x 2 M: the hierarchical wire with the codec off, and on at 16
   bits with ``auto_retry=2`` (the trail printed), each equal to the
   1-rank join with every join kernel launched once a rank at least,
   and the segmented sort over the same hierarchy (no hand kernel).
   The driver runs of (a) and (c) and the worker's joins of (c) share
   one launch, as in phase 13.
   (c) the one-slice hierarchy (``--shuffle hierarchical``) over NCCL
   through a worker rank: the combined digest equal to the plain 1-rank
   join's, as the padded wire's is; with an even number of cards above
   one, also 2 slices over NCCL subgroups, codec off and on: the driver
   (ms a join, a rank's bytes on each tier, the retry trail) and the
   worker (digests, every join kernel on every rank). ``python3
   chip_smoke.py --phase 16`` runs this phase alone (after the build).
17. The query layer. (a) TPC-H Q3 and Q10 at SF-10 through the tpch
   driver (``--query``, one rank): customer ⋈ orders ⋈ lineitem with
   the group-by fused into the second join, no overflow after the
   ladder, the groups equal to the numpy whole-query oracle, the op
   totals, ms a query over warm repeats and peak device memory; the
   first join launches the scans, both compaction sites and the
   expand, the second the groups compaction. (b) ``--agg`` at SF-10 with
   Q3's filters, oracle-equal. (c) the join driver's ``--agg-ab 3`` at
   config 2's shape: min ms of the pushdown and of materialize then
   group on the host, both oracle-equal. (d) Q3 and Q10 at SF-1 on 4
   emulated ranks and on an emulated 2 x 2 hierarchy, each equal to the
   1-rank groups (Q10 runs the partials exchange). (e) Q10 at SF-1
   over NCCL, one process a card, its groups digest equal to the 1-rank
   one (in phase 13's launch); with four or more cards also Q3 and Q10 at
   SF-10 over 4 NCCL ranks, equal to (a)'s. (f) the groups compaction at
   (a)'s Q3 shape against its twin (``stream_compact[groups]``).
   ``python3 chip_smoke.py --phase 17`` runs this phase alone (after
   the build).

18. The serving core, at BASELINE config 2's width (int64 key and
   payload, seed 42, selectivity 0.3): (a) the join driver's
   ``--resident-ab 5`` at 10 M x 10 M (register s, the minima of warm
   full and probe-only joins, equal matches and row digests, no warm
   build); (b) a 10 M-row build registered once, 32 probe requests of
   2^18 rows, each from its own seed, each row digest equal to a cold
   full join of the same pair, the program cache 1 miss, 31 hits and 1
   build, ms a request, and the scans, both compaction sites and the
   build-mode expand at one request's shapes (10,262,144 merged
   positions) against their twins; (c) four appends of 1 M-row deltas,
   one ``maintain``, conservation at every step, a re-probe equal to a
   cold join on the concatenated build, generation evictions of that
   table's entries only, and a drop; (d) the probe-only aggregate at
   10 M x 10 M, key mode and probe mode (1024 groups, k = 2), every
   group equal to the numpy oracle; (e) 8 requests of 1 M x 1 M
   micro-batched into one step and split, each equal to its own join,
   no match across requests, the second batch a cache hit; (f) 4
   emulated ranks at 1 M rows equal to one rank (its NCCL part runs in
   phase 13's launch). ``python3 chip_smoke.py --phase 18`` runs this
   phase alone (after the build).

19. The telemetry session, the watchdog and the fault plans, in a
   process of its own. (a) The join driver at the headline's shape
   (10 M x 10 M, seed 42) at over-decomposition 4 (so that it partitions
   and shuffles) over NCCL as a world of 1, in one launch, through its
   guarded run (``benchmarks.run_guarded``, as ``main``): off, with
   ``--telemetry DIR --history FILE``, and with ``--telemetry DIR --trace
   --history FILE``. Equal totals; the ``telemetry`` block only in the
   session runs; every join site launched as often off as on, less the
   session runs' one untimed metrics join; ms a join
   off, with a session, and with the device trace; the event log's
   ``generate``, ``partition``, ``shuffle``, ``join`` and ``timed_join``
   spans; the Chrome traces load; in the ``torch.profiler`` device trace
   every launch of ``join_scans``, ``stream_compact`` and
   ``expand_gather`` inside a ``join`` span. Then one untimed join of the
   same tables without and with a session: equal digests and launches.
   (b) The two ``--history`` runs: two entries under one signature. (c)
   ``FaultInjectingCommunicator`` on the card: ``fail_dispatches=1``
   under ``retry_with_backoff`` recovers with the clean digest;
   ``overflow_programs=2`` gives the ladder the JAX package gives on the
   CPU, with the clean digest; the driver with a 60 s dispatch delay
   under ``--guard-deadline-s 5`` (a process of its own, ``chip_smoke.py
   --fault-driver JOB``) exits 1 with a ``HangError`` record; config 4 at
   SF-10 with ``batch_deadline_s`` 2 and batch 2's device work 3 s late (a
   spin enqueued before it) reports the partial total, batch 2 failed.
   ``python3 chip_smoke.py --phase 19`` runs this phase alone (after the
   build).
20. The join service's daemon (``python -m
   distributed_join_tpu_torch.service.server``) over TCP on localhost,
   on this card, in the shared process: (a) a 10 M-row build registered
   over the wire and 32 resident joins of 2^18 probe rows, each equal to
   an in-process registry join, the cache 1 miss and 31 hits, the
   client's ms a request, the metrics op's ordered quantiles and the
   Prometheus text; (b) a wire join at 10 M x 10 M, cold then run-only
   warm, equal to the in-process join, and between them an ``explain`` op
   whose digest equals the key the warm join runs under; (c) 16 small
   joins batched against
   one by one, equal matches, both walls; (d) Q3 at SF-1 through the
   query op, equal to the numpy oracle; (e) append, tables, drop, stats,
   ping; (f) the poison drill; (g) drain; (h) ``--smoke`` as a
   subprocess. ``python3 chip_smoke.py --phase 20`` runs this phase alone
   (after the build).
21. The cost model (``planning/cost.py``) and the device metrics tape,
   in a process of its own: (a) each primitive the model prices timed
   at the headline's shape (the merged sort, the segmented batched sort,
   one more value lane, join_scans, stream_compact, expand_gather, a
   random gather, the 16-byte row gather, a device copy, the codec's
   encode and decode, NCCL all_to_all_single over a world of 1) and
   printed as the model's fields beside the card's name and power limit;
   (b) predicted against measured walls of the headline, a k = 4 join
   over 4 emulated ranks, a serving request and Q3 at SF-10; (c) the
   tape over 4 emulated ranks at 10 M x 10 M: counted wire bytes equal
   to the plan's on the padded, ppermute, 16-bit compressed and 2 x 2
   hierarchical wires (both tiers), within its estimate on the ragged
   wire, matches equal to the totals, an anti join, launches equal with
   the tape off and on, the CUDA kernels and ms the tape adds.
   ``python3 chip_smoke.py --phase 21`` runs this phase alone.
22. The stage profiler, the run diagnosis and the baseline gate, in a
   process of its own: (a) config 2's join at 10 M x 10 M profiled stage
   by stage on one rank at k = 1 (the join alone) and k = 4 (all three
   stages), each stage's counters equal to the tape-on join's, the
   padded wire bytes to the plan's, the stages' least walls summing to
   at least 0.95 x the monolithic step's; (b) Q3 at SF-10 operator by
   operator, each operator's counters equal to the tape-on query's; (c)
   the constants refitted from those stages (not the world-of-1
   shuffle) against the shipped ones, and phase 21(b)'s workloads priced
   by both; (d) ``--diagnose`` on the join driver over 4 emulated ranks,
   a Zipf alpha 1.5 probe (the key-skew indicator warns, naming the skew
   knobs) and a uniform one (clean); (e) the daemon's smoke twice, the
   second gated against baselines written from the first.
   ``python3 chip_smoke.py --phase 22`` runs this phase alone.
23. The autotuner (``planning/tuner.py``), in the shared process: (a)
   the warm contract at config 2's 10 M x 10 M on one rank: a cold join
   at ``out_capacity_factor`` 0.1 escalates at least twice; fed its
   history line, the repeat runs one ``tuned_presize`` attempt at the
   cold run's final rung, builds no program and returns the same rows;
   the cold, warm tuned and static default sizing's walls. (b)
   ``JoinService(auto_tune=True)`` at the serving request's shape (a
   10 M-row build, a 2^18-row probe): the second request builds nothing
   and runs one attempt from history; the daemon's ``explain`` op
   carries ``tuned``; the join driver twice with ``--history F
   --auto-tune`` (the second starts at the first's final rung); ``analyze
   tune F --json`` passes ``analyze check``. (c) the fill rules over 4
   emulated ranks, each fed a history this phase wrote, filled against
   static at their settled rungs (median of 3, equal row digests): the
   skew fill on config 3's Zipf alpha 1.5 tables (B5 launches), the
   ragged wire fill (a padded run at shuffle factor 2) and the segmented
   sort fill (a stage-profiled history); a resident join with ``tuner=``
   on the Zipf probe drops the structural fills. (d) the card's name and
   power limit beside the numbers. ``python3 chip_smoke.py --phase 23``
   runs this phase alone.
24. Wire integrity (``parallel/integrity.py``), in a process of its own,
   over 4 emulated ranks at 4 M x 4 M rows stored in key order: (a)
   ``verify_integrity=True`` on the padded, ppermute, 16-bit compressed,
   ragged (with a variable-length string payload), 2 x 2 hierarchical
   (cross-slice codec on) and segmented wires, each clean with 2 n^2
   pairs checked and the unverified join's row digest, the verified and
   unverified ms a join (medians of 5), and the join kernels launched on
   the verified joins (path ``integrity``); (b) every corruption mode on
   the padded and ragged wires, ``bit_flip`` and ``misroute`` on the
   cross-slice hop: a budget of 1 recovers through ``retry_integrity``
   to the clean digest with the program evicted, an unbounded budget
   raises ``IntegrityError``; (c) the join and all-to-all drivers'
   ``--verify-integrity`` records; (d) the headline with integrity off,
   its launches and row digest equal to the headline phase's. ``python3
   chip_smoke.py --phase 24`` runs this phase alone.
25. The serving fleet (``service/fleet.py``), in the shared process:
   (a) an in-process fleet of two replicas on this card (K = 2 table
   replication, a persist dir a slot) beside a direct ``JoinService``
   daemon: a 10 M-row resident build and a 1 M-row append on both
   holders, 32 probe-only requests of 2^18 rows and wire joins at 10 M x
   10 M, each equal to the direct service's, the warm repeats on the
   cold request's replica with no program built, the router's and the
   direct call's ms a request (medians over pairs, the first side
   alternating); a holder that missed an append refuses with
   ``StaleGenerationError`` and the router fails over; the join kernels
   launched on the router's requests (path ``fleet``). (b) ``python -m
   distributed_join_tpu_torch.service.fleet --smoke`` (daemon replicas
   on this card, a shared persist dir, a scripted SIGKILL): its gates
   and its baseline gate
   (``results/baselines_torch/fleet_smoke.json``), kill to serving
   seconds, the replacement's first request with its program bound from
   disk against a replica's from an empty persist dir, each replica's
   peak device memory. (c) ``--ha-smoke``, started after (a)'s timed
   pairs and run beside (b): the rebuild's and the takeover's seconds,
   its baseline gate. ``python3 chip_smoke.py
   --phase 25`` runs this phase alone.
26. The chaos soak (``parallel/chaos.py``), in a process of its own:
   (a) ``soak(42, 20)`` over 8 emulated ranks on this card (every config
   family, every fault kind): 0 failures, the verdict histogram, ms a
   trial, the join kernels launched (path ``chaos``); (b) 2 hierarchical trials and 3 poisoned-history
   tuner trials, 0 failures; (c) the ``--fleet 8 --fleet-fault kill``
   soak over two daemon replicas on this card: its gates, kill to
   drained and kill to replaced seconds; (d) the join driver at config
   2's rows over 4 emulated ranks with ``--verify-integrity --auto-retry
   1``, clean and with ``--chaos-seed`` 3 (no fault), 7 (an overflowed
   program) and 2 (a misroute): a run refuses with ``IntegrityError`` or
   reports the clean run's row digest (3 and 7 must). ``python3
   chip_smoke.py --phase 26`` runs this phase alone.
27. The native driver (``native/join_main.cpp``: libtorch, the
   join_scans, stream_compact and expand_gather kernels called through
   their C entry points; g++ builds it in a thread beside nvcc at the
   top of the script), in the shared process: (a) ``--selftest``; (b) at
   1 M x 1 M, 8 iterations, the driver's dumped tables through the
   port's ``build_looped_join`` give its total, overflow and checksum
   exactly, and native against Python ms a join on those tables in 5
   alternating pairs (the Python host share of a one-rank join; no
   gate); (c) at 10 M x 10 M: ``matches_per_join`` equals the driver's
   count of probe hits, no overflow, its rows/s beside the headline's;
   (d) (c)'s launches are path ``native``; (e) the 14 schedule programs
   recorded over 8 emulated ranks on this card equal
   ``results/schedules_torch/``. It runs in the shared process
   (``--phase 20,23,25,27``).

The whole script runs phases 2 to 14 and 16 in one process, then 15,
17, 18, 19, 21, 22, 24 and 26 each in a process of its own, and 20, 23,
25 and 27, which take no profiler session, one after another in one
more (``--phase 20,23,25,27``)
(``--phase N``): late in one
long process the profiler has dropped launches and scaled durations. A device
time counts only when the profiler caught every launch the wrappers made
and its clock agrees with the CUDA events' on a spin kernel in the same
session; otherwise the row says "not measured".

Launch counts are set to zero just before each path and read just after;
the launches of phase 2, of the config-3 kernel check and of the
bucket-shape checks do not count.
The line before the last is one JSON object with every kernel's numbers,
one row per kernel and call site (the join sites also carry their
launches on the paths of phases 10 to 17, phases 13's, 14's and 16's
NCCL paths summed over the ranks, 15's the SF-10 run's; the segmented
paths launch none, and the fused aggregate none of the materializing
join's, with the reason in ``no_launch_reason``; the groups site's
launches are those of phase 17's Q3 and Q10 at SF-10; the serving
rows' are those of phase 18(b)'s warm request, and the join sites also
carry the paths ``resident``, ``resident_agg`` and ``batched``, and
``telemetry``: phase 19(a)'s driver run with the session and the device
trace on, ``service``: phase 20's wire requests (a)-(e), which the
groups site's entry carries too, phase 21(c)'s ``tape_*`` paths, and
phase 22's ``stageprof_join`` (the k = 4 profile) and ``stageprof_q3``,
and phase 23's ``tuner_warm``, ``tuner_service``, ``tuner_skew_fill``,
``tuner_wire_fill`` and ``tuner_sort_fill``, the last launching none: the
segmented path, phase 24's ``integrity``, phase 25's ``fleet``
(the router's requests to its in-process replicas) and phase 26's
``chaos`` (the main soak's trials) and phase 27's ``native`` (the
native driver's 10 M-row run); the skew site's
entry carries its launches on the paths
that run the sidecar, phase 23's ``tuner_skew_fill`` among them);
the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits
with code 2, and without the package beside it with code 3; neither
prints a result.

A line marked ``# noqa: DJL004`` reads a reduction to the host for a
check or a sizing, after the calls it checks and outside every timed
window; joinlint reports any other such read.
"""

from __future__ import annotations

import json
import os
import re
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
SCALAR_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
SEED = 42
NROWS = 10_000_000
EMU_ROWS = 2_000_000
EMU_RANKS = 4
CONFIG3_ROWS = 50_000_000
CONFIG3_HH_OUT = 48_000_000
ZIPF_ALPHA = 1.5
ZIPF_EMU_FACTOR = 1.6
REPS = 5                       # CUDA-event calls a kernel row
DEVICE = "cuda"
C1_POSITIONS = 2**30 + 2**20   # above the scan's old 2^30 - 1 limit
CONFIG5_ROWS = 5_000_000
STRING_KEY_ROWS = 5_000_000
FLOAT32_ROWS = 8_000_000       # keys up to 2 * rows < 2^24: exact in float32
TYPED = ("left", "right", "full_outer", "semi", "anti")
TYPED_EMU = ("full_outer", "anti")
TYPED_ITERS = 4                # 4 warm-up and 4 timed joins, as the config
                               # benchmark times them


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _check(cond: bool, msg: str) -> None:
    if not cond:
        _fail(msg)


def time_ms(fn, reps: int = REPS) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events),
    after two warm-up calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _own_kernel_names() -> frozenset:
    """The names of the ``__global__`` functions in the port's CUDA
    sources: the kernels its wrappers launch."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "distributed_join_tpu_torch", "csrc")
    names = set()
    for f in sorted(os.listdir(src)):
        if f.endswith(".cu"):
            with open(os.path.join(src, f)) as fh:
                names.update(re.findall(
                    r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                    r"(\w+)", fh.read()))
    return frozenset(names)


PROFILE_SESSIONS = 3           # profiler sessions before "not measured"
PROFILE_PAD_S = 0.05           # host seconds either side of the profiled calls
SPIN_CYCLES = 1_000_000        # each spin kernel of the clock check
# the spin's profiled time over its CUDA events' time: 0.91-0.94 in a
# fresh process on the H100; late in a long process durations have come
# out scaled by ~0.55
CLOCK_TOLERANCE = 0.15


def device_ms(fn, reps: int = REPS, floor: float | None = None,
              sessions: int = PROFILE_SESSIONS
              ) -> tuple[float | None, dict]:
    """Mean device time of the kernels ``fn`` launches per call
    (torch.profiler), after a warm-up call, and its split by kernel name:
    what ``time_ms`` measures less the host's gaps between launches,
    which bind a call whose kernels take tens of microseconds.

    A session is a measurement only when the profiler caught every
    launch the port's wrappers made in it; when its clock agrees with the
    CUDA events' on a spin kernel in the same session (within
    ``CLOCK_TOLERANCE``: the events bracket the second of two spins,
    which starts behind the first with no host gap); and, with ``floor``
    (the work's bound), when its sum is not below it. Late in a long
    process (the whole script) sessions have dropped launches, and kept
    them with every duration scaled by ~0.55, memsets included, while a
    fresh process measures them right. The calls keep ``PROFILE_PAD_S``
    of host time on either side inside the session, and a session that
    misses is run again, up to ``sessions`` (1 where ``fn`` runs
    collectives: every rank must run it as often). The time is None
    when none measured."""
    from torch.profiler import ProfilerActivity, profile
    wrappers = _launch_wrappers()
    own = _own_kernel_names()
    fn()
    torch.cuda.synchronize()
    spin = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    cuda = torch.autograd.DeviceType.CUDA
    for session in range(1, sessions + 1):
        made = -sum(w.launches for w in wrappers)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            torch.cuda._sleep(SPIN_CYCLES)
            spin[0].record()
            torch.cuda._sleep(SPIN_CYCLES)
            spin[1].record()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        made += sum(w.launches for w in wrappers)
        spins = sorted((e.time_range.start, e.device_time_total)
                       for e in prof.events()
                       if e.device_type == cuda and "spin_kernel" in e.name)
        clock = (spins[-1][1] / 1e3 / spin[0].elapsed_time(spin[1])
                 if spins else 0.0)
        parts, caught = {}, 0
        for e in prof.key_averages():
            if e.device_type != cuda or "spin_kernel" in e.key:
                continue
            name = re.split(r"[(<]", e.key.replace(
                "(anonymous namespace)::", ""))[0].split("::")[-1].strip()
            ms = e.device_time_total / 1e3 / reps
            parts[name] = parts.get(name, 0.0) + ms
            if name.split()[-1] in own:
                caught += e.count
        total = sum(parts.values())
        if (caught >= made and abs(clock - 1) <= CLOCK_TOLERANCE
                and (floor is None or total >= floor)):
            return total, parts
        print(f"[profile] session {session}: the profiler caught {caught} "
              f"of the {made} kernel launches made, {total:.4f} device ms"
              + ("" if floor is None else f" (bound {floor:.4f})")
              + f"; its clock {clock:.4f} of the CUDA events'", flush=True)
    print("[profile] device time not measured", flush=True)
    return None, parts


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / SCALAR_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def max_abs_err(got, want, n: int | None = None) -> float:
    """Largest |difference| over the first ``n`` entries of each pair
    (every entry when ``n`` is None); 0 when they are bit-identical."""
    err = 0.0
    for g, w in zip(got, want):
        g, w = (g, w) if n is None else (g[:n], w[:n])
        if g.numel() and not torch.equal(g, w):
            d = (g.double() - w.double()).abs().max()
            err = max(err, float(d), 1.0)  # noqa: DJL004
    return err


def row_digest(res) -> tuple:
    """Order-independent digest of the valid rows: (rows, wrapping sum
    and xor of a 64-bit hash of each row). Floats enter by their bits; a
    2-D column enters element by element, a bool column as 0 or 1."""
    from distributed_join_tpu_torch.ops.hashing import fmix64, hash_combine
    t = res.table
    h = None
    for name in t.column_names:
        c = t.columns[name]
        if c.dtype == torch.bool:   # an outer join's validity columns
            c = c.to(torch.int64)
        if c.dtype.is_floating_point:
            c = c.view(torch.int64 if c.element_size() == 8 else torch.int32)
        for col in c.reshape(c.shape[0], -1).unbind(1):
            hc = fmix64(col)
            h = hc if h is None else hash_combine(h, hc)
    h = h[t.valid]
    return int(t.valid.sum()), int(h.sum()), _xor_reduce(h)  # noqa: DJL004


def _xor_reduce(h: torch.Tensor) -> int:
    while h.numel() > 1:
        if h.numel() % 2:
            h = torch.cat([h, h.new_zeros(1)])
        h = h[0::2] ^ h[1::2]
    return int(h[0]) if h.numel() else 0


def gpu_line() -> str:
    from distributed_join_tpu_torch.bench import gpu_identity
    return gpu_identity()["nvidia_smi"]


# -- phase 2: the kernels at the headline's shapes ---------------------


def stage_inputs(build, probe, out_cap: int) -> dict:
    """The inputs each kernel sees inside the headline join, made with
    the plain twins (so every stage is checked on its own)."""
    from distributed_join_tpu_torch.ops import join as J
    from distributed_join_tpu_torch.ops.compact import stream_compact_reference
    from distributed_join_tpu_torch.ops.lanes import to_u64_lane
    from distributed_join_tpu_torch.ops.scan import join_scans_reference

    keys, b1d, p1d = ["key"], ["build_payload"], ["probe_payload"]
    m_ops, m_tag = J._masked_keys(build, probe, keys)
    m_val = torch.cat([build.columns["build_payload"],
                       probe.columns["probe_payload"]])
    skeys, stag, svals = J._merged_sort(build, probe, keys, b1d, p1d)
    first = J._run_starts(skeys)
    sc = join_scans_reference(stag, first)
    is_rec = (stag == 1) & (sc["cnt"] > 0)
    rec_lanes = [to_u64_lane(sc["start_out"]), to_u64_lane(skeys[0]),
                 to_u64_lane(svals[("p", "probe_payload")]),
                 to_u64_lane(sc["lo_m"])]
    compacted = stream_compact_reference(is_rec, sc["rec_pos"], rec_lanes,
                                         out_cap)
    rec_total = int(sc["rec_pos"][-1]) + 1
    kept = min(rec_total, out_cap)
    j = torch.arange(out_cap, dtype=torch.int32, device=stag.device)
    live = j < kept
    S = torch.where(live, compacted[0].to(torch.int32),
                    torch.full_like(j, J.I32_MAX))
    lo = torch.where(live, compacted[3].to(torch.int32), torch.zeros_like(j))
    matched = sc["matched"] != 0
    pack_lane = [to_u64_lane(svals[("b", "build_payload")])]
    pack = stream_compact_reference(matched, sc["mb_pos"], pack_lane,
                                    build.capacity)
    total = int(sc["cnt"].sum(dtype=torch.int64))  # noqa: DJL004
    return dict(tag=stag, first=first, is_rec=is_rec, rec_pos=sc["rec_pos"],
                rec_lanes=rec_lanes, matched=matched, mb_pos=sc["mb_pos"],
                pack_lane=pack_lane, S=S, lo=lo,
                rec_cols=[compacted[1], compacted[2]], pack=pack,
                kept=kept, total=total,
                n_matched=int(matched.sum()),  # noqa: DJL004
                nb=build.capacity, out_cap=out_cap,
                sort_ops=(m_ops[0], m_tag, m_val),
                join_sort=lambda: J._merged_sort(build, probe, keys, b1d,
                                                 p1d))


def check_and_time(rows, name, source, replaces, got, want, prefix, fn_k,
                   fn_p, fn_lib, nbytes, ops, **extra):
    """Hold one kernel's outputs against its twin's (bit-identical over
    the first ``prefix`` entries), time kernel, twin and library call,
    and append the kernel's row."""
    torch.cuda.synchronize()
    err = max_abs_err(got, want, prefix)
    _check(err == 0, f"{name}: kernel disagrees with its plain twin "
                     f"(max_abs_err {err})")
    b, by = bound_ms(nbytes, ops)
    row = dict(name=name, route="cuda", source=source, replaces=replaces,
               max_abs_err=err, ms=time_ms(fn_k), plain_ms=time_ms(fn_p),
               bound_ms=b, bound_by=by,
               library_ms=None if fn_lib is None else time_ms(fn_lib),
               **{k: time_ms(f) for k, f in extra.items()})
    dev, parts = device_ms(fn_k, floor=b)
    row["device_ms"] = dev
    print(f"[kernel] {name}: kernel_ms={row['ms']:.4f} "
          f"device_ms={'not measured' if dev is None else f'{dev:.4f}'} "
          f"plain_ms={row['plain_ms']:.4f} bound_ms={b:.4f} ({by}) "
          f"library_ms={row['library_ms']} max_abs_err={err}"
          + "".join(f" {k}={row[k]:.4f}" for k in extra), flush=True)
    if len(parts) > 1:
        print(f"[kernel] {name}: device ms by kernel " + ", ".join(
            f"{k} {v:.4f}" for k, v in sorted(parts.items(),
                                              key=lambda kv: -kv[1])),
              flush=True)
    rows.append(row)


def kernel_phase(build, probe, out_cap: int) -> list:
    from distributed_join_tpu_torch.ops import compact, expand, scan

    x = stage_inputs(build, probe, out_cap)
    n = x["tag"].shape[0]
    rows = []

    def add(*args, **kw):
        check_and_time(rows, *args, **kw)

    # fused scans over the 20 M merged positions
    got = scan.join_scans(x["tag"], x["first"])
    want = scan.join_scans_reference(x["tag"], x["first"])
    add("join_scans", "distributed_join_tpu_torch/csrc/join_scans.cu",
        "distributed_join_tpu/ops/scan_pallas.py:106,150 "
        "(_scan_r_kernel, _scan_f_kernel)",
        [got[k] for k in scan.NAMES], [want[k] for k in scan.NAMES], None,
        lambda: scan.join_scans(x["tag"], x["first"]),
        lambda: scan.join_scans_reference(x["tag"], x["first"]), None,
        nbytes=2 * n + 6 * 4 * n, ops=40 * n)

    # the two compactions of one join, each at its own call site: the
    # run-record block, 4 lanes, 20 M -> out_cap, and the matched-build
    # pack, 1 lane, 20 M -> nb; each checked over its survivor prefix.
    # Bound: every mask byte read, and the kept survivors' lanes read and
    # written. No pos byte: pos == cumsum(mask) - 1 (the contract) follows
    # from the mask, so the function needs none of it (the kernel reads
    # one a tile).
    surv = int(x["is_rec"].sum())  # noqa: DJL004
    kept = min(surv, out_cap)
    k = len(x["rec_lanes"])
    nm = x["n_matched"]
    mask_r, mask_m = x["is_rec"], x["matched"]
    packed = torch.stack(x["rec_lanes"], 1)
    pack_lane = x["pack_lane"][0]
    for name, mask, pos, lanes, cap, n_kept, lib, nbytes in (
            ("stream_compact[record]", mask_r, x["rec_pos"], x["rec_lanes"],
             out_cap, kept, lambda: packed[mask_r], n + 2 * kept * 8 * k),
            ("stream_compact[pack]", mask_m, x["mb_pos"], x["pack_lane"],
             x["nb"], nm, lambda: pack_lane[mask_m], n + 2 * nm * 8)):
        got = compact.stream_compact(mask, pos, lanes, cap)
        want = compact.stream_compact_reference(mask, pos, lanes, cap)
        add(name, "distributed_join_tpu_torch/csrc/stream_compact.cu",
            "distributed_join_tpu/ops/compact_planes.py:53 (_compact_kernel); "
            "distributed_join_tpu/ops/compact_pallas.py:62 (_compact_kernel)",
            got, want, n_kept,
            lambda m=mask, q=pos, ls=lanes, c=cap: compact.stream_compact(
                m, q, ls, c),
            lambda m=mask, q=pos, ls=lanes, c=cap:
                compact.stream_compact_reference(m, q, ls, c),
            lib, nbytes=nbytes, ops=n)
        del got, want
    del packed

    # expand-gather, build mode: 2 record lanes + 1 build lane -> out_cap
    tot = min(x["total"], out_cap)
    S, lo, rc, pk = x["S"], x["lo"], x["rec_cols"], x["pack"]
    got_r, got_b = expand.expand_gather(S, rc, out_cap, lo=lo, build_cols=pk)
    want_r, want_b = expand.expand_gather_reference(S, rc, out_cap, lo=lo,
                                                    build_cols=pk)
    kk, kb = len(rc), len(pk)
    add("expand_gather[build]",
        "distributed_join_tpu_torch/csrc/expand_gather.cu",
        "distributed_join_tpu/ops/expand_pallas.py:335 (_expand_kernel_b8)",
        got_r + got_b, want_r + want_b, tot,
        lambda: expand.expand_gather(S, rc, out_cap, lo=lo, build_cols=pk),
        lambda: expand.expand_gather_reference(S, rc, out_cap, lo=lo,
                                               build_cols=pk),
        None,
        nbytes=x["kept"] * (4 + 4 + 8 * kk) + nm * 8 * kb
        + tot * 8 * (kk + kb),
        ops=tot * 2 * 32)

    # expand-gather, record mode: the same records, 2 lanes + start_b
    got_r, got_s = expand.expand_gather(S, rc, out_cap)
    want_r, want_s = expand.expand_gather_reference(S, rc, out_cap)
    kept_r = x["kept"]
    run_len = torch.diff(torch.cat([
        S[:kept_r].long(), torch.tensor([tot], device=S.device)]))
    rec_pack = torch.stack(rc, 1)[:kept_r]
    add("expand_gather[record]",
        "distributed_join_tpu_torch/csrc/expand_gather.cu",
        "distributed_join_tpu/ops/expand_pallas.py:264 (_expand_kernel)",
        got_r + [got_s], want_r + [want_s], tot,
        lambda: expand.expand_gather(S, rc, out_cap),
        lambda: expand.expand_gather_reference(S, rc, out_cap),
        lambda: torch.repeat_interleave(rec_pack, run_len, dim=0,
                                        output_size=tot),
        nbytes=kept_r * (4 + 8 * kk) + tot * (8 * kk + 4),
        ops=tot * 2 * 32)

    # expand_pull (B7) on the same records: equal to expand_gather's
    # output, and to its own twin (which adds start_b and the zero rank
    # placeholder in build mode)
    gat_r, gat_b = expand.expand_gather(S, rc, out_cap, lo=lo, build_cols=pk)
    got = expand.expand_pull(S, rc, out_cap, lo=lo, build_cols=pk)
    want = expand.expand_pull_reference(S, rc, out_cap, lo=lo, build_cols=pk)
    _check(max_abs_err(got[0] + got[3], gat_r + gat_b, tot) == 0,
           "expand_pull[build] differs from expand_gather")
    add("expand_pull[build]",
        "distributed_join_tpu_torch/csrc/expand_gather.cu",
        "distributed_join_tpu/ops/expand_planes.py:58 (_expand_kernel)",
        got[0] + [got[1], got[2]] + got[3],
        want[0] + [want[1], want[2]] + want[3], tot,
        lambda: expand.expand_pull(S, rc, out_cap, lo=lo, build_cols=pk),
        lambda: expand.expand_pull_reference(S, rc, out_cap, lo=lo,
                                             build_cols=pk),
        None,
        nbytes=x["kept"] * (4 + 4 + 8 * kk) + nm * 8 * kb
        + tot * (8 * (kk + kb) + 4 + 4),
        ops=tot * 2 * 32)
    got_r, got_s = expand.expand_pull(S, rc, out_cap)
    want_r, want_s = expand.expand_pull_reference(S, rc, out_cap)
    gat_r, gat_s = expand.expand_gather(S, rc, out_cap)
    _check(max_abs_err(got_r + [got_s], gat_r + [gat_s], tot) == 0,
           "expand_pull[record] differs from expand_gather")
    add("expand_pull[record]",
        "distributed_join_tpu_torch/csrc/expand_gather.cu",
        "distributed_join_tpu/ops/expand_planes.py:58 (_expand_kernel)",
        got_r + [got_s], want_r + [want_s], tot,
        lambda: expand.expand_pull(S, rc, out_cap),
        lambda: expand.expand_pull_reference(S, rc, out_cap),
        lambda: torch.repeat_interleave(rec_pack, run_len, dim=0,
                                        output_size=tot),
        nbytes=kept_r * (4 + 8 * kk) + tot * (8 * kk + 4),
        ops=tot * 2 * 32)
    del rec_pack
    rows.extend(merge_sort_rows(x["sort_ops"], x["join_sort"]))
    return rows


def live_digit_passes(operands, nk: int) -> tuple[int, int]:
    """The radix sort's live passes on these operands, and its digit
    positions, counted with torch ops: the key planes packed two to a
    64-bit word, and a byte position is live where not every row has the
    same byte there."""
    from distributed_join_tpu_torch.ops import merge_sort as ms
    planes = [p for c in operands[:nk] for p in ms.key_to_planes(c)]
    live = 0
    for i in range(0, len(planes), 2):
        word = ms._wide(planes[i]) << 32
        if i + 1 < len(planes):
            word = word | ms._wide(planes[i + 1])
        for b in range(8):
            digit = (word >> (8 * b)) & 0xFF
            live += int(digit.amin() != digit.amax())  # noqa: DJL004
    return live, 8 * ((len(planes) + 1) // 2)


def merge_sort_rows(sort_ops, join_sort) -> list:
    """B6 at the join's merged-sort operand set (int64 key + int8 tag as
    keys, int64 value) and at one int64 key with one int64 value: the
    kernel route and the stable twin both give the stable order, so every
    operand must be bit-identical (stronger than the contract's sorted
    keys plus equal rows within each key run). Each row carries the
    number of live digit passes of these keys."""
    from distributed_join_tpu_torch.ops import merge_sort as ms

    key, tag, val = sort_ops
    n = key.shape[0]
    rows = []
    src = "distributed_join_tpu_torch/csrc/radix_sort.cu"
    rep = ("distributed_join_tpu/ops/sort_pallas.py:314 (_merge_tile_kernel)")
    for name, operands, nk, lib in (
            ("merge_sort[key+tag]", (key, tag, val), 2, None),
            ("merge_sort[key]", (key, val), 1,
             lambda: _sort_and_gather(key, val))):
        got = ms.merged_sort(operands, nk)
        want = ms.merged_sort_reference(operands, nk)
        width = sum(c.element_size() for c in operands)
        extra = {"join_merged_sort_ms": join_sort} if lib is None else {}
        # bytes: every operand read once and written once; operations:
        # one digit per row for each live digit position of these keys
        # at the scalar rate (never binds next to the bytes)
        live, digits = live_digit_passes(operands, nk)
        check_and_time(rows, name, src, rep, list(got), list(want), None,
                       lambda o=operands, k=nk: ms.merged_sort(o, k),
                       lambda o=operands, k=nk: ms.merged_sort_reference(o, k),
                       lib, nbytes=2 * n * width, ops=n * max(live, 1),
                       **extra)
        rows[-1]["live_passes"] = live
        print(f"[kernel] {name}: {live} live digit passes of {digits}",
              flush=True)
        del got, want
    return rows


def _sort_and_gather(key, val):
    srt = torch.sort(key)
    return srt.values, val[srt.indices]


# -- the paths ----------------------------------------------------------


def _launch_wrappers() -> tuple:
    """Every kernel wrapper and call site that counts its launches."""
    from distributed_join_tpu_torch.ops import (
        aggregate,
        compact,
        expand,
        join,
        merge_sort,
        scan,
    )
    from distributed_join_tpu_torch.parallel import skew
    return (scan.join_scans, join.compact_records,
            join.pack_matched_builds, join.pack_valid_builds,
            compact.stream_compact,
            expand.expand_gather, skew.extract_prefix,
            merge_sort.merge_sort_planes, expand.expand_pull,
            aggregate.compact_groups)


def counted(fn):
    """Run ``fn`` with every launch count set to zero; returns (its
    result, the counts it left, by wrapper or call site)."""
    from distributed_join_tpu_torch.ops import _kernels
    wrappers = _launch_wrappers()
    torch.cuda.synchronize()
    _kernels.reset_launch_counts(*wrappers)
    out = fn()
    torch.cuda.synchronize()
    return out, {w.__name__: w.launches for w in wrappers}


JOIN_KERNELS = ("join_scans", "compact_records", "pack_matched_builds",
                "expand_gather")


def _require_launched(counts: dict, names, where: str,
                      at_least: int = 1) -> None:
    for name in names:
        _check(counts[name] >= at_least,
               f"{name} was launched {counts[name]} times on {where} (at "
               f"least {at_least} expected)")


def headline_phase():
    from distributed_join_tpu_torch import bench
    from distributed_join_tpu_torch.ops.join import sort_merge_inner_join
    from distributed_join_tpu_torch.ops.kernel_config import KernelConfig
    from distributed_join_tpu_torch.table import Table
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )

    record, counts = counted(lambda: bench.run(NROWS, bench.ITERS, device=DEVICE))
    print("[headline] " + json.dumps(record), flush=True)
    print(f"[headline] launches {counts}", flush=True)
    _require_launched(counts, JOIN_KERNELS, "the headline path")

    build, probe = generate_build_probe_tables(
        seed=SEED, build_nrows=NROWS, probe_nrows=NROWS,
        selectivity=bench.SELECTIVITY, device=DEVICE)
    match_out = int(bench.MATCHES_PER_ROW * NROWS * bench.OUT_SLACK)
    contract_out = int(NROWS * 1.2)
    digests = {}
    for label, out_cap in (("match_sized", match_out),
                           ("contract", contract_out)):
        k = sort_merge_inner_join(build, probe, "key", out_cap)
        p = sort_merge_inner_join(build, probe, "key", out_cap,
                                  kernel_config=KernelConfig("plain"))
        _check(not bool(k.overflow), f"headline {label} join overflowed")
        _check(int(k.total) == int(p.total) == record["matches_per_join"],
               f"headline {label} totals differ")
        dk, dp = row_digest(k), row_digest(p)
        print(f"[headline] {label}: out_cap={out_cap} total={int(k.total)} "
              f"digest kernel={dk} plain={dp}", flush=True)
        _check(dk == dp, f"headline {label} digest differs from the plain "
                         "path")
        digests[label] = dk
        del k, p

    # a small join on the card against the CPU path (held against the
    # JAX package by the CPU tests)
    sb, sp = generate_build_probe_tables(seed=7, build_nrows=20_000,
                                         probe_nrows=30_000, rand_max=5_000,
                                         device=DEVICE)
    g = sort_merge_inner_join(sb, sp, "key", 200_000)
    cpu = [Table({n: c.cpu() for n, c in t.columns.items()}, t.valid.cpu())
           for t in (sb, sp)]
    c = sort_merge_inner_join(*cpu, "key", 200_000)
    _check(row_digest(g) == row_digest(c) and int(g.total) == int(c.total)
           > 0, "small join on the card differs from the CPU path")
    print(f"[headline] small join vs CPU path: total={int(g.total)} equal",
          flush=True)
    return record, counts, digests


def record_mode_phase():
    from distributed_join_tpu_torch.ops.join import sort_merge_inner_join
    from distributed_join_tpu_torch.ops.kernel_config import KernelConfig
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )
    build, probe = generate_build_probe_tables(
        seed=SEED, build_nrows=NROWS, probe_nrows=NROWS, device=DEVICE)
    out_cap = int(NROWS * 0.75)
    k, counts = counted(lambda: sort_merge_inner_join(
        build, probe, "key", out_cap, build_payload=[]))
    p = sort_merge_inner_join(build, probe, "key", out_cap, build_payload=[],
                              kernel_config=KernelConfig("plain"))
    _check(counts["expand_gather"] > 0 and counts["join_scans"] > 0,
           f"no-build-payload join launched {counts}")
    _check(not bool(k.overflow) and int(k.total) == int(p.total),
           "no-build-payload join: totals differ or overflow")
    _check(row_digest(k) == row_digest(p),
           "no-build-payload join differs from the plain path")
    print(f"[record-mode] total={int(k.total)} launches {counts} equal",
          flush=True)
    return counts


def emulated_phase():
    from distributed_join_tpu_torch.parallel.communicator import (
        EmulatedCommunicator,
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        distributed_inner_join,
    )
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )
    build, probe = generate_build_probe_tables(
        seed=SEED, build_nrows=EMU_ROWS, probe_nrows=EMU_ROWS, device=DEVICE)
    t0 = time.perf_counter()
    multi, counts = counted(lambda: distributed_inner_join(
        build, probe, EmulatedCommunicator(EMU_RANKS), auto_retry=2))
    wall = time.perf_counter() - t0
    one = distributed_inner_join(build, probe, LocalCommunicator(),
                                 auto_retry=2)
    _check(not bool(multi.overflow) and not bool(one.overflow),
           "emulated join overflowed")
    _check(int(multi.total) == int(one.total) > 0,
           "emulated 4-rank total differs from 1 rank")
    _check(row_digest(multi) == row_digest(one),
           "emulated 4-rank rows differ from 1 rank")
    _require_launched(counts, JOIN_KERNELS, "the emulated path")
    print(f"[emulated] {EMU_RANKS} ranks on one card: total="
          f"{int(multi.total)} equal to 1 rank; wall {wall:.3f} s "
          f"(host clock, first call); launches {counts}", flush=True)
    return counts


def _config3_args(skew_on: bool, rows: int | None = None):
    """The config driver's arguments for BASELINE config 3: with the skew
    path on, the driver's auto-policy sets threshold 0.001 and the HH
    probe block; the HH output block is 48 M of 50 M (scaled with rows)."""
    from distributed_join_tpu_torch.benchmarks import distributed_join as D
    rows = CONFIG3_ROWS if rows is None else rows
    argv = ["--communicator", "local", "--build-table-nrows", str(rows),
            "--probe-table-nrows", str(rows), "--zipf-alpha",
            str(ZIPF_ALPHA), "--hh-slots", "64", "--iterations", "4"]
    if skew_on:
        argv += ["--hh-out-capacity",
                 str(CONFIG3_HH_OUT * rows // CONFIG3_ROWS)]
    else:
        argv += ["--skew-threshold", "0"]
    return D.parse_args(argv)


def skew_site_row(build, probe, args) -> dict:
    """B5 at the skew call site, on the config-3 tables: the compaction
    of the row iota under the HH build mask at capacity 2048 (the HH
    build broadcast, the one skew-site shape config 3 launches), with
    the library call iota[mask][:cap]. The HH probe mask at n/8 (the
    generic HH probe block, which config 3's policy does not use: its
    block covers every local row, and extract_prefix sorts) is checked
    and timed too, on a log line of its own that the kernels line does
    not carry. The bound reads each mask byte and each kept survivor's
    lane, and writes the kept lanes (no pos byte, as at the join
    sites)."""
    from distributed_join_tpu_torch.benchmarks import distributed_join as D
    from distributed_join_tpu_torch.ops import compact
    from distributed_join_tpu_torch.ops.hashing import hash_columns
    from distributed_join_tpu_torch.parallel import skew
    from distributed_join_tpu_torch.parallel.communicator import (
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        HH_BUILD_SLOTS_PER_HH,
    )

    thr = D.skew_policy(args, 1)[0]
    bh = hash_columns([build.columns["key"]]).view(torch.uint64)
    ph = hash_columns([probe.columns["key"]]).view(torch.uint64)
    hh = skew.global_heavy_hitters(
        LocalCommunicator(), ph, probe.valid, args.hh_slots,
        threshold=int(thr * probe.capacity))
    n = probe.capacity
    iota = torch.arange(n, dtype=torch.int64, device=probe.device)
    sites = (("stream_compact[skew]", skew.mark_heavy(bh, hh) & build.valid,
              args.hh_slots * HH_BUILD_SLOTS_PER_HH),
             ("stream_compact[skew, HH probe at n/8, off the path]",
              skew.mark_heavy(ph, hh) & probe.valid, n // 8))
    del bh, ph
    rows = []
    for name, mask, cap in sites:
        pos = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1
        surv = int(mask.sum())  # noqa: DJL004
        kept = min(surv, cap)
        print(f"[config3] {name}: {surv} survivors, capacity {cap}",
              flush=True)
        _check(surv > 0, f"config 3 found no heavy hitters ({name})")
        got = compact.stream_compact(mask, pos, [iota], cap)
        want = compact.stream_compact_reference(mask, pos, [iota], cap)
        check_and_time(
            rows, name, "distributed_join_tpu_torch/csrc/stream_compact.cu",
            "distributed_join_tpu/ops/compact_pallas.py:62 (_compact_kernel), "
            "called from distributed_join_tpu/parallel/skew.py:252-269",
            [got[0][:kept]], [want[0][:kept]], None,
            lambda m=mask, p=pos, c=cap: compact.stream_compact(
                m, p, [iota], c),
            lambda m=mask, p=pos, c=cap: compact.stream_compact_reference(
                m, p, [iota], c),
            lambda m=mask, c=cap: iota[m][:c],
            nbytes=n + 2 * 8 * kept, ops=2 * n)
        del got, want, pos
    return rows[0]


def config3_phase():
    """BASELINE config 3 through the config driver, skew on and naive;
    then the skew join's rows against the naive join's, each through the
    kernels and through the plain twins, on the same tables."""
    from distributed_join_tpu_torch.benchmarks import distributed_join as D
    from distributed_join_tpu_torch.ops.kernel_config import KernelConfig
    from distributed_join_tpu_torch.parallel.communicator import (
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        make_join_step,
    )

    skew_args, naive_args = _config3_args(True), _config3_args(False)
    torch.cuda.empty_cache()
    rec, counts = counted(lambda: D.run(skew_args, device=DEVICE))
    print("[config3] skew " + json.dumps(rec), flush=True)
    print(f"[config3] skew launches {counts}", flush=True)
    torch.cuda.empty_cache()
    naive, ncounts = counted(lambda: D.run(naive_args, device=DEVICE))
    print("[config3] naive " + json.dumps(naive), flush=True)
    print(f"[config3] peak_memory_bytes skew={rec.get('peak_memory_bytes')} "
          f"naive={naive.get('peak_memory_bytes')} (each driver run alone "
          "on the card)", flush=True)
    rows = skew_args.build_table_nrows
    for label, r in (("skew", rec), ("naive", naive)):
        _check(not r["overflow"], f"config 3 {label} join overflowed")
        _check(r["matches_per_join"] == rows,
               f"config 3 {label}: {r['matches_per_join']} matches, "
               f"expected {rows}")
    _require_launched(counts, JOIN_KERNELS + ("extract_prefix",),
                      "the config-3 skew path")
    _require_launched(ncounts, JOIN_KERNELS, "the config-3 naive path")

    build, probe, _ = D.make_tables(skew_args, torch.device(DEVICE))
    row = skew_site_row(build, probe, skew_args)
    torch.cuda.empty_cache()

    # the rows: one untimed join of each kind on the unshifted tables,
    # through the kernels and through the plain twins (the plain skew
    # join's extract_prefix takes its sort branch: no kernel at all)
    comm = LocalCommunicator()
    thr, hh_probe, hh_out, _ = D.skew_policy(skew_args, 1)
    digests = {}
    for label, opts in (("skew", dict(skew_threshold=thr,
                                      hh_slots=skew_args.hh_slots,
                                      hh_probe_capacity=hh_probe,
                                      hh_out_capacity=hh_out)),
                        ("naive", {})):
        for route in ("kernel", "plain"):
            res = make_join_step(comm, key="key",
                                 kernel_config=KernelConfig(route),
                                 **opts)(build, probe)
            _check(not bool(res.overflow) and int(res.total) == rows,
                   f"config 3 {label} {route} digest join: total "
                   f"{int(res.total)}")
            digests[f"{label}/{route}"] = row_digest(res)
            del res
            torch.cuda.empty_cache()
    print(f"[config3] digests {digests}", flush=True)
    _check(len(set(digests.values())) == 1,
           "config 3: the skew and naive joins, through the kernels and "
           "through the plain twins, do not give the same rows")
    return row, counts


def zipf_emulated_phase():
    """The naive-overflows / skew-fits pair on 4 emulated ranks: JAX's
    test_zipf_skew_relieves_shuffle_padding, on the card."""
    from distributed_join_tpu_torch.benchmarks import distributed_join as D
    from distributed_join_tpu_torch.parallel.communicator import (
        EmulatedCommunicator,
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        distributed_inner_join,
    )

    args = _config3_args(True, EMU_ROWS)
    build, probe, _ = D.make_tables(args, torch.device(DEVICE))
    thr, hh_probe, hh_out, _ = D.skew_policy(args, EMU_RANKS)
    sizing = dict(shuffle_capacity_factor=ZIPF_EMU_FACTOR,
                  out_capacity_factor=2.0)
    one = distributed_inner_join(build, probe, LocalCommunicator(),
                                 auto_retry=2, **sizing)
    naive, ncounts = counted(lambda: distributed_inner_join(
        build, probe, EmulatedCommunicator(EMU_RANKS), auto_retry=2,
        **sizing))
    skewed, scounts = counted(lambda: distributed_inner_join(
        build, probe, EmulatedCommunicator(EMU_RANKS), skew_threshold=thr,
        hh_slots=args.hh_slots, hh_probe_capacity=hh_probe,
        hh_out_capacity=hh_out, **sizing))
    trail = naive.retry_report
    print(f"[zipf-emulated] naive attempts "
          f"{[a.overflow for a in trail.attempts]}; skew attempts "
          f"{[a.overflow for a in skewed.retry_report.attempts]}",
          flush=True)
    _check(trail.attempts[0].overflow and trail.resolved,
           "naive Zipf join: the first attempt did not overflow, or the "
           "ladder did not relieve it")
    _check(skewed.retry_report.n_attempts == 1 and not bool(skewed.overflow),
           "skew Zipf join overflowed on its first attempt")
    d1 = row_digest(one)
    for label, r in (("naive", naive), ("skew", skewed)):
        _check(int(r.total) == int(one.total) == EMU_ROWS
               and row_digest(r) == d1,
               f"emulated Zipf {label} join differs from the 1-rank join")
    _require_launched(ncounts, JOIN_KERNELS, "the emulated naive Zipf path")
    _require_launched(scounts, JOIN_KERNELS + ("extract_prefix",),
                      "the emulated skew Zipf path")
    print(f"[zipf-emulated] {EMU_RANKS} ranks, factor {ZIPF_EMU_FACTOR}: "
          f"total={int(one.total)}, both equal to 1 rank; launches naive "
          f"{ncounts} skew {scounts}", flush=True)


def entry_points_phase(build, probe) -> dict:
    """B6 and B7 through their own entry points, each call counted on
    its own, at phase 2's shapes."""
    from distributed_join_tpu_torch.ops import expand
    from distributed_join_tpu_torch.ops.merge_sort import merged_sort

    x = stage_inputs(build, probe, int(0.6 * NROWS * 1.25))
    key, tag, val = x["sort_ops"]
    S, lo, rc, pk, cap = x["S"], x["lo"], x["rec_cols"], x["pack"], \
        x["out_cap"]
    calls = {
        "merge_sort[key+tag]": (lambda: merged_sort((key, tag, val), 2),
                                "merge_sort_planes"),
        "merge_sort[key]": (lambda: merged_sort((key, val), 1),
                            "merge_sort_planes"),
        "expand_pull[build]": (lambda: expand.expand_pull(
            S, rc, cap, lo=lo, build_cols=pk), "expand_pull"),
        "expand_pull[record]": (lambda: expand.expand_pull(S, rc, cap),
                                "expand_pull"),
    }
    launches = {}
    for name, (fn, wrapper) in calls.items():
        _, counts = counted(fn)
        _check(counts[wrapper] > 0, f"{name}: {wrapper} was not launched")
        launches[name] = counts[wrapper]
    print(f"[entry-points] launches {launches}", flush=True)
    return launches


# -- phases 9-11: the scan's int32 domain, config 5, types and strings --


def c1_phase() -> dict:
    """One ``join_scans`` call on C1_POSITIONS positions of runs
    [build, build, probe, probe]: every output has a closed form in the
    run index r = i // 4, checked exactly chunk by chunk, past the old
    2^30 - 1 limit too. Device time by CUDA events; the bound reads tag
    and first and writes six int32 outputs, 26 B a position."""
    from distributed_join_tpu_torch.ops import scan

    n = C1_POSITIONS
    dev = torch.device(DEVICE)
    tag = torch.tensor([0, 0, 1, 1], dtype=torch.int8, device=dev).repeat(
        n // 4)
    first = torch.tensor([1, 0, 0, 0], dtype=torch.bool, device=dev).repeat(
        n // 4)
    outs = scan.join_scans(tag, first)
    torch.cuda.synchronize()
    # per position of a run (b, b, p, p): value = a * r + c
    forms = {"matched": ((0, 1), (0, 1), (0, 0), (0, 0)),
             "cnt": ((0, 0), (0, 0), (0, 2), (0, 2)),
             "start_out": ((4, 0), (4, 0), (4, 0), (4, 2)),
             "lo_m": ((2, 0), (2, 0), (2, 0), (2, 0)),
             "rec_pos": ((2, -1), (2, -1), (2, 0), (2, 1)),
             "mb_pos": ((2, 0), (2, 1), (2, 1), (2, 1))}
    chunk = 1 << 26
    for lo in range(0, n, chunk):
        i = torch.arange(lo, min(n, lo + chunk), device=dev)
        r, q = i // 4, i % 4
        for name, per_q in forms.items():
            a = torch.tensor([f[0] for f in per_q], device=dev)[q]
            c = torch.tensor([f[1] for f in per_q], device=dev)[q]
            _check(torch.equal(outs[name][lo:lo + chunk],
                               (a * r + c).to(torch.int32)),
                   f"join_scans at {n} positions: {name} differs from its "
                   f"closed form in [{lo}, {lo + chunk})")
    del outs
    torch.cuda.empty_cache()
    ms = time_ms(lambda: scan.join_scans(tag, first), reps=3)
    b, by = bound_ms(26 * n, 40 * n)
    print(f"[c1] join_scans on {n} positions (2^30 + 2^20): all six "
          f"outputs equal their closed forms; ms={ms:.4f} bound_ms={b:.4f} "
          f"({by}, 26 B a position)", flush=True)
    del tag, first
    torch.cuda.empty_cache()
    return {"positions": n, "ms": ms, "bound_ms": b}


def _driver_and_digest(label: str, argv: list) -> dict:
    """The config driver's protocol on ``argv`` (counted: every join
    kernel launched, no overflow), then one join of its tables through
    the kernel pipeline and one through the plain formulation, whose row
    digests (2-D byte columns included) must be equal. Returns the
    launch counts of the driver's run."""
    from distributed_join_tpu_torch.benchmarks import distributed_join as D
    from distributed_join_tpu_torch.ops.kernel_config import KernelConfig
    from distributed_join_tpu_torch.parallel.communicator import (
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        make_join_step,
    )

    args = D.parse_args(["--communicator", "local", "--iterations", "4",
                         *argv])
    torch.cuda.empty_cache()
    rec, counts = counted(lambda: D.run(args, device=DEVICE))
    print(f"[{label}] " + json.dumps(rec), flush=True)
    print(f"[{label}] launches {counts}", flush=True)
    _check(not rec["overflow"], f"{label}: the driver's join overflowed")
    _require_launched(counts, JOIN_KERNELS, f"the {label} path")
    build, probe, key = D.make_tables(args, torch.device(DEVICE))
    digests = {}
    for route in ("kernel", "plain"):
        res = make_join_step(LocalCommunicator(), key=key,
                             kernel_config=KernelConfig(route))(build, probe)
        _check(not bool(res.overflow) and int(res.total)
               == rec["matches_per_join"],
               f"{label} {route} digest join: total {int(res.total)}")
        digests[route] = row_digest(res)
        del res
        torch.cuda.empty_cache()
    print(f"[{label}] digests {digests}", flush=True)
    _check(digests["kernel"] == digests["plain"],
           f"{label}: the kernel pipeline and the plain formulation give "
           "different rows")
    return counts


def config5_phase() -> dict:
    """BASELINE config 5 (scripts/run_baseline_configs.sh:58-63) at its
    size: a 2-column composite key and a 16-byte string payload."""
    rows = str(CONFIG5_ROWS)
    return _driver_and_digest("config5", [
        "--build-table-nrows", rows, "--probe-table-nrows", rows,
        "--key-columns", "2", "--string-payload-bytes", "16"])


def types_phase() -> dict:
    """The headline in float64 keys and payloads, a 16-byte string key,
    and a float32 join whose keys stay below 2^24."""
    counts = {}
    for label, rows, argv in (
            ("float64", NROWS, ["--key-type", "float64",
                                "--payload-type", "float64"]),
            ("string-key", STRING_KEY_ROWS, ["--string-key-bytes", "16"]),
            ("float32", FLOAT32_ROWS, ["--key-type", "float32",
                                       "--payload-type", "float32"])):
        counts[label] = _driver_and_digest(label, [
            "--build-table-nrows", str(rows), "--probe-table-nrows",
            str(rows), *argv])
    return counts


def emulated_strings_phase() -> None:
    """4 emulated ranks at EMU_ROWS x EMU_ROWS: a composite key of a
    16-byte string key and an int64 column, with a 16-byte string
    payload; equal to the 1-rank join (results, not speed)."""
    from distributed_join_tpu_torch.parallel.communicator import (
        EmulatedCommunicator,
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        distributed_inner_join,
    )
    from distributed_join_tpu_torch.table import Table
    from distributed_join_tpu_torch.utils.generators import (
        generate_composite_build_probe_tables,
    )
    from distributed_join_tpu_torch.utils.strings import encode_int_strings

    build, probe, _ = generate_composite_build_probe_tables(
        seed=SEED, build_nrows=EMU_ROWS, probe_nrows=EMU_ROWS,
        key_columns=2, string_payload_len=16, device=DEVICE)

    def stringify(t):
        cols = dict(t.columns)
        cols["skey"], cols["skey#len"] = encode_int_strings(
            cols.pop("key0"), prefix="itm-", digits=12)
        return Table(cols, t.valid)

    build, probe = stringify(build), stringify(probe)
    opts = dict(key=["skey", "key1"], auto_retry=2)
    multi, counts = counted(lambda: distributed_inner_join(
        build, probe, EmulatedCommunicator(EMU_RANKS), **opts))
    one = distributed_inner_join(build, probe, LocalCommunicator(), **opts)
    _check(not bool(multi.overflow) and not bool(one.overflow),
           "emulated string join overflowed")
    _check(int(multi.total) == int(one.total) > 0
           and row_digest(multi) == row_digest(one),
           "emulated 4-rank string join differs from 1 rank")
    _require_launched(counts, JOIN_KERNELS, "the emulated string path")
    print(f"[emulated-strings] {EMU_RANKS} ranks: total={int(multi.total)} "
          f"equal to 1 rank (string key + int64 key, string payload); "
          f"launches {counts}", flush=True)


# -- phase 12: the join types -------------------------------------------


def expected_typed_rows(build, probe) -> dict:
    """Each type's output rows, counted from the tables alone: the
    matches by binary search of the sorted valid build keys, unmatched
    probes and builds by ``torch.isin`` on the valid keys."""
    bk = build.columns["key"][build.valid]
    pk = probe.columns["key"][probe.valid]
    sb = torch.sort(bk).values
    matches = int((torch.searchsorted(sb, pk, right=True)  # noqa: DJL004
                   - torch.searchsorted(sb, pk)).sum())
    hit_p = torch.isin(pk, bk)
    unmatched_p = int((~hit_p).sum())  # noqa: DJL004
    unmatched_b = int((~torch.isin(bk, pk)).sum())  # noqa: DJL004
    return {"left": matches + unmatched_p, "right": matches + unmatched_b,
            "full_outer": matches + unmatched_p + unmatched_b,
            "semi": int(hit_p.sum()), "anti": unmatched_p}  # noqa: DJL004


def join_kernel_ms(top: list) -> dict:
    """Device ms a join of the port's join kernels in a profile's rows
    (the compaction's two call sites share one kernel)."""
    names = {"compaction": ("compact_kernel",),
             "expand": ("expand_kernel",),
             "join_scans": ("f_pass", "r_pass")}
    return {k: sum(r["ms"] for r in top if any(p in r["name"] for p in pats))
            for k, pats in names.items()}


def captured_join_calls(fn):
    """Run ``fn`` with the join's scans, compaction and expand calls
    recorded: returns (its result, {call site: the arguments of its last
    call})."""
    from distributed_join_tpu_torch.ops import join as J
    calls = {}
    real_scans = J.join_scans
    real_compact, real_expand = J.stream_compact, J.expand_gather

    def scans(tag, first):
        calls["join_scans"] = (tag, first)
        return real_scans(tag, first)

    def compact(mask, pos, cols, capacity, launch_counter=None):
        calls[launch_counter.__name__] = (mask, pos, list(cols), capacity)
        return real_compact(mask, pos, cols, capacity,
                            launch_counter=launch_counter)

    def expand(S, cols, out_capacity, lo=None, build_cols=None):
        calls["expand_gather"] = (S, list(cols), out_capacity, lo,
                                  build_cols)
        return real_expand(S, cols, out_capacity, lo=lo,
                           build_cols=build_cols)

    J.join_scans, J.stream_compact, J.expand_gather = scans, compact, expand
    try:
        return fn(), calls
    finally:
        J.join_scans = real_scans
        J.stream_compact, J.expand_gather = real_compact, real_expand


def typed_kernel_rows(build, probe, caps) -> list:
    """The kernels at the typed joins' shapes that phase 2 does not have:
    the full outer join's record block (5 lanes: S, key, probe payload,
    build rank, side flags) and build-mode expand, the valid-build pack,
    and the anti join's record-mode expand (run length 1); each with the
    inputs one join of that type gives it, against its twin. Bounds as
    phase 2's: a compaction reads every mask byte and the kept survivors'
    lanes and writes them; an expand reads each live record (and each
    valid build row the pack holds) and writes each slot up to the
    total."""
    from distributed_join_tpu_torch.ops import compact, expand
    from distributed_join_tpu_torch.ops.join import sort_merge_inner_join
    from distributed_join_tpu_torch.ops.kernel_config import KernelConfig

    rows = []
    route = KernelConfig("kernel")
    src_c = "distributed_join_tpu_torch/csrc/stream_compact.cu"
    src_e = "distributed_join_tpu_torch/csrc/expand_gather.cu"
    rep_c = ("distributed_join_tpu/ops/compact_planes.py:53 "
             "(_compact_kernel); distributed_join_tpu/ops/compact_pallas.py:"
             "62 (_compact_kernel)")
    res, calls = captured_join_calls(lambda: sort_merge_inner_join(
        build, probe, "key", caps["full_outer"], join_type="full_outer",
        kernel_config=route))
    tot = min(int(res.total), caps["full_outer"])
    del res
    n = build.capacity + probe.capacity
    for name, site in (("stream_compact[record, full_outer]",
                        "compact_records"),
                       ("stream_compact[valid-build pack]",
                        "pack_valid_builds")):
        mask, pos, lanes, cap = calls[site]
        kept = min(int(mask.sum()), cap)  # noqa: DJL004
        lib = (lambda m=mask, packed=torch.stack(lanes, 1): packed[m])
        got = compact.stream_compact(mask, pos, lanes, cap)
        want = compact.stream_compact_reference(mask, pos, lanes, cap)
        check_and_time(
            rows, name, src_c, rep_c, got, want, kept,
            lambda m=mask, q=pos, ls=lanes, c=cap: compact.stream_compact(
                m, q, ls, c),
            lambda m=mask, q=pos, ls=lanes, c=cap:
                compact.stream_compact_reference(m, q, ls, c),
            lib, nbytes=n + 2 * kept * 8 * len(lanes), ops=n)
        del got, want, lib
    n_rec = int(calls["compact_records"][0].sum())  # noqa: DJL004
    n_valid_b = int(build.valid.sum())  # noqa: DJL004
    S, rc, cap, lo, pk = calls["expand_gather"]
    got_r, got_b = expand.expand_gather(S, rc, cap, lo=lo, build_cols=pk)
    want_r, want_b = expand.expand_gather_reference(S, rc, cap, lo=lo,
                                                    build_cols=pk)
    check_and_time(
        rows, "expand_gather[build, full_outer]", src_e,
        "distributed_join_tpu/ops/expand_pallas.py:335 (_expand_kernel_b8)",
        got_r + got_b, want_r + want_b, tot,
        lambda: expand.expand_gather(S, rc, cap, lo=lo, build_cols=pk),
        lambda: expand.expand_gather_reference(S, rc, cap, lo=lo,
                                               build_cols=pk), None,
        nbytes=n_rec * (4 + 4 + 8 * len(rc)) + n_valid_b * 8 * len(pk)
        + tot * 8 * (len(rc) + len(pk)), ops=tot * 2 * 32)
    del calls, got_r, got_b, want_r, want_b, S, rc, lo, pk
    torch.cuda.empty_cache()

    res, calls = captured_join_calls(lambda: sort_merge_inner_join(
        build, probe, "key", caps["anti"], join_type="anti",
        kernel_config=route))
    tot = min(int(res.total), caps["anti"])
    del res
    S, rc, cap, _, _ = calls["expand_gather"]
    n_rec = int(calls["compact_records"][0].sum())  # noqa: DJL004
    got_r, got_s = expand.expand_gather(S, rc, cap)
    want_r, want_s = expand.expand_gather_reference(S, rc, cap)
    run_len = torch.diff(torch.cat([
        S[:n_rec].long(), torch.tensor([tot], device=S.device)]))
    rec_pack = torch.stack(rc, 1)[:n_rec]
    check_and_time(
        rows, "expand_gather[record, anti]", src_e,
        "distributed_join_tpu/ops/expand_pallas.py:264 (_expand_kernel)",
        got_r + [got_s], want_r + [want_s], tot,
        lambda: expand.expand_gather(S, rc, cap),
        lambda: expand.expand_gather_reference(S, rc, cap),
        lambda: torch.repeat_interleave(rec_pack, run_len, dim=0,
                                        output_size=tot),
        nbytes=n_rec * (4 + 8 * len(rc)) + tot * (8 * len(rc) + 4),
        ops=tot * 2 * 32)
    del calls, rec_pack
    torch.cuda.empty_cache()
    return rows


def typed_phase():
    """The five typed joins of the headline's tables (phase 12)."""
    from distributed_join_tpu_torch import bench
    from distributed_join_tpu_torch.ops.kernel_config import KernelConfig
    from distributed_join_tpu_torch.parallel.communicator import (
        EmulatedCommunicator,
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        distributed_inner_join,
        make_join_step,
    )
    from distributed_join_tpu_torch.utils.benchmarking import (
        profile_join,
        timed_join_throughput,
    )
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )

    build, probe = generate_build_probe_tables(
        seed=SEED, build_nrows=NROWS, probe_nrows=NROWS,
        selectivity=bench.SELECTIVITY, device=DEVICE)
    want = expected_typed_rows(build, probe)
    caps = {t: int(want[t] * bench.OUT_SLACK) for t in TYPED}
    print(f"[typed] expected rows {want}; output blocks {caps}", flush=True)
    comm = LocalCommunicator()
    counts, timing = {}, {}
    for t in TYPED:
        res, c = counted(lambda: distributed_inner_join(
            build, probe, comm, join_type=t, out_rows_per_rank=caps[t]))
        _check(not bool(res.overflow) and res.retry_report.n_attempts == 1,
               f"{t} join overflowed its first rung")
        _check(int(res.total) == want[t],
               f"{t} join: total {int(res.total)}, counted {want[t]}")
        need = ["join_scans", "compact_records", "expand_gather"]
        if t not in ("semi", "anti"):
            need.append("pack_valid_builds")
        _require_launched(c, need, f"the {t} path")
        dk = row_digest(res)
        del res
        plain = distributed_inner_join(
            build, probe, comm, join_type=t, out_rows_per_rank=caps[t],
            kernel_config=KernelConfig("plain"))
        dp = row_digest(plain)
        _check(int(plain.total) == want[t] and dk == dp,
               f"{t} join: the kernel pipeline and the plain formulation "
               "give different rows")
        del plain
        torch.cuda.empty_cache()
        step = make_join_step(comm, key="key", join_type=t,
                              out_rows_per_rank=caps[t])
        sec, total, ovf = timed_join_throughput(comm, step, build, probe,
                                                TYPED_ITERS)
        _check(not ovf and total == want[t],
               f"{t} join: the timed joins gave {total} rows")
        timing[t] = sec * 1e3
        counts[t] = c
        print(f"[typed] {t}: total={want[t]} out_rows={caps[t]} "
              f"ms_per_join={sec * 1e3:.4f} "
              f"m_rows_per_sec={2 * NROWS / sec / 1e6:.1f} digest equal to "
              f"the plain formulation; launches {c}", flush=True)
        prof = profile_join(step, build, probe, joins=3, top=60)
        if t == "full_outer":
            print("[typed] full_outer profile " + json.dumps(prof),
                  flush=True)
        print(f"[typed] {t} device ms a join: busy "
              f"{prof['device_busy_ms_per_join']:.4f} of wall "
              f"{prof['host_wall_ms_per_join']:.4f}; " + ", ".join(
                  f"{k} {v:.4f}" for k, v in
                  join_kernel_ms(prof["top_kernels_ms_per_join"]).items()),
              flush=True)
    n = 2 * NROWS
    x = torch.arange(n, dtype=torch.int32, device=DEVICE) % 1000
    print(f"[typed] torch.cummax on {n} int32: "
          f"{time_ms(lambda: torch.cummax(x, 0), reps=3):.3f} ms; "
          f"torch.cumsum: {time_ms(lambda: torch.cumsum(x, 0)):.4f} ms",
          flush=True)
    del x
    rows = typed_kernel_rows(build, probe, caps)
    del build, probe
    torch.cuda.empty_cache()

    eb, ep = generate_build_probe_tables(
        seed=SEED, build_nrows=EMU_ROWS, probe_nrows=EMU_ROWS, device=DEVICE)
    for t in TYPED_EMU:
        multi, c = counted(lambda: distributed_inner_join(
            eb, ep, EmulatedCommunicator(EMU_RANKS), join_type=t,
            auto_retry=2))
        one = distributed_inner_join(eb, ep, comm, join_type=t,
                                     auto_retry=2)
        _check(not bool(multi.overflow) and not bool(one.overflow),
               f"emulated {t} join overflowed")
        _check(int(multi.total) == int(one.total) > 0
               and row_digest(multi) == row_digest(one),
               f"emulated 4-rank {t} join differs from 1 rank")
        _require_launched(c, ("compact_records", "expand_gather"),
                          f"the emulated {t} path")
        print(f"[typed-emulated] {EMU_RANKS} ranks: {t} total="
              f"{int(multi.total)} equal to 1 rank (attempts "
              f"{multi.retry_report.n_attempts}); launches {c}", flush=True)
    return counts, timing, rows


# -- phase 13: the join over NCCL, one process a card ---------------------


NCCL_SITES = ("join_scans", "compact_records", "pack_matched_builds",
              "pack_valid_builds", "expand_gather")
NCCL_K = 4                     # over-decomposition of the worker's join
NCCL_RESIDENT_AB = 2           # phase 18(f): the resident A/B over NCCL
A2A_MIB = (64, 256)
NCCL_TIMEOUT_S = 600


def _launch(n: int, argv: list, timeout: float = NCCL_TIMEOUT_S):
    """``python <argv>`` on ``n`` processes, one a card, through the
    port's launcher (NCCL), from this script's directory. The rendezvous
    port is one the OS hands a wildcard bind; a job whose store still
    finds it taken (a socket of an earlier job in TIME_WAIT on it) runs
    once more on another."""
    import signal
    import socket
    import subprocess
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    for attempt in range(2):
        with socket.socket() as sk:
            sk.bind(("", 0))
            port = sk.getsockname()[1]
        cmd = [sys.executable, "-m",
               "distributed_join_tpu_torch.benchmarks.launch",
               "--num-processes", str(n), "--coordinator",
               f"localhost:{port}", "--", sys.executable, *argv]
        # a session of its own, so that a timeout stops every rank with it
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, cwd=root,
                                env=env, start_new_session=True)
        try:
            out, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
            _fail(f"the launched job {argv[:3]} passed {timeout} s")
        if proc.returncode == 0 or "EADDRINUSE" not in err or attempt:
            return subprocess.CompletedProcess(cmd, proc.returncode, out,
                                               err)
        print(f"[launch] port {port} was taken; once more on another",
              flush=True)


def _launched_record(label: str, n: int, argv: list) -> dict:
    """The JSON record rank 0 printed last; fails the phase if any rank
    failed (the launcher's exit code)."""
    r = _launch(n, argv)
    if r.returncode != 0:
        print(r.stderr[-6000:], file=sys.stderr, flush=True)
        _fail(f"{label}: the launched job exited with {r.returncode}")
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    _check(len(lines) == 1, f"{label}: {len(lines)} records on stdout "
                            "(rank 0 alone prints one)")
    for ln in r.stdout.splitlines():
        if ln.strip() and not ln.startswith("{"):
            print(f"[nccl] {label}: {ln}", flush=True)
    return json.loads(lines[0])


def bucket_kernel_rows(calls, label: str = "nccl bucket") -> list:
    """The join kernels at the shapes one bucket of the NCCL path (or
    one batch of the config-4 path: ``label``) gives them: the inputs
    the last local join passed to the scans, both compaction sites and
    the build-mode expand (``calls``, from ``captured_join_calls``),
    each held against its twin. The buckets arrive padded (the shuffle's
    capacity factor), so the merged domain is not the headline's. Bounds
    as phase 2's."""
    from distributed_join_tpu_torch.ops import compact, expand, scan

    rows = []
    tag, first = calls["join_scans"]
    n = tag.shape[0]
    got = scan.join_scans(tag, first)
    want = scan.join_scans_reference(tag, first)
    check_and_time(
        rows, f"join_scans[{label}]",
        "distributed_join_tpu_torch/csrc/join_scans.cu",
        "distributed_join_tpu/ops/scan_pallas.py:106,150 "
        "(_scan_r_kernel, _scan_f_kernel)",
        [got[k] for k in scan.NAMES], [want[k] for k in scan.NAMES], None,
        lambda: scan.join_scans(tag, first),
        lambda: scan.join_scans_reference(tag, first), None,
        nbytes=2 * n + 6 * 4 * n, ops=40 * n)
    total = int(want["cnt"].sum(dtype=torch.int64))  # noqa: DJL004
    del got, want
    kept = {}
    for name, site in ((f"stream_compact[record, {label}]",
                        "compact_records"),
                       (f"stream_compact[pack, {label}]",
                        "pack_matched_builds")):
        mask, pos, lanes, cap = calls[site]
        kept[site] = min(int(mask.sum()), cap)  # noqa: DJL004
        lib = (lambda m=mask, packed=torch.stack(lanes, 1): packed[m])
        got = compact.stream_compact(mask, pos, lanes, cap)
        want = compact.stream_compact_reference(mask, pos, lanes, cap)
        check_and_time(
            rows, name, "distributed_join_tpu_torch/csrc/stream_compact.cu",
            "distributed_join_tpu/ops/compact_planes.py:53 (_compact_kernel)"
            "; distributed_join_tpu/ops/compact_pallas.py:62 "
            "(_compact_kernel)",
            got, want, kept[site],
            lambda m=mask, q=pos, ls=lanes, c=cap: compact.stream_compact(
                m, q, ls, c),
            lambda m=mask, q=pos, ls=lanes, c=cap:
                compact.stream_compact_reference(m, q, ls, c),
            lib, nbytes=n + 2 * kept[site] * 8 * len(lanes), ops=n)
        del got, want, lib
    S, rc, cap, lo, pk = calls["expand_gather"]
    tot = min(total, cap)
    got_r, got_b = expand.expand_gather(S, rc, cap, lo=lo, build_cols=pk)
    want_r, want_b = expand.expand_gather_reference(S, rc, cap, lo=lo,
                                                    build_cols=pk)
    check_and_time(
        rows, f"expand_gather[build, {label}]",
        "distributed_join_tpu_torch/csrc/expand_gather.cu",
        "distributed_join_tpu/ops/expand_pallas.py:335 (_expand_kernel_b8)",
        got_r + got_b, want_r + want_b, tot,
        lambda: expand.expand_gather(S, rc, cap, lo=lo, build_cols=pk),
        lambda: expand.expand_gather_reference(S, rc, cap, lo=lo,
                                               build_cols=pk), None,
        nbytes=kept["compact_records"] * (4 + 4 + 8 * len(rc))
        + kept["pack_matched_builds"] * 8 * len(pk)
        + tot * 8 * (len(rc) + len(pk)), ops=tot * 2 * 32)
    for r in rows:
        r["merged_positions"] = n
    return rows


def partition_shuffle_ms(comm, build, probe, shuffle: str = "padded",
                         compression_bits=None,
                         dcn_codec_on: bool = False) -> tuple:
    """The partition and the shuffle of one join at over-decomposition
    ``NCCL_K`` on the wire ``shuffle`` (with ``compression_bits``, the
    codec; on the hierarchical wire ``dcn_codec_on`` puts it on the
    cross-slice hop, 16 bits without ``compression_bits``), with no
    local join: the step's own calls
    (parallel/distributed_join.py ``make_join_step``, ``_batch_shuffle``)
    at its default capacity factor. Returns, each the slowest rank's: the
    ms a call as ``time_ms`` times it (host gaps and the ragged wire's
    host reads included), and the device ms of its kernels as
    ``device_ms`` sums them, NCCL's apart (an NCCL kernel also counts
    the time it waits for a peer)."""
    import math

    from distributed_join_tpu_torch.ops.partition import (
        radix_hash_partition,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        DEFAULT_SHUFFLE_CAPACITY_FACTOR,
        _batch_shuffle,
        _round_up,
    )
    n = comm.n_ranks
    nb = NCCL_K * n

    def step(b_local, p_local):
        rows = 0
        for t in (b_local, p_local):
            cap = _round_up(int(math.ceil(
                t.capacity / nb * DEFAULT_SHUFFLE_CAPACITY_FACTOR)), 8)
            pt = radix_hash_partition(t, ["key"], nb)
            for b in range(NCCL_K):
                recv, _ = _batch_shuffle(comm, pt, b, n, cap, mode=shuffle,
                                         compression_bits=compression_bits,
                                         dcn_codec_on=dcn_codec_on)
                rows += recv.capacity
        return torch.tensor([rows], device=b_local.valid.device)

    fn = comm.spmd(step, sharded_out=True)
    ms = comm.host_max(time_ms(lambda: fn(build, probe)))
    # the first profiler of a process starts CUPTI, which stalls this
    # rank while its peers' NCCL kernels wait: that run is not kept
    device_ms(lambda: fn(build, probe), reps=1, sessions=1)
    _, parts = device_ms(lambda: fn(build, probe), sessions=1)
    nccl = sum(v for k, v in parts.items() if "nccl" in k.lower())
    other = sum(parts.values()) - nccl
    return ms, comm.host_max(other), comm.host_max(nccl)


def _worker_drivers(drivers: dict) -> dict:
    """The join driver (benchmarks/distributed_join.py, its ``run`` or,
    with ``--profile``, its ``profile``) on each ``{label: argv}`` in
    turn, in this process and its process group: one launch serves a
    phase's driver runs. Returns rank 0's records (None elsewhere)."""
    from distributed_join_tpu_torch.benchmarks import distributed_join as D
    from distributed_join_tpu_torch.parallel.bootstrap import process_id
    rank0 = process_id() == 0
    out = {}
    for label, argv in drivers.items():
        t = time.perf_counter()
        args = D.parse_args(argv)
        out[label] = D.profile(args) if args.profile else D.run(args)
        torch.cuda.empty_cache()
        if rank0:
            print(f"driver {label}: {time.perf_counter() - t:.1f} s",
                  flush=True)
    return out if rank0 else None


def _worker_join(comm, build, probe) -> dict:
    """Phase 13(b) on this rank: one counted ``distributed_inner_join``
    of the global tables at ``NCCL_K``, this rank's digest and counts
    gathered to rank 0, rank 0's kernel checks at a bucket's shapes, and
    the partition and shuffle timed alone."""
    from distributed_join_tpu_torch.parallel.distributed_join import (
        distributed_inner_join,
    )
    rank0 = comm.axis_index() == 0
    join = (lambda: distributed_inner_join(
        build, probe, comm, over_decomposition=NCCL_K))
    if rank0:
        (res, counts), calls = captured_join_calls(lambda: counted(join))
    else:
        res, counts = counted(join)
    digest = row_digest(res)
    mine = torch.tensor([[*digest, int(res.total), int(res.overflow),
                          *(counts[s] for s in NCCL_SITES)]],
                        dtype=torch.int64, device=comm.device)
    del res
    # rank 0's kernel checks launch nothing on the path: its counts are
    # read above; the other ranks wait at the next collective
    rows = bucket_kernel_rows(calls) if rank0 else []
    if rank0:
        del calls
    ps_ms = partition_shuffle_ms(comm, build, probe)
    every = comm.all_gather(mine).tolist()
    return {"ranks": [
        {"digest": v[:3], "total": v[3], "overflow": bool(v[4]),
         "launches": dict(zip(NCCL_SITES, v[5:]))} for v in every],
        "bucket_rows": rows, "partition_shuffle_ms": ps_ms}


def _worker_wires(comm, build, probe, wires: dict) -> dict:
    """Phases 14 and 16 on this rank: for each wire, one counted
    ``distributed_inner_join`` at ``NCCL_K`` (digest, launch counts,
    this rank's host reads, wire rows and bytes, gathered to rank 0),
    then the wire's partition and shuffle alone."""
    from distributed_join_tpu_torch.parallel.communicator import (
        make_communicator,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        distributed_inner_join,
    )
    out = {}
    for mode, opts in wires.items():
        opts = dict(opts)
        slices = opts.pop("slices", None)
        c = comm if slices is None else make_communicator("nccl",
                                                          n_slices=slices)
        before = c.counters()
        res, counts = counted(lambda: distributed_inner_join(
            build, probe, c, over_decomposition=NCCL_K, **opts))
        after = c.counters()
        mine = torch.tensor([[*row_digest(res), int(res.total),
                              int(res.overflow),
                              *(counts[s] for s in NCCL_SITES),
                              *(after[k] - before[k] for k in after)]],
                            dtype=torch.int64, device=comm.device)
        del res
        ps = partition_shuffle_ms(c, build, probe,
                                  opts.get("shuffle", "padded"),
                                  opts.get("compression_bits"),
                                  opts.get("dcn_codec") == "on")
        every = comm.all_gather(mine).tolist()
        out[mode] = {"ranks": [
            {"digest": v[:3], "total": v[3], "overflow": bool(v[4]),
             "launches": dict(zip(NCCL_SITES, v[5:5 + len(NCCL_SITES)])),
             "counters": dict(zip(before, v[5 + len(NCCL_SITES):]))}
            for v in every], "partition_shuffle_ms": ps}
    return out


def nccl_rank_worker(job: dict) -> int:
    """One rank of a launched NCCL phase (13, 14 or 16), started by the
    launcher with a JSON job: ``drivers`` (``{label: argv}`` of the join
    driver, each run in this process: one launch a phase), ``join``
    (phase 13's counted join and kernel checks) and ``wires`` (``{mode:
    join options}``: phases 14 and 16). The global tables are ``NROWS``
    rows a rank from the seed; launch counts are set to zero just before
    each join and read just after. Rank 0 prints one JSON line with
    every part's results."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from distributed_join_tpu_torch.parallel.bootstrap import (
        maybe_initialize_from_env,
    )
    from distributed_join_tpu_torch.parallel.communicator import (
        make_communicator,
    )
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )
    _check(maybe_initialize_from_env(), "the worker runs under the launcher")
    comm = make_communicator("nccl")
    n = comm.n_ranks
    out = {"drivers": _worker_drivers(job.get("drivers", {}))}
    if job.get("tpch"):
        # the config-4 driver's queries in this process group (phase 17's
        # Q10 over NCCL at SF-1 rides phase 13's launch)
        from distributed_join_tpu_torch.benchmarks import tpch_join
        from distributed_join_tpu_torch.parallel.bootstrap import process_id
        out["tpch"] = {}
        for label, targv in job["tpch"].items():
            rec = tpch_join.run(tpch_join.parse_args(targv))
            out["tpch"][label] = rec if process_id() == 0 else None
            torch.cuda.empty_cache()
    if job.get("a2a_refusal"):
        # the all-to-all benchmark's run over this world (of one card):
        # its refusal, raised before it touches the card
        from distributed_join_tpu_torch.benchmarks import all_to_all
        try:
            all_to_all.run(all_to_all.parse_args(job["a2a_refusal"]))
            out["a2a_refusal"] = None
        except SystemExit as exc:
            out["a2a_refusal"] = str(exc)
    if job.get("session_digest"):
        # the session's cost first, before any profiler in this process
        build, probe = generate_build_probe_tables(
            seed=SEED, build_nrows=NROWS * n, probe_nrows=NROWS * n,
            unique_build_keys=True, device=comm.device)
        out["session_ab_ms"] = _worker_session_ab(
            comm, build, probe, job["session_digest"])
        del build, probe
        torch.cuda.empty_cache()
    if job.get("telemetry"):
        out["telemetry"] = _worker_telemetry(job["telemetry"])
    if job.get("session_digest"):
        build, probe = generate_build_probe_tables(
            seed=SEED, build_nrows=NROWS * n, probe_nrows=NROWS * n,
            unique_build_keys=True, device=comm.device)
        out["session_digest"] = _worker_session_digest(
            comm, build, probe, job["session_digest"])
        del build, probe
    if job.get("join") or job.get("wires"):
        build, probe = generate_build_probe_tables(
            seed=SEED, build_nrows=NROWS * n, probe_nrows=NROWS * n,
            unique_build_keys=True, device=comm.device)
        if job.get("join"):
            out.update(_worker_join(comm, build, probe))
        if job.get("wires"):
            out["wires"] = _worker_wires(comm, build, probe, job["wires"])
    if comm.axis_index() == 0:
        print(json.dumps(out), flush=True)
    comm.finalize()
    return 0


def _worker_record(label: str, n: int, job: dict) -> dict:
    """Launch ``n`` worker ranks with ``job``; rank 0's JSON line."""
    return _launched_record(label, n, [os.path.abspath(__file__),
                                       "--nccl-rank-worker", json.dumps(job)])


def _driver_argv(rows: int, *flags) -> list:
    """The join driver's flags over NCCL at ``rows`` x ``rows`` global
    rows (config 2's shape a rank)."""
    return ["--communicator", "nccl", "--build-table-nrows", str(rows),
            "--probe-table-nrows", str(rows), *flags]


def _combine_digests(digests) -> tuple:
    """Per-rank row digests as one: rows and hash sums add (the sum
    wrapping in 64 bits, as ``row_digest``'s), xors fold."""
    rows, total, x = 0, 0, 0
    for d in digests:
        rows += d[0]
        total = (total + d[1] + 2**63) % 2**64 - 2**63
        x ^= d[2]
    return rows, total, x


def nccl_phase() -> dict:
    """Phase 13: the port's driver over NCCL on every card, one process
    a card (a world of 1 on a one-card machine), at ``NROWS`` rows a
    rank; the worker's join digests against the plain 1-rank join of the
    same global tables; the all-to-all benchmark. Returns the launch
    counts summed over ranks, by call site, and the kernel rows at a
    bucket's shapes (rank 0)."""
    from distributed_join_tpu_torch.ops.kernel_config import KernelConfig
    from distributed_join_tpu_torch.parallel.communicator import (
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        distributed_inner_join,
    )
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )
    smi = gpu_line()
    n = torch.cuda.device_count()
    rows = NROWS * n
    # the driver's tables: selectivity 0.3, unique build keys
    build, probe = generate_build_probe_tables(
        seed=SEED, build_nrows=rows, probe_nrows=rows,
        unique_build_keys=True, device=DEVICE)
    plain = distributed_inner_join(build, probe, LocalCommunicator(),
                                   kernel_config=KernelConfig("plain"))
    _check(not bool(plain.overflow), "phase 13: the 1-rank join overflowed")
    want_total, want_digest = int(plain.total), row_digest(plain)
    del build, probe, plain
    torch.cuda.empty_cache()
    print(f"[nccl] {n} process(es), one a card; global tables {rows:,} x "
          f"{rows:,}; the plain 1-rank join: total={want_total} digest="
          f"{want_digest}", flush=True)

    # one launch: the driver at k = 1 (with the resident A/B) and k = 4,
    # the k = 4 profile, then the worker's counted join and kernel checks
    # phase 17's Q10 at SF-1 over NCCL rides this launch: its 1-rank
    # groups digest first
    from distributed_join_tpu_torch.benchmarks import (
        distributed_join as jdriver,
    )
    from distributed_join_tpu_torch.planning.query import tpch_query_plan
    from distributed_join_tpu_torch.utils.tpch import (
        generate_tpch_query_tables,
        query_filters,
    )
    tables = query_filters(generate_tpch_query_tables(
        SEED, QUERY_SMALL_SF, device=DEVICE), "q10")
    _, res, _, _ = _query_frame(tables, tpch_query_plan("q10"),
                                LocalCommunicator())
    q10_digest = jdriver.row_digest(res.table)
    del tables, res
    torch.cuda.empty_cache()

    driver = _driver_argv(rows, "--iterations", "4")
    a2a = ["--communicator", "nccl", "--buffer-size",
           str(A2A_MIB[0] << 20)]
    worker = _worker_record("nccl", n, {
        "join": True, "a2a_refusal": a2a if n < 2 else None,
        "tpch": {"q10": ["--communicator", "nccl", "--iterations", "2",
                         "--query", "q10", "--scale-factor",
                         str(QUERY_SMALL_SF)]},
        "drivers": {
        "k=1": [*driver, "--over-decomposition-factor", "1",
                "--resident-ab", str(NCCL_RESIDENT_AB)],
        f"k={NCCL_K}": [*driver, "--over-decomposition-factor",
                        str(NCCL_K)],
        "profile": [*driver, "--over-decomposition-factor", str(NCCL_K),
                    "--profile", "3"]}})
    for k in (1, NCCL_K):
        rec = worker["drivers"][f"k={k}"]
        print(f"[nccl] k={k} " + json.dumps(rec), flush=True)
        _check(rec["communicator"] == "nccl" and rec["n_ranks"] == n,
               f"nccl k={k}: record of {rec['communicator']} x "
               f"{rec['n_ranks']}")
        _check(not rec["overflow"], f"nccl k={k}: the join overflowed")
        _check(rec["matches_per_join"] == want_total,
               f"nccl k={k}: {rec['matches_per_join']} matches, the 1-rank "
               f"join has {want_total}")
        print(f"[nccl] k={k}: {rec['elapsed_per_join_s'] * 1e3:.3f} ms a "
              f"join, {rec['m_rows_per_sec_per_rank']:.2f} M rows/s a rank "
              f"({n} rank(s)); {smi}", flush=True)
    # phase 18(f): the resident A/B inside this world
    ab = worker["drivers"]["k=1"]["resident_ab"]
    _check("skipped" not in ab and ab["matches_equal"] and ab["digest_equal"]
           and ab["matches_probe_only"] == want_total
           and ab["warm_probe_new_traces"] == 0 and not ab["overflow"],
           f"nccl --resident-ab: {json.dumps(ab)}")
    print(f"[nccl] --resident-ab {NCCL_RESIDENT_AB}, {n} rank(s): "
          f"register {ab['register_s']:.4f} s; cold min "
          f"{ab['cold_wall_min_s'] * 1e3:.4f} ms, probe-only min "
          f"{ab['probe_only_wall_min_s'] * 1e3:.4f} ms (speedup "
          f"{ab['probe_only_speedup']:.4f}); matches "
          f"{ab['matches_probe_only']} equal to the plain 1-rank join's, "
          f"digests equal, no warm build; {smi}", flush=True)
    prof = worker["drivers"]["profile"]
    print(f"[nccl] profile k={NCCL_K}, rank 0: " + json.dumps(prof),
          flush=True)
    rec = worker["tpch"]["q10"]
    _check(rec["oracle_equal"] and rec["groups_digest"] == q10_digest,
           f"q10 over NCCL ({n} ranks, SF-{QUERY_SMALL_SF:g}): groups "
           f"digest {rec['groups_digest']} != the 1-rank {q10_digest}")
    print(f"[query] q10 SF-{QUERY_SMALL_SF:g} over NCCL, {n} rank(s) "
          f"(phase 17(e), in this launch): {rec['groups']} groups, digest "
          f"equal to the 1-rank run's, oracle-equal; ms a query "
          f"{[round(t * 1e3, 4) for t in rec['query_s']]}; {smi}",
          flush=True)

    got = worker["ranks"]
    _check(len(got) == n, f"nccl worker: {len(got)} ranks reported")
    ps_ms, ps_busy, ps_nccl = worker["partition_shuffle_ms"]
    print(f"[nccl] partition + shuffle at k={NCCL_K}, no local join: "
          f"{ps_ms:.4f} ms a join; device ms of its kernels {ps_busy:.4f} "
          f"besides NCCL's {ps_nccl:.4f} (slowest rank of {n}); {smi}",
          flush=True)
    for r, g in enumerate(got):
        print(f"[nccl] worker rank {r}: {json.dumps(g)}", flush=True)
        _check(not g["overflow"] and g["total"] == want_total,
               f"nccl worker rank {r}: total {g['total']}, overflow "
               f"{g['overflow']}")
        _require_launched(g["launches"], JOIN_KERNELS,
                          f"rank {r} of the NCCL path")
    combined = _combine_digests(tuple(g["digest"]) for g in got)
    _check(combined == want_digest,
           f"nccl worker: combined digest {combined} != the plain 1-rank "
           f"join's {want_digest}")
    print(f"[nccl] combined row digest over {n} rank(s) equals the plain "
          "1-rank join's", flush=True)

    a2a = ["-m", "distributed_join_tpu_torch.benchmarks.all_to_all",
           "--communicator", "nccl"]
    if n < 2:
        # run in the phase's one launch (the worker's world of one card)
        _check("needs >= 2 ranks" in (worker["a2a_refusal"] or ""),
               f"all_to_all on one card: expected its refusal, got "
               f"{worker['a2a_refusal']!r}")
        print("[nccl] all_to_all needs >= 2 ranks: one card, not measured "
              "(the benchmark refused in the phase's NCCL world of one, as "
              "the JAX benchmark does)", flush=True)
    for mib in (A2A_MIB if n >= 2 else ()):
        rec = _launched_record(f"all_to_all {mib} MiB", n, [
            *a2a, "--buffer-size", str(mib << 20)])
        print(f"[nccl] all_to_all {mib} MiB a rank x {n}: "
              f"{rec['aggregate_offchip_gb_per_sec']:.2f} GB/s off-chip, "
              f"{rec['aggregate_gb_per_sec_incl_local']:.2f} GB/s incl. "
              f"local ({rec['elapsed_per_exchange_s'] * 1e3:.4f} ms an "
              f"exchange, median window); {smi}", flush=True)
    return ({s: sum(g["launches"][s] for g in got) for s in NCCL_SITES},
            worker["bucket_rows"], (want_total, want_digest), prof)


# -- phase 14: the wires over NCCL ------------------------------------------


# the wires at config 2's shape: the driver's flags and the join options
WIRES = {
    "padded": ([], {}),
    "ragged": (["--shuffle", "ragged"], {"shuffle": "ragged"}),
    "ppermute": (["--shuffle", "ppermute"], {"shuffle": "ppermute"}),
    "compressed32": (["--compression", "--compression-bits", "32"],
                     {"compression_bits": 32}),
    "compressed16": (["--compression", "--auto-retry", "2"],
                     {"compression_bits": 16, "auto_retry": 2}),
}
CONFIG5_RAGGED = {
    "padded": [],
    "ragged": ["--shuffle", "ragged"],
    "ragged_varlen": ["--shuffle", "ragged", "--variable-length-strings"],
}
CODEC_BITS = (16, 32)


def codec_rows(build, probe) -> list:
    """The codec on one k = 4 batch's padded block of the headline's
    tables (this card as a world of 1: 10 M rows into 4 buckets, each
    padded to 1.6x): encode plus decode ms of its int64 key and payload
    blocks at each of ``CODEC_BITS``, the bytes it saves, and the wire
    rate at which the saving pays for the codec (saved bytes over the
    codec's time). Encode and decode are also held against each other
    where the block packs."""
    import math

    from distributed_join_tpu_torch.ops import compression
    from distributed_join_tpu_torch.ops.partition import (
        radix_hash_partition,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        DEFAULT_SHUFFLE_CAPACITY_FACTOR,
        _round_up,
    )
    cap = _round_up(int(math.ceil(
        build.capacity / NCCL_K * DEFAULT_SHUFFLE_CAPACITY_FACTOR)), 8)
    rows = []
    for side, t in (("build", build), ("probe", probe)):
        pt = radix_hash_partition(t, ["key"], NCCL_K)
        padded, counts, _, row_valid = pt.to_padded(cap, 0, 1)
        for name, col in padded.items():
            col = torch.where(row_valid, col, col[0, counts[0] - 1])
            for bits in CODEC_BITS:
                enc = compression.encode_rows(col, bits, 256)
                dec = compression.decode_rows(enc[0], enc[1], cap, bits,
                                              256, col.dtype)
                if not bool(enc[2].any()):
                    _check(torch.equal(dec, col),
                           f"codec {side}.{name} bits={bits}: decode differs")
                # timed as the wire encodes: without the required bits
                e_ms = time_ms(lambda c=col, b=bits: compression.encode_rows(
                    c, b, 256, required_bits=False))
                d_ms = time_ms(lambda e=enc, b=bits, d=col.dtype:
                               compression.decode_rows(e[0], e[1], cap, b,
                                                       256, d))
                saved = col.nbytes - enc[0].nbytes - enc[1].nbytes
                rows.append({
                    "column": f"{side}.{name}", "bits": bits, "rows": cap,
                    "overflow": bool(enc[2].any()),
                    "required_bits": int(enc[3].max()),  # noqa: DJL004
                    "encode_ms": e_ms, "decode_ms": d_ms,
                    "raw_bytes": col.nbytes, "saved_bytes": saved,
                    "break_even_gb_per_s": saved / ((e_ms + d_ms) * 1e6)})
    return rows


def wire_phase(want_total: int | None = None,
               want_digest: tuple | None = None) -> dict:
    """Phase 14: the wires over NCCL on every card, one process a card,
    at config 2's shape (``NROWS`` a rank, k = ``NCCL_K``): the driver
    in each wire of ``WIRES`` (no overflow, the plain 1-rank join's
    matches); the worker in each wire (digests combined equal the plain
    1-rank join's, every join kernel launched on every rank, the
    partition and shuffle alone); config 5 at 5 M x 5 M a rank on the
    ragged wire, fixed and variable-length strings, against the padded
    run's matches, byte-exact on the wire; the codec on one batch.
    Returns the join sites' launches summed over ranks, by wire."""
    from distributed_join_tpu_torch.ops.kernel_config import KernelConfig
    from distributed_join_tpu_torch.parallel.communicator import (
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        distributed_inner_join,
    )
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )
    smi = gpu_line()
    n = torch.cuda.device_count()
    rows = NROWS * n
    build, probe = generate_build_probe_tables(
        seed=SEED, build_nrows=rows, probe_nrows=rows,
        unique_build_keys=True, device=DEVICE)
    if want_total is None:
        plain = distributed_inner_join(build, probe, LocalCommunicator(),
                                       kernel_config=KernelConfig("plain"))
        _check(not bool(plain.overflow),
               "phase 14: the 1-rank join overflowed")
        want_total, want_digest = int(plain.total), row_digest(plain)
        del plain
    local = generate_build_probe_tables(
        seed=SEED, build_nrows=NROWS, probe_nrows=NROWS,
        unique_build_keys=True, device=DEVICE)
    for r in codec_rows(*local):
        print(f"[wire] codec {json.dumps(r)}; {smi}", flush=True)
    del build, probe, local
    torch.cuda.empty_cache()

    # one launch: the driver on every wire and on config 5, then the
    # worker's join on every wire
    driver = _driver_argv(rows, "--iterations", "4",
                          "--over-decomposition-factor", str(NCCL_K))
    c5 = _driver_argv(CONFIG5_ROWS * n, "--key-columns", "2",
                      "--string-payload-bytes", "16", "--iterations", "4",
                      "--over-decomposition-factor", str(NCCL_K))
    job = _worker_record("wires", n, {
        "drivers": {**{mode: [*driver, *flags]
                       for mode, (flags, _) in WIRES.items()},
                    **{f"config 5 {mode}": [*c5, *flags]
                       for mode, flags in CONFIG5_RAGGED.items()}},
        "wires": {m: o for m, (_, o) in WIRES.items()}})
    for mode in WIRES:
        rec = job["drivers"][mode]
        _check(not rec["overflow"], f"wire {mode}: the join overflowed")
        _check(rec["matches_per_join"] == want_total,
               f"wire {mode}: {rec['matches_per_join']} matches, the 1-rank "
               f"join has {want_total}")
        trail = [a["action"] for a in (rec["retry"] or {}).get(
            "attempts", [])]
        if mode == "compressed16":
            # keys of 10 M-row tables span 2^24 in a 256-row block
            _check(trail[:2] == ["initial", "widen_compression_bits"],
                   f"wire {mode}: retry trail {trail}")
        print(f"[wire] {mode}: {rec['elapsed_per_join_s'] * 1e3:.4f} ms a "
              f"join, {rec['m_rows_per_sec_per_rank']:.2f} M rows/s a rank "
              f"({n} rank(s), k={NCCL_K}); rank 0 sends "
              f"{rec['wire_rows_per_join']:.0f} rows, "
              f"{rec['wire_bytes_per_join']:.0f} bytes a join; host reads "
              f"a join {rec['host_reads_per_join']:.1f}; retry {trail}; "
              f"{smi}", flush=True)

    worker = job["wires"]
    launches = {}
    for mode, got in worker.items():
        _check(len(got["ranks"]) == n,
               f"wire worker {mode}: {len(got['ranks'])} ranks reported")
        for r, g in enumerate(got["ranks"]):
            _check(not g["overflow"] and g["total"] == want_total,
                   f"wire worker {mode} rank {r}: total {g['total']}, "
                   f"overflow {g['overflow']}")
            _require_launched(g["launches"], JOIN_KERNELS,
                              f"rank {r} of the {mode} wire")
        combined = _combine_digests(tuple(g["digest"]) for g in got["ranks"])
        _check(combined == want_digest,
               f"wire worker {mode}: combined digest {combined} != the "
               f"plain 1-rank join's {want_digest}")
        c0 = got["ranks"][0]["counters"]
        ps_ms, ps_busy, ps_nccl = got["partition_shuffle_ms"]
        print(f"[wire] {mode}: partition + shuffle at k={NCCL_K}, no local "
              f"join: {ps_ms:.4f} ms; device ms of its kernels "
              f"{ps_busy:.4f} besides NCCL's {ps_nccl:.4f} (slowest rank "
              f"of {n}); one join on rank 0 (every rung of it): "
              f"{c0['wire_rows']} rows, {c0['wire_bytes']} bytes sent, "
              f"{c0['host_reads']} host reads; digest equal, every join "
              f"kernel launched on every rank; {smi}", flush=True)
        launches[mode] = {s: sum(g["launches"][s] for g in got["ranks"])
                          for s in NCCL_SITES}

    c5_matches = None
    for mode in CONFIG5_RAGGED:
        rec = job["drivers"][f"config 5 {mode}"]
        _check(not rec["overflow"], f"config 5 {mode}: the join overflowed")
        c5_matches = (rec["matches_per_join"] if c5_matches is None
                      else c5_matches)
        _check(rec["matches_per_join"] == c5_matches,
               f"config 5 {mode}: {rec['matches_per_join']} matches, the "
               f"padded run has {c5_matches}")
        exact = rec["string_wire_bytes"]["byte_exact_on_wire"]
        _check(exact == (mode != "padded"),
               f"config 5 {mode}: byte_exact_on_wire {exact}")
        print(f"[wire] config 5 {mode}: "
              f"{rec['elapsed_per_join_s'] * 1e3:.4f} ms a join, "
              f"{rec['m_rows_per_sec_per_rank']:.2f} M rows/s a rank; rank 0 "
              f"sends {rec['wire_rows_per_join']:.0f} rows, "
              f"{rec['wire_bytes_per_join']:.0f} bytes a join; host reads "
              f"a join {rec['host_reads_per_join']:.1f}; string bytes "
              f"{json.dumps(rec['string_wire_bytes'])}; {smi}", flush=True)
    return launches


# -- phase 15: BASELINE config 4, TPC-H lineitem ⋈ orders --------------------


TPCH_SF = 10.0                 # the driver's run: SF-10, host generator
TPCH_BATCHES = 4
TPCH_SF10_ORDERS = 15_000_000
TPCH_SF10_LINES = 60_000_261   # results/tpch_sf10_1chip.json (numpy PCG64)
TPCH_SMALL_SF = 1.0            # the phase's own checks
# the kernel rows at a config-4 batch's shape, and their call sites
TPCH_SITES = {"join_scans[tpch batch]": "join_scans",
              "stream_compact[record, tpch batch]": "compact_records",
              "stream_compact[pack, tpch batch]": "pack_matched_builds",
              "expand_gather[build, tpch batch]": "expand_gather"}


def _tpch_driver(argv: list) -> dict:
    """The config-4 driver in this process, on this card."""
    from distributed_join_tpu_torch.benchmarks import tpch_join
    rec = tpch_join.run(tpch_join.parse_args(argv), device=DEVICE)
    print("[tpch] " + json.dumps(rec), flush=True)
    _check(not rec["overflow"], f"tpch {argv}: the join overflowed")
    return rec


def _per_dispatch_launches(fn):
    """Run ``fn`` with every join the batch loop dispatches counted on
    its own: returns (its result, the launch counts of each dispatch, in
    order). A dispatch launches on this thread, so the counts before and
    after it are its own."""
    from distributed_join_tpu_torch.parallel import out_of_core
    wrappers = _launch_wrappers()
    real = out_of_core.make_distributed_join
    seen = []

    def factory(*args, **kwargs):
        join = real(*args, **kwargs)

        def each(*tables):
            before = [w.launches for w in wrappers]
            res = join(*tables)
            seen.append({w.__name__: w.launches - b
                         for w, b in zip(wrappers, before)})
            return res
        return each

    out_of_core.make_distributed_join = factory
    try:
        return fn(), seen
    finally:
        out_of_core.make_distributed_join = real


def tpch_expected_matches(orders_batches, lineitem_batches) -> int:
    """The matches of the host batches, counted by numpy without a join:
    a sparse order key maps back to its order's index, and a line matches
    when its order survived the filters (order keys are unique)."""
    from distributed_join_tpu_torch.utils.tpch import ORDERS_PER_SF
    present = np.zeros(int(ORDERS_PER_SF * TPCH_SMALL_SF), bool)

    def index(keys):
        k = keys.astype(np.int64) - 1
        return (k // 32) * 8 + k % 32

    for b in orders_batches:
        present[index(b["o_orderkey"])] = True
    return sum(int(present[index(b["l_orderkey"])].sum())  # noqa: DJL004
               for b in lineitem_batches)


def tpch_phase():
    """Phase 15: config 4 through its driver at SF-10 on the host
    generator (4 batches), with the last batch's kernel inputs captured
    and held against their twins; then the batch loop at SF-1 with Q3's
    filters, a manifest and a fetching consumer, against numpy's count
    and the plain path's digest, every join kernel launched on every
    batch; then the single-shot and key-range paths on the card's
    generator at SF-1. Returns the launch counts of the SF-10 run and
    the kernel rows at its batch shape."""
    import tempfile

    from distributed_join_tpu_torch.ops.kernel_config import KernelConfig
    from distributed_join_tpu_torch.parallel.communicator import (
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.parallel.out_of_core import (
        batched_join_host,
    )
    from distributed_join_tpu_torch.utils.tpch_host import (
        generate_tpch_host_batches,
        rename_batches,
    )
    smi = gpu_line()
    print(f"[tpch] before SF-{TPCH_SF:g}: device memory reserved "
          f"{torch.cuda.memory_reserved(DEVICE):,} B", flush=True)
    (rec, counts), calls = captured_join_calls(lambda: counted(
        lambda: _tpch_driver(["--scale-factor", str(TPCH_SF),
                              "--host-generator", "--batches",
                              str(TPCH_BATCHES)])))
    _check(rec["lineitem_nrows"] == rec["matches_per_join"]
           == TPCH_SF10_LINES and rec["orders_nrows"] == TPCH_SF10_ORDERS,
           f"tpch SF-{TPCH_SF:g}: {rec['orders_nrows']} orders, "
           f"{rec['lineitem_nrows']} lines, {rec['matches_per_join']} "
           f"matches; expected {TPCH_SF10_ORDERS}, {TPCH_SF10_LINES}")
    _require_launched(counts, JOIN_KERNELS, f"the SF-{TPCH_SF:g} path")
    print(f"[tpch] SF-{TPCH_SF:g}, {TPCH_BATCHES} batches, host generator: "
          f"generate_s={rec['generate_s']:.3f} pad_s={rec['pad_s']:.3f} "
          f"put_s={rec['put_s']:.3f} dispatch_s={rec['dispatch_s']:.3f} "
          f"fetch_wait_s={rec['fetch_wait_s']:.3f} elapsed_per_join_s="
          f"{rec['elapsed_per_join_s']:.3f} "
          f"({rec['rows_per_sec'] / 1e6:.2f} M rows/s); host RSS "
          f"{rec['host_rss_bytes']} B, peak "
          f"{rec['peak_host_rss_bytes']:,} B, pinned "
          f"{rec['pinned_host_bytes']} B; launches {counts}; {smi}",
          flush=True)
    rows = bucket_kernel_rows(calls, label="tpch batch")
    del calls
    torch.cuda.empty_cache()

    ob, lb = generate_tpch_host_batches(SEED, TPCH_SMALL_SF, TPCH_BATCHES,
                                        q3_filters=True)
    want = tpch_expected_matches(ob, lb)
    build = rename_batches(ob, {"o_orderkey": "key"})
    probe = rename_batches(lb, {"l_orderkey": "key"})
    digests = {}

    def run(label, **opts):
        got = {}
        with tempfile.TemporaryDirectory() as d:
            stats = {}
            manifest = os.path.join(d, "manifest.json")
            (total, overflow), per = _per_dispatch_launches(
                lambda: batched_join_host(
                    build, probe, LocalCommunicator(), device=DEVICE,
                    stats=stats,
                    manifest_path=manifest, out_capacity_factor=1.5,
                    on_batch_result=lambda b, res: got.__setitem__(
                        b, row_digest(res)), **opts))
            with open(manifest) as f:
                done = json.load(f)["batches"]
        _check(not overflow and total == want,
               f"tpch SF-{TPCH_SMALL_SF:g} {label}: total {total}, "
               f"overflow {overflow}; numpy counts {want}")
        _check(sorted(got) == list(range(TPCH_BATCHES))
               and sum(v["total"] for v in done.values()) == want
               and len(done) == TPCH_BATCHES,
               f"tpch SF-{TPCH_SMALL_SF:g} {label}: fetched {sorted(got)}, "
               f"manifest {done}")
        digests[label] = _combine_digests(got.values())
        print(f"[tpch] SF-{TPCH_SMALL_SF:g} Q3 filters, {label}: total "
              f"{total} = numpy's count; {len(per)} dispatches "
              f"(the warm-up and {TPCH_BATCHES} batches); digest "
              f"{digests[label]}; stats {json.dumps(stats)}", flush=True)
        return per

    per = run("kernels")
    for i, c in enumerate(per):
        _require_launched(c, JOIN_KERNELS, f"dispatch {i} of the batch loop")
    run("plain", kernel_config=KernelConfig("plain"))
    _check(digests["kernels"] == digests["plain"],
           f"tpch SF-{TPCH_SMALL_SF:g}: the batched digest "
           f"{digests['kernels']} != the plain path's {digests['plain']}")
    del ob, lb, build, probe

    for batches in (1, TPCH_BATCHES):
        r = _tpch_driver(["--scale-factor", str(TPCH_SMALL_SF),
                          "--batches", str(batches)])
        _check(r["matches_per_join"] == r["lineitem_nrows"] > 0,
               f"tpch SF-{TPCH_SMALL_SF:g} --batches {batches}: "
               f"{r['matches_per_join']} matches of "
               f"{r['lineitem_nrows']} lines")
        print(f"[tpch] SF-{TPCH_SMALL_SF:g} device generator, --batches "
              f"{batches}: {r['matches_per_join']} matches = lines, "
              f"{r['elapsed_per_join_s'] * 1e3:.3f} ms a join; {smi}",
              flush=True)
    return counts, rows


# -- phase 16: the segmented sort and the hierarchical wire -----------------


SEG_SITES = ("join_scans", "compact_records", "pack_matched_builds",
             "expand_gather")
SEG_REASON = ("the segmented local join is a batched torch formulation (as "
              "the JAX package's is XLA, reaching no Pallas kernel): it "
              "launches no hand kernel")
SORT_AB_JOINS = 5
HIER_SLICES = 2


def _sort_rows(prof: dict) -> dict:
    """The sort kernels of a ``--profile`` record: their device ms and
    calls a join, summed, and the rows themselves."""
    rows = [r for r in prof["top_kernels_ms_per_join"]
            if "sort" in r["name"].lower()]
    return {"ms": sum(r["ms"] for r in rows),
            "calls": sum(r["calls_per_join"] for r in rows), "rows": rows}


def segmented_phase(want_total: int | None = None,
                    want_digest: tuple | None = None,
                    flat_profile: dict | None = None) -> dict:
    """Phase 16: (a) the segmented sort at config 2's shape (``NROWS`` a
    rank, k = ``NCCL_K``, auto segments) through the driver over NCCL,
    one process a card: no overflow, the plain 1-rank join's matches,
    ms a join; the same driver's ``--sort-ab`` (both modes' totals and
    row digests equal); ``--profile 3`` of each mode (the sorts' device
    ms); one in-process join of the same tables on a local communicator
    at k = ``NCCL_K``, counted (no hand kernel launched) and digest-equal
    to the plain 1-rank join. (b) 4 emulated ranks as 2 x 2 slices on
    this card at ``EMU_ROWS``: the hierarchical wire with the codec off,
    and on at 16 bits with ``auto_retry=2``, each equal to the 1-rank
    join with every join kernel launched once a rank at least; then the
    segmented sort over the same emulated hierarchy. (c) the degenerate
    hierarchy (``--shuffle hierarchical``, one slice) over NCCL through
    the worker: the combined digest equals the plain 1-rank join's, as
    the padded wire's does. With an even number of cards above one, the
    hierarchical wire as ``HIER_SLICES`` slices over NCCL subgroups, codec
    off and on: the driver (ms a join, bytes on each tier) and the
    worker (digests). Returns the launch counts by path."""
    from distributed_join_tpu_torch.ops.kernel_config import KernelConfig
    from distributed_join_tpu_torch.parallel.communicator import (
        EmulatedCommunicator,
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        distributed_inner_join,
    )
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )
    smi = gpu_line()
    n = torch.cuda.device_count()
    rows = NROWS * n
    build, probe = generate_build_probe_tables(
        seed=SEED, build_nrows=rows, probe_nrows=rows,
        unique_build_keys=True, device=DEVICE)
    if want_total is None:
        plain = distributed_inner_join(build, probe, LocalCommunicator(),
                                       kernel_config=KernelConfig("plain"))
        _check(not bool(plain.overflow),
               "phase 16: the 1-rank join overflowed")
        want_total, want_digest = int(plain.total), row_digest(plain)
        del plain
    paths = {}
    # (a) in process: the segmented join of the same tables at k = 4 on a
    # local communicator (one rank, four buckets)
    if n == 1:
        seg, paths["segmented"] = counted(lambda: distributed_inner_join(
            build, probe, LocalCommunicator(), over_decomposition=NCCL_K,
            sort_mode="segmented"))
        _check(not bool(seg.overflow) and int(seg.total) == want_total
               and row_digest(seg) == want_digest,
               f"segmented local k={NCCL_K}: total {int(seg.total)}, "
               f"overflow {bool(seg.overflow)}, digest differs from the "
               "plain 1-rank join's")
        _check(not any(paths["segmented"].values()),
               f"the segmented path launched {paths['segmented']}")
        print(f"[segmented] local k={NCCL_K}: total {int(seg.total)}, "
              f"digest equal to the plain 1-rank join's; launches "
              f"{paths['segmented']} ({SEG_REASON})", flush=True)
        del seg
    del build, probe
    torch.cuda.empty_cache()

    # one launch: the segmented driver with its --sort-ab, the profiles,
    # the hierarchical drivers (an even number of cards above one), then
    # the worker's joins on the hierarchical wires
    driver = _driver_argv(rows, "--iterations", "4",
                          "--over-decomposition-factor", str(NCCL_K))
    drivers = {"segmented": [*driver, "--sort-mode", "segmented",
                             "--sort-ab", str(SORT_AB_JOINS)],
               "segmented profile": [*driver, "--sort-mode", "segmented",
                                     "--profile", "3"]}
    if flat_profile is None:
        drivers["flat profile"] = [*driver, "--profile", "3"]
    wires = {"hierarchical_1": {"shuffle": "hierarchical", "slices": 1}}
    multi = n > 1 and n % HIER_SLICES == 0
    if multi:
        for codec in ("off", "on"):
            drivers[f"hierarchical {codec}"] = [
                *driver, "--shuffle", "hierarchical", "--slices",
                str(HIER_SLICES), "--dcn-codec", codec, "--auto-retry", "2"]
            wires[f"hierarchical_{HIER_SLICES}_{codec}"] = {
                "shuffle": "hierarchical", "slices": HIER_SLICES,
                "dcn_codec": codec, "auto_retry": 2}
    job = _worker_record("segmented", n, {"drivers": drivers,
                                          "wires": wires})
    rec = job["drivers"]["segmented"]
    ab = rec["sort_ab"]
    print(f"[segmented] driver: " + json.dumps(rec), flush=True)
    _check(not rec["overflow"] and rec["matches_per_join"] == want_total,
           f"segmented driver: {rec['matches_per_join']} matches, overflow "
           f"{rec['overflow']}; the 1-rank join has {want_total}")
    _check("skipped" not in ab and ab["matches_equal"]
           and ab["digest_equal"] and ab["matches"] == want_total,
           f"segmented --sort-ab: {json.dumps(ab)}")
    print(f"[segmented] k={NCCL_K}, {n} rank(s), {ab['sort_segments']} "
          f"segments: {rec['elapsed_per_join_s'] * 1e3:.4f} ms a join "
          f"(driver); --sort-ab {SORT_AB_JOINS}: flat min "
          f"{ab['flat_ms_min']:.4f} median {ab['flat_ms_median']:.4f} ms, "
          f"segmented min {ab['segmented_ms_min']:.4f} median "
          f"{ab['segmented_ms_median']:.4f} ms, speedup "
          f"{ab['segmented_speedup']:.4f}; totals and digests equal; {smi}",
          flush=True)
    profs = {"segmented": job["drivers"]["segmented profile"],
             "flat": flat_profile or job["drivers"]["flat profile"]}
    for mode, prof in profs.items():
        srt = _sort_rows(prof)
        print(f"[segmented] profile {mode}, rank 0: device busy "
              f"{prof['device_busy_ms_per_join']:.4f} ms a join, sorts "
              f"{srt['ms']:.4f} ms in {srt['calls']} calls a join: "
              f"{json.dumps(srt['rows'])}; top kernels "
              f"{json.dumps(prof['top_kernels_ms_per_join'])}; {smi}",
              flush=True)

    # (b) the emulated hierarchy on this card
    eb, ep = generate_build_probe_tables(
        seed=SEED, build_nrows=EMU_ROWS, probe_nrows=EMU_ROWS, device=DEVICE)
    one = distributed_inner_join(eb, ep, LocalCommunicator(), auto_retry=2)
    _check(not bool(one.overflow), "phase 16: the emulated 1-rank join "
                                   "overflowed")
    want_emu = (int(one.total), row_digest(one))
    del one
    for label, opts in (
            ("hierarchical off", dict(dcn_codec="off")),
            ("hierarchical on", dict(dcn_codec="on", compression_bits=16)),
            ("hierarchical segmented", dict(dcn_codec="off",
                                            sort_mode="segmented"))):
        comm = EmulatedCommunicator(EMU_RANKS, n_slices=HIER_SLICES)
        t0 = time.perf_counter()
        res, counts = counted(lambda: distributed_inner_join(
            eb, ep, comm, shuffle="hierarchical", auto_retry=2, **opts))
        wall = time.perf_counter() - t0
        got = (int(res.total), row_digest(res))
        trail = [(a.action, a.compression_bits)
                 for a in res.retry_report.attempts]
        _check(not bool(res.overflow) and got == want_emu,
               f"emulated {label}: total {got[0]}, overflow "
               f"{bool(res.overflow)}; differs from the 1-rank join")
        if label.endswith("segmented"):
            _check(not any(counts.values()),
                   f"emulated {label} launched {counts}")
            paths["hierarchical_segmented"] = counts
        else:
            _require_launched(counts, JOIN_KERNELS, f"emulated {label}",
                              at_least=EMU_RANKS)
            paths[label.replace(" ", "_")] = counts
        print(f"[hierarchical] emulated {EMU_RANKS} ranks as "
              f"{HIER_SLICES} x {EMU_RANKS // HIER_SLICES}, {label}: total "
              f"{got[0]} equal to the 1-rank join; retry {trail}; counters "
              f"{json.dumps(comm.counters())}; wall {wall:.3f} s (host "
              f"clock, first call); launches {counts}", flush=True)
        del res
    del eb, ep
    torch.cuda.empty_cache()

    # (c) hierarchical over NCCL: one slice (the padded wire), and with an
    # even number of cards two slices over subgroups, codec off and on
    for codec in (("off", "on") if multi else ()):
        rec = job["drivers"][f"hierarchical {codec}"]
        _check(not rec["overflow"] and rec["matches_per_join"] == want_total,
               f"hierarchical {codec}: {rec['matches_per_join']} matches, "
               f"overflow {rec['overflow']}")
        trail = [(a["action"], a["compression_bits"])
                 for a in (rec["retry"] or {}).get("attempts", [])]
        print(f"[hierarchical] NCCL {HIER_SLICES} x {n // HIER_SLICES}, "
              f"codec {codec}, k={NCCL_K}: "
              f"{rec['elapsed_per_join_s'] * 1e3:.4f} ms a join; rank 0 "
              f"bytes a join: intra-slice "
              f"{rec['wire_bytes_ici_per_join']:.0f}, cross-slice "
              f"{rec['wire_bytes_dcn_per_join']:.0f}, saved "
              f"{rec['wire_bytes_saved_per_join']:.0f}, total "
              f"{rec['wire_bytes_per_join']:.0f}; retry {trail}; (both "
              f"tiers are NVLink on one node); {smi}", flush=True)
    if not multi:
        print(f"[hierarchical] {n} card(s): {HIER_SLICES} slices over "
              "NCCL need an even number of cards above one; not run",
              flush=True)
    worker = job["wires"]
    for mode, got in worker.items():
        for r, g in enumerate(got["ranks"]):
            _check(not g["overflow"] and g["total"] == want_total,
                   f"{mode} worker rank {r}: total {g['total']}, overflow "
                   f"{g['overflow']}")
            _require_launched(g["launches"], JOIN_KERNELS,
                              f"rank {r} of the {mode} wire")
        combined = _combine_digests(tuple(g["digest"]) for g in got["ranks"])
        _check(combined == want_digest,
               f"{mode} worker: combined digest {combined} != the plain "
               f"1-rank join's {want_digest}")
        ps_ms, ps_busy, ps_nccl = got["partition_shuffle_ms"]
        print(f"[hierarchical] worker {mode}: digest equal to the plain "
              f"1-rank join's (as the padded wire's), every join kernel "
              f"launched on every rank; rank 0 counters "
              f"{json.dumps(got['ranks'][0]['counters'])}; partition + "
              f"shuffle alone {ps_ms:.4f} ms, device ms of its kernels "
              f"{ps_busy:.4f} besides NCCL's {ps_nccl:.4f}; {smi}",
              flush=True)
        paths[f"nccl_{mode}"] = {s: sum(g["launches"][s]
                                        for g in got["ranks"])
                                 for s in NCCL_SITES}
    return paths


# -- phase 17: the query layer -------------------------------------------


QUERY_SF = 10.0                # Q3 and Q10, --agg: TPC-H SF-10
QUERY_SMALL_SF = 1.0           # emulated ranks, the NCCL world of 1
QUERY_ITERS = 3                # warm queries timed after the cold one
AGG_AB_JOINS = 3               # (c): timed pairs
QUERIES = ("q3", "q10")
QUERY_SITES = JOIN_KERNELS + ("compact_groups",)
GROUPS_REASON = ("the materializing join runs no groups compaction; the "
                 "fused aggregate runs no join scan, compaction of records "
                 "or expand")


def captured_groups_calls(fn):
    """Run ``fn`` with the groups compaction's inputs recorded: returns
    (its result, the arguments of its last call)."""
    from distributed_join_tpu_torch.ops import aggregate as A
    calls = {}
    real = A.stream_compact

    def compact(mask, pos, cols, capacity, launch_counter=None):
        calls["compact_groups"] = (mask, pos, list(cols), capacity)
        return real(mask, pos, cols, capacity,
                    launch_counter=launch_counter)

    A.stream_compact = compact
    try:
        return fn(), calls
    finally:
        A.stream_compact = real


def groups_kernel_row(call) -> dict:
    """B2 at the groups site: the compaction of a query's per-run
    domain (the second join's merged positions) into the groups block,
    held against its twin over the survivor prefix; the library call is
    ``packed[mask]``. Bound as the other compaction sites: every mask
    byte, the kept survivors' lanes read and written."""
    from distributed_join_tpu_torch.ops import compact
    mask, pos, lanes, cap = call
    n = mask.shape[0]
    kept = min(int(mask.sum()), cap)  # noqa: DJL004
    packed = torch.stack(lanes, 1)
    rows = []
    got = compact.stream_compact(mask, pos, lanes, cap)
    want = compact.stream_compact_reference(mask, pos, lanes, cap)
    check_and_time(
        rows, "stream_compact[groups]",
        "distributed_join_tpu_torch/csrc/stream_compact.cu",
        "distributed_join_tpu/ops/compact_planes.py:53 (_compact_kernel), "
        "at the site of distributed_join_tpu/ops/aggregate.py:460 "
        "(_compact_runs, a lax.sort)",
        got, want, kept,
        lambda: compact.stream_compact(mask, pos, lanes, cap),
        lambda: compact.stream_compact_reference(mask, pos, lanes, cap),
        lambda: packed[mask], nbytes=n + 2 * kept * 8 * len(lanes), ops=n)
    rows[0].update(merged_positions=n, lanes=len(lanes), survivors=kept)
    return rows[0]


def _query_frame(tables, plan, comm, **opts):
    """The groups of ``plan`` over ``comm`` (counted) as a host frame,
    with the run's launch counts and its host wall seconds."""
    from distributed_join_tpu_torch.ops.aggregate import groups_frame
    from distributed_join_tpu_torch.parallel.query_exec import (
        distributed_query,
    )
    spec = plan.aggregate
    t0 = time.perf_counter()
    res, counts = counted(lambda: distributed_query(
        tables, plan, comm, auto_retry=4, **opts))
    wall = time.perf_counter() - t0
    _check(not bool(res.overflow), f"{plan.output} on {comm.name}: overflow "
                                   "after the ladder")
    return (groups_frame(res.table, spec, list(spec.group_keys)), res,
            counts, wall)


def query_profile(query: str, joins: int = 3) -> dict:
    """Where one warm query at SF-10 on one rank spends its device time
    (``utils.benchmarking.profile_calls``: top kernels, busy ms against
    the host wall)."""
    from distributed_join_tpu_torch.parallel.communicator import (
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.parallel.query_exec import (
        distributed_query,
    )
    from distributed_join_tpu_torch.planning.query import tpch_query_plan
    from distributed_join_tpu_torch.utils.benchmarking import profile_calls
    from distributed_join_tpu_torch.utils.tpch import (
        generate_tpch_query_tables,
        query_filters,
    )
    tables = query_filters(generate_tpch_query_tables(
        SEED, QUERY_SF, device=DEVICE), query)
    plan = tpch_query_plan(query)
    return profile_calls(lambda: distributed_query(
        tables, plan, LocalCommunicator(), auto_retry=4),
        torch.device(DEVICE), joins, top=20)


def query_phase() -> tuple:
    """Phase 17: the query layer. (a) Q3 and Q10 at SF-10 through the
    tpch driver (``--query``, local communicator): no overflow after the
    ladder, groups equal to the numpy whole-query oracle (the driver
    refuses otherwise), op totals, ms a query over warm repeats, peak
    device memory; the first join launches the scans, both compaction
    sites and the expand, the second the groups compaction. (b) ``--agg``
    at SF-10 with Q3's filters, oracle-equal. (c) the join driver's
    ``--agg-ab`` at config 2's shape, both sides oracle-equal. (d) Q3
    and Q10 at SF-1 on 4 emulated ranks and on an emulated 2 x 2
    hierarchy, each equal to the 1-rank groups (Q10 runs the partials
    exchange). (e) Q10 at SF-1 over NCCL, one process a card, its groups
    digest equal to the 1-rank one: checked in phase 13, whose launch
    runs it; with four or more cards also Q3 and Q10 at SF-10 over 4
    NCCL ranks (a launch of their own here), equal to (a)'s.
    (f) the groups compaction of (a)'s Q3 against its twin, right after
    that query. Prints each part's seconds. Returns the launch counts by
    path and the kernel row."""
    from distributed_join_tpu_torch.benchmarks import (
        distributed_join as jdriver,
    )
    from distributed_join_tpu_torch.ops.aggregate import frames_equal
    from distributed_join_tpu_torch.parallel.communicator import (
        EmulatedCommunicator,
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.planning.query import tpch_query_plan
    from distributed_join_tpu_torch.utils.tpch import (
        generate_tpch_query_tables,
        query_filters,
    )
    smi = gpu_line()
    paths, digests = {}, {}
    t_part = time.perf_counter()

    def part_done(label):
        nonlocal t_part
        now = time.perf_counter()
        print(f"[phase] 17{label}: {now - t_part:.1f} s", flush=True)
        t_part = now

    # (a) the driver at SF-10 on this card, and (f) the groups
    # compaction at its Q3 shape
    for q in QUERIES:
        torch.cuda.empty_cache()
        (rec, counts), got = captured_groups_calls(lambda: counted(
            lambda: _tpch_driver(["--query", q, "--scale-factor",
                                  str(QUERY_SF), "--iterations",
                                  str(QUERY_ITERS)])))
        _check(rec["oracle_equal"] and rec["groups"] > 0,
               f"--query {q}: {rec['groups']} groups, oracle "
               f"{rec['oracle_equal']}")
        _require_launched(counts, QUERY_SITES, f"the {q} query path")
        paths[f"query_{q}"] = counts
        if q == "q3":
            # (f) the groups compaction at this query's shape, measured
            # before the query's own profiler runs
            row = groups_kernel_row(got["compact_groups"])
        del got
        prof = query_profile(q)
        print(f"[query] {q} SF-{QUERY_SF:g} profile: device busy "
              f"{prof['device_busy_ms_per_join']:.4f} of "
              f"{prof['host_wall_ms_per_join']:.4f} ms a query (busy share "
              f"{prof['device_busy_share']:.4f}); top kernels "
              f"{json.dumps(prof['top_kernels_ms_per_join'])}; {smi}",
              flush=True)
        digests[q] = rec["groups_digest"]
        print(f"[query] {q} SF-{QUERY_SF:g}: op_totals {rec['op_totals']}, "
              f"{rec['groups']} groups equal to the numpy oracle, retry "
              f"attempts {rec['retry_attempts']}; ms a query (warm, host "
              f"clock) {[round(t * 1e3, 4) for t in rec['query_s']]}, min "
              f"{rec['query_ms_min']:.4f}; peak device memory "
              f"{rec['peak_memory_bytes']:,} B; launches {counts}; {smi}",
              flush=True)
    part_done("a+f")
    # (b) --agg at SF-10 with Q3's filters
    torch.cuda.empty_cache()
    rec, counts = counted(lambda: _tpch_driver([
        "--agg", "--q3-filters", "--scale-factor", str(QUERY_SF),
        "--iterations", str(QUERY_ITERS)]))
    agg = rec["aggregate"]
    _check(agg["oracle_equal"] and agg["groups"] > 0,
           f"--agg: {json.dumps(agg)}")
    _require_launched(counts, ("compact_groups",), "the --agg path")
    paths["agg"] = counts
    print(f"[query] --agg SF-{QUERY_SF:g} Q3 filters: {agg['groups']} "
          f"groups equal to the numpy oracle; "
          f"{rec['elapsed_per_join_s'] * 1e3:.4f} ms a join "
          f"({rec['rows_per_sec'] / 1e6:.2f} M rows/s); peak device memory "
          f"{rec['peak_memory_bytes']:,} B; launches {counts}; {smi}",
          flush=True)
    part_done("b")
    # (c) --agg-ab at config 2's shape, one rank
    torch.cuda.empty_cache()
    rec, counts = counted(lambda: jdriver.run(jdriver.parse_args([
        "--build-table-nrows", str(NROWS), "--probe-table-nrows",
        str(NROWS), "--iterations", "4", "--agg-ab", str(AGG_AB_JOINS)]),
        device=DEVICE))
    ab = rec["agg_ab"]
    _check("skipped" not in ab and ab["oracle_equal_pushdown"]
           and ab["oracle_equal_materialize"] and not ab["overflow"],
           f"--agg-ab: {json.dumps(ab)}")
    paths["agg_ab"] = counts
    print(f"[query] --agg-ab {AGG_AB_JOINS} at {NROWS:,} x {NROWS:,}: "
          f"materialize min {ab['materialize_wall_min_s'] * 1e3:.4f} ms, "
          f"pushdown min {ab['pushdown_wall_min_s'] * 1e3:.4f} ms (host "
          f"clock, the fetch included), speedup "
          f"{ab['pushdown_speedup']:.4f}; {ab['groups']} groups, both "
          f"oracle-equal; walls {json.dumps(ab['materialize_walls_s'])} / "
          f"{json.dumps(ab['pushdown_walls_s'])}; {smi}", flush=True)
    part_done("c")
    # (d) emulated ranks and the emulated hierarchy at SF-1
    torch.cuda.empty_cache()
    small = {}
    base = generate_tpch_query_tables(SEED, QUERY_SMALL_SF, device=DEVICE)
    for q in QUERIES:
        plan = tpch_query_plan(q)
        tables = query_filters(base, q)
        one, res, _, _ = _query_frame(tables, plan, LocalCommunicator())
        small[q] = jdriver.row_digest(res.table)
        for label, comm, opts in (
                ("emulated", EmulatedCommunicator(EMU_RANKS), {}),
                ("hierarchical", EmulatedCommunicator(
                    EMU_RANKS, n_slices=HIER_SLICES),
                 dict(shuffle="hierarchical", dcn_codec="off"))):
            got, res, counts, wall = _query_frame(tables, plan, comm, **opts)
            _check(frames_equal(got, one),
                   f"{q} {label}: groups differ from the 1-rank groups")
            _require_launched(counts, JOIN_KERNELS, f"{q} {label}",
                              at_least=EMU_RANKS)
            _require_launched(counts, ("compact_groups",), f"{q} {label}",
                              at_least=EMU_RANKS)
            paths[f"{label}_{q}"] = counts
            print(f"[query] {q} SF-{QUERY_SMALL_SF:g} {label} "
                  f"{EMU_RANKS} ranks: {len(got[plan.aggregate.group_keys[0]])}"
                  f" groups equal to 1 rank; retry attempts "
                  f"{res.retry_attempts}; wall {wall:.3f} s (host clock, "
                  f"first call); launches {counts}", flush=True)
    del base
    torch.cuda.empty_cache()
    part_done("d")
    # (e) over NCCL, one process a card
    n = torch.cuda.device_count()
    driver = ["-m", "distributed_join_tpu_torch.benchmarks.tpch_join",
              "--communicator", "nccl", "--iterations", "2"]
    # Q10 at SF-1 over NCCL runs in phase 13's launch
    runs = ([(q, QUERY_SF, digests[q]) for q in QUERIES]
            if n >= EMU_RANKS else [])
    for q, sf, want in runs:
        rec = _launched_record(f"query {q} nccl", n, [
            *driver, "--query", q, "--scale-factor", str(sf)])
        _check(rec["oracle_equal"] and rec["groups_digest"] == want,
               f"{q} over NCCL ({n} ranks, SF-{sf:g}): groups digest "
               f"{rec['groups_digest']} != the 1-rank {want}")
        print(f"[query] {q} SF-{sf:g} over NCCL, {n} rank(s): "
              f"{rec['groups']} groups, digest equal to the 1-rank run's, "
              f"oracle-equal; ms a query {[round(t * 1e3, 4) for t in rec['query_s']]}; "
              f"{smi}", flush=True)
    part_done("e")
    torch.cuda.empty_cache()
    return paths, row


# -- phase 18: the serving core ------------------------------------------


RESIDENT_AB_JOINS = 5
SERVING_REQUESTS = 32
SERVING_PROBE_ROWS = 1 << 18
LSM_DELTAS = 4
LSM_DELTA_ROWS = 1_000_000
AGG_GROUPS = 1024
AGG_ITERS = 3
BATCH_REQUESTS = 8
BATCH_ROWS = 1_000_000
RESIDENT_EMU_ROWS = 1_000_000
# (b)'s two registries: (label of the kernel rows, launch path, capacity
# factor): the registry's default (None: room for appends), then 1 (the
# shard unpadded)
SERVING_SETTINGS = (("serving", "resident", None),
                    ("serving, factor 1", "resident_factor1", 1.0))
SERVING_SITES = {"join_scans[{}]": "join_scans",
                 "stream_compact[record, {}]": "compact_records",
                 "stream_compact[pack, {}]": "pack_matched_builds",
                 "expand_gather[build, {}]": "expand_gather"}


def _timed_s(fn):
    """(result, host seconds) of one call, synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _serving_probe(seed: int, rows: int, groups: int = 0):
    """A probe of config 2's kind against the unique build keys [0,
    NROWS) (the generator's build is the same at every seed): hits at
    selectivity 0.3, from ``seed``; with ``groups``, a ``grp`` column of
    that many values."""
    from distributed_join_tpu_torch.table import Table
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )
    _, probe = generate_build_probe_tables(
        seed=seed, build_nrows=NROWS, probe_nrows=rows,
        unique_build_keys=True, device=DEVICE)
    if not groups:
        return probe
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    grp = torch.randint(0, groups, (rows,), generator=g, device=DEVICE)
    return Table({**probe.columns, "grp": grp}, probe.valid)


def _key_digest(table) -> int:
    """The conservation digest of a table as the registry computes it:
    the uint64 sum of the valid rows' key hashes."""
    from distributed_join_tpu_torch.ops.hashing import hash_columns
    h = hash_columns([table.columns["key"]])
    return int(torch.where(table.valid, h, 0).sum()) % 2**64  # noqa: DJL004


def serving_profile(registry, probe, joins: int = 3) -> dict:
    """Where one warm probe-only request spends its device time
    (``utils.benchmarking.profile_calls``)."""
    from distributed_join_tpu_torch.utils.benchmarking import profile_calls
    return profile_calls(lambda: registry.join("dim", probe),
                         torch.device(DEVICE), joins, top=10)


def resident_phase() -> tuple:
    """Phase 18: the serving core at BASELINE config 2's width (an int64
    key and payload, seed 42, selectivity 0.3, one card). (a) the join
    driver's ``--resident-ab 5`` at 10 M x 10 M: equal matches and row
    digests, no warm build; register s, both minima and the speedup.
    (b) a 10 M-row build registered once, then 32 probe requests of
    2^18 rows, each from its own seed: each request's row digest equal
    to a cold full join of the same pair, the cache 1 miss, 31 hits and
    1 build; ms a request; the kernels at one request's shapes against
    their twins; all of it at the registry's default capacity factor
    (1.5: a 15 M-row shard) and again at 1 (10 M rows); a profile of a
    warm request at the default. (c) four
    appends of 1 M-row deltas, one ``maintain`` (s), conservation at
    every step (rows and key-hash sums also counted here), a re-probe
    whose digest equals a cold join on the concatenated build, the
    generation evictions hitting only that table's entries, and a
    ``drop``. (d) the probe-only aggregate at 10 M x 10 M: key mode
    grouped by the join key (count and a sum of each side's payload),
    and probe mode grouped by a probe column of 1024 values (k = 2: the
    cross-batch combine), every group equal to the numpy oracle; ms a
    query. (e) K = 8 requests of 1 M x 1 M combined into one step and
    split: each request's rows equal its own join's, no match crosses
    requests, and a second batch in the same slots is a cache hit. (f) 4
    emulated ranks at 1 M rows: the probe-only joins at k = 1 and 2, an
    append and the probe-mode aggregate equal to one rank's (its NCCL
    part runs in phase 13's launch). Returns the launch counts by path
    and the kernel rows at the serving shape."""
    from distributed_join_tpu_torch.benchmarks import (
        distributed_join as jdriver,
    )
    from distributed_join_tpu_torch.ops.aggregate import (
        AggregateSpec,
        aggregate_oracle,
        frames_equal,
        groups_frame,
    )
    from distributed_join_tpu_torch.parallel.communicator import (
        EmulatedCommunicator,
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        distributed_inner_join,
    )
    from distributed_join_tpu_torch.service import batching
    from distributed_join_tpu_torch.service.programs import JoinProgramCache
    from distributed_join_tpu_torch.service.resident import (
        ResidentTableRegistry,
    )
    from distributed_join_tpu_torch.table import Table
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )
    smi = gpu_line()
    paths = {}
    t_part = time.perf_counter()

    def part_done(label):
        nonlocal t_part
        now = time.perf_counter()
        print(f"[phase] 18{label}: {now - t_part:.1f} s", flush=True)
        t_part = now

    # (a) --resident-ab through the driver
    torch.cuda.empty_cache()
    rec = jdriver.run(jdriver.parse_args([
        "--build-table-nrows", str(NROWS), "--probe-table-nrows",
        str(NROWS), "--iterations", "4", "--resident-ab",
        str(RESIDENT_AB_JOINS)]), device=DEVICE)
    ab = rec["resident_ab"]
    _check("skipped" not in ab and ab["matches_equal"] and ab["digest_equal"]
           and ab["warm_probe_new_traces"] == 0 and not ab["overflow"]
           and ab["matches_cold"] == rec["matches_per_join"],
           f"--resident-ab: {json.dumps(ab)}")
    print(f"[resident] --resident-ab {RESIDENT_AB_JOINS} at {NROWS:,} x "
          f"{NROWS:,}: register {ab['register_s']:.4f} s; cold min "
          f"{ab['cold_wall_min_s'] * 1e3:.4f} ms, probe-only min "
          f"{ab['probe_only_wall_min_s'] * 1e3:.4f} ms (host clock), "
          f"speedup {ab['probe_only_speedup']:.4f}; matches "
          f"{ab['matches_probe_only']}, digests equal, warm builds "
          f"{ab['warm_probe_new_traces']}; walls "
          f"{json.dumps(ab['cold_walls_s'])} / "
          f"{json.dumps(ab['probe_only_walls_s'])}; resident "
          f"{json.dumps(ab['resident'])}; {smi}", flush=True)
    del rec
    part_done("a")

    # (b) the serving stream against a resident 10 M-row build, at each
    # capacity factor of SERVING_SETTINGS
    torch.cuda.empty_cache()
    build, _ = generate_build_probe_tables(
        seed=SEED, build_nrows=NROWS, probe_nrows=1, unique_build_keys=True,
        device=DEVICE)
    local = LocalCommunicator()
    rows = []
    for label, path, factor in SERVING_SETTINGS:
        cache = JoinProgramCache(local)
        serving = ResidentTableRegistry(
            local, cache,
            **({} if factor is None else {"capacity_factor": factor}))
        serving.register("dim", build)
        shard = serving.peek("dim").capacity_per_rank
        before = cache.stats()
        walls, counts = [], None
        for i in range(SERVING_REQUESTS):
            probe = _serving_probe(SEED + 1 + i, SERVING_PROBE_ROWS)
            if i == 1:
                # the warm request's launches and kernel inputs
                ((res, wall), counts), calls = captured_join_calls(
                    lambda: counted(lambda: _timed_s(
                        lambda: serving.join("dim", probe))))
            else:
                res, wall = _timed_s(lambda: serving.join("dim", probe))
            walls.append(wall)
            cold = distributed_inner_join(build, probe, local)
            _check(not bool(res.overflow) and not bool(cold.overflow)
                   and row_digest(res) == row_digest(cold),
                   f"serving request {i} ({label}): total "
                   f"{int(res.total)} against the cold join's "
                   f"{int(cold.total)}")
            del res, cold, probe
        after = cache.stats()
        delta = {k: after[k] - before[k]
                 for k in ("hits", "misses", "traces")}
        _check(delta == {"hits": SERVING_REQUESTS - 1, "misses": 1,
                         "traces": 1}, f"serving cache ({label}): {delta}")
        _require_launched(counts, JOIN_KERNELS, f"a request ({label})")
        paths[path] = counts
        warm = walls[1:]
        print(f"[resident] serving, capacity factor "
              f"{serving.capacity_factor} ({shard:,}-row shard): "
              f"{SERVING_REQUESTS} requests of {SERVING_PROBE_ROWS:,} probe "
              f"rows against the resident {NROWS:,}-row build, each digest "
              f"equal to a cold full join; cache {json.dumps(delta)}; ms a "
              f"request (host clock, warm) min {min(warm) * 1e3:.4f} median "
              f"{sorted(warm)[len(warm) // 2] * 1e3:.4f}, first "
              f"{walls[0] * 1e3:.4f}; launches {counts}; {smi}", flush=True)
        for r in bucket_kernel_rows(calls, label=label):
            rows.append(dict(r, path=path))
        del calls
        if factor is None:
            prof = serving_profile(serving, _serving_probe(
                SEED + 1, SERVING_PROBE_ROWS))
            print(f"[resident] serving profile, one warm request: device "
                  f"busy {prof['device_busy_ms_per_join']:.4f} of "
                  f"{prof['host_wall_ms_per_join']:.4f} ms (busy share "
                  f"{prof['device_busy_share']:.4f}); top kernels "
                  f"{json.dumps(prof['top_kernels_ms_per_join'])}; {smi}",
                  flush=True)
        del serving, cache
    part_done("b")

    # (c) LSM maintenance: four appends, one maintain, a re-probe, a drop
    torch.cuda.empty_cache()
    cache = JoinProgramCache(local)
    reg = ResidentTableRegistry(local, cache)
    reg.register("dim", build)
    other_build, other_probe = generate_build_probe_tables(
        seed=SEED + 90, build_nrows=RESIDENT_EMU_ROWS,
        probe_nrows=RESIDENT_EMU_ROWS, unique_build_keys=True,
        device=DEVICE)
    reg.register("other", other_build)
    probe = _serving_probe(SEED + 91, SERVING_PROBE_ROWS)
    reg.join("dim", probe)
    reg.join("other", other_probe)
    want_rows, want_digest = NROWS, _key_digest(build)
    _check((reg.get("dim").rows, reg.get("dim").key_digest)
           == (want_rows, want_digest), "register: conservation pair")
    deltas = []
    g = torch.Generator(device=DEVICE)
    g.manual_seed(SEED + 92)
    for i in range(LSM_DELTAS):
        d = Table.from_dense({
            "key": torch.randint(0, 2 * NROWS, (LSM_DELTA_ROWS,),
                                 generator=g, device=DEVICE),
            "build_payload": torch.arange(LSM_DELTA_ROWS, device=DEVICE)
            + NROWS * (i + 1)})
        deltas.append(d)
        h = reg.append("dim", d, maintain=False)
        want_rows += LSM_DELTA_ROWS
        want_digest = (want_digest + _key_digest(d)) % 2**64
        _check(h.generation == i + 2 and len(h.pending_runs) == i + 1,
               f"append {i}: generation {h.generation}")
    _, maintain_s = _timed_s(lambda: reg.maintain("dim"))
    h = reg.get("dim")
    _check((h.rows, h.key_digest, h.merges) == (want_rows, want_digest,
                                                LSM_DELTAS),
           f"maintain: rows {h.rows}, digest {h.key_digest:#x}, merges "
           f"{h.merges}; counted {want_rows}, {want_digest:#x}")
    _check(cache.generation_evictions == 1,
           f"generation evictions {cache.generation_evictions}: only dim's "
           "one probe program")
    other = reg.join("other", other_probe)
    _check(other.resident["warm"], "the other table's repeat was evicted")
    res = reg.join("dim", probe)
    full = Table({n: torch.cat([build.columns[n],
                                *(d.columns[n] for d in deltas)])
                  for n in build.columns},
                 torch.cat([build.valid, *(d.valid for d in deltas)]))
    cold = distributed_inner_join(full, probe, local)
    _check(not bool(res.overflow) and row_digest(res) == row_digest(cold),
           f"re-probe: total {int(res.total)}, cold {int(cold.total)}")
    reg.drop("dim")
    _check(reg.names() == ["other"] and cache.generation_evictions == 2,
           f"drop: {reg.names()}, {cache.stats()}")
    print(f"[resident] LSM: {LSM_DELTAS} appends of {LSM_DELTA_ROWS:,} "
          f"rows, one maintain {maintain_s:.4f} s (host clock), "
          f"{want_rows:,} rows and the key-hash sum conserved at every "
          f"step; re-probe digest equal to a cold join on the concatenated "
          f"build ({int(res.total)} matches); generation evictions "
          f"{cache.generation_evictions} (the other table's repeat warm); "
          f"dropped; {smi}", flush=True)
    del reg, cache, res, cold, full, deltas, other, probe
    part_done("c")

    # (d) the probe-only aggregate at 10 M x 10 M
    torch.cuda.empty_cache()
    probe = _serving_probe(SEED, NROWS, groups=AGG_GROUPS)
    reg = ResidentTableRegistry(local, JoinProgramCache(local))
    reg.register("dim", build)
    aggs = [("count", None), ("sum", "build_payload"),
            ("sum", "probe_payload")]
    agg_counts = {}
    for mode, group, k in (("key", "key", 1), ("probe", "grp", 2)):
        spec = AggregateSpec.of(group, aggs)
        (res, _), agg_counts[mode] = counted(lambda: _timed_s(
            lambda: reg.join("dim", probe, aggregate=spec,
                             over_decomposition=k)))
        walls = [_timed_s(lambda: reg.join(
            "dim", probe, aggregate=spec, over_decomposition=k))[1]
            for _ in range(AGG_ITERS)]
        got = groups_frame(res.table, spec, [group])
        _check(not bool(res.overflow) and frames_equal(
            got, aggregate_oracle(build, probe, ["key"], spec)),
            f"probe-only aggregate, {mode} mode: groups differ from numpy")
        _require_launched(agg_counts[mode], ("compact_groups",),
                          f"the probe-only aggregate, {mode} mode")
        print(f"[resident] probe-only aggregate, {mode} mode (group by "
              f"{group}, k={k}): {len(got[group]):,} groups equal to the "
              f"numpy oracle; ms a query (host clock, warm) "
              f"{[round(w * 1e3, 4) for w in walls]}; launches "
              f"{agg_counts[mode]}; {smi}", flush=True)
        del res, got
    paths["resident_agg"] = {s: sum(c[s] for c in agg_counts.values())
                             for s in agg_counts["key"]}
    del reg, probe
    part_done("d")

    # (e) micro-batching: K requests as one step
    torch.cuda.empty_cache()

    def requests(seed):
        out = []
        for i in range(BATCH_REQUESTS):
            b, p = generate_build_probe_tables(
                seed=seed + i, build_nrows=BATCH_ROWS,
                probe_nrows=BATCH_ROWS, unique_build_keys=True,
                device=DEVICE)
            tag = i << 40     # the request, in the payloads' high bits
            out.append((Table({"key": b.columns["key"], "build_payload":
                               b.columns["build_payload"] + tag}, b.valid),
                        Table({"key": p.columns["key"], "probe_payload":
                               p.columns["probe_payload"] + tag}, p.valid)))
        return out

    cache = JoinProgramCache(local)
    for batch_no, seed in enumerate((SEED + 200, SEED + 300)):
        reqs = requests(seed)
        mb = batching.combine(reqs)
        hits0 = cache.hits
        res, counts = counted(lambda: distributed_inner_join(
            mb.build, mb.probe, local, key=list(mb.key), auto_retry=1,
            program_cache=cache))
        if batch_no == 0:
            paths["batched"] = counts
            _require_launched(counts, JOIN_KERNELS, "the batched join")
        else:
            _check(cache.hits == hits0 + 1,
                   "the second batch in the same slots built a program")
        parts = batching.split(res, mb, with_rows=True)
        for i, ((b, p), part) in enumerate(zip(reqs, parts)):
            own = distributed_inner_join(b, p, local)
            want = own.table.to_host()
            got = part["rows"]
            _check(not part["overflow"] and part["matches"]
                   == int(own.total) and all(
                       np.array_equal(np.sort(got[c]), np.sort(want[c]))
                       for c in want),
                   f"batch {batch_no} request {i}: rows differ from its "
                   "own join's")
            _check(bool(((got["build_payload"] >> 40) == i).all()
                        and ((got["probe_payload"] >> 40) == i).all()),
                   f"batch {batch_no} request {i}: a match crosses requests")
        print(f"[resident] batching: {BATCH_REQUESTS} requests of "
              f"{BATCH_ROWS:,} x {BATCH_ROWS:,} in one step (batch "
              f"{batch_no}): each request's rows equal its own join's, no "
              f"match crosses requests; cache {json.dumps(cache.stats())}; "
              f"launches {counts}", flush=True)
        del res, parts, mb, reqs
    part_done("e")

    # (f) 4 emulated ranks at 1 M rows, held against one rank
    torch.cuda.empty_cache()
    eb, ep = generate_build_probe_tables(
        seed=SEED, build_nrows=RESIDENT_EMU_ROWS,
        probe_nrows=RESIDENT_EMU_ROWS, unique_build_keys=True,
        device=DEVICE)
    ep = Table({**ep.columns, "grp": ep.columns["probe_payload"] % 97},
               ep.valid)
    delta = Table.from_dense({
        "key": torch.arange(RESIDENT_EMU_ROWS // 4, device=DEVICE) * 3,
        "build_payload": torch.arange(RESIDENT_EMU_ROWS // 4,
                                      device=DEVICE)})
    spec = AggregateSpec.of("grp", aggs)
    outs = []
    for comm in (local, EmulatedCommunicator(EMU_RANKS)):
        reg = ResidentTableRegistry(comm, JoinProgramCache(comm))
        reg.register("dim", eb)
        got = [row_digest(reg.join("dim", ep, over_decomposition=k))
               for k in (1, 2)]
        reg.append("dim", delta, maintain=True)
        h = reg.get("dim")
        got.append(row_digest(reg.join("dim", ep)))
        got.append((h.rows, h.key_digest))
        agg = reg.join("dim", ep, aggregate=spec, over_decomposition=2)
        outs.append((got, groups_frame(agg.table, spec, ["grp"])))
    _check(outs[0][0] == outs[1][0] and frames_equal(outs[1][1], outs[0][1]),
           f"resident on {EMU_RANKS} emulated ranks differs from one rank")
    print(f"[resident] {EMU_RANKS} emulated ranks at {RESIDENT_EMU_ROWS:,} "
          "rows: probe-only joins at k=1 and 2, an append and the "
          "probe-mode aggregate equal to one rank's", flush=True)
    del eb, ep, build, outs
    torch.cuda.empty_cache()
    part_done("f")
    return paths, rows


# -- phase 19: the telemetry session, the watchdog and the fault plans -------


TEL_K = 4                      # over-decomposition: partition and shuffle run
TEL_ITERS = 4                  # the driver's timed joins (and as many warm)
HANG_DEADLINE_S = 5.0          # (c): the driver's --guard-deadline-s ...
HANG_DELAY_S = 60.0            # ... and the injected dispatch delay
TEL_SF = 10.0                  # (c): config 4's SF-10 batch loop
TEL_BATCHES = 4
BATCH_DEADLINE_S = 2.0         # its batch_deadline_s ...
STALL_S = 3.0                  # ... and the stalled batch's device stall
STALLED_BATCH = 2
# the kernels of each join-path source, by their __global__ names
JOIN_SOURCE_KERNELS = {"join_scans": ("r_pass", "f_pass"),
                       "stream_compact": ("compact_kernel",),
                       "expand_gather": ("expand_kernel",)}


def _worker_telemetry(drivers: dict) -> dict:
    """Phase 19(a, b) on this rank: the join driver on each ``{label:
    argv}`` through its guarded run (``benchmarks.run_guarded``, as its
    ``main`` runs it, the record returned rather than printed), every
    launch counted. Returns rank 0's records, counts and seconds."""
    from distributed_join_tpu_torch.benchmarks import (
        distributed_join as D,
        run_guarded,
        stamp_record,
    )
    from distributed_join_tpu_torch.parallel.bootstrap import process_id
    out = {}
    for label, argv in drivers.items():
        args = D.parse_args(argv)
        box = {}

        def body(a):
            box["record"] = stamp_record(D.run(a))
            return box["record"]

        t = time.perf_counter()
        rc, counts = counted(lambda: run_guarded(body, args,
                                                 "distributed_join"))
        _check(rc == 0, f"phase 19 driver {label}: rc {rc}")
        out[label] = {"record": box["record"], "launches": counts,
                      "s": time.perf_counter() - t}
        torch.cuda.empty_cache()
    return out if process_id() == 0 else None


def _worker_session_digest(comm, build, probe, tel_dir: str) -> dict:
    """Phase 19(a) on this rank: one untimed join of the driver's global
    tables at ``TEL_K`` without and with a telemetry session (its device
    trace on), each counted: the digests, totals and launches, and the
    session's device trace."""
    from distributed_join_tpu_torch import telemetry
    from distributed_join_tpu_torch.parallel.distributed_join import (
        distributed_inner_join,
    )
    out = {}
    for label in ("off", "on"):
        def join():
            return distributed_inner_join(build, probe, comm,
                                          over_decomposition=TEL_K)

        if label == "on":
            with telemetry.session(tel_dir, trace=True):
                telemetry.maybe_start_device_trace()
                res, counts = counted(join)
                path = telemetry.stop_device_trace()
            out["device_trace"] = path
        else:
            res, counts = counted(join)
        out[label] = {"digest": row_digest(res), "total": int(res.total),
                      "overflow": bool(res.overflow), "launches": counts}
        del res
    return out


TEL_AB_ORDER = (False, True, True, False, False, True, True, False)


def _worker_session_ab(comm, build, probe, tel_dir: str) -> list:
    """Phase 19(a) on this rank, before any profiler session of this
    process (a CUPTI session slows every later launch of the process):
    the step's ms a join at ``TEL_K`` (CUDA events over ``TEL_ITERS``
    dependent joins after as many warm ones) without and with a
    telemetry session (no device trace), in the turns of
    ``TEL_AB_ORDER``."""
    import contextlib

    from distributed_join_tpu_torch import telemetry
    from distributed_join_tpu_torch.parallel.distributed_join import (
        make_join_step,
    )
    from distributed_join_tpu_torch.utils.benchmarking import (
        timed_join_throughput,
    )
    step = make_join_step(comm, over_decomposition=TEL_K)
    ms = []
    for i, on in enumerate(TEL_AB_ORDER):
        with (telemetry.session(f"{tel_dir}_ab{i}") if on
              else contextlib.nullcontext()):
            sec, _, _ = timed_join_throughput(comm, step, build, probe,
                                              TEL_ITERS)
        ms.append(sec * 1e3)
    return ms


def _device_trace_sources(path: str) -> dict:
    """``{source: (launches, launches inside a join span)}`` of the
    join-path kernels in a device trace."""
    from distributed_join_tpu_torch.telemetry.export import (
        device_trace_kernels,
    )
    kernels = device_trace_kernels(path, "join")
    out = {}
    for src, names in JOIN_SOURCE_KERNELS.items():
        hits = [v for k, v in kernels.items()
                if any(re.search(rf"\b{n}\b", k) for n in names)]
        out[src] = (sum(h["launches"] for h in hits),
                    sum(h["inside"] for h in hits))
    return out


def _device_stall(inner, at: int, cycles: int):
    """``inner`` wrapped in a ``FaultInjectingCommunicator`` with an
    empty plan whose ``at``-th program call first enqueues a spin of
    ``cycles`` on the current stream: a batch whose device work ends
    late, which a host-side ``dispatch_delay_s`` (a sleep before the
    dispatch, as in the JAX package) cannot give, since the batch
    deadline bounds the settle."""
    from distributed_join_tpu_torch.parallel.faults import (
        FaultInjectingCommunicator,
        FaultPlan,
    )

    class Stall(FaultInjectingCommunicator):
        calls = 0

        def spmd(self, fn, *, sharded_out=None, local_inputs=False):
            prog = super().spmd(fn, sharded_out=sharded_out,
                                local_inputs=local_inputs)

            def run(*a):
                self.calls += 1
                if self.calls == at:
                    torch.cuda._sleep(cycles)
                return prog(*a)

            return run

    return Stall(inner, FaultPlan())


def _spin_cycles_per_s() -> float:
    """``torch.cuda._sleep``'s cycles a second on this card (CUDA
    events over 20 spins)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(20):
        torch.cuda._sleep(SPIN_CYCLES)
    end.record()
    end.synchronize()
    return 20 * SPIN_CYCLES / (start.elapsed_time(end) / 1e3)


def fault_driver(job: dict) -> int:
    """``chip_smoke.py --fault-driver JOB``: the join driver's ``main`` on
    ``JOB["argv"]`` with its communicator wrapped in
    ``FaultInjectingCommunicator(FaultPlan(**JOB["plan"]))`` (phase
    19(c): a dispatch delay past ``--guard-deadline-s``)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from distributed_join_tpu_torch.benchmarks import distributed_join as D
    from distributed_join_tpu_torch.parallel.faults import (
        FaultInjectingCommunicator,
        plan_from_record,
    )
    real = D.make_communicator
    D.make_communicator = lambda *a, **k: FaultInjectingCommunicator(
        real(*a, **k), plan_from_record(job["plan"]))
    return D.main(job["argv"])


def telemetry_phase() -> dict:
    """Phase 19: the telemetry session, the watchdog and the fault plans
    on the card. Returns ``{"telemetry": launches}``: the session-on
    driver run's, by wrapper or call site."""
    import subprocess
    import tempfile
    import threading

    from distributed_join_tpu_torch.parallel.communicator import (
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        distributed_inner_join,
        make_distributed_join,
    )
    from distributed_join_tpu_torch.parallel.faults import (
        FaultInjectingCommunicator,
        FaultPlan,
        retry_with_backoff,
    )
    from distributed_join_tpu_torch.parallel.out_of_core import (
        batched_join_host,
    )
    from distributed_join_tpu_torch.telemetry import history
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )
    from distributed_join_tpu_torch.utils.tpch_host import (
        generate_tpch_host_batches,
        rename_batches,
    )
    smi = gpu_line()
    here = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="phase19_", dir=os.path.join(
        here, "build") if os.path.isdir(os.path.join(here, "build"))
        else None)
    t_phase = time.perf_counter()

    # (c) the guard, started first in a process of its own: the driver
    # whose every dispatch sleeps HANG_DELAY_S under a HANG_DEADLINE_S
    # guard
    hang_argv = ["--communicator", "local", "--build-table-nrows",
                 str(NROWS), "--probe-table-nrows", str(NROWS),
                 "--guard-deadline-s", str(HANG_DEADLINE_S),
                 "--json-output", os.path.join(work, "hang.json")]
    t_hang = time.perf_counter()
    hang = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--fault-driver",
         json.dumps({"argv": hang_argv,
                     "plan": {"dispatch_delay_s": HANG_DELAY_S}})],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    hang_out: dict = {}

    def reap():
        try:
            hang_out["io"] = hang.communicate(timeout=HANG_DELAY_S + 120)
        except subprocess.TimeoutExpired:
            hang.kill()
            hang_out["io"] = hang.communicate()
        hang_out["s"] = time.perf_counter() - t_hang

    reaper = threading.Thread(target=reap, daemon=True)
    reaper.start()

    # (a, b) the driver over NCCL, a world of 1, in one launch: off, with
    # a session (and --history), with a session and the device trace
    # (and --history); then one join without and with a session
    tel, trc, hist = (os.path.join(work, d) for d in
                      ("tel", "trace", "history.jsonl"))
    driver = _driver_argv(NROWS, "--over-decomposition-factor", str(TEL_K),
                          "--iterations", str(TEL_ITERS))
    launched: dict = {}

    def launch():
        try:
            launched["worker"] = _worker_record("telemetry", 1, {
                "telemetry": {
                    "off": driver,
                    "session": [*driver, "--telemetry", tel, "--history",
                                hist],
                    "trace": [*driver, "--telemetry", trc, "--trace",
                              "--history", hist]},
                "session_digest": os.path.join(work, "digest")})
        except BaseException as exc:  # noqa: BLE001 — re-raised below
            launched["error"] = exc

    launcher = threading.Thread(target=launch)
    launcher.start()
    # (c)'s SF-10 host batches, generated on this host while the worker
    # runs on the card
    t = time.perf_counter()
    ob, lb = generate_tpch_host_batches(seed=SEED, scale_factor=TEL_SF,
                                        n_batches=TEL_BATCHES)
    build_b = rename_batches(ob, {"o_orderkey": "key"})
    probe_b = rename_batches(lb, {"l_orderkey": "key"})
    del ob, lb
    lines = [b["key"].shape[0] for b in probe_b]
    gen_s = time.perf_counter() - t
    launcher.join()
    if "error" in launched:
        raise launched["error"]
    worker = launched["worker"]
    runs = worker["telemetry"]
    joins = 2 * TEL_ITERS      # the warm-up loop and the timed one
    ms = {}
    for label, run in runs.items():
        rec = run["record"]
        _check(not rec["overflow"] and rec["matches_per_join"] > 0,
               f"phase 19 {label}: {json.dumps(rec)[:300]}")
        _check(("telemetry" in rec) == (label != "off"),
               f"phase 19 {label}: telemetry block "
               f"{'missing' if label != 'off' else 'present'}")
        ms[label] = rec["elapsed_per_join_s"] * 1e3
        _require_launched(run["launches"], JOIN_KERNELS,
                          f"the phase 19 {label} driver run")
    totals = {run["record"]["matches_per_join"] for run in runs.values()}
    _check(len(totals) == 1, f"phase 19: totals differ {totals}")
    # a session adds the driver's one untimed metrics join
    # (benchmarks.collect_join_metrics) to its timed ones
    for site in NCCL_SITES:
        one = runs["off"]["launches"][site] // joins
        got = {label: run["launches"][site] - (label != "off") * one
               for label, run in runs.items()}
        _check(len(set(got.values())) == 1,
               f"phase 19: {site} launched {got} (off, session, trace; "
               "the session runs less their metrics join)")
    per_join = {site: runs["off"]["launches"][site] / joins
                for site in JOIN_KERNELS}
    print(f"[telemetry] driver at {NROWS:,} x {NROWS:,}, k={TEL_K}, over "
          f"NCCL (a world of 1): ms a join off {ms['off']:.4f}, with a "
          f"session {ms['session']:.4f} ({ms['session'] / ms['off']:.4f}x)"
          f", with a session and the device trace {ms['trace']:.4f} "
          f"({ms['trace'] / ms['off']:.4f}x); launches a join equal on and "
          f"off {json.dumps(per_join)}; totals {totals.pop()}; {smi}",
          flush=True)
    # the session's files
    events = [json.loads(ln) for ln in open(os.path.join(
        tel, "events.rank0.jsonl"))]
    spans = {e["name"] for e in events if e["kind"] == "span"}
    _check({"partition", "shuffle", "join", "generate", "timed_join"}
           <= spans, f"phase 19: spans {sorted(spans)}")
    for d in (tel, trc):
        doc = json.load(open(os.path.join(d, "trace.rank0.json")))
        _check(isinstance(doc["traceEvents"], list) and doc["traceEvents"],
               f"phase 19: the Chrome trace in {d} is empty")
    device = os.path.join(trc, "device_trace", "trace.rank0.json")
    nesting = _device_trace_sources(device)
    for src, (n_all, n_in) in nesting.items():
        _check(n_all > 0 and n_in == n_all,
               f"phase 19: {src}: {n_in} of {n_all} launches inside a join "
               "span in the device trace")
    print(f"[telemetry] event log: {len(events)} records, spans "
          f"{sorted(spans)}; device trace {os.path.getsize(device):,} "
          f"bytes: every launch inside a join span "
          f"{json.dumps({k: v[0] for k, v in nesting.items()})}",
          flush=True)
    dig = worker["session_digest"]
    _check(dig["off"]["digest"] == dig["on"]["digest"]
           and dig["off"]["total"] == dig["on"]["total"] > 0
           and not dig["off"]["overflow"] and not dig["on"]["overflow"],
           f"phase 19: a join with a session differs: {json.dumps(dig)}")
    _check(all(dig["off"]["launches"][s] == dig["on"]["launches"][s]
               for s in NCCL_SITES), "phase 19: a join's launches differ "
           "with a session on")
    print(f"[telemetry] one join at k={TEL_K} with a session (device trace "
          f"on) and without: digest {tuple(dig['on']['digest'])} equal, "
          "launches equal", flush=True)
    ab = worker["session_ab_ms"]
    on = [v for v, o in zip(ab, TEL_AB_ORDER) if o]
    off = [v for v, o in zip(ab, TEL_AB_ORDER) if not o]
    print(f"[telemetry] the step at k={TEL_K}, ms a join in turns "
          f"{''.join('AB'[o] for o in TEL_AB_ORDER)} (A off, B a session "
          f"without the device trace; CUDA events over {TEL_ITERS} joins, "
          f"before any profiler in the process): "
          f"{' '.join(f'{v:.4f}' for v in ab)}; mean on / off "
          f"{sum(on) / sum(off):.4f}; {smi}", flush=True)
    # (b) two --history runs, one signature
    entries, bad = history.load_history(hist)
    sigs = {e["signature"] for e in entries}
    _check(len(entries) == 2 and bad == 0 and len(sigs) == 1
           and all(e["outcome"] == "ok" for e in entries),
           f"phase 19: history {json.dumps(entries)[:400]}")
    print(f"[telemetry] --history: 2 entries under signature {sigs.pop()}, "
          f"walls {[e['wall_s'] for e in entries]} s", flush=True)

    # (c) the fault plans on the card, in this process
    build, probe = generate_build_probe_tables(
        seed=SEED, build_nrows=NROWS, probe_nrows=NROWS,
        unique_build_keys=True, device=DEVICE)
    clean = distributed_inner_join(build, probe, LocalCommunicator(),
                                   over_decomposition=TEL_K)
    want = (row_digest(clean), int(clean.total))
    del clean
    fn = make_distributed_join(FaultInjectingCommunicator(
        LocalCommunicator(), FaultPlan(fail_dispatches=1)),
        over_decomposition=TEL_K)
    res, attempts = retry_with_backoff(lambda: fn(build, probe),
                                       max_attempts=2, backoff_s=0.01)
    _check(len(attempts) == 2 and "FaultInjectedError" in (
        attempts[0]["error"] or "") and attempts[1]["error"] is None
           and (row_digest(res), int(res.total)) == want,
           f"phase 19: fail_dispatches=1: {attempts}")
    del res
    res = distributed_inner_join(
        build, probe, FaultInjectingCommunicator(
            LocalCommunicator(), FaultPlan(overflow_programs=2)),
        over_decomposition=TEL_K, auto_retry=3)
    trail = [(a.action, a.overflow, a.shuffle_capacity_factor,
              a.out_capacity_factor) for a in res.retry_report.attempts]
    # the trail the JAX package gives this plan on the CPU
    # (tests/test_torch_faults.py holds the port's to it)
    _check(trail == [("initial", True, 1.6, 1.2),
                     ("double_capacities", True, 3.2, 2.4),
                     ("double_capacities", False, 6.4, 4.8)]
           and (row_digest(res), int(res.total)) == want,
           f"phase 19: overflow_programs=2: trail {trail}")
    print(f"[faults] fail_dispatches=1 under retry_with_backoff: recovered "
          f"on attempt 2, digest equal; overflow_programs=2: trail "
          f"{trail}, digest equal", flush=True)
    del res, build, probe, fn
    torch.cuda.empty_cache()

    # (c) config 4 at SF-10 with a batch deadline and a batch whose device
    # work ends late: partial totals, the stalled batch failed
    cycles = int(STALL_S * _spin_cycles_per_s())
    stats = {}
    # call 1 is the warm-up, 2 + b batch b's
    total, overflow = batched_join_host(
        build_b, probe_b, _device_stall(LocalCommunicator(),
                                        2 + STALLED_BATCH, cycles),
        device=DEVICE, batch_deadline_s=BATCH_DEADLINE_S,
        on_batch_failure="continue", stats=stats)
    want_partial = sum(lines) - lines[STALLED_BATCH]
    _check(stats["failed_batches"] == [STALLED_BATCH] and not overflow
           and total == want_partial,
           f"phase 19: SF-{TEL_SF:g} stalled loop: total {total}, failed "
           f"{stats['failed_batches']}, want {want_partial}")
    print(f"[faults] SF-{TEL_SF:g}, {TEL_BATCHES} batches, batch_deadline_s "
          f"{BATCH_DEADLINE_S} and batch {STALLED_BATCH}'s device work "
          f"{STALL_S} s late: failed batches {stats['failed_batches']}, "
          f"partial total {total} (= {sum(lines)} - {lines[STALLED_BATCH]}"
          f"); generation {gen_s:.1f} s (beside the worker), loop "
          f"{stats['elapsed_s']:.3f} s",
          flush=True)
    del build_b, probe_b

    # (c) the guard's result
    reaper.join(HANG_DELAY_S + 180)
    _check(not reaper.is_alive() and hang.returncode is not None,
           "phase 19: the guarded driver did not exit")
    out, err = hang_out["io"]
    hang_s = hang_out["s"]
    lines_out = [ln for ln in out.splitlines() if ln.startswith("{")]
    rec = json.loads(lines_out[-1]) if lines_out else {}
    fail = rec.get("failure") or {}
    _check(hang.returncode == 1 and fail.get("error") == "HangError"
           and fail.get("deadline_s") == HANG_DEADLINE_S
           and hang_s < HANG_DELAY_S,
           f"phase 19: guarded driver rc {hang.returncode}, record "
           f"{json.dumps(rec)[:300]}, {hang_s:.1f} s; {err[-2000:]}")
    print(f"[faults] driver with a {HANG_DELAY_S:g} s dispatch delay under "
          f"--guard-deadline-s {HANG_DEADLINE_S:g}: rc 1, record "
          f"{json.dumps(fail)}, exited {hang_s:.1f} s after its start "
          f"(process start, tables and the {HANG_DEADLINE_S:g} s guard)",
          flush=True)
    print(f"[phase] telemetry_phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {"telemetry": runs["trace"]["launches"]}


SERVICE_BATCH = 16             # (c): small joins, batched and one by one
SERVICE_BATCH_ROWS = 1 << 16   # rows a side of each small join
SERVICE_QUERY_SF = 1.0         # (d): Q3 through the query op
SERVICE_DRAIN_ROWS = 1_000_000  # (g): the in-flight join's rows a side
SMOKE_DRILL_JOINS = 200        # (h): the smoke's resident drill, joins a side
# phase 18(b)'s in-process ms a request (NVIDIA H100 80GB HBM3, 700.00 W;
# PERF.md, PR 15 run 8)
SERVING_18B_MS = 4.22


def service_phase() -> dict:
    """Phase 20: the join service's daemon (``python -m
    distributed_join_tpu_torch.service.server``) over TCP on localhost,
    the ``local`` communicator on this card, at phase 18's shapes. (a) a
    10 M-row build (seed 42, unique keys) registered over the wire, then
    32 resident ``join`` requests of 2^18 probe rows, each from its own
    seed, at the default capacity factor 1.5: each response's matches
    equal an in-process ``ResidentTableRegistry.join`` of the same tables
    (the probe drawn by the daemon's own ``_probe_from_spec``), the cache
    1 miss and 31 hits, no build on a warm request; the client's ms a
    request; the ``metrics`` op's p50 <= p95 <= p99 for the resident
    joins and ``djtpu_requests_total`` in the Prometheus text. (b) a wire
    ``join`` at 10 M x 10 M (seed 42), cold then warm: the warm request
    builds nothing, and its matches equal ``distributed_inner_join`` on
    the tables the same spec generates in process. (c) ``batch`` of 16
    joins of 2^16 rows a side against the same 16 sent one by one, both
    warm: equal per-request matches; both walls. (d) a ``query`` op, Q3
    at SF-1: its groups equal the numpy oracle (the in-process repeat of
    the same plan on the service, a cache hit, gives the frame); between
    (b)'s cold and warm joins an ``explain`` op of the same spec, whose
    digest must equal the cache key the warm join then runs under. (e)
    ``append`` of 1 M rows, ``tables``, ``drop``, ``stats`` (uptime,
    pending high-water mark) and ``ping``. (f) the poison drill
    (``server._poison_drill``: ``FaultPlan(dispatch_delay_s=3.0)`` under
    a 0.75 s deadline): the request hangs, the next is refused,
    ``flightrecorder.json`` lands, the detached worker is joined. (g) a
    daemon over ``FaultPlan(dispatch_delay_s=1.0,
    delay_after_dispatches=1)``: ``drain`` settles an in-flight join
    before it answers, then a join refuses with ``DrainingError``. (h)
    ``--smoke --history-dir DIR --smoke-resident-joins 200`` as a
    subprocess, its wall gates on (the batch beats one by one; the warm
    probe-only join beats the warm full join on the median over 200
    back-to-back pairs of their wall ratio): rc 0, warm builds 0, >= 2 history signatures, its explain step's program resident, nothing
    ``not_ported``, and its baseline gate skipping the committed CPU
    baselines (drawn over 8 emulated ranks; phase 22(e) gates on the
    card). Launches
    are counted over (a)-(e)'s wire requests only (the in-process
    references launch outside the counts). Returns ``{"service":
    launches}``."""
    import shutil
    import subprocess
    import tempfile
    import threading
    from types import SimpleNamespace

    from distributed_join_tpu_torch.ops.aggregate import (
        frames_equal,
        groups_frame,
    )
    from distributed_join_tpu_torch.parallel.communicator import (
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        distributed_inner_join,
    )
    from distributed_join_tpu_torch.parallel.faults import (
        FaultInjectingCommunicator,
        FaultPlan,
    )
    from distributed_join_tpu_torch.service import server
    from distributed_join_tpu_torch.service.programs import JoinProgramCache
    from distributed_join_tpu_torch.service.resident import (
        ResidentTableRegistry,
    )
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )
    from distributed_join_tpu_torch.utils.tpch_host import query_oracle
    smi = gpu_line()
    t_phase = t_part = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="service_phase_")

    def part_done(label):
        nonlocal t_part
        now = time.perf_counter()
        print(f"[phase] 20{label}: {now - t_part:.1f} s", flush=True)
        t_part = now

    svc = server.JoinService(LocalCommunicator(), server.ServiceConfig(
        history_dir=os.path.join(tmp, "hist")))
    _check(svc.device == torch.device(DEVICE),
           f"the service's device {svc.device}")
    daemon, port = server.start_daemon(svc)
    client = server.ServiceClient("127.0.0.1", port)
    launches: dict = {}

    def wire(payload: dict, what: str, ok: bool = True):
        """One request through the daemon: (response, client seconds);
        its launches add to the service path's."""
        box = {}

        def send():
            t0 = time.perf_counter()
            box["resp"] = client.send(dict(payload))
            box["s"] = time.perf_counter() - t0

        _, counts = counted(send)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        resp = box["resp"]
        if ok:
            _check(resp.get("ok"), f"{what}: {json.dumps(resp)[:600]}")
        return resp, box["s"]

    try:
        # (a) a resident table over the wire
        torch.cuda.empty_cache()
        reg_spec = {"op": "register", "name": "dim", "rows": NROWS,
                    "seed": SEED, "unique_keys": True}
        reg, reg_s = wire(reg_spec, "register")
        handle = svc.resident.get("dim")
        ref_build, _ = server._build_from_spec(reg_spec, DEVICE)
        ref_comm = LocalCommunicator()
        ref = ResidentTableRegistry(ref_comm, JoinProgramCache(ref_comm))
        ref.register("dim", ref_build)
        before = svc.cache.stats()
        walls, traces, daemon_s = [], [], []
        for i in range(SERVING_REQUESTS):
            spec = {"op": "join", "table": "dim",
                    "probe_nrows": SERVING_PROBE_ROWS, "seed": SEED + 1 + i}
            resp, s = wire(spec, f"resident join {i}")
            walls.append(s)
            daemon_s.append(resp["elapsed_s"])
            traces.append(resp["new_traces"])
            probe = server._probe_from_spec(spec, handle, DEVICE)
            want = ref.join("dim", probe)
            _check(not resp["overflow"] and not bool(want.overflow)
                   and resp["matches"] == int(want.total),
                   f"resident join {i}: {resp['matches']} matches against "
                   f"the in-process registry's {int(want.total)}")
            del probe, want
        after = svc.cache.stats()
        delta = {k: after[k] - before[k] for k in ("hits", "misses",
                                                   "traces")}
        _check(delta == {"hits": SERVING_REQUESTS - 1, "misses": 1,
                         "traces": 1}, f"service cache: {delta}")
        _check(traces[0] == 1 and not any(traces[1:]),
               f"builds a request: {traces}")
        warm = sorted(walls[1:])
        served = sorted(daemon_s[1:])
        met, _ = wire({"op": "metrics"}, "metrics")
        lat = met["metrics"]["ops"]["resident_join"]["latency"]
        _check(lat["count"] == SERVING_REQUESTS and lat["p50_s"]
               and lat["p50_s"] <= lat["p95_s"] <= lat["p99_s"],
               f"resident_join latency {json.dumps(lat)}")
        prom, _ = wire({"op": "metrics", "format": "prometheus"},
                       "prometheus")
        _check("djtpu_requests_total" in prom["prometheus"],
               "the Prometheus text lacks djtpu_requests_total")
        print(f"[service] (a) register {NROWS:,} rows over the wire "
              f"{reg_s:.4f} s (client clock; {reg['capacity_per_rank']:,}-"
              f"row shard); {SERVING_REQUESTS} resident joins of "
              f"{SERVING_PROBE_ROWS:,} probe rows, each equal to the "
              f"in-process registry's join; cache {json.dumps(delta)}; "
              f"client ms a request (warm) min {warm[0] * 1e3:.4f} median "
              f"{warm[len(warm) // 2] * 1e3:.4f}, first "
              f"{walls[0] * 1e3:.4f} (in process, phase 18(b): "
              f"{SERVING_18B_MS} ms); the daemon's resident_join call "
              f"(the probe drawn before it) min {served[0] * 1e3:.4f} "
              f"median {served[len(served) // 2] * 1e3:.4f}; the metrics "
              f"op's latency p50/p95/p99 "
              f"{lat['p50_s'] * 1e3:.3f}/{lat['p95_s'] * 1e3:.3f}/"
              f"{lat['p99_s'] * 1e3:.3f} ms; {smi}", flush=True)
        del ref, ref_build
        part_done("a")

        # (b) a wire join at 10 M x 10 M, cold then warm
        torch.cuda.empty_cache()
        spec = {"op": "join", "build_nrows": NROWS, "probe_nrows": NROWS,
                "seed": SEED, "selectivity": 0.3}
        cold, cold_s = wire(spec, "cold join")
        exp, exp_s = wire({**{k: v for k, v in spec.items() if k != "op"},
                           "op": "explain"}, "explain")
        traces0 = svc.cache.traces
        warmj, warm_s = wire(spec, "warm join")
        # the warm join hit the program the explain named: its key is the
        # cache's most recently used one
        key = next(reversed(svc.cache._entries)).digest()
        _check(exp["plan"]["signature_digest"] == key
               and exp["cache"]["resident"] and svc.cache.traces == traces0,
               f"explain: digest {exp['plan']['signature_digest'][:16]} "
               f"against the join's key {key[:16]}, cache {exp['cache']}")
        build, probe = generate_build_probe_tables(
            seed=SEED, build_nrows=NROWS, probe_nrows=NROWS, device=DEVICE)
        want = distributed_inner_join(build, probe, LocalCommunicator(),
                                      auto_retry=2)
        _check(warmj["new_traces"] == 0 and cold["new_traces"] >= 1
               and warmj["matches"] == cold["matches"] == int(want.total)
               and not warmj["overflow"],
               f"wire join: cold {cold['matches']} ({cold['new_traces']} "
               f"builds), warm {warmj['matches']} ({warmj['new_traces']}), "
               f"in process {int(want.total)}")
        print(f"[service] (b) wire join {NROWS:,} x {NROWS:,}: "
              f"{warmj['matches']:,} matches, equal to the in-process join; "
              f"cold {cold_s * 1e3:.4f} ms ({cold['new_traces']} build), warm "
              f"{warm_s * 1e3:.4f} ms run-only (client clock, the daemon's "
              f"generation of both tables included; daemon elapsed "
              f"{warmj['elapsed_s'] * 1e3:.4f} ms); the explain op before "
              f"the warm join: digest {key[:16]} equal to the key it ran "
              f"under, resident, predicted "
              f"{exp['cost']['total_s'] * 1e3:.4f} ms ({exp_s * 1e3:.4f} ms "
              f"to answer, client clock); {smi}", flush=True)
        del build, probe, want
        part_done("b")

        # (c) batched against sequential
        torch.cuda.empty_cache()
        small = [{"op": "join", "build_nrows": SERVICE_BATCH_ROWS,
                  "probe_nrows": SERVICE_BATCH_ROWS, "seed": 100 + i,
                  "selectivity": 0.5, "out_capacity_factor": 3.0}
                 for i in range(SERVICE_BATCH)]
        batch_req = {"op": "batch", "out_capacity_factor": 3.0,
                     "requests": [{k: v for k, v in s.items() if k != "op"}
                                  for s in small]}
        for s in small:
            wire(s, "sequential warm-up")
        wire(batch_req, "batch warm-up")
        t0 = time.perf_counter()
        seq = [wire(s, "sequential")[0] for s in small]
        seq_s = time.perf_counter() - t0
        seq_daemon_s = sum(r["elapsed_s"] for r in seq)
        batched, batched_s = wire(batch_req, "batch")
        seq_m = [r["matches"] for r in seq]
        bat_m = [r["matches"] for r in batched["requests"]]
        _check(seq_m == bat_m and all(seq_m)
               and not any(r["new_traces"] for r in seq)
               and batched["new_traces"] == 0,
               f"batched {bat_m} against sequential {seq_m}")
        print(f"[service] (c) {SERVICE_BATCH} joins of "
              f"{SERVICE_BATCH_ROWS:,} rows a side, warm: one by one "
              f"{seq_s * 1e3:.4f} ms, batched {batched_s * 1e3:.4f} ms "
              f"(client clock; speedup {seq_s / batched_s:.4f}); of which "
              f"the daemon's join calls (the tables drawn before them) "
              f"{seq_daemon_s * 1e3:.4f} and {batched['elapsed_s'] * 1e3:.4f}"
              f" ms; equal per-request matches; {smi}", flush=True)
        part_done("c")

        # (d) a query op: Q3 at SF-1
        torch.cuda.empty_cache()
        qspec = {"op": "query", "query": "q3",
                 "scale_factor": SERVICE_QUERY_SF, "seed": SEED}
        q, q_s = wire(qspec, "query")
        tables, plan = server._query_from_spec(qspec, DEVICE)
        res = svc.query(tables, plan)
        spec_agg = plan.aggregate
        got = groups_frame(res.table, spec_agg, list(spec_agg.group_keys))
        oracle = query_oracle(plan, {n: t.to_host()
                                     for n, t in tables.items()})
        _check(not q["overflow"] and res.new_traces == 0
               and q["groups"] == res.groups > 0
               and frames_equal(got, oracle),
               f"query q3: {q['groups']} groups on the wire, {res.groups} "
               "in process, against the numpy oracle")
        print(f"[service] (d) query q3 SF-{SERVICE_QUERY_SF:g}: "
              f"{q['groups']} groups equal to the numpy oracle, op_totals "
              f"{q['op_totals']}; {q_s * 1e3:.4f} ms cold (client clock); "
              f"{smi}", flush=True)
        del tables, res
        part_done("d")

        # (e) table housekeeping
        app, _ = wire({"op": "append", "name": "dim",
                       "rows": LSM_DELTA_ROWS, "seed": SEED + 99},
                      "append")
        tabs, _ = wire({"op": "tables"}, "tables")
        drop, _ = wire({"op": "drop", "name": "dim"}, "drop")
        stats, _ = wire({"op": "stats"}, "stats")
        ping, _ = wire({"op": "ping"}, "ping")
        _check(app["generation"] == 2 and tabs["count"] == 1
               and drop["dropped"] and stats["uptime_s"] > 0
               and stats["pending_hwm"] >= 1 and stats["failed"] == 0
               and not svc.resident.names(),
               f"housekeeping: append {json.dumps(app)[:300]}, stats "
               f"{json.dumps(stats)[:300]}")
        print(f"[service] (e) append {LSM_DELTA_ROWS:,} rows (generation "
              f"{app['generation']}, pending runs {app['pending_runs']}), "
              f"tables, drop, ping; stats served {stats['served']}, uptime "
              f"{stats['uptime_s']} s, pending high-water "
              f"{stats['pending_hwm']}; launches on the service path "
              f"{launches}", flush=True)
        _require_launched(launches, JOIN_KERNELS + ("compact_groups",),
                          "the service path")
        client.send({"op": "shutdown"})
    finally:
        client.close()
        daemon.server_close()
    part_done("e")

    # (f) the poison drill on the card
    fr = os.path.join(tmp, "flightrecorder.json")
    drill = server._poison_drill(SimpleNamespace(
        communicator="local", n_ranks=None, flight_recorder_path=fr),
        None)
    _check(drill["flightrecorder"] == fr and os.path.exists(fr)
           and drill["rejected_after_poison"] == 1
           and not [t for t in threading.enumerate()
                    if t.name.startswith("watchdog-request")],
           f"poison drill: {json.dumps(drill)}")
    print(f"[service] (f) poison drill: {json.dumps(drill)}", flush=True)
    part_done("f")

    # (g) drain
    dsvc = server.JoinService(FaultInjectingCommunicator(
        LocalCommunicator(), FaultPlan(dispatch_delay_s=1.0,
                                       delay_after_dispatches=1)))
    ddaemon, dport = server.start_daemon(dsvc)
    clients = [server.ServiceClient("127.0.0.1", dport) for _ in range(3)]
    dq = {"op": "join", "build_nrows": SERVICE_DRAIN_ROWS,
          "probe_nrows": SERVICE_DRAIN_ROWS, "seed": SEED}
    done = {}
    try:
        _check(clients[0].send(dict(dq))["ok"], "drain: the first join")

        def slow():
            done["resp"] = clients[0].send(dict(dq))
            done["t"] = time.monotonic()

        th = threading.Thread(target=slow)
        th.start()
        time.sleep(0.3)
        drained = clients[1].send({"op": "drain", "reason": "phase 20",
                                   "settle_timeout_s": 30.0})
        t_drained = time.monotonic()
        th.join(timeout=60.0)
        late = clients[2].send(dict(dq))
        _check(drained["ok"] and drained["drained"]
               and drained["pending"] == 0 and done["resp"]["ok"]
               and t_drained >= done["t"]
               and late.get("error") == "DrainingError",
               f"drain: {json.dumps(drained)}, in flight "
               f"{json.dumps(done.get('resp'))[:200]}, late {late}")
        print(f"[service] (g) drain settled the in-flight join "
              f"({done['resp']['matches']:,} matches) before answering; "
              f"then {late['error']}: {late['message']}", flush=True)
    finally:
        for c in clients:
            c.close()
        ddaemon.server_close()
    part_done("g")

    # (h) --smoke through the CLI
    hist = os.path.join(tmp, "smoke_hist")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "distributed_join_tpu_torch.service.server",
         "--smoke", "--history-dir", hist,
         "--flight-recorder-path", os.path.join(tmp, "smoke_fr.json"),
         "--smoke-resident-joins", str(SMOKE_DRILL_JOINS)],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    smoke_s = time.perf_counter() - t0
    lines_out = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    rec = json.loads(lines_out[-1]) if lines_out else {}
    _check(r.returncode == 0 and rec.get("warm_new_traces") == 0
           and (rec.get("history") or {}).get("n_signatures", 0) >= 2
           and (rec.get("explain") or {}).get("cache", {}).get("resident")
           and "not_ported" not in rec
           and all("drawn at" in v.get("skipped", "")
                   for v in rec.get("baseline_gate", {"-": {}}).values()),
           f"--smoke rc {r.returncode}: {r.stdout[-1500:]} "
           f"{r.stderr[-3000:]}")
    print(f"[service] (h) --smoke: rc 0 in {smoke_s:.1f} s; warm builds 0; "
          f"history {json.dumps(rec['history'])}; batched "
          f"{rec['batched_s'] * 1e3:.4f} ms against sequential "
          f"{rec['sequential_s'] * 1e3:.4f} ms; resident drill speedup "
          f"{rec['resident_drill']['probe_only_speedup']:.4f} (median "
          f"over pairs; probe-only won "
          f"{rec['resident_drill']['probe_only_pair_wins']} of "
          f"{SMOKE_DRILL_JOINS}; medians "
          f"{rec['resident_drill']['cold_wall_median_s'] * 1e3:.4f} ms full, "
          f"{rec['resident_drill']['probe_only_wall_median_s'] * 1e3:.4f} ms "
          f"probe-only); baseline "
          f"gate {json.dumps(rec['baseline_gate'])}; {smi}", flush=True)
    part_done("h")
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"[phase] service_phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {"service": launches}


# -- phase 21: the cost model fitted on the card, graded, and the tape -----

COST_RANKS = 4                 # (b), (c): emulated ranks on this card
COST_K = 4                     # (b): the k = 4 join's over-decomposition
COST_SERVING_REQUESTS = 8      # (b): warm requests timed
NCCL_LATENCY_ELEMS = 1024      # (a): 8 KiB of int64 a call
NCCL_LATENCY_REPS = 200
HBM_COPY_BYTES = 2 << 30       # (a): the device copy
COST_WIRES = (                 # (c): (label, slices, join options)
    ("tape_padded", 1, {}),
    ("tape_ppermute", 1, {"shuffle": "ppermute"}),
    ("tape_compressed16", 1, {"compression_bits": 16}),
    ("tape_hier2x2", 2, {"shuffle": "hierarchical", "dcn_codec": "on"}),
    ("tape_ragged", 1, {"shuffle": "ragged"}),
)


def clustered(t):
    """``t`` stored in key order, each payload the row id again (the
    generator's payload): a clustered table, the layout the codec is
    for. A 256-row codec block of a bucket then spans about a thousand
    keys and row ids, which 16 bits hold; on the generator's order the
    row ids span the whole table and the 16-bit rung overflows."""
    from distributed_join_tpu_torch.table import Table
    order = torch.argsort(t.columns["key"], stable=True)
    cols = {name: (torch.arange(order.numel(), dtype=col.dtype,
                                device=col.device)
                   if name.endswith("payload") else col[order])
            for name, col in t.columns.items()}
    return Table(cols, t.valid[order])


def cuda_kernels(fn) -> int:
    """The CUDA kernels ``fn`` launches (every one, torch's included),
    counted by torch.profiler over one call after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type == cuda)


def _nccl_latency_s() -> float:
    """One NCCL ``all_to_all_single`` of ``NCCL_LATENCY_ELEMS`` int64
    over a process group of this process alone, per call."""
    import socket

    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0,
                            device_id=torch.device(DEVICE, 0))
    try:
        x = torch.arange(NCCL_LATENCY_ELEMS, dtype=torch.int64, device=DEVICE)
        out = torch.empty_like(x)
        ms = time_ms(lambda: dist.all_to_all_single(out, x),
                     reps=NCCL_LATENCY_REPS)
        _check(torch.equal(out, x), "NCCL all_to_all over a world of 1")
    finally:
        dist.destroy_process_group()
    return ms / 1e3


def fit_constants(build, probe) -> tuple:
    """Phase 21(a): each primitive the cost model prices, timed with CUDA
    events on the port's own code at the headline's shape (20 M merged
    positions), as the ``CostModel`` field it fits. Returns (fields,
    rows: what each was timed on)."""
    import math

    from distributed_join_tpu_torch.ops import compact, compression, expand
    from distributed_join_tpu_torch.ops import join as J
    from distributed_join_tpu_torch.ops import scan
    from distributed_join_tpu_torch.ops import segmented as seg_ops
    from distributed_join_tpu_torch.ops.partition import (
        radix_hash_partition,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        DEFAULT_SHUFFLE_CAPACITY_FACTOR,
        _round_up,
    )
    from distributed_join_tpu_torch.table import Table
    out_cap = int(0.6 * NROWS * 1.25)
    x = stage_inputs(build, probe, out_cap)
    n = x["tag"].shape[0]
    keys, b1d, p1d = ["key"], ["build_payload"], ["probe_payload"]
    fields, rows = {}, {}

    def per(name, ms, elems, what):
        fields[name] = ms * 1e6 / elems
        rows[name] = {"ms": ms, "elements": elems, "on": what}

    per("sort_ns_per_elem", time_ms(lambda: J._merged_sort(
        build, probe, keys, b1d, p1d)), n,
        "ops/join._merged_sort (int64 key + int8 tag, the payload lane)")
    wide = Table({**probe.columns, "probe_x": probe.columns["probe_payload"]
                  + 1}, probe.valid)
    lane_ms = time_ms(lambda: J._merged_sort(build, wide, keys, b1d,
                                             p1d + ["probe_x"]))
    per("sort_lane_ns_per_elem", max(lane_ms - rows["sort_ns_per_elem"]["ms"],
                                     0.0), n,
        "one more int64 value lane on the merged sort")
    seg = seg_ops.resolve_sort_segments(None, NROWS, 1, COST_K,
                                        DEFAULT_SHUFFLE_CAPACITY_FACTOR)
    run = 2 * seg_ops.segment_capacity(NROWS, 1, COST_K, seg,
                                       DEFAULT_SHUFFLE_CAPACITY_FACTOR)
    n_runs = max(n // run, 1)
    used = n_runs * run
    k2 = x["sort_ops"][0][:used].reshape(n_runs, run)
    t2 = x["sort_ops"][1][:used].reshape(n_runs, run)
    v2 = x["sort_ops"][2][:used].reshape(n_runs, run)

    def batched_sort():
        perm = seg_ops._lexsort_rows([k2, t2])
        return torch.take_along_dim(v2, perm, 1)

    per("sort_run_ns_per_elem", time_ms(batched_sort), used,
        f"ops/segmented._lexsort_rows on ({n_runs}, {run}) runs, the value "
        "lane gathered")
    per("scan_ns_per_elem", time_ms(lambda: scan.join_scans(
        x["tag"], x["first"])), n, "join_scans")
    per("compact_ns_per_elem", time_ms(lambda: compact.stream_compact(
        x["is_rec"], x["rec_pos"], x["rec_lanes"], out_cap)), n,
        "stream_compact, the run-record site")
    S, lo, rc, pk = x["S"], x["lo"], x["rec_cols"], x["pack"]
    per("expand_ns_per_out_row", time_ms(lambda: expand.expand_gather(
        S, rc, out_cap, lo=lo, build_cols=pk)), out_cap,
        "expand_gather, build mode")
    del x
    g = torch.Generator(device=DEVICE)
    g.manual_seed(SEED)
    vals = torch.randint(0, 2**62, (n,), generator=g, device=DEVICE)
    idx = torch.randperm(n, generator=g, device=DEVICE)
    per("gather_ns_per_elem", time_ms(lambda: vals[idx]), n,
        "a random int64 gather")
    col2d = torch.randint(0, 256, (n, 16), generator=g, device=DEVICE,
                          dtype=torch.uint8)
    per("row_gather_ns_per_row", time_ms(lambda: J._row_gather(
        col2d, idx, n)), n, "ops/join._row_gather of 16-byte rows")
    del vals, idx, col2d
    blob = torch.empty(HBM_COPY_BYTES, dtype=torch.uint8, device=DEVICE)
    ms = time_ms(lambda: blob.clone(), reps=5)
    fields["hbm_bytes_per_s"] = 2 * HBM_COPY_BYTES / (ms / 1e3)
    rows["hbm_bytes_per_s"] = {"ms": ms, "bytes": 2 * HBM_COPY_BYTES,
                               "on": "a device copy (read + write)"}
    del blob
    cap = _round_up(int(math.ceil(
        NROWS / COST_K * DEFAULT_SHUFFLE_CAPACITY_FACTOR)), 8)
    pt = radix_hash_partition(build, ["key"], COST_K)
    padded, counts, _, row_valid = pt.to_padded(cap, 0, 1)
    block = torch.where(row_valid, padded["key"],
                        padded["key"][0, counts[0] - 1])
    enc = compression.encode_rows(block, 16, 256, required_bits=False)
    e_ms = time_ms(lambda: compression.encode_rows(block, 16, 256,
                                                   required_bits=False))
    d_ms = time_ms(lambda: compression.decode_rows(enc[0], enc[1], cap, 16,
                                                   256, block.dtype))
    fields["codec_bytes_per_s"] = 2 * block.nbytes / ((e_ms + d_ms) / 1e3)
    rows["codec_bytes_per_s"] = {"encode_ms": e_ms, "decode_ms": d_ms,
                                 "raw_bytes": block.nbytes,
                                 "on": "a k = 4 batch's int64 key block, "
                                       "16 bits"}
    del pt, padded, block, enc
    fields["collective_latency_s"] = _nccl_latency_s()
    rows["collective_latency_s"] = {
        "bytes": 8 * NCCL_LATENCY_ELEMS, "reps": NCCL_LATENCY_REPS,
        "on": "NCCL all_to_all_single over a world of 1"}
    fields["hbm_capacity_bytes"] = torch.cuda.get_device_properties(
        0).total_memory
    return fields, rows


def cost_phase() -> dict:
    """Phase 21: the cost model of ``planning/cost.py`` on the card. (a)
    fits its constants (``fit_constants``) at the headline's shape and
    prints them beside the card's name and power limit (the defaults
    of ``CostModel`` are these numbers). (b) grades the shipped model:
    predicted against measured walls, without a gate, of the headline
    (``build_plan``), a k = 4 join over 4 emulated ranks at 10 M x 10 M,
    one serving request of phase 18(b)'s shape (``build_probe_plan``,
    through ``ResidentTableRegistry.join(explain=True)``) and Q3 at
    SF-10 (``explain_query``). (c) the metrics tape at full width, 4
    emulated ranks at 10 M x 10 M, the tables stored in key order
    (``clustered``, so that the 16-bit codec holds): no wire overflows;
    on the padded, ppermute, 16-bit compressed and 2 x 2 hierarchical
    wires the counted bytes equal the plan's prediction exactly (both
    tiers of the hierarchy), on the ragged wire they stay within the
    plan's estimate; ``matches`` equals the join's total, the same on
    every wire and equal to the tape-off join's; an anti join runs
    the record-mode expand with the tape; with the tape off a join
    launches each kernel exactly as with it on, n_ranks x k times; the
    CUDA kernels the tape adds are counted (torch.profiler), and its ms
    on the headline join. Returns the launch counts by path."""
    from distributed_join_tpu_torch import bench
    from distributed_join_tpu_torch.parallel.communicator import (
        EmulatedCommunicator,
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        distributed_inner_join,
        make_distributed_join,
        make_join_step,
    )
    from distributed_join_tpu_torch.parallel.query_exec import (
        distributed_query,
    )
    from distributed_join_tpu_torch.planning import cost
    from distributed_join_tpu_torch.planning.plan import build_plan
    from distributed_join_tpu_torch.planning.query import (
        explain_query,
        tpch_query_plan,
    )
    from distributed_join_tpu_torch.service.programs import JoinProgramCache
    from distributed_join_tpu_torch.service.resident import (
        ResidentTableRegistry,
    )
    from distributed_join_tpu_torch.utils.benchmarking import (
        timed_join_throughput,
    )
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )
    from distributed_join_tpu_torch.utils.tpch import (
        generate_tpch_query_tables,
        query_filters,
    )
    smi = gpu_line()
    t_part = time.perf_counter()
    paths = {}

    def part_done(label):
        nonlocal t_part
        now = time.perf_counter()
        print(f"[phase] 21{label}: {now - t_part:.1f} s", flush=True)
        t_part = now

    build, probe = generate_build_probe_tables(
        seed=SEED, build_nrows=NROWS, probe_nrows=NROWS,
        selectivity=bench.SELECTIVITY, device=DEVICE)

    # (a) the constants
    fields, fit_rows = fit_constants(build, probe)
    shipped = cost.CostModel()
    print(f"[cost] (a) fitted constants {json.dumps(fields)}; {smi}",
          flush=True)
    print(f"[cost] (a) timed on {json.dumps(fit_rows)}", flush=True)
    print("[cost] (a) fitted / shipped default: " + json.dumps(
        {k: v / getattr(shipped, k) for k, v in fields.items()}),
        flush=True)
    part_done("a")

    # (b) the shipped model graded
    graded = {}
    local = LocalCommunicator()
    match_out = int(bench.MATCHES_PER_ROW * NROWS * bench.OUT_SLACK)
    step = make_join_step(local, key="key", out_rows_per_rank=match_out)
    sec, total, ovf = timed_join_throughput(local, step, build, probe,
                                            bench.ITERS)
    _check(not ovf and total > 0, "phase 21 headline join")
    plan = build_plan(local, build, probe, with_metrics=False,
                      out_rows_per_rank=match_out)
    graded["headline"] = (plan.cost["total_s"], sec)
    emu = EmulatedCommunicator(COST_RANKS)
    fn = make_distributed_join(emu, over_decomposition=COST_K,
                               with_metrics=False)
    res = fn(build, probe)
    _check(not bool(res.overflow), "phase 21 k = 4 join overflowed")
    del res
    ms = time_ms(lambda: fn(build, probe), reps=3)
    plan = build_plan(emu, build, probe, with_metrics=False,
                      over_decomposition=COST_K)
    graded[f"k{COST_K}_{COST_RANKS}_emulated_ranks"] = (plan.cost["total_s"],
                                                       ms / 1e3)
    reg_build, _ = generate_build_probe_tables(
        seed=SEED, build_nrows=NROWS, probe_nrows=SERVING_PROBE_ROWS,
        unique_build_keys=True, device=DEVICE)
    registry = ResidentTableRegistry(local, JoinProgramCache(local))
    registry.register("dim", reg_build)
    del reg_build
    sprobe = _serving_probe(SEED + 1, SERVING_PROBE_ROWS)
    first = registry.join("dim", sprobe, explain=True, with_metrics=False)
    walls = sorted(_timed_s(lambda: registry.join(
        "dim", sprobe, with_metrics=False))[1]
        for _ in range(COST_SERVING_REQUESTS))
    graded["serving_request"] = (first.plan.cost["total_s"],
                                 walls[len(walls) // 2])
    _check(first.plan.probe_only
           and first.plan.digest in {s.digest()
                                     for s in registry.cache._entries},
           "phase 21: the serving plan's digest is not the cache key")
    del registry, sprobe, first
    torch.cuda.empty_cache()
    tables = query_filters(generate_tpch_query_tables(
        seed=SEED, scale_factor=QUERY_SF, device=DEVICE), "q3")
    qplan = tpch_query_plan("q3")
    cache = JoinProgramCache(local)
    factors = dict(over_decomposition=1, shuffle_capacity_factor=1.6,
                   out_capacity_factor=1.5)
    qres = distributed_query(tables, qplan, local, auto_retry=4,
                             program_cache=cache, with_metrics=False,
                             **factors)
    _check(not bool(qres.overflow), "phase 21 Q3 overflowed")
    scale = 2 ** qres.retry_attempts
    walls = sorted(_timed_s(lambda: distributed_query(
        tables, qplan, local, auto_retry=4, program_cache=cache,
        with_metrics=False, **factors))[1] for _ in range(QUERY_ITERS))
    doc = explain_query(qplan, local, tables, defaults=dict(
        factors, shuffle_capacity_factor=1.6 * scale,
        out_capacity_factor=1.5 * scale))
    graded["q3_sf10"] = (doc["total_s"], walls[len(walls) // 2])
    del tables, qres, cache
    torch.cuda.empty_cache()
    for name, (pred, meas) in graded.items():
        print(f"[cost] (b) {name}: predicted {pred * 1e3:.4f} ms, measured "
              f"{meas * 1e3:.4f} ms (measured / predicted "
              f"{meas / pred:.4f}); {smi}", flush=True)
    part_done("b")

    # (c) the tape at full width, on the tables stored in key order
    totals = {}
    cbuild, cprobe = clustered(build), clustered(probe)
    for label, slices, opts in COST_WIRES:
        comm = EmulatedCommunicator(COST_RANKS, n_slices=slices)
        res, counts = counted(lambda: distributed_inner_join(
            cbuild, cprobe, comm, with_metrics=True, explain=True, **opts))
        red = res.telemetry.to_dict()["reduced"]
        plan = res.plan
        _check(not bool(res.overflow), f"phase 21 {label} join overflowed")
        _check(red["matches"] == int(res.total),
               f"{label}: matches {red['matches']} != total {int(res.total)}")
        totals[label] = int(res.total)
        for side in ("build", "probe"):
            w, got = plan.wire[side], red[f"{side}.wire_bytes"]
            if plan.wire["exact"]:
                _check(got == w["bytes_total"],
                       f"{label} {side}: wire bytes {got} != plan "
                       f"{w['bytes_total']}")
                for tier in ("ici", "dcn"):
                    if f"{tier}_bytes_per_rank" in w:
                        _check(red[f"{side}.wire_bytes_{tier}"]
                               == w[f"{tier}_bytes_per_rank"] * COST_RANKS,
                               f"{label} {side} {tier} bytes")
            else:
                _check(got <= w["bytes_total"],
                       f"{label} {side}: {got} bytes above the estimate")
        _require_launched(counts, JOIN_KERNELS, f"the phase 21 {label} path")
        paths[label] = counts
        print(f"[cost] (c) {label}: wire bytes build "
              f"{red['build.wire_bytes']:,} probe {red['probe.wire_bytes']:,}"
              + (f" (ici {red['build.wire_bytes_ici']:,}, dcn "
                 f"{red['build.wire_bytes_dcn']:,} a side of build)"
                 if "build.wire_bytes_dcn" in red else "")
              + (" equal to the plan" if plan.wire["exact"] else
                 f" within the plan's estimate "
                 f"{plan.wire['build']['bytes_total']:,}/"
                 f"{plan.wire['probe']['bytes_total']:,}")
              + f"; matches {red['matches']:,}; launches {counts}",
              flush=True)
        del res
    del cbuild, cprobe
    _check(len(set(totals.values())) == 1,
           f"phase 21: totals differ across wires {totals}")
    comm = EmulatedCommunicator(COST_RANKS)
    off, off_counts = counted(lambda: distributed_inner_join(
        build, probe, comm, with_metrics=False))
    _check(not hasattr(off, "telemetry")
           and int(off.total) == totals["tape_padded"],
           "phase 21: the tape-off join")
    on_counts = paths["tape_padded"]
    _check(off_counts == on_counts
           and all(off_counts[s] == COST_RANKS for s in JOIN_KERNELS),
           f"phase 21: launches tape off {off_counts}, on {on_counts}")
    paths["tape_off"] = off_counts
    del off
    res, counts = counted(lambda: distributed_inner_join(
        build, probe, comm, with_metrics=True, join_type="anti"))
    red = res.telemetry.to_dict()["reduced"]
    _check(red["matches"] == int(res.total) > 0
           and counts["expand_gather"] == COST_RANKS,
           f"phase 21 anti join: {red}, launches {counts}")
    paths["tape_anti"] = counts
    del res
    fn_off = make_distributed_join(comm, with_metrics=False)
    fn_on = make_distributed_join(comm, with_metrics=True)
    k_off, k_on = cuda_kernels(lambda: fn_off(build, probe)), cuda_kernels(
        lambda: fn_on(build, probe))
    h_off = make_distributed_join(local, with_metrics=False,
                                  out_rows_per_rank=match_out)
    h_on = make_distributed_join(local, with_metrics=True,
                                 out_rows_per_rank=match_out)
    ms_off, ms_on = (time_ms(lambda f=f: f(build, probe))
                     for f in (h_off, h_on))
    print(f"[cost] (c) tape off: launches equal to tape on, {COST_RANKS} a "
          f"kernel ({off_counts}); CUDA kernels a {COST_RANKS}-rank join "
          f"off {k_off}, on {k_on} (+{k_on - k_off}); the headline join "
          f"{ms_off:.4f} ms off, {ms_on:.4f} ms on ({ms_on / ms_off:.4f}x); "
          f"anti join with the tape: {red['matches']:,} rows, launches "
          f"{counts}; {smi}", flush=True)
    part_done("c")
    return paths


# -- phase 22: stage profiles, the refit, the diagnosis, the gate ---------

STAGE_REPEATS = 5              # (a), (b): timed repeats a profile
STAGE_K = 4                    # (a): the over-decomposition of the 3-stage run
DIAG_RANKS = 4                 # (d): emulated ranks of the diagnosed runs
DIAG_ROWS = 4_000_000          # (d): rows a side of the diagnosed runs
GATE_RESIDENT_JOINS = 3        # (e): the smoke's resident drill, a side
REFIT_MOVE = 0.10              # (c): a default changes past this move


def _join_stage_record(op: dict, query_rec: dict) -> dict:
    """One operator of a one-rank, k = 1 query profile as a join-only
    ``stageprofile`` record for ``calibrate_from_stage_profile``: the
    step joins one bucket directly (no partition, no shuffle, and
    ``cost.predict`` prices neither), so the operator's wall is its join
    stage's and its predicted total that stage's price."""
    return {"kind": "stageprofile", "platform": query_rec["platform"],
            "overflow": query_rec["overflow"], "sort_segments": 1,
            "stages": {"join": {"ran": True, "wall_s": op["wall_s"],
                                "predicted_s": op["predicted_s"],
                                "counters": op["counters"]}}}


def _print_profile(tag: str, rec: dict) -> None:
    for name in ("partition", "shuffle", "join", "skew"):
        st = rec["stages"][name]
        if st["ran"]:
            print(f"[stageprof] {tag} {name}: measured {st['wall_s'] * 1e3:.4f}"
                  f" ms (min {st['wall_min_s'] * 1e3:.4f}), predicted "
                  f"{st['predicted_s'] * 1e3:.4f} ms, ratio "
                  f"{st['ratio']:.4f}", flush=True)
    ov = rec["overlap"]
    print(f"[stageprof] {tag}: sum of stages {rec['sum_of_stages_s'] * 1e3:.4f}"
          f" ms (min {rec['sum_of_stages_min_s'] * 1e3:.4f}), monolithic "
          f"{rec['monolithic']['wall_s'] * 1e3:.4f} ms (min "
          f"{rec['monolithic']['wall_min_s'] * 1e3:.4f}); overlap credit "
          f"{ov['credit_s'] * 1e3:.4f} ms (fraction {ov['fraction']})",
          flush=True)


def stageprof_phase() -> dict:
    """Phase 22: the stage profiler, the run diagnosis and the baseline
    gate on the card. (a) profiles config 2's join at the headline's
    shape (10 M x 10 M, the join driver's tables), ``STAGE_REPEATS``
    repeats: one rank at k = 1 is the join alone; one rank at k = 4 runs
    all three stages (the shuffle a world of 1). The stage set is
    ``STAGE_KEYS`` with ``skew`` not run; every stage's counters equal
    the tape-on monolithic join's; the padded wire bytes equal
    ``build_plan``'s; the sum of the stages' least walls is at least
    0.95 x the monolithic least wall. (b) profiles Q3 at SF-10 operator
    by operator at the rung the query resolves to: each operator's
    ``matches`` (and the aggregate's groups) equal the tape-on
    monolithic query's. (c) refits the constants with
    ``calibrate_from_stage_profile(platform="cuda")`` over the stages
    that measured the work they price: (a)'s joins and partition, and
    (b)'s operators, each a one-bucket join (not the world-of-1 shuffle,
    a local copy), and prints the refit against the shipped model and
    the predictions of phase 21(b)'s workloads (the headline, the k = 4
    join over 4 emulated ranks, the serving request, Q3 at SF-10) and
    of (a)'s under both. (d) runs the
    join driver with ``--diagnose`` over 4 emulated ranks, a Zipf alpha
    1.5 probe with the skew sidecar off and a uniform one: the first's
    key-skew indicator warns and names the skew knobs, the second is
    clean, both ``diagnosis.json`` pass ``analyze check``. (e) runs the
    daemon's smoke twice in process: the first's signatures written as
    baselines (``analyze compare --write``), the second gated against
    them. Returns the launch counts of (a)'s k = 4 profile and (b)'s
    (paths ``stageprof_join`` and ``stageprof_q3``)."""
    import shutil
    import tempfile

    from distributed_join_tpu_torch import bench
    from distributed_join_tpu_torch.benchmarks import (
        distributed_join as jdriver,
    )
    from distributed_join_tpu_torch.benchmarks import run_guarded
    from distributed_join_tpu_torch.parallel.communicator import (
        EmulatedCommunicator,
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        distributed_inner_join,
    )
    from distributed_join_tpu_torch.parallel.query_exec import (
        distributed_query,
    )
    from distributed_join_tpu_torch.planning import cost
    from distributed_join_tpu_torch.planning.plan import (
        abstract_tables,
        build_plan,
    )
    from distributed_join_tpu_torch.planning.query import (
        explain_query,
        tpch_query_plan,
    )
    from distributed_join_tpu_torch.service import server as srv
    from distributed_join_tpu_torch.service.programs import JoinProgramCache
    from distributed_join_tpu_torch.service.resident import (
        ResidentTableRegistry,
    )
    from distributed_join_tpu_torch.telemetry import analyze, stageprof
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )
    from distributed_join_tpu_torch.utils.tpch import (
        generate_tpch_query_tables,
        query_filters,
    )
    smi = gpu_line()
    t_part = time.perf_counter()
    paths = {}

    def part_done(label):
        nonlocal t_part
        now = time.perf_counter()
        print(f"[phase] 22{label}: {now - t_part:.1f} s", flush=True)
        t_part = now

    # (a) config 2's join at the headline's shape
    local = LocalCommunicator()
    build, probe = generate_build_probe_tables(
        seed=SEED, build_nrows=NROWS, probe_nrows=NROWS,
        unique_build_keys=True, device=DEVICE)
    profiles = {}
    for k in (1, STAGE_K):
        prof, counts = counted(lambda k=k: stageprof.profile_join_stages(
            local, build, probe, repeats=STAGE_REPEATS, over_decomposition=k))
        rec = prof.as_record()
        profiles[k] = rec
        mono = distributed_inner_join(build, probe, local, with_metrics=True,
                                      over_decomposition=k)
        red = mono.telemetry.to_dict()["reduced"]
        _check(set(rec["stages"]) == set(stageprof.STAGE_KEYS)
               and not rec["stages"]["skew"]["ran"] and not rec["overflow"]
               and rec["platform"] == torch.device(DEVICE).type,
               f"phase 22 k = {k}: stages {json.dumps(rec['stages'])[:400]}")
        ran = [s for s in ("partition", "shuffle", "join")
               if rec["stages"][s]["ran"]]
        _check(ran == (["join"] if k == 1 else
                       ["partition", "shuffle", "join"]),
               f"phase 22 k = {k}: the stages that ran {ran}")
        for st in ran:
            for name, v in rec["stages"][st]["counters"].items():
                _check(red.get(name) == v,
                       f"phase 22 k = {k} {st} {name}: {v} against the "
                       f"monolithic tape's {red.get(name)}")
        _check(rec["stages"]["join"]["counters"]["matches"] == int(mono.total)
               > 0, f"phase 22 k = {k}: matches")
        if k > 1:
            plan = build_plan(local, build, probe, with_metrics=False,
                              over_decomposition=k)
            sh = rec["stages"]["shuffle"]["counters"]
            for side in ("build", "probe"):
                _check(sh[f"{side}.wire_bytes"]
                       == plan.wire[side]["bytes_total"],
                       f"phase 22: {side} wire bytes {sh[side + '.wire_bytes']}"
                       f" != plan {plan.wire[side]['bytes_total']}")
            for side in ("build", "probe"):
                _check(rec["stages"]["partition"]["counters"][
                    f"{side}.rows_partitioned"] == NROWS,
                    f"phase 22: {side} rows partitioned")
            _require_launched(counts, JOIN_KERNELS, "the stage profile")
            paths["stageprof_join"] = counts
        del mono
        _check(rec["sum_of_stages_min_s"]
               >= 0.95 * rec["monolithic"]["wall_min_s"],
               f"phase 22 k = {k}: sum of stage minima "
               f"{rec['sum_of_stages_min_s']} < 0.95 x monolithic "
               f"{rec['monolithic']['wall_min_s']}")
        _print_profile(f"(a) k={k}", rec)
        print(f"[stageprof] (a) k={k} launches {counts}; {smi}", flush=True)
        print("[stageprof] (a) record " + json.dumps(rec), flush=True)
    del build, probe
    torch.cuda.empty_cache()
    part_done("a")

    # (b) Q3 at SF-10, an operator at a time
    tables = query_filters(generate_tpch_query_tables(
        seed=SEED, scale_factor=QUERY_SF, device=DEVICE), "q3")
    qplan = tpch_query_plan("q3")
    factors = dict(over_decomposition=1, shuffle_capacity_factor=1.6,
                   out_capacity_factor=1.5)
    qres = distributed_query(tables, qplan, local, auto_retry=4,
                             with_metrics=False, **factors)
    _check(not bool(qres.overflow), "phase 22 Q3 overflowed")
    scale = 2 ** qres.retry_attempts
    rung = dict(factors, shuffle_capacity_factor=1.6 * scale,
                out_capacity_factor=1.5 * scale)
    del qres
    qprof, qcounts = counted(lambda: stageprof.profile_query_stages(
        local, qplan, tables, repeats=STAGE_REPEATS, **rung))
    qrec = qprof.as_record()
    mono = distributed_query(tables, qplan, local, with_metrics=True, **rung)
    _check(not qrec["overflow"]
           and qrec["platform"] == torch.device(DEVICE).type,
           "phase 22 Q3 profile")
    for op, m, total in zip(qplan.ops, mono.telemetry, mono.op_totals):
        got = qrec["operators"][op.op_id]["counters"]
        red = m.to_dict()["reduced"]
        _check(got["matches"] == red["matches"] == int(total),
               f"phase 22 Q3 {op.op_id}: matches {got} against {red}")
        if op.aggregate is not None:
            _check(got["agg.groups"] == red["agg.groups"]
                   == int(mono.table.valid.sum()) > 0,  # noqa: DJL004
                   f"phase 22 Q3 {op.op_id}: groups {got} against {red}")
    _require_launched(qcounts, QUERY_SITES, "the Q3 profile")
    paths["stageprof_q3"] = qcounts
    gaps = {}
    for oid in qrec["order"]:
        op = qrec["operators"][oid]
        gaps[oid] = op["wall_s"] - op["predicted_s"]
        print(f"[stageprof] (b) Q3 {oid}: measured {op['wall_s'] * 1e3:.4f} ms"
              f" (min {op['wall_min_s'] * 1e3:.4f}), predicted "
              f"{op['predicted_s'] * 1e3:.4f} ms, ratio {op['ratio']:.4f}, "
              f"counters {op['counters']}", flush=True)
    worst = max(gaps, key=gaps.get)
    print(f"[stageprof] (b) Q3: sum of operators "
          f"{qrec['sum_of_operators_s'] * 1e3:.4f} ms, monolithic "
          f"{qrec['monolithic']['wall_s'] * 1e3:.4f} ms (min "
          f"{qrec['monolithic']['wall_min_s'] * 1e3:.4f}), predicted "
          f"{qrec['predicted_total_s'] * 1e3:.4f} ms; the gap's largest "
          f"part: {worst} (+{gaps[worst] * 1e3:.4f} ms of "
          f"{sum(gaps.values()) * 1e3:.4f}); launches {qcounts}; {smi}",
          flush=True)
    print("[stageprof] (b) record " + json.dumps(qrec), flush=True)
    del mono
    part_done("b")

    # (c) the refit, from the stages that measured the work they price
    fed = [profiles[1]]
    four = json.loads(json.dumps(profiles[STAGE_K]))
    four["stages"]["shuffle"]["ran"] = False      # a world of 1: a copy
    fed.append(four)
    fed.extend(_join_stage_record(qrec["operators"][oid], qrec)
               for oid in qrec["order"])
    model, report = cost.calibrate_from_stage_profile(
        fed, platform=torch.device(DEVICE).type)
    _check(report["calibrated"] and "shuffle" not in report["stage_scales"],
           f"phase 22 refit: {report}")
    shipped = cost.CostModel()
    owned = [c for m in cost.STAGE_CONSTANTS.values()
             for c in m["time"] + m["bandwidth"]]
    refit = {c: {"shipped": getattr(shipped, c), "refit": getattr(model, c),
                 "move": getattr(model, c) / getattr(shipped, c)}
             for c in owned}
    print(f"[stageprof] (c) report {json.dumps(report)}", flush=True)
    print(f"[stageprof] (c) refit constants {json.dumps(refit)}; {smi}",
          flush=True)
    print("[stageprof] (c) defaults a refit moves past "
          f"{REFIT_MOVE:.0%}: " + json.dumps(
              {c: v["refit"] for c, v in refit.items()
               if abs(v["move"] - 1) > REFIT_MOVE}), flush=True)
    # phase 21(b)'s workloads priced by both models (host arithmetic on
    # abstract tables)
    ab, ap = abstract_tables(NROWS, NROWS)
    match_out = int(bench.MATCHES_PER_ROW * NROWS * bench.OUT_SLACK)
    grade = {}
    for name, comm, opts in (
            ("headline", local, dict(out_rows_per_rank=match_out)),
            (f"k{COST_K}_{COST_RANKS}_emulated_ranks",
             EmulatedCommunicator(COST_RANKS),
             dict(over_decomposition=COST_K)),
            ("profile_k1", local, {}),
            (f"profile_k{STAGE_K}", local,
             dict(over_decomposition=STAGE_K))):
        plan = build_plan(comm, ab, ap, with_metrics=False, **opts)
        grade[name] = (plan.cost["total_s"],
                       cost.predict(plan, model)["total_s"])
    grade["q3_sf10"] = tuple(
        explain_query(qplan, local, tables, cost_model=mdl,
                      defaults=rung, orders=False)["total_s"]
        for mdl in (None, model))
    del tables
    # phase 21(b)'s serving request: its probe-only plan from the
    # registry's explain
    reg_build, _ = generate_build_probe_tables(
        seed=SEED, build_nrows=NROWS, probe_nrows=SERVING_PROBE_ROWS,
        unique_build_keys=True, device=DEVICE)
    registry = ResidentTableRegistry(local, JoinProgramCache(local))
    registry.register("dim", reg_build)
    del reg_build
    splan = registry.join("dim", _serving_probe(SEED + 1, SERVING_PROBE_ROWS),
                          explain=True, with_metrics=False).plan
    grade["serving_request"] = (splan.cost["total_s"],
                                cost.predict(splan, model)["total_s"])
    del registry
    measured = {"profile_k1": profiles[1]["monolithic"]["wall_s"],
                f"profile_k{STAGE_K}":
                    profiles[STAGE_K]["monolithic"]["wall_s"],
                "q3_sf10": qrec["monolithic"]["wall_s"]}
    for name, (before, after) in grade.items():
        meas = measured.get(name)
        print(f"[stageprof] (c) {name}: predicted shipped "
              f"{before * 1e3:.4f} ms, refit {after * 1e3:.4f} ms"
              + ("" if meas is None else
                 f"; measured {meas * 1e3:.4f} ms (measured / predicted "
                 f"{meas / before:.4f} shipped, {meas / after:.4f} refit)")
              + f"; {smi}", flush=True)
    torch.cuda.empty_cache()
    part_done("c")

    # (d) --diagnose over emulated ranks: a Zipf probe, then a uniform one
    tmp = tempfile.mkdtemp(prefix="stageprof_")
    diags = {}
    for label, extra in (("zipf", ["--zipf-alpha", "1.5",
                                   "--skew-threshold", "0"]),
                         ("uniform", [])):
        d = os.path.join(tmp, label)
        args = jdriver.parse_args([
            "--communicator", "emulated", "--n-ranks", str(DIAG_RANKS),
            "--build-table-nrows", str(DIAG_ROWS), "--probe-table-nrows",
            str(DIAG_ROWS), "--iterations", "1", "--auto-retry", "2",
            "--diagnose", "--telemetry", d, *extra])
        out = {}

        def body(a, out=out):
            out["record"] = jdriver.run(a)
            return out["record"]

        _check(run_guarded(body, args, "distributed_join") == 0,
               f"phase 22 (d) {label} driver run")
        path = os.path.join(d, "diagnosis.json")
        _check(os.path.exists(path) and analyze.check_file(path) == [],
               f"phase 22 (d) {label}: diagnosis.json "
               f"{analyze.check_file(path) if os.path.exists(path) else None}")
        diags[label] = json.load(open(path))
        ks = diags[label]["indicators"]["key_skew"]
        print(f"[stageprof] (d) {label}: status {diags[label]['status']}, "
              f"key skew {json.dumps(ks.get('counters'))}, recommendations "
              f"{[r['id'] for r in diags[label]['recommendations']]}; "
              f"matches {out['record']['matches_per_join']:,}; {smi}",
              flush=True)
    zr = {r["id"]: r for r in diags["zipf"]["recommendations"]}
    _check(diags["zipf"]["indicators"]["key_skew"]["status"] == "warn"
           and "skew_enable_prpd" in zr
           and any("--skew-threshold" in f
                   for f in zr["skew_enable_prpd"]["flags"]),
           f"phase 22 (d) the Zipf run's diagnosis: {zr}")
    _check(diags["uniform"]["status"] == "ok"
           and not diags["uniform"]["recommendations"],
           f"phase 22 (d) the uniform run is not clean: "
           f"{json.dumps(diags['uniform']['indicators'])[:600]}")
    part_done("d")

    # (e) the daemon smoke's gate: run 1 writes the baselines, run 2 gates
    gate_dir = os.path.join(tmp, "baselines")
    recs = []
    for i in (1, 2):
        args = srv.parse_args([
            "--smoke", "--smoke-no-wall-gate", "--smoke-resident-joins",
            str(GATE_RESIDENT_JOINS), "--smoke-baseline-dir", gate_dir,
            "--flight-recorder-path", os.path.join(tmp, f"fr{i}.json")])
        args.request_deadline_s = None
        rec = srv.run_smoke(srv._service_from_args(args), args)
        _check(not rec["violations"], f"phase 22 (e) smoke {i}: "
               f"{rec['violations']}")
        recs.append(rec)
        if i == 1:
            _check(all("skipped" in v for v in rec["baseline_gate"].values()),
                   f"phase 22 (e) smoke 1 gate {rec['baseline_gate']}")
            rpath = os.path.join(tmp, "smoke1.json")
            dpath = os.path.join(tmp, "resident_drill1.json")
            json.dump(rec, open(rpath, "w"))
            json.dump(rec["resident_drill"], open(dpath, "w"))
            for name, src in (("service_smoke", rpath),
                              ("resident_smoke", dpath)):
                _check(analyze.main(["compare", src, "--baseline", name,
                                     "--baseline-dir", gate_dir,
                                     "--write"]) == 0,
                       f"phase 22 (e) compare --write {name}")
    gate = recs[1]["baseline_gate"]
    _check(all(v.get("ok") is True for v in gate.values()),
           f"phase 22 (e) the card's gate: {gate}")
    print(f"[stageprof] (e) smoke 2 gated against smoke 1's baselines: "
          f"{json.dumps(gate)}; signature {json.dumps(recs[1]['counter_signature'])}"
          f"; {smi}", flush=True)
    part_done("e")
    shutil.rmtree(tmp, ignore_errors=True)
    return paths


# -- phase 23: the autotuner ------------------------------------------------

TUNE_RETRY = 6                 # the ladder's budget on every tuned path
TUNE_COLD_OUT = 0.1            # (a), (b): the output factor that escalates
TUNE_REPS = 3                  # timed calls a median
TUNE_RANKS = 4                 # (c): emulated ranks of the fill rules
TUNE_FILL_ROWS = 4_000_000     # (c): rows a side of the fill rules' tables
TUNE_WIRE_FACTOR = 2.0         # (c): the padded run's shuffle factor
TUNE_STAGE_REPEATS = 3         # (c): the sort rule's stage profile
TUNE_SORT_K = 4                # (c): the one-rank sort rule's over-decomposition
TUNE_SITES = JOIN_KERNELS


def _median_ms(fn, reps: int = TUNE_REPS) -> float:
    """Median wall of ``fn`` over ``reps`` calls after one warm-up, each
    call from a synchronised device to its own synchronisation (host
    clock: a tuned call's host resolution is part of what it costs)."""
    import statistics
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    return statistics.median(walls)


def _settled(opts: dict, res) -> dict:
    """``opts`` at the rung ``res``'s ladder settled at."""
    last = res.retry_report.attempts[-1]
    out = dict(opts, shuffle_capacity_factor=last.shuffle_capacity_factor,
               out_capacity_factor=last.out_capacity_factor)
    for k in ("out_rows_per_rank", "compression_bits", "hh_build_capacity",
              "hh_probe_capacity", "hh_out_capacity"):
        if getattr(last, k) is not None:
            out[k] = getattr(last, k)
    return out


def fill_rule(label: str, comm, build, probe, opts: dict, knob: str,
              want, store: str, stage_profile: bool = False,
              must_fire: bool = True) -> tuple:
    """One fill rule on the card: a static join (tape on) filed in a
    history store under the workload signature of the tape-off call (with
    the stage profile of the settled static program when asked), the
    tuner's verdict on that store (``knob`` must be filled with
    ``want``), then the static and the filled programs, each at the rung
    its ladder settles at, timed on the same communicator and tables
    (median of ``TUNE_REPS``), with equal row digests. Returns the
    numbers, the verdict and the filled program's launch counts; with
    ``must_fire`` off, a verdict that fills nothing returns its evidence
    and no counts instead of failing."""
    from distributed_join_tpu_torch.parallel.distributed_join import (
        distributed_inner_join,
    )
    from distributed_join_tpu_torch.planning.tuner import (
        JoinTuner,
        workload_signature,
    )
    from distributed_join_tpu_torch.service.programs import JoinProgramCache
    from distributed_join_tpu_torch.telemetry import history, stageprof

    cache = JoinProgramCache(comm)

    def join(**kw):
        return distributed_inner_join(build, probe, comm, program_cache=cache,
                                      auto_retry=TUNE_RETRY, **kw)

    t = time.perf_counter()
    static = join(with_metrics=True, **opts)
    wall = time.perf_counter() - t
    _check(static.retry_report.resolved and not bool(static.overflow),
           f"phase 23 (c) {label}: the static join did not settle")
    static_opts = _settled(opts, static)
    summary = None
    if stage_profile:
        prof = stageprof.profile_join_stages(
            comm, build, probe, repeats=TUNE_STAGE_REPEATS, **static_opts)
        summary = prof.summary()
        print(f"[tuner] (c) {label}: stage walls {json.dumps(summary['wall_s'])}",
              flush=True)
    sig = workload_signature(comm, build, probe, with_metrics=False, **opts)
    hist = history.WorkloadHistory(store)
    hist.append(history.request_entry(
        request_id=f"static-{label}", op="join", signature=sig,
        outcome="served", wall_s=wall, matches=int(static.total),
        retry_record=static.retry_report.as_record(),
        metrics=static.telemetry.to_dict(), stage_profile=summary,
        platform=torch.device(DEVICE).type))
    hist.close()
    tuner = JoinTuner(store)
    cfg = tuner.resolve(comm, build, probe,
                        opts=dict(opts, with_metrics=False))
    print(f"[tuner] (c) {label}: verdict {json.dumps(cfg.as_record())}",
          flush=True)
    if not must_fire and cfg.structural.get(knob) != want:
        walls = (summary or {}).get("wall_s") or {}
        total = sum(v for v in walls.values() if v)
        return {"rule": label, "fired": False, "basis": cfg.basis,
                "join_stage_share": (walls.get("join") or 0) / total
                if total else None}, None
    _check(cfg.structural.get(knob) == want,
           f"phase 23 (c) {label}: {knob} not filled with {want!r} "
           f"({json.dumps(cfg.as_record())})")
    filled = join(with_metrics=False, tuner=tuner, **opts)
    _check(filled.retry_report.resolved and filled.tuned["applied"].get(knob)
           == want, f"phase 23 (c) {label}: the filled join "
           f"{json.dumps(filled.tuned)}")
    filled_opts = _settled(cfg.apply(opts), filled)
    want_digest = row_digest(join(with_metrics=False, **static_opts))
    got, counts = counted(lambda: join(with_metrics=False, **filled_opts))
    _check(got.retry_report.n_attempts == 1
           and row_digest(got) == want_digest,
           f"phase 23 (c) {label}: the filled program's rows differ from "
           "the static program's")
    static_ms = _median_ms(lambda: join(with_metrics=False, **static_opts))
    filled_ms = _median_ms(lambda: join(with_metrics=False, **filled_opts))
    out = {"rule": label, "fired": True, "knob": knob, "filled": want,
           "static_ms": static_ms, "filled_ms": filled_ms,
           "ratio": filled_ms / static_ms, "basis": cfg.basis,
           "static_rung": static.retry_report.attempts[-1].attempt,
           "filled_rung": filled.retry_report.attempts[-1].attempt,
           "rows": want_digest[0]}
    return out, counts


def tuner_phase() -> dict:
    """Phase 23: the autotuner on the card. (a) the warm contract at the
    headline's shape (10 M x 10 M, config 2's tables, one rank): a cold
    join at ``out_capacity_factor`` 0.1 escalates at least twice; fed its
    history line, the repeat runs one ``tuned_presize`` attempt at the
    cold run's final rung label, builds no program and returns the cold
    total and rows; the cold wall (its escalations included), the warm
    tuned and the static default sizing's medians. (b) the service with
    ``auto_tune`` at the serving request's shape (a 10 M-row build, a
    2^18-row probe): the second identical request builds nothing, runs
    one attempt from history; the daemon's ``explain`` op carries the
    ``tuned`` block; the join driver twice with ``--history F
    --auto-tune``: the second record starts at the first's final rung and
    climbs none; ``analyze tune F --json`` passes ``analyze check``. (c)
    the fill rules over 4 emulated ranks, each from a history this phase
    wrote, filled against static at the settled rungs: the skew fill
    (config 3's Zipf alpha 1.5, skew off: B5 launches), the wire fill (a
    padded run at shuffle factor 2, wire efficiency ~0.5) and the
    sort-mode fill (a stage-profiled history); then a resident join with
    ``tuner=`` on the Zipf probe drops the structural fills. Returns the
    launch counts of paths ``tuner_warm``, ``tuner_service``,
    ``tuner_skew_fill``, ``tuner_wire_fill`` and ``tuner_sort_fill``."""
    import contextlib
    import io
    import shutil
    import tempfile

    from distributed_join_tpu_torch.benchmarks import (
        distributed_join as D,
    )
    from distributed_join_tpu_torch.benchmarks import run_guarded
    from distributed_join_tpu_torch.parallel.communicator import (
        EmulatedCommunicator,
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        distributed_inner_join,
    )
    from distributed_join_tpu_torch.planning.tuner import (
        SORT_STAGE_SHARE_WARN,
        JoinTuner,
    )
    from distributed_join_tpu_torch.service import server as srv
    from distributed_join_tpu_torch.service.programs import JoinProgramCache
    from distributed_join_tpu_torch.service.resident import (
        ResidentTableRegistry,
    )
    from distributed_join_tpu_torch.telemetry import analyze, history
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )
    smi = gpu_line()
    t_part = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="tuner_")
    platform = torch.device(DEVICE).type
    paths = {}

    def part_done(label):
        nonlocal t_part
        now = time.perf_counter()
        print(f"[phase] 23{label}: {now - t_part:.1f} s", flush=True)
        t_part = now

    # (a) the warm contract at the headline's shape
    local = LocalCommunicator()
    build, probe = generate_build_probe_tables(
        seed=SEED, build_nrows=NROWS, probe_nrows=NROWS,
        unique_build_keys=True, device=DEVICE)
    cache = JoinProgramCache(local)
    store = history.WorkloadHistory(os.path.join(tmp, "warm.jsonl"))
    tuner = JoinTuner(store.path)

    def join(**kw):
        return distributed_inner_join(build, probe, local, program_cache=cache,
                                      auto_retry=TUNE_RETRY,
                                      with_metrics=False, **kw)

    torch.cuda.synchronize()
    t = time.perf_counter()
    cold = join(tuner=tuner, out_capacity_factor=TUNE_COLD_OUT)
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t) * 1e3
    rr = cold.retry_report
    _check(rr.n_attempts >= 3 and rr.resolved
           and cold.tuned["source"] == "static",
           f"phase 23 (a) the cold join: {rr.as_record()} {cold.tuned}")
    store.append(history.request_entry(
        request_id="cold", op="join", signature=cold.tuned["signature"],
        outcome="served", wall_s=cold_ms / 1e3, new_traces=cache.traces,
        matches=int(cold.total), retry_record=rr.as_record(),
        tuned=cold.tuned, platform=platform))
    tuner.load(store.path)
    cold_digest = row_digest(cold)
    final = rr.attempts[-1].attempt
    del cold
    traces = cache.traces
    warm, counts = counted(lambda: join(tuner=tuner,
                                        out_capacity_factor=TUNE_COLD_OUT))
    att = [(a.attempt, a.action) for a in warm.retry_report.attempts]
    _check(att == [(final, "tuned_presize")] and cache.traces == traces
           and row_digest(warm) == cold_digest
           and warm.tuned["source"] == "history"
           and warm.tuned["rung"] == final,
           f"phase 23 (a) the warm join: attempts {att}, programs built "
           f"{cache.traces - traces}, tuned {warm.tuned}")
    _require_launched(counts, TUNE_SITES, "the tuned warm join")
    paths["tuner_warm"] = counts
    del warm
    warm_ms = _median_ms(lambda: join(tuner=tuner,
                                      out_capacity_factor=TUNE_COLD_OUT))
    _check(cache.traces == traces, "phase 23 (a) a timed warm join built")
    static_res = join()
    _check(row_digest(static_res) == cold_digest
           and static_res.retry_report.n_attempts == 1,
           "phase 23 (a) the static default sizing's rows")
    del static_res
    static_ms = _median_ms(join)
    sizing = {k: v for k, v in rr.attempts[-1].as_record().items()
              if k.endswith("_factor")}
    print(f"[tuner] (a) {NROWS:,} x {NROWS:,}, one rank: cold {cold_ms:.4f} ms"
          f" ({rr.n_attempts} attempts, {rr.n_attempts - 1} escalations, "
          f"settled at rung {final} {json.dumps(sizing)}); warm tuned "
          f"{warm_ms:.4f} ms (median of {TUNE_REPS}; 1 attempt, "
          f"tuned_presize, 0 programs built); static default sizing "
          f"{static_ms:.4f} ms (median of {TUNE_REPS}); warm / static "
          f"{warm_ms / static_ms:.4f}; launches {counts}; {smi}", flush=True)
    del build, probe
    torch.cuda.empty_cache()
    part_done("a")

    # (b) the service, the daemon's explain, the driver, analyze tune
    sdir = os.path.join(tmp, "service")
    service = srv.JoinService(local, srv.ServiceConfig(
        auto_retry=TUNE_RETRY, auto_tune=True, history_dir=sdir),
        device=DEVICE)
    sb, sp = generate_build_probe_tables(
        seed=SEED, build_nrows=NROWS, probe_nrows=SERVING_PROBE_ROWS,
        unique_build_keys=True, device=DEVICE)
    r1 = service.join(sb, sp, out_capacity_factor=TUNE_COLD_OUT)
    _check(r1.retry_report.n_attempts > 1 and r1.retry_report.resolved,
           f"phase 23 (b) the first request: {r1.retry_report.as_record()}")
    r2, counts = counted(lambda: service.join(
        sb, sp, out_capacity_factor=TUNE_COLD_OUT))
    rung = r1.retry_report.attempts[-1].attempt
    _check(r2.new_traces == 0 and r2.retry_report.n_attempts == 1
           and r2.retry_report.attempts[0].action == "tuned_presize"
           and r2.tuned["source"] == "history" and r2.tuned["rung"] == rung
           and r2.matches == r1.matches,
           f"phase 23 (b) the second request: new_traces {r2.new_traces}, "
           f"{r2.retry_report.as_record()}, {r2.tuned}")
    _require_launched(counts, TUNE_SITES, "the service's tuned request")
    paths["tuner_service"] = counts
    entries, _ = history.load_history(sdir)
    rec = service.recorder.snapshot()["records"][-1]
    _check(entries[-1]["tuned"]["source"] == "history"
           and entries[-1]["rung"] == rung
           and rec["tuned"]["source"] == "history"
           and service.stats()["tuner"]["history_hits"] >= 1,
           f"phase 23 (b) the request's records: {entries[-1]} {rec}")
    server, port = srv.start_daemon(service)
    client = srv.ServiceClient("127.0.0.1", port)
    try:
        resp = client.send({"op": "explain", "build_nrows": NROWS,
                            "probe_nrows": SERVING_PROBE_ROWS,
                            "out_capacity_factor": TUNE_COLD_OUT})
    finally:
        client.close()
        server.shutdown()
        server.server_close()
    _check(resp.get("ok") and resp["tuned"]["source"] == "history"
           and resp["tuned"]["rung"] == rung,
           f"phase 23 (b) the daemon's explain: {json.dumps(resp)[:600]}")
    print(f"[tuner] (b) service at {NROWS:,} x {SERVING_PROBE_ROWS:,}: first "
          f"request {r1.retry_report.n_attempts} attempts, second "
          f"new_traces {r2.new_traces}, 1 attempt at rung {rung} from "
          f"history; explain op tuned {json.dumps(resp['tuned'])}; "
          f"stats {json.dumps(service.stats()['tuner'])}; launches {counts}"
          f"; {smi}", flush=True)
    del service, sb, sp, r1, r2
    torch.cuda.empty_cache()
    hist_path = os.path.join(tmp, "driver_history.jsonl")
    drv = []
    for i in (1, 2):
        args = D.parse_args([
            "--communicator", "local", "--build-table-nrows", str(NROWS),
            "--probe-table-nrows", str(NROWS), "--iterations", "1",
            "--auto-retry", str(TUNE_RETRY), "--out-capacity-factor",
            str(TUNE_COLD_OUT), "--telemetry", os.path.join(tmp, f"drv{i}"),
            "--history", hist_path, "--auto-tune"])
        out = {}

        def body(a, out=out):
            out["record"] = D.run(a)
            return out["record"]

        _check(run_guarded(body, args, "distributed_join") == 0,
               f"phase 23 (b) driver run {i}")
        drv.append(out["record"])
    first, second = drv
    f_att = first["retry"]["attempts"]
    s_att = second["retry"]["attempts"]
    _check(first["tuned"]["source"] == "static" and len(f_att) > 1
           and second["tuned"]["source"] == "history"
           and len(s_att) == 1 and s_att[0]["action"] == "tuned_presize"
           and s_att[0]["attempt"] == f_att[-1]["attempt"]
           and not s_att[0]["overflow"]
           and second["matches_per_join"] == first["matches_per_join"],
           f"phase 23 (b) the driver's records: {first['retry']} "
           f"{second['retry']} {second['tuned']}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = analyze.main(["tune", hist_path, "--json"])
    tune_path = os.path.join(tmp, "tune.json")
    with open(tune_path, "w") as f:
        f.write(buf.getvalue())
    _check(rc == 0 and analyze.check_file(tune_path) == [],
           f"phase 23 (b) analyze tune: rc {rc}, "
           f"{analyze.check_file(tune_path)}")
    tune = json.loads(buf.getvalue())
    print(f"[tuner] (b) driver --auto-tune: run 1 {len(f_att)} attempts, "
          f"{first['elapsed_per_join_s'] * 1e3:.4f} ms a join at its final "
          f"rung; run 2 1 attempt at rung {s_att[0]['attempt']}, "
          f"{second['elapsed_per_join_s'] * 1e3:.4f} ms a join; analyze tune "
          f"{json.dumps(tune['signatures'])}; {smi}", flush=True)
    part_done("b")

    # (c) the fill rules over emulated ranks
    emu = EmulatedCommunicator(TUNE_RANKS)
    zb, zp, _ = D.make_tables(_config3_args(False, TUNE_FILL_ROWS),
                              torch.device(DEVICE))
    rules = []
    res, counts = fill_rule("skew", emu, zb, zp, {"shuffle": "padded"},
                            "skew_threshold", 0.001,
                            os.path.join(tmp, "skew.jsonl"))
    _require_launched(counts, TUNE_SITES + ("extract_prefix",),
                      "the skew fill")
    paths["tuner_skew_fill"] = counts
    rules.append(res)
    # the resident join on the same Zipf probe: its probe-only verdict
    # drops the structural fills the evidence makes
    registry = ResidentTableRegistry(emu, JoinProgramCache(emu))
    registry.register("dim", zb)
    rstore = history.WorkloadHistory(os.path.join(tmp, "resident.jsonl"))
    rtuner = JoinTuner(rstore.path)
    rcold = registry.join("dim", zp, auto_retry=TUNE_RETRY, tuner=rtuner,
                          with_metrics=True)
    rstore.append(history.request_entry(
        request_id="resident", op="resident_join",
        signature=rcold.tuned["signature"], outcome="served", wall_s=0.0,
        matches=int(rcold.total),
        retry_record=rcold.retry_report.as_record(),
        metrics=rcold.telemetry.to_dict(), tuned=rcold.tuned,
        platform=platform))
    rtuner.load(rstore.path)
    rwarm = registry.join("dim", zp, auto_retry=TUNE_RETRY, tuner=rtuner)
    dropped = rwarm.tuned["basis"].get("structural_dropped") or {}
    _check(rwarm.tuned["structural"] == {} and "skew_threshold" in dropped
           and rwarm.retry_report.attempts[0].attempt
           == rcold.retry_report.attempts[-1].attempt
           and int(rwarm.total) == int(rcold.total),
           f"phase 23 (c) the resident join's verdict {rwarm.tuned}")
    print(f"[tuner] (c) resident join on the Zipf probe: dropped "
          f"{json.dumps(dropped)}, sizing {json.dumps(rwarm.tuned['sizing'])}"
          f", first attempt {rwarm.retry_report.attempts[0].as_record()}",
          flush=True)
    del registry, rcold, rwarm, zb, zp
    torch.cuda.empty_cache()
    ub, up = generate_build_probe_tables(
        seed=SEED, build_nrows=TUNE_FILL_ROWS, probe_nrows=TUNE_FILL_ROWS,
        unique_build_keys=True, device=DEVICE)
    res, counts = fill_rule("wire", emu, ub, up,
                            {"shuffle_capacity_factor": TUNE_WIRE_FACTOR},
                            "shuffle", "ragged",
                            os.path.join(tmp, "wire.jsonl"))
    _require_launched(counts, TUNE_SITES, "the wire fill")
    paths["tuner_wire_fill"] = counts
    rules.append(res)
    # the sort rule over the emulated ranks (their partition and shuffle
    # stages may outweigh the join there), then on one rank at k = 4 at
    # config 2's shape, whose join stage phase 22(a) measured over half
    res, _ = fill_rule("sort_mode", emu, ub, up, {"shuffle": "padded"},
                       "sort_mode", "segmented",
                       os.path.join(tmp, "sort.jsonl"), stage_profile=True,
                       must_fire=False)
    rules.append(res)
    del ub, up
    torch.cuda.empty_cache()
    cb, cp = generate_build_probe_tables(
        seed=SEED, build_nrows=NROWS, probe_nrows=NROWS,
        unique_build_keys=True, device=DEVICE)
    res, counts = fill_rule("sort_mode_k4", local, cb, cp,
                            {"shuffle": "padded",
                             "over_decomposition": TUNE_SORT_K},
                            "sort_mode", "segmented",
                            os.path.join(tmp, "sort_k4.jsonl"),
                            stage_profile=True)
    paths["tuner_sort_fill"] = counts
    rules.append(res)
    del cb, cp
    for r in rules:
        where = (f"one rank, k = {TUNE_SORT_K}" if r["rule"] == "sort_mode_k4"
                 else f"{TUNE_RANKS} emulated ranks")
        if not r["fired"]:
            print(f"[tuner] (c) {r['rule']} rule, {where}: did not "
                  f"fire, join stage share "
                  f"{r['join_stage_share']:.4f} (bar "
                  f"{SORT_STAGE_SHARE_WARN}); {smi}", flush=True)
            continue
        print(f"[tuner] (c) {r['rule']} fill, {where}, "
              f"{r['rows']:,} rows out: {r['knob']}={r['filled']!r} filled "
              f"{r['filled_ms']:.4f} ms (rung {r['filled_rung']}) against "
              f"static {r['static_ms']:.4f} ms (rung {r['static_rung']}), "
              f"filled / static {r['ratio']:.4f}; evidence "
              f"{json.dumps(r['basis'])}; {smi}", flush=True)
    print("[tuner] (c) ratios " + json.dumps(
        {r["rule"]: r["ratio"] for r in rules if r["fired"]}), flush=True)
    torch.cuda.empty_cache()
    part_done("c")
    print(f"[tuner] (d) {smi}", flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    return paths


INTEGRITY_RANKS = 4            # (a), (b): emulated ranks on this card
INTEGRITY_ROWS = 4_000_000     # (a), (b): rows a side (int64 key, payload)
INTEGRITY_REPS = 5             # (a): timed joins a median, each way
INTEGRITY_SEED = 5             # (b): the fault plans' seed
INTEGRITY_WIRES = (            # (a): (label, slices, join options)
    ("padded", 1, {}),
    ("ppermute", 1, {"shuffle": "ppermute"}),
    ("compressed16", 1, {"compression_bits": 16}),
    ("ragged_strings", 1, {"shuffle": "ragged"}),
    ("hier2x2_codec", 2, {"shuffle": "hierarchical", "dcn_codec": "on"}),
    ("segmented", 1, {"sort_mode": "segmented", "sort_segments": 4}),
)
INTEGRITY_SEAMS = {            # (b): wire -> the modes run on it
    "padded": ("bit_flip", "row_truncate", "row_duplicate", "misroute"),
    "ragged_strings": ("bit_flip", "row_truncate", "row_duplicate",
                       "misroute"),
    "hier2x2_codec": ("bit_flip", "misroute"),
}
A2A_INTEGRITY_MIB = 64         # (c): the all-to-all driver's buffer a rank


def integrity_phase() -> dict:
    """Phase 24: wire integrity (``parallel/integrity.py``) on the card,
    over 4 emulated ranks at 4 M x 4 M rows (int64 key and payload, the
    tables stored in key order, ``clustered``, so the 16-bit codec packs
    them). (a) ``verify_integrity=True`` on every wire (padded, ppermute,
    compressed at 16 bits, ragged with a variable-length 16-byte string
    payload, the 2 x 2 hierarchy with the cross-slice codec, segmented):
    each report ok with 2 n^2 checked pairs, each result's row digest the
    unverified join's; the verified and unverified ms a join (medians of
    5, host clock from a synchronised card to a synchronised card,
    through a program cache), and the launches of the join kernels on the
    verified joins (path ``integrity``). (b) each corruption mode on the
    padded and ragged wires, and ``bit_flip`` and ``misroute`` on the
    hierarchy's cross-slice hop: with ``auto_retry=2`` and a budget of 1
    the trail is ``initial``, ``retry_integrity`` and the digest the clean
    join's; with an unbounded budget ``IntegrityError`` and no rows. (c)
    the join driver's and the all-to-all driver's ``--verify-integrity``
    records over the emulated ranks: ``integrity.ok``. (d) integrity off:
    the headline's launches and match-sized row digest, which ``main``
    holds against the headline phase's. Returns ``{"launches_by_path":
    {"integrity": counts}, "headline_launches": ...,
    "headline_digest": ...}``."""
    import functools
    import statistics

    from distributed_join_tpu_torch import bench
    from distributed_join_tpu_torch.benchmarks import all_to_all as A
    from distributed_join_tpu_torch.benchmarks import (
        distributed_join as D,
    )
    from distributed_join_tpu_torch.ops.join import sort_merge_inner_join
    from distributed_join_tpu_torch.parallel.communicator import (
        EmulatedCommunicator,
    )
    from distributed_join_tpu_torch.parallel.distributed_join import (
        distributed_inner_join,
        make_distributed_join,
    )
    from distributed_join_tpu_torch.parallel.faults import (
        FaultInjectingCommunicator,
        FaultPlan,
    )
    from distributed_join_tpu_torch.parallel.integrity import IntegrityError
    from distributed_join_tpu_torch.service.programs import JoinProgramCache
    from distributed_join_tpu_torch.table import Table
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )
    from distributed_join_tpu_torch.utils.strings import (
        LEN_SUFFIX,
        encode_int_strings,
    )

    smi = gpu_line()
    n = INTEGRITY_RANKS
    build, probe = (clustered(t) for t in generate_build_probe_tables(
        seed=SEED, build_nrows=INTEGRITY_ROWS, probe_nrows=INTEGRITY_ROWS,
        device=DEVICE))
    tag, tag_len = encode_int_strings(build.columns["build_payload"],
                                      prefix="itm-", digits=12,
                                      pad_digits=False)
    stringed = Table(dict(build.columns, build_tag=tag,
                          **{"build_tag" + LEN_SUFFIX: tag_len}),
                     build.valid)

    def comm_of(slices, plan=None):
        inner = EmulatedCommunicator(n, n_slices=slices)
        return inner if plan is None else FaultInjectingCommunicator(
            inner, plan)

    def tables_of(label):
        return (stringed if label == "ragged_strings" else build), probe

    # (a) clean verification on every wire
    clean = {}
    verified_calls = []
    for label, slices, opts in INTEGRITY_WIRES:
        comm = comm_of(slices)
        cache = JoinProgramCache(comm)
        b, p = tables_of(label)
        opts = dict(opts, auto_retry=2)

        def plain(comm=comm, cache=cache, b=b, p=p, opts=opts):
            return distributed_inner_join(b, p, comm, program_cache=cache,
                                          **opts)

        def verified(comm=comm, cache=cache, b=b, p=p, opts=opts):
            return distributed_inner_join(b, p, comm, program_cache=cache,
                                          verify_integrity=True, **opts)

        res_p, res_v = plain(), verified()
        attempts = res_v.retry_report.n_attempts
        if attempts > 1:
            # the timed joins run the settled rung alone
            opts = _settled(opts, res_v)
            res_p, res_v = plain(opts=opts), verified(opts=opts)
        rep = res_v.integrity_report
        _check(rep.ok and rep.checked_pairs == 2 * n * n,
               f"integrity (a) {label}: report {rep.as_record()}")
        _check(not bool(res_v.overflow) and not bool(res_p.overflow),
               f"integrity (a) {label} overflowed")
        clean[label] = row_digest(res_p)
        _check(row_digest(res_v) == clean[label],
               f"integrity (a) {label}: the verified rows differ from the "
               "unverified join's")
        ms = {}
        for way, fn in (("unverified", plain), ("verified", verified)):
            walls = []
            for _ in range(INTEGRITY_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(opts=opts)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            ms[way] = statistics.median(walls)
        print(f"[integrity] (a) {label}: ok, {rep.checked_pairs} pairs, "
              f"total={int(res_v.total)} digest={clean[label]}, "
              f"{attempts} ladder attempt(s); ms a join at the settled rung "
              f"(median of {INTEGRITY_REPS}) unverified "
              f"{ms['unverified']:.3f} verified {ms['verified']:.3f} "
              f"ratio {ms['verified'] / ms['unverified']:.4f}; {smi}",
              flush=True)
        verified_calls.append(functools.partial(verified, opts=opts))
        del res_p, res_v
    _, counts = counted(lambda: [fn() for fn in verified_calls])
    print(f"[integrity] (a) launches on the verified joins of the "
          f"{len(INTEGRITY_WIRES)} wires {counts}", flush=True)
    _require_launched(counts, JOIN_KERNELS, "the integrity path")
    # what the digests add on the padded wire: CUDA kernels of one join
    # off, with the tape alone, and with the tape and the digests
    comm = comm_of(1)
    kernels = {way: cuda_kernels(lambda f=make_distributed_join(
        comm, **kw): f(build, probe)) for way, kw in (
            ("off", {}), ("tape", {"with_metrics": True}),
            ("digests", {"with_integrity": True}))}
    print(f"[integrity] (a) CUDA kernels of one padded join over {n} "
          f"ranks: off {kernels['off']}, the tape alone "
          f"{kernels['tape']}, the tape and the digests "
          f"{kernels['digests']} (+{kernels['digests'] - kernels['tape']} "
          f"for the digests)", flush=True)

    # (b) every mode on the padded and ragged seams and the cross-slice hop
    wires = {label: (slices, opts) for label, slices, opts in INTEGRITY_WIRES}
    for label, modes in INTEGRITY_SEAMS.items():
        slices, opts = wires[label]
        b, p = tables_of(label)
        for mode in modes:
            comm = comm_of(slices, FaultPlan(seed=INTEGRITY_SEED,
                                             corrupt_mode=mode,
                                             corrupt_collectives=1))
            cache = JoinProgramCache(comm)
            res = distributed_inner_join(b, p, comm, program_cache=cache,
                                         verify_integrity=True,
                                         auto_retry=2, **opts)
            trail = [a.action for a in res.retry_report.attempts]
            _check(trail == ["initial", "retry_integrity"]
                   and res.integrity_report.ok
                   and row_digest(res) == clean[label]
                   and cache.integrity_evictions == 1,
                   f"integrity (b) {label} {mode}: trail {trail}, digest "
                   f"{row_digest(res)} against {clean[label]}")
            del res
            comm = comm_of(slices, FaultPlan(seed=INTEGRITY_SEED,
                                             corrupt_mode=mode,
                                             corrupt_collectives=1 << 30))
            try:
                res = distributed_inner_join(b, p, comm,
                                             verify_integrity=True,
                                             auto_retry=1, **opts)
                _fail(f"integrity (b) {label} {mode}: an unbounded budget "
                      f"returned {int(res.total)} rows")
            except IntegrityError as exc:
                pairs = len(exc.report.mismatches)
            print(f"[integrity] (b) {label} {mode}: budget 1 -> {trail}, "
                  f"digest equal; unbounded -> IntegrityError on {pairs} "
                  "pairs", flush=True)

    # (c) the drivers' --verify-integrity over the emulated ranks
    rec = D.run(D.parse_args(
        ["--communicator", "emulated", "--n-ranks", str(n),
         "--build-table-nrows", str(INTEGRITY_ROWS),
         "--probe-table-nrows", str(INTEGRITY_ROWS), "--iterations", "2",
         "--verify-integrity"]))
    _check(rec["integrity"]["ok"] and not rec["overflow"],
           f"integrity (c) join driver record {rec['integrity']}")
    a2a, _ = A.run(A.parse_args(
        ["--communicator", "emulated", "--n-ranks", str(n),
         "--buffer-size", str(A2A_INTEGRITY_MIB << 20), "--iterations", "5",
         "--verify-integrity"]))
    _check(a2a["integrity"]["ok"]
           and a2a["integrity"]["checked_pairs"] == n * n,
           f"integrity (c) all-to-all driver record {a2a['integrity']}")
    print(f"[integrity] (c) join driver: integrity {rec['integrity']}, "
          f"{rec['elapsed_per_join_s'] * 1e3:.3f} ms a join; all-to-all "
          f"driver: integrity {a2a['integrity']}, "
          f"{a2a['elapsed_per_exchange_s'] * 1e3:.3f} ms an exchange; "
          f"{smi}", flush=True)
    del build, probe, stringed
    torch.cuda.empty_cache()

    # (d) integrity off: the headline's launches and row digest
    record, head_counts = counted(
        lambda: bench.run(NROWS, bench.ITERS, device=DEVICE))
    hb, hp = generate_build_probe_tables(
        seed=SEED, build_nrows=NROWS, probe_nrows=NROWS,
        selectivity=bench.SELECTIVITY, device=DEVICE)
    match_out = int(bench.MATCHES_PER_ROW * NROWS * bench.OUT_SLACK)
    digest = row_digest(sort_merge_inner_join(hb, hp, "key", match_out))
    print(f"[integrity] (d) integrity off: headline launches {head_counts}, "
          f"match-sized digest {digest}, {record['matches_per_join']} "
          "matches", flush=True)
    return {"launches_by_path": {"integrity": counts},
            "headline_launches": head_counts, "headline_digest": digest}


# -- phase 25: the serving fleet ---------------------------------------------


FLEET_WIRE_PAIRS = 32          # (a): warm wire joins a side, in pairs
FLEET_SMOKE_TIMEOUT_S = 300


def _fleet_smoke(tmp: str, flag: str, extra: tuple = ()):
    """``python -m distributed_join_tpu_torch.service.fleet <flag>`` on
    this device with its workdir under ``tmp``, started (not waited for):
    ``(process, record path, start time)``."""
    import subprocess
    work = os.path.join(tmp, flag.strip("-"))
    out = work + ".json"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__))]
        + [x for x in env.get("PYTHONPATH", "").split(os.pathsep) if x])
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_join_tpu_torch.service.fleet",
         flag, "--device", DEVICE, "--persist-dir", work,
         "--json-output", out, *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        start_new_session=True)
    return proc, out, time.perf_counter()


def _fleet_smoke_kill(started) -> None:
    """Kill a smoke started by ``_fleet_smoke`` and its replicas (its
    session's process group), if it still runs."""
    import signal
    proc = started[0]
    if proc.poll() is None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.communicate()


def _fleet_smoke_record(started, what: str) -> tuple:
    """Wait for a smoke started by ``_fleet_smoke``: (its record, its
    seconds); a non-zero exit fails the phase."""
    proc, out, t0 = started
    try:
        so, se = proc.communicate(timeout=FLEET_SMOKE_TIMEOUT_S)
    except BaseException:
        _fleet_smoke_kill(started)
        raise
    secs = time.perf_counter() - t0
    _check(proc.returncode == 0 and os.path.exists(out),
           f"{what}: rc {proc.returncode}; {so[-2000:]} {se[-4000:]}")
    with open(out) as fh:
        rec = json.load(fh)
    _check(not rec["violations"], f"{what}: {rec['violations']}")
    return rec, secs


def _pair_medians(first, second, pairs: int):
    """``pairs`` back-to-back calls of ``first`` and ``second`` (each
    returns its seconds), the side that goes first alternating: the
    medians of each side's ms, and the quartiles (25th, 50th, 75th
    percentile) of the pairs' ratios first / second."""
    import numpy as np
    a, b = [], []
    for i in range(pairs):
        if i % 2 == 0:
            a.append(first(i))
            b.append(second(i))
        else:
            b.append(second(i))
            a.append(first(i))
    ratios = np.asarray(a) / np.asarray(b)
    return (float(np.median(a)) * 1e3, float(np.median(b)) * 1e3,
            [float(q) for q in np.percentile(ratios, [25, 50, 75])])


def fleet_phase() -> dict:
    """Phase 25: the serving fleet (``service/fleet.py``) on this card, in
    a process of its own. (a) an in-process fleet of two replicas (each a
    ``JoinService`` on the local communicator on this card), K = 2 table
    replication, a persist dir a slot, behind the router's TCP daemon,
    beside a direct ``JoinService`` daemon that gets the same requests:
    a 10 M-row resident build (phase 18's: seed 42, unique keys, capacity
    factor 1.5) registered on both holders, a 1 M-row append on both,
    then ``SERVING_REQUESTS`` probe-only requests of 2^18 rows and
    ``FLEET_WIRE_PAIRS`` wire joins at config 2's 10 M x 10 M, each pair
    sent to the router and to the direct daemon with the first side
    alternating: equal matches, the warm repeats on the cold request's
    replica with no program built, the router's and the direct call's ms
    a request (medians over the pairs). Then one holder misses an append
    (the fan-out skips it as rebuilding, and the directory is told it
    serves): the next probe-only join meets ``StaleGenerationError`` on
    it and fails over to the other holder, oracle-equal to the direct
    service. Launches are counted over the router's requests (path
    ``fleet``): the scans, both compaction sites and the expand. (b)
    ``--smoke`` as a subprocess (two daemon
    replicas of 2 emulated ranks on this card, a shared persist dir, a
    scripted SIGKILL): its gates, the baseline gate against
    ``results/baselines_torch/fleet_smoke.json``, the seconds from the
    kill to the replacement serving, the replacement's first request
    with its program bound from disk beside a replica's from an empty
    persist dir, each replica's peak device memory. (c) ``--ha-smoke``
    as a subprocess, started once (a)'s timed pairs are done, so that it
    runs beside (b) (both under each other's load) and not beside the
    pairs: the holder rebuild's and the standby's takeover seconds, its
    baseline gate. Returns ``{"fleet":
    launches}``."""
    import shutil
    import tempfile

    from distributed_join_tpu_torch.parallel.communicator import (
        LocalCommunicator,
    )
    from distributed_join_tpu_torch.service import fleet, server
    smi = gpu_line()
    t_part = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="fleet_phase_")

    def part_done(label):
        nonlocal t_part
        now = time.perf_counter()
        print(f"[phase] 25{label}: {now - t_part:.1f} s", flush=True)
        t_part = now

    ha = None
    if DEVICE == "cuda":
        # (a)'s peak alone: the shared process ran other phases before
        torch.cuda.reset_peak_memory_stats()
    cfg = fleet.FleetConfig(
        n_replicas=2, replica_ranks=1, table_replication=2,
        persist_dir=os.path.join(tmp, "programs"),
        coord_dir=os.path.join(tmp, "coord"),
        probe_interval_s=30.0, retry_budget=2, suspect_strikes=2)
    router = fleet.FleetRouter(fleet.in_process_fleet_factory(
        2, 1, persist_dir=cfg.persist_dir, device=DEVICE), cfg)
    router.start()
    rserver, rport = fleet.start_router_daemon(router)
    rclient = server.ServiceClient("127.0.0.1", rport)
    direct = server.JoinService(LocalCommunicator(), server.ServiceConfig(),
                                device=DEVICE)
    dserver, dport = server.start_daemon(direct)
    dclient = server.ServiceClient("127.0.0.1", dport)
    launches: dict = {}
    resps: dict = {"router": [], "direct": []}

    def send(side: str, payload: dict, what: str):
        """One request to the router (its launches counted on the path
        ``fleet``) or to the direct daemon: its client seconds."""
        box = {}

        def go():
            t0 = time.perf_counter()
            box["resp"] = (rclient if side == "router" else dclient).send(
                dict(payload))
            box["s"] = time.perf_counter() - t0

        if side == "router":
            _, counts = counted(go)
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
        else:
            go()
        resp = box["resp"]
        _check(resp.get("ok"), f"{what} ({side}): {json.dumps(resp)[:600]}")
        resps[side].append(resp)
        return box["s"]

    try:
        # (a) the resident table on both holders, and on the direct service
        reg = {"op": "register", "name": "fact", "rows": NROWS,
               "seed": SEED, "unique_keys": True}
        delta = {"op": "append", "name": "fact", "rows": LSM_DELTA_ROWS,
                 "seed": SEED + 100}
        for spec in (reg, delta):
            for side in ("router", "direct"):
                send(side, spec, spec["op"])
        r_reg, r_app = resps["router"][0], resps["router"][1]
        _check(sorted(r_reg["fleet"]["holders"]) == [0, 1]
               and r_app["generation"] == 2
               and sorted(r_app["fleet"]["applied"]) == [0, 1],
               f"register/append fan-out: {r_reg['fleet']} "
               f"{r_app['fleet']} generation {r_app['generation']}")
        primary = fleet.affine_replica({"op": "join", "table": "fact"},
                                       cfg.replica_ranks, cfg.n_replicas)

        def probe_spec(i):
            return {"op": "join", "table": "fact",
                    "probe_nrows": SERVING_PROBE_ROWS, "seed": SEED + 1 + i}

        def check_pairs(label, n):
            r = resps["router"][-n:]
            d = resps["direct"][-n:]
            _check([x["matches"] for x in r] == [x["matches"] for x in d],
                   f"{label}: router matches {[x['matches'] for x in r]} "
                   f"against the direct service's "
                   f"{[x['matches'] for x in d]}")
            reps = {x["fleet"]["replica"] for x in r}
            _check(len(reps) == 1 and r[0]["new_traces"] >= 1
                   and not any(x["new_traces"] for x in r[1:]),
                   f"{label}: replicas {reps}, builds "
                   f"{[x['new_traces'] for x in r]}")
            return reps.pop()

        cold_r = send("router", probe_spec(0), "cold probe")
        cold_d = send("direct", probe_spec(0), "cold probe")
        ms_r, ms_d, q_p = _pair_medians(
            lambda i: send("router", probe_spec(i + 1), f"probe {i + 1}"),
            lambda i: send("direct", probe_spec(i + 1), f"probe {i + 1}"),
            SERVING_REQUESTS - 1)
        rep = check_pairs("probe-only", SERVING_REQUESTS)
        _check(rep == primary, f"probe-only joins served by {rep}, the "
               f"table's ring start is {primary}")
        print(f"[fleet] (a) {NROWS:,}-row table on holders "
              f"{r_reg['fleet']['holders']} (K=2), {LSM_DELTA_ROWS:,}-row "
              f"append on both (generation 2); {SERVING_REQUESTS} probe-only "
              f"requests of {SERVING_PROBE_ROWS:,} rows on replica {rep}, "
              f"each equal to the direct service's, warm repeats build 0; "
              f"cold (a build each) router {cold_r * 1e3:.4f} ms, direct "
              f"{cold_d * 1e3:.4f} ms; warm ms a request (client clock, "
              f"medians over {SERVING_REQUESTS - 1} pairs, the first side "
              f"alternating): router {ms_r:.4f}, direct {ms_d:.4f}; the "
              f"pairs' ratio router / direct quartiles {q_p[0]:.4f} "
              f"{q_p[1]:.4f} {q_p[2]:.4f}; {smi}", flush=True)
        part_done("a probe-only")

        wire = {"op": "join", "build_nrows": NROWS, "probe_nrows": NROWS,
                "seed": SEED, "selectivity": 0.3}
        torch.cuda.empty_cache()
        cold_r = send("router", wire, "cold wire join")
        cold_d = send("direct", wire, "cold wire join")
        wr, wd, q_w = _pair_medians(
            lambda i: send("router", wire, f"wire join {i}"),
            lambda i: send("direct", wire, f"wire join {i}"),
            FLEET_WIRE_PAIRS)
        rep_w = check_pairs("wire join", FLEET_WIRE_PAIRS + 1)
        warm_r = [x["elapsed_s"] for x in resps["router"][-FLEET_WIRE_PAIRS:]]
        print(f"[fleet] (a) wire join {NROWS:,} x {NROWS:,} through the "
              f"router on replica {rep_w} (the signature's ring start "
              f"{fleet.affine_replica(wire, 1, 2)}): "
              f"{resps['router'][-1]['matches']:,} matches, equal to the "
              f"direct service's, warm repeats build 0; cold router "
              f"{cold_r * 1e3:.4f} ms, direct {cold_d * 1e3:.4f} ms; warm ms "
              f"a request (client clock, medians over {FLEET_WIRE_PAIRS} "
              f"pairs, the first side alternating): router {wr:.4f}, direct "
              f"{wd:.4f}; the pairs' ratio router / direct quartiles "
              f"{q_w[0]:.4f} {q_w[1]:.4f} {q_w[2]:.4f}; the replica's warm "
              f"join (daemon clock) min {min(warm_r) * 1e3:.4f} ms; {smi}",
              flush=True)
        torch.cuda.empty_cache()
        part_done("a wire")
        # (c) starts now, after the timed pairs, and runs beside (b)
        ha = _fleet_smoke(tmp, "--ha-smoke")

        # the stale holder: the primary misses an append
        entry = router._tables["fact"]
        entry["holders"][primary]["state"] = "rebuilding"
        delta2 = {"op": "append", "name": "fact", "rows": LSM_DELTA_ROWS,
                  "seed": SEED + 200}
        send("router", delta2, "append past the primary")
        send("direct", delta2, "append")
        app2 = resps["router"][-1]
        _check(app2["fleet"]["applied"] == [1 - primary]
               and app2["generation"] == 3,
               f"the partial append: {app2['fleet']}")
        entry["holders"][primary]["state"] = "serving"
        before = router.stats()["failovers_total"]
        send("router", probe_spec(SERVING_REQUESTS), "failover probe")
        send("direct", probe_spec(SERVING_REQUESTS), "probe")
        fo, want = resps["router"][-1], resps["direct"][-1]
        holder = router.stats()["tables"]["fact"]["holders"][str(primary)]
        fenced = server.ServiceClient(*router.replicas[primary].addr())
        try:
            refusal = fenced.send({**probe_spec(0), "min_generation": 3})
        finally:
            fenced.close()
        _check(fo["matches"] == want["matches"]
               and fo["fleet"]["replica"] == 1 - primary
               and fo["fleet"]["attempts"] == 2
               and fo["resident"]["generation"] == 3
               and router.stats()["failovers_total"] == before + 1
               and holder["state"] == "stale"
               and refusal.get("error") == "StaleGenerationError",
               f"stale holder: {fo.get('fleet')}, holder {holder}, "
               f"refusal {refusal.get('error')}")
        _require_launched(launches, JOIN_KERNELS, "the fleet path")
        mem = direct.stats().get("device_memory") or {"peak_bytes": 0}
        print(f"[fleet] (a) the primary holder {primary} missed the "
              f"generation-3 append: its fenced join refused with "
              f"StaleGenerationError, the router failed over to replica "
              f"{fo['fleet']['replica']} in {fo['fleet']['attempts']} "
              f"attempts, {fo['matches']:,} matches equal to the direct "
              f"service's; the holder is now {holder['state']}; launches on "
              f"the fleet path {launches}; peak device memory over (a) "
              f"(both replicas and the direct service, one process) "
              f"{mem['peak_bytes']:,} B; {smi}", flush=True)
    except BaseException:
        if ha is not None:
            _fleet_smoke_kill(ha)
        raise
    finally:
        for c in (rclient, dclient):
            c.close()
        rserver.shutdown()
        rserver.server_close()
        router.stop()
        dserver.shutdown()
        dserver.server_close()
    del router, direct
    torch.cuda.empty_cache()
    part_done("a stale")

    try:
        # (b) the smoke, subprocess replicas sharing one persist dir
        rec, secs = _fleet_smoke_record(
            _fleet_smoke(tmp, "--smoke"), "--smoke")
        gate = rec["baseline_gate"]
        cold = rec["cold_replica"]
        _check(DEVICE == "cpu" or gate.get("ok") is True,
               f"--smoke baseline gate: {gate}")
        _check(rec["platform"] == "cuda" or DEVICE == "cpu",
               f"--smoke drew on {rec['platform']}")
        _check(rec["replacement_cache"]["disk_loads"] == 1
               and rec["replacement_cache"]["traces"] == 0
               and cold["new_traces"] >= 1,
               f"--smoke: replacement cache {rec['replacement_cache']}, the "
               f"fresh-dir replica built {cold['new_traces']}")
        print(f"[fleet] (b) --smoke ({rec['replicas']} daemon replicas x "
              f"{rec['n_ranks']} emulated ranks on this card, shared "
              f"persist dir, (c) beside it): {secs:.1f} s; kill -> "
              f"drained {rec['drained_after_s']} s, -> replacement healthy "
              f"{rec['replaced_after_s']:.3f} s, -> serving "
              f"{rec['kill_to_serving_s']:.3f} s; the replacement's first "
              f"request {rec['replacement_first_request_ms']:.2f} ms "
              f"(program bound from the shared dir's entry: 0 builds, 1 "
              f"disk load; the daemon's join "
              f"{rec['replacement_first_request_server_s'] * 1e3:.2f} ms) "
              f"against a replica from an empty persist dir "
              f"{cold['first_request_ms']:.2f} ms ({cold['new_traces']} "
              f"build; daemon {cold['first_request_server_s'] * 1e3:.2f} "
              f"ms); failover in {rec['failover_attempts']} attempts; "
              f"{rec['burst_shed']} of 8 shed at inflight 1; peak device "
              f"memory by replica {json.dumps(rec['replica_memory'])}; "
              f"baseline gate {json.dumps(gate)}; {smi}", flush=True)
        print("[fleet] (b) counter signature "
              + json.dumps(rec["counter_signature"]), flush=True)
        part_done("b")

        # (c) the HA smoke, started after (a)'s timed pairs
        rec, secs = _fleet_smoke_record(ha, "--ha-smoke")
        _check(DEVICE == "cpu" or rec["baseline_gate"].get("ok") is True,
               f"--ha-smoke baseline gate: {rec['baseline_gate']}")
        counters = rec["counter_signature"]["counters"]
        print(f"[fleet] (c) --ha-smoke (K=2, beside (b)): {secs:.1f} s; "
              f"holder kill -> failover in {rec['failover_attempts']} "
              f"attempts, rebuild from the manifest "
              f"{json.dumps(rec['rebuild_s'])} s (rebuilt replay: "
              f"{counters['rebuilt_replay_new_traces']} builds), router "
              f"kill -> standby takeover {rec['takeover_s']:.3f} s (its "
              f"resend: {counters['takeover_new_traces']} builds); peak "
              f"device memory by replica "
              f"{json.dumps(rec['replica_memory'])}; baseline gate "
              f"{json.dumps(rec['baseline_gate'])}; {smi}", flush=True)
        print("[fleet] (c) counter signature "
              + json.dumps(rec["counter_signature"]), flush=True)
        part_done("c")
    finally:
        # (c) still running when (b) failed: it and its replicas go
        _fleet_smoke_kill(ha)
    shutil.rmtree(tmp, ignore_errors=True)
    return {"fleet": launches}


# -- phase 26: the chaos soak ----------------------------------------------

CHAOS_SEED = 42
CHAOS_TRIALS = 20              # (a): the main soak's trials
CHAOS_RANKS = 8                # (a), (b): emulated ranks a trial
CHAOS_HIER = 2                 # (b): hierarchical trials
CHAOS_TUNER = 3                # (b): poisoned-history trials
CHAOS_FLEET = 8                # (c): trials through the fleet
CHAOS_DRIVER_RANKS = 4         # (d): the join driver's emulated ranks
# (d): --chaos-seed -> the fault the seed draws (chaos.wrap_communicator)
CHAOS_DRIVER_SEEDS = {3: "none", 7: "overflow", 2: "misroute"}


def chaos_phase() -> dict:
    """Phase 26: the chaos soak (``parallel/chaos.py``) on this card, in a
    process of its own. (a) ``soak(CHAOS_SEED, CHAOS_TRIALS)`` over
    ``CHAOS_RANKS`` emulated ranks: 0 failures, the verdict histogram, ms
    a trial, and the join kernels' launches (path ``chaos``; B5's skew
    site is counted, not required: at a trial's rows the sidecar's
    extract takes the sort by the JAX branch rule). (b) ``hier_slice`` and ``tuner_slice``:
    0 failures. (c) ``fleet_slice(..., fault="kill")`` over two daemon
    replicas on this card: its gates, and the kill-to-drain and
    kill-to-replaced seconds. (d) the join driver at config 2's rows over
    ``CHAOS_DRIVER_RANKS`` emulated ranks with ``--verify-integrity
    --auto-retry 1``, without ``--chaos-seed`` and with each seed of
    ``CHAOS_DRIVER_SEEDS``: a run either refuses with ``IntegrityError``
    (the driver's exit is then non-zero: ``run_guarded`` re-raises) or
    reports the clean run's row digest; seeds 3 and 7 must report it.
    Returns ``{"launches_by_path": {"chaos": counts}}``."""
    import statistics

    from distributed_join_tpu_torch.benchmarks import (
        distributed_join as D,
    )
    from distributed_join_tpu_torch.parallel import chaos
    from distributed_join_tpu_torch.parallel.integrity import IntegrityError

    smi = gpu_line()
    t = time.perf_counter()
    summary, counts = counted(lambda: chaos.soak(
        CHAOS_SEED, CHAOS_TRIALS, n_ranks=CHAOS_RANKS, repro_out=None,
        device=DEVICE))
    secs = time.perf_counter() - t
    _check(summary["failures"] == 0,
           f"chaos (a): {summary['failures']} failed trials: "
           f"{[r for r in summary['records'] if r['verdict'].startswith('FAILED')]}")
    # B5's skew site is not required: at a trial's 64-256 rows a rank
    # the skew sidecar's extract takes the sort (the JAX package's branch
    # rule: the kernel only where a rank's rows are twice the capacity)
    _require_launched(counts, JOIN_KERNELS, "the chaos soak")
    ms = [r["elapsed_s"] * 1e3 for r in summary["records"]]
    faults = {}
    for r in summary["records"]:
        faults[r["fault"]] = faults.get(r["fault"], 0) + 1
    print(f"[chaos] (a) soak seed {CHAOS_SEED}, {CHAOS_TRIALS} trials over "
          f"{CHAOS_RANKS} emulated ranks: verdicts "
          f"{json.dumps(summary['verdicts'], sort_keys=True)}, faults "
          f"{json.dumps(faults, sort_keys=True)}, 0 failures; ms a trial "
          f"median {statistics.median(ms):.1f} min {min(ms):.1f} max "
          f"{max(ms):.1f}; {secs:.1f} s; launches "
          f"{json.dumps({k: counts[k] for k in (*JOIN_KERNELS, 'extract_prefix')})}"
          f"; {smi}", flush=True)

    # (b) the hierarchical and tuner slices
    for name, fn, trials in (("hier", chaos.hier_slice, CHAOS_HIER),
                             ("tuner", chaos.tuner_slice, CHAOS_TUNER)):
        t = time.perf_counter()
        sl = fn(CHAOS_SEED, trials, n_ranks=CHAOS_RANKS, repro_out=None,
                device=DEVICE)
        _check(sl["failures"] == 0, f"chaos (b) {name}: {sl}")
        extra = ""
        if name == "tuner":
            _check(all(r["tuner_presized"] and r["tuner_corrected"]
                       for r in sl["records"]),
                   f"chaos (b) tuner loop open: {sl['records']}")
            extra = ", every trial pre-sized and corrected"
        print(f"[chaos] (b) {name} slice: {trials} trials, verdicts "
              f"{json.dumps(sl['verdicts'], sort_keys=True)}, 0 failures"
              f"{extra}; {time.perf_counter() - t:.1f} s", flush=True)

    # (c) the fleet soak: SIGKILL of the midpoint trial's replica
    t = time.perf_counter()
    fl = chaos.fleet_slice(CHAOS_SEED, CHAOS_FLEET, fault="kill",
                           device=DEVICE)
    dr = fl["drain_replace"]
    _check(fl["failures"] == 0 and dr["replaced"]
           and fl["post_replacement_new_traces"] == 0,
           f"chaos (c) fleet kill: {fl['failure_records']} {dr}")
    print(f"[chaos] (c) fleet soak, kill, {CHAOS_FLEET} trials over two "
          f"daemon replicas on this card: verdicts "
          f"{json.dumps(fl['verdicts'], sort_keys=True)}, victim "
          f"{fl['victim']}, kill to drained {dr['drained_after_s']} s, kill "
          f"to replaced {dr.get('replaced_after_s')} s, replacement new "
          f"traces {fl['post_replacement_new_traces']}, trace continuity "
          f"{json.dumps(fl['trace_continuity'])}; "
          f"{time.perf_counter() - t:.1f} s", flush=True)

    # (d) the join driver's --chaos-seed at config 2's rows
    argv = ["--communicator", "emulated", "--n-ranks",
            str(CHAOS_DRIVER_RANKS), "--build-table-nrows", str(NROWS),
            "--probe-table-nrows", str(NROWS), "--iterations", "1",
            "--verify-integrity", "--auto-retry", "1"]
    clean = D.run(D.parse_args(argv), device=DEVICE)
    _check(clean["row_digest"] is not None and not clean["overflow"],
           f"chaos (d) clean run: {clean['integrity']}")
    print(f"[chaos] (d) join driver {NROWS} x {NROWS} over "
          f"{CHAOS_DRIVER_RANKS} emulated ranks, no --chaos-seed: digest "
          f"{clean['row_digest']}, {clean['matches_per_join']} matches",
          flush=True)
    for seed, fault in CHAOS_DRIVER_SEEDS.items():
        t = time.perf_counter()
        try:
            rec = D.run(D.parse_args(argv + ["--chaos-seed", str(seed)]),
                        device=DEVICE)
        except IntegrityError as exc:
            _check(fault not in ("none", "overflow"),
                   f"chaos (d) seed {seed} ({fault}) refused: {exc}")
            print(f"[chaos] (d) --chaos-seed {seed} ({fault}): refused, "
                  f"IntegrityError on {len(exc.report.mismatches)} pairs, "
                  f"no record; {time.perf_counter() - t:.1f} s", flush=True)
            continue
        _check(rec["row_digest"] == clean["row_digest"]
               and rec["matches_per_join"] == clean["matches_per_join"],
               f"chaos (d) seed {seed} ({fault}): digest "
               f"{rec['row_digest']} against {clean['row_digest']}")
        print(f"[chaos] (d) --chaos-seed {seed} ({fault}): digest equal to "
              f"the clean run's, retry {json.dumps(rec['retry'])}, "
              f"integrity ok {rec['integrity']['ok']}; "
              f"{time.perf_counter() - t:.1f} s", flush=True)
    return {"launches_by_path": {"chaos": counts}}


def serving_kernel_entries(rows: list, paths: dict) -> list:
    """The serving shapes' rows of the kernels line: their launches on
    the path of the registry they were taken from (every warm request
    launches each once)."""
    sites = {name.format(label): site for label, _, _ in SERVING_SETTINGS
             for name, site in SERVING_SITES.items()}
    return [{**{k: r[k] for k in (
        "name", "route", "source", "replaces")},
        "launches": paths[r["path"]][sites[r["name"]]],
        **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                             "bound_by", "library_ms", "device_ms",
                             "merged_positions")},
        "launches_by_path": {r["path"]: paths[r["path"]][
            sites[r["name"]]]}} for r in rows]


def groups_kernel_entry(row: dict, paths: dict) -> dict:
    """The groups site's entry of the kernels line: its launches on the
    main query paths (Q3 and Q10 at SF-10), by path (the paths counted in
    this process; the NCCL workers count the join sites only), and why
    the paths without one launch none."""
    counts = {p: c["compact_groups"] for p, c in paths.items()
              if "compact_groups" in c}
    return {**{k: row[k] for k in (
        "name", "route", "source", "replaces")},
        "launches": counts["query_q3"] + counts["query_q10"],
        **{k: row[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "device_ms", "merged_positions", "lanes",
            "survivors")},
        "launches_by_path": counts,
        "no_launch_reason": {p: GROUPS_REASON
                             for p, c in counts.items() if not c}}


# -- phase 27: the native driver ---------------------------------------

NATIVE_ROWS = 1_000_000        # (b): the Python against native pairs
NATIVE_BIG_ROWS = 10_000_000   # (c): config 2's rows
NATIVE_ITERS = 8
NATIVE_PAIRS = 5
_DRIVER_BUILD: dict = {}


def start_driver_build() -> None:
    """Compile ``native/join_main.cpp`` (g++ against libtorch) in a
    thread, while the kernels build; :func:`native_phase` waits for it."""
    import threading

    from distributed_join_tpu_torch.native import export_join

    def run():
        try:
            t = time.perf_counter()
            _DRIVER_BUILD["path"] = str(export_join.build_driver())
            _DRIVER_BUILD["s"] = time.perf_counter() - t
        except Exception as exc:  # noqa: BLE001 — re-raised in native_phase
            _DRIVER_BUILD["error"] = exc

    _DRIVER_BUILD["thread"] = threading.Thread(target=run,
                                               name="driver-build")
    _DRIVER_BUILD["thread"].start()


def _driver_path() -> str:
    if "thread" not in _DRIVER_BUILD:
        start_driver_build()
    _DRIVER_BUILD["thread"].join()
    if "error" in _DRIVER_BUILD:
        raise _DRIVER_BUILD["error"]
    return _DRIVER_BUILD["path"]


def _native_run(driver: str, *argv) -> dict:
    """One driver run; its JSON record (the last line)."""
    import subprocess

    r = subprocess.run([driver, *argv], capture_output=True, text=True,
                       timeout=300)
    if r.returncode != 0:
        _fail(f"join_main {' '.join(argv)} exited {r.returncode}: "
              f"{r.stderr[-2000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def native_phase() -> dict:
    """Phase 27: the native driver (``native/join_main.cpp``, libtorch,
    the join_scans, stream_compact and expand_gather kernels called
    through their C entry points), in the shared process. (a)
    ``--selftest``; (b) at 1 M x 1 M, 8 iterations, the driver's tables
    (``--dump-tables``) through the port's ``build_looped_join`` on this
    card and through ``export_join.numpy_reference`` give the driver's
    total, overflow and checksum exactly, then native against Python ms
    a join on those tables in 5 alternating pairs (the Python host share
    of a one-rank join; recorded, no gate); (c) at 10 M x 10 M, 8
    iterations, with ``--dump-tables``: the numpy reference gives the
    driver's three outputs exactly, ``matches_per_join`` equals the
    driver's own count of probe hits, no overflow, rows/s; and each
    kernel the driver calls, on the inputs its first join gives it (20 M
    merged positions, 12 M output slots), equals its plain twin; (d)
    (c)'s kernel launches are path ``native``; (e) the 14 schedule
    programs recorded over 8 emulated ranks on this card equal
    ``results/schedules_torch/``. Returns ``{"native": counts,
    "native_rows_per_sec": (c)'s rate}``."""
    from distributed_join_tpu_torch.analysis import schedule
    from distributed_join_tpu_torch.native import export_join

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "native", "chip_smoke")
    t = time.perf_counter()
    driver = _driver_path()
    print(f"[native] driver {os.path.basename(driver)} (g++ "
          f"{_DRIVER_BUILD.get('s', 0.0):.1f} s in the background); wait "
          f"{time.perf_counter() - t:.1f} s", flush=True)

    import subprocess
    r = subprocess.run([driver, "--selftest"], capture_output=True,
                       text=True, timeout=120)
    _check(r.returncode == 0 and "11 22 33 44" in r.stdout,
           f"(a) join_main --selftest: {r.returncode} {r.stdout} {r.stderr}")
    print(f"[native] (a) {r.stdout.strip()}", flush=True)

    def export(rows, name):
        out = os.path.join(work, name)
        export_join.main(["--build-table-nrows", str(rows),
                          "--probe-table-nrows", str(rows),
                          "--iterations", str(NATIVE_ITERS), "-o", out])
        return out

    def dumped(rows, name):
        """The driver's run at ``rows`` with ``--dump-tables``: its
        record, its outputs, the tables on the card, and the numpy
        reference's outputs on them."""
        tables = os.path.join(work, f"tables_{name}")
        art = export(rows, f"art_{name}")
        rec = _native_run(driver, "--artifact-dir", art, "--dump-tables",
                          tables)
        cols = export_join.load_tables(tables, rows, rows)
        ref = export_join.numpy_reference(cols, NATIVE_ITERS,
                                          _native_out_rows(rows))
        return rec, [rec["total_matches_x_iters"], rec["overflow"],
                     rec["dce_guard_checksum"]], \
            [c.to(DEVICE) for c in cols], ref

    _, want, cols, ref = dumped(NATIVE_ROWS, "1m")
    art = os.path.join(work, "art_1m")
    looped, _ = export_join.build_looped_join(
        NATIVE_ROWS, NATIVE_ROWS, NATIVE_ITERS, _native_out_rows(NATIVE_ROWS),
        DEVICE)
    got = [x.item() for x in looped(*cols)]
    _check(got == want == ref,
           f"(b) 1 M x 1 M: join_main {want}, the port's build_looped_join "
           f"{got}, the numpy reference {ref} (total x iters, overflow, "
           "checksum)")
    print(f"[native] (b) 1 M x 1 M, {NATIVE_ITERS} iterations: native == "
          f"python == numpy (total x iters, overflow, checksum) = {want}",
          flush=True)

    def python_s():
        looped(*cols)[0].item()                   # warm-up loop
        t0 = time.perf_counter()
        looped(*cols)[0].item()                   # one host read
        return (time.perf_counter() - t0) / NATIVE_ITERS

    native_ms, python_ms = [], []
    for _ in range(NATIVE_PAIRS):
        native_ms.append(1e3 * _native_run(
            driver, "--artifact-dir", art)["elapsed_per_join_s"])
        python_ms.append(1e3 * python_s())
    med_n, med_p = float(np.median(native_ms)), float(np.median(python_ms))
    print(f"[native] (b) ms a join at 1 M x 1 M, {NATIVE_PAIRS} alternating "
          f"pairs: native {native_ms} python {python_ms}; medians native "
          f"{med_n:.4f} python {med_p:.4f}: the Python host share "
          f"{(med_p - med_n) / med_p:.3f} of a one-rank join", flush=True)
    del cols, looped

    big, want, cols, ref = dumped(NATIVE_BIG_ROWS, "10m")
    _check(want == ref and big["matches_per_join"] == big["probe_hits"] > 0
           and not big["overflow"],
           f"(c) 10 M x 10 M: join_main {want} against the numpy reference "
           f"{ref} (total x iters, overflow, checksum); matches_per_join "
           f"{big['matches_per_join']} against {big['probe_hits']} probe "
           "hits")
    print(f"[native] (c) 10 M x 10 M: native == numpy (total x iters, "
          f"overflow, checksum) = {want}; {json.dumps(big)}", flush=True)
    errs = native_kernel_checks(cols, _native_out_rows(NATIVE_BIG_ROWS))
    print(f"[native] (c) each kernel against its plain twin at this run's "
          f"shapes (iteration 0): max_abs_err {errs}", flush=True)
    del cols
    by_site = big["kernel_launches_by_site"]
    counts = {w.__name__: 0 for w in _launch_wrappers()}
    counts.update(by_site)
    _require_launched(counts, JOIN_KERNELS, "the native driver",
                      NATIVE_ITERS)
    print(f"[native] (d) launches on path native: {by_site}", flush=True)

    t = time.perf_counter()
    violations, scheds = schedule.check_schedules(
        schedule_dir=os.path.join(root, schedule.DEFAULT_SCHEDULE_DIR),
        device=DEVICE)
    _check(not violations, "(e) schedules on the card: "
           + "; ".join(violations))
    print(f"[native] (e) {len(scheds)} programs recorded on {DEVICE} over "
          f"{schedule.N_RANKS} emulated ranks equal results/schedules_torch/ "
          f"({time.perf_counter() - t:.1f} s)", flush=True)
    return {"native": counts, "native_rows_per_sec": big["rows_per_sec"]}


def _native_out_rows(rows: int) -> int:
    """export_join's output rows for ``rows`` probe rows (its default
    capacity factor, 1.2)."""
    return int(np.ceil(rows * 1.2))


def native_kernel_checks(cols, out_cap: int) -> dict:
    """B1, B2 at its record and pack sites and B3 in build mode on the
    inputs the native driver's first join gives them (the dumped tables,
    ``out_cap`` output slots), each against its plain twin over the
    prefix its contract defines; ``{site: max_abs_err}``, all 0."""
    from distributed_join_tpu_torch.ops import compact, expand, scan
    from distributed_join_tpu_torch.table import Table

    bk, bp, bv, pk, pp, pv = cols
    x = stage_inputs(Table({"key": bk, "build_payload": bp}, bv),
                     Table({"key": pk, "probe_payload": pp}, pv), out_cap)
    got = scan.join_scans(x["tag"], x["first"])
    want = scan.join_scans_reference(x["tag"], x["first"])
    errs = {"join_scans": max_abs_err([got[k] for k in scan.NAMES],
                                      [want[k] for k in scan.NAMES])}
    for site, mask, pos, lanes, cap, kept in (
            ("stream_compact[record]", x["is_rec"], x["rec_pos"],
             x["rec_lanes"], out_cap, x["kept"]),
            ("stream_compact[pack]", x["matched"], x["mb_pos"],
             x["pack_lane"], x["nb"], x["n_matched"])):
        errs[site] = max_abs_err(
            compact.stream_compact(mask, pos, lanes, cap),
            compact.stream_compact_reference(mask, pos, lanes, cap), kept)
    S, lo, rc, pack = x["S"], x["lo"], x["rec_cols"], x["pack"]
    got_r, got_b = expand.expand_gather(S, rc, out_cap, lo=lo,
                                        build_cols=pack)
    want_r, want_b = expand.expand_gather_reference(S, rc, out_cap, lo=lo,
                                                    build_cols=pack)
    errs["expand_gather[build]"] = max_abs_err(
        got_r + got_b, want_r + want_b, min(x["total"], out_cap))
    torch.cuda.synchronize()
    _check(not any(errs.values()), f"(c) a kernel disagrees with its plain "
                                   f"twin at the native path's shapes: {errs}")
    return errs


# phases 20, 23, 25 and 27 take no profiler session: the whole script
# runs them in one process of their own, one after another
SHARED_PHASES = "20,23,25,27"


def phase_in_own_process(phase) -> dict:
    """``python3 chip_smoke.py --phase N`` in a process of its own; its
    output passes through, and its line before the last (the phase's
    kernels, launches by path and rows) is returned. Late in one long
    process the profiler's sessions drop launches and scale durations
    (``device_ms``); a fresh process measures them right."""
    import subprocess
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--phase", str(phase)], capture_output=True,
                       text=True, timeout=900)
    lines = r.stdout.splitlines()
    for ln in lines[:-2]:
        print(ln, flush=True)
    if r.returncode != 0:
        print(r.stdout[-3000:] + r.stderr[-6000:], file=sys.stderr,
              flush=True)
        _fail(f"phase {phase} in its own process exited with "
              f"{r.returncode}")
    print(f"[phase] phase {phase} in its own process: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return json.loads(lines[-2])


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    job = (json.loads(argv[1]) if argv[:1] == ["--nccl-rank-worker"]
           and len(argv) == 2 else None)
    fault_job = (json.loads(argv[1]) if argv[:1] == ["--fault-driver"]
                 and len(argv) == 2 else None)
    phases = [["--phase", str(p)] for p in range(13, 27)]
    phases.append(["--phase", SHARED_PHASES])
    if argv not in ([], *phases) and job is None and fault_job is None:
        print("usage: chip_smoke.py [--phase 13 | 14 | 15 | 16 | 17 | 18 "
              f"| 19 | 20 | 21 | 22 | 23 | 24 | 25 | 26 | {SHARED_PHASES}]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from distributed_join_tpu_torch.ops import _kernels
    except ModuleNotFoundError:
        print("chip_smoke: distributed_join_tpu_torch/ is not beside this "
              "script; run it from the root of a checkout", file=sys.stderr)
        return 3
    if job is not None:
        return nccl_rank_worker(job)
    if fault_job is not None:
        return fault_driver(fault_job)
    from distributed_join_tpu_torch.utils.generators import (
        generate_build_probe_tables,
    )

    t_start = time.perf_counter()
    smi = gpu_line()
    print(f"[gpu] {smi}", flush=True)
    print(f"[gpu] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    if argv in ([], ["--phase", SHARED_PHASES]):
        start_driver_build()   # g++ beside nvcc: phase 27 waits for it
    t0 = time.perf_counter()
    reports = _kernels.build(verbose=True)
    secs = time.perf_counter() - t0
    print(f"[build] {len(_kernels.SOURCES)} kernel libraries in "
          f"{secs:.2f} s (nvcc, sm_90a, in parallel)", flush=True)
    for name, text in reports.items():
        regs = [ln.strip() for ln in text.splitlines()
                if "registers" in ln or "stack frame" in ln]
        print(f"[build] {name}: " + " | ".join(regs), flush=True)
    ok = json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    if argv == ["--phase", "13"]:
        nccl, _, _, _ = nccl_phase()
        print(f"[done] {time.perf_counter() - t_start:.1f} s; {smi}",
              flush=True)
        print(json.dumps({"nccl_launches": nccl}), flush=True)
        print(ok, flush=True)
        return 0
    if argv == ["--phase", "14"]:
        wires = wire_phase()
        print(f"[done] {time.perf_counter() - t_start:.1f} s; {smi}",
              flush=True)
        print(json.dumps({"wire_launches": wires}), flush=True)
        print(ok, flush=True)
        return 0

    if argv == ["--phase", "15"]:
        counts, rows = tpch_phase()
        print(f"[done] {time.perf_counter() - t_start:.1f} s; {smi}",
              flush=True)
        print(json.dumps({"kernels": [dict(
            r, launches=counts[TPCH_SITES[r["name"]]]) for r in rows],
            "launches_by_path": {"tpch": counts}, "rows": rows}),
            flush=True)
        print(ok, flush=True)
        return 0

    if argv == ["--phase", "16"]:
        seg_paths = segmented_phase()
        print(f"[done] {time.perf_counter() - t_start:.1f} s; {smi}",
              flush=True)
        print(json.dumps({"launches_by_path": seg_paths,
                          "segmented_reason": SEG_REASON}), flush=True)
        print(ok, flush=True)
        return 0

    if argv == ["--phase", "17"]:
        query_paths, groups_row = query_phase()
        print(f"[done] {time.perf_counter() - t_start:.1f} s; {smi}",
              flush=True)
        print(json.dumps({"kernels": [groups_kernel_entry(
            groups_row, query_paths)], "launches_by_path": query_paths,
            "rows": [groups_row]}), flush=True)
        print(ok, flush=True)
        return 0

    if argv == ["--phase", "19"]:
        tel_paths = telemetry_phase()
        print(f"[done] {time.perf_counter() - t_start:.1f} s; {smi}",
              flush=True)
        print(json.dumps({"launches_by_path": tel_paths}), flush=True)
        print(ok, flush=True)
        return 0

    if argv == ["--phase", "20"]:
        service_paths = service_phase()
        print(f"[done] {time.perf_counter() - t_start:.1f} s; {smi}",
              flush=True)
        print(json.dumps({"launches_by_path": service_paths}), flush=True)
        print(ok, flush=True)
        return 0

    if argv == ["--phase", "21"]:
        cost_paths = cost_phase()
        print(f"[done] {time.perf_counter() - t_start:.1f} s; {smi}",
              flush=True)
        print(json.dumps({"launches_by_path": cost_paths}), flush=True)
        print(ok, flush=True)
        return 0

    if argv == ["--phase", "22"]:
        stage_paths = stageprof_phase()
        print(f"[done] {time.perf_counter() - t_start:.1f} s; {smi}",
              flush=True)
        print(json.dumps({"launches_by_path": stage_paths}), flush=True)
        print(ok, flush=True)
        return 0

    if argv == ["--phase", "23"]:
        tuner_paths = tuner_phase()
        print(f"[done] {time.perf_counter() - t_start:.1f} s; {smi}",
              flush=True)
        print(json.dumps({"launches_by_path": tuner_paths}), flush=True)
        print(ok, flush=True)
        return 0

    if argv == ["--phase", "24"]:
        integ = integrity_phase()
        print(f"[done] {time.perf_counter() - t_start:.1f} s; {smi}",
              flush=True)
        print(json.dumps(integ), flush=True)
        print(ok, flush=True)
        return 0

    if argv == ["--phase", "25"]:
        fleet_paths = fleet_phase()
        print(f"[done] {time.perf_counter() - t_start:.1f} s; {smi}",
              flush=True)
        print(json.dumps({"launches_by_path": fleet_paths}), flush=True)
        print(ok, flush=True)
        return 0

    if argv == ["--phase", "26"]:
        chaos_paths = chaos_phase()
        print(f"[done] {time.perf_counter() - t_start:.1f} s; {smi}",
              flush=True)
        print(json.dumps(chaos_paths), flush=True)
        print(ok, flush=True)
        return 0

    if argv == ["--phase", SHARED_PHASES]:
        # the phases that profile nothing, one after another in one
        # process (each process start costs ~9 s on the card's host)
        shared = {}
        for p, fn in (("20", service_phase), ("23", tuner_phase),
                      ("25", fleet_phase), ("27", native_phase)):
            t = time.perf_counter()
            torch.cuda.empty_cache()
            shared.update(fn())
            print(f"[phase] phase {p} in the shared process: "
                  f"{time.perf_counter() - t:.1f} s", flush=True)
        rate = shared.pop("native_rows_per_sec")
        print(f"[done] {time.perf_counter() - t_start:.1f} s; {smi}",
              flush=True)
        print(json.dumps({"launches_by_path": shared,
                          "native_rows_per_sec": rate}), flush=True)
        print(ok, flush=True)
        return 0

    if argv == ["--phase", "18"]:
        resident_paths, serving_rows = resident_phase()
        print(f"[done] {time.perf_counter() - t_start:.1f} s; {smi}",
              flush=True)
        print(json.dumps({"kernels": serving_kernel_entries(
            serving_rows, resident_paths),
            "launches_by_path": resident_paths, "rows": serving_rows}),
            flush=True)
        print(ok, flush=True)
        return 0

    def timed(phase, *args, **kwargs):
        t = time.perf_counter()
        out = phase(*args, **kwargs)
        print(f"[phase] {phase.__name__}: {time.perf_counter() - t:.1f} s",
              flush=True)
        return out

    build, probe = generate_build_probe_tables(
        seed=SEED, build_nrows=NROWS, probe_nrows=NROWS, device=DEVICE)
    rows = timed(kernel_phase, build, probe, int(0.6 * NROWS * 1.25))
    own = timed(entry_points_phase, build, probe)
    del build, probe
    torch.cuda.empty_cache()

    head_rec, head, head_digests = timed(headline_phase)
    rec = timed(record_mode_phase)
    timed(emulated_phase)
    skew_row, c3 = timed(config3_phase)
    timed(zipf_emulated_phase)
    c1 = timed(c1_phase)
    paths = {"config5": timed(config5_phase), **timed(types_phase)}
    timed(emulated_strings_phase)
    typed, typed_ms, typed_rows = timed(typed_phase)
    paths.update(typed)
    print(f"[typed] ms_per_join {json.dumps(typed_ms)}; {smi}", flush=True)
    paths["nccl"], bucket_rows, plain, flat_prof = timed(nccl_phase)
    paths.update({f"nccl_{mode}": c
                  for mode, c in timed(wire_phase, *plain).items()})
    paths.update(timed(segmented_phase, *plain, flat_profile=flat_prof))
    # the phases that profile kernel rows late in the script, each in a
    # process of its own (``phase_in_own_process``)
    own15, own17, own18, own19, own21, own22, own24, own26, shared = (
        phase_in_own_process(p)
        for p in (15, 17, 18, 19, 21, 22, 24, 26, SHARED_PHASES))
    for own_phase in (own15, own17, own18, own19, own21, own22, own24,
                      own26, shared):
        paths.update(own_phase["launches_by_path"])
    # phase 24(d): integrity off leaves the headline as it was
    _check(own24["headline_launches"] == head
           and tuple(own24["headline_digest"])
           == head_digests["match_sized"],
           f"integrity off: the headline's launches "
           f"{own24['headline_launches']} and digest "
           f"{own24['headline_digest']} differ from the headline phase's "
           f"{head} {head_digests['match_sized']}")
    print(f"[integrity] (d) the headline with integrity off equals the "
          f"headline phase's: launches {head}, digest "
          f"{head_digests['match_sized']}", flush=True)
    print(f"[native] (c) 10 M x 10 M: native "
          f"{shared['native_rows_per_sec'] / 1e6:.2f} M rows/s against "
          f"the headline's {head_rec['value_capacity_contract']:.2f} M "
          "rows/s at the same output contract, 1.2 x probe rows (the "
          "generators differ: the driver's build keys are unique and its "
          "probe hits drawn by std::mt19937_64; the headline draws build "
          "keys with replacement)", flush=True)
    tpch_rows, (groups_row,), serving_rows = (
        own15["rows"], own17["rows"], own18["rows"])

    launches = {"join_scans": head["join_scans"],
                "stream_compact[record]": head["compact_records"],
                "stream_compact[pack]": head["pack_matched_builds"],
                "stream_compact[skew]": c3["extract_prefix"],
                "expand_gather[build]": head["expand_gather"],
                "expand_gather[record]": rec["expand_gather"],
                **{k: own[k] for k in ("merge_sort[key+tag]",
                                       "merge_sort[key]")},
                **{k: own[k] for k in ("expand_pull[build]",
                                       "expand_pull[record]")},
                "stream_compact[record, full_outer]":
                    typed["full_outer"]["compact_records"],
                "stream_compact[valid-build pack]":
                    typed["full_outer"]["pack_valid_builds"],
                "expand_gather[build, full_outer]":
                    typed["full_outer"]["expand_gather"],
                "expand_gather[record, anti]": typed["anti"]["expand_gather"],
                "join_scans[nccl bucket]": paths["nccl"]["join_scans"],
                "stream_compact[record, nccl bucket]":
                    paths["nccl"]["compact_records"],
                "stream_compact[pack, nccl bucket]":
                    paths["nccl"]["pack_matched_builds"],
                "expand_gather[build, nccl bucket]":
                    paths["nccl"]["expand_gather"],
                **{name: paths["tpch"][site]
                   for name, site in TPCH_SITES.items()}}
    # the join sites' launches on the paths of phases 10-12, each path's
    # own run
    site = {"join_scans": "join_scans",
            "stream_compact[record]": "compact_records",
            "stream_compact[pack]": "pack_matched_builds",
            "stream_compact[valid-build pack]": "pack_valid_builds",
            "expand_gather[build]": "expand_gather"}
    by_name = {r["name"]: r for r in [*rows, skew_row, *typed_rows,
                                      *bucket_rows, *tpch_rows]}
    kernels = []
    for name, count in launches.items():
        r = dict(by_name[name], launches=count)
        if name in site:
            r["launches_by_path"] = {p: c[site[name]]
                                     for p, c in paths.items()}
            r["no_launch_reason"] = {"segmented": SEG_REASON,
                                     "hierarchical_segmented": SEG_REASON,
                                     "tuner_sort_fill": SEG_REASON,
                                     "agg": GROUPS_REASON,
                                     "resident_agg": GROUPS_REASON}
        if name == "stream_compact[skew]":
            # the skew site's launches on the paths that run the sidecar
            # (phase 23(c)'s filled program)
            r["launches_by_path"] = {p: c["extract_prefix"]
                                     for p, c in paths.items()
                                     if c.get("extract_prefix")}
            r["no_launch_reason"] = {}
        if name == "join_scans":
            r["c1_ms"], r["c1_bound_ms"] = c1["ms"], c1["bound_ms"]
        kernels.append({k: r[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            *[k for k in r if k.endswith("_ms") and k not in (
                "ms", "plain_ms", "bound_ms", "library_ms")],
            *(["live_passes"] if "live_passes" in r else []),
            *(["merged_positions"] if "merged_positions" in r else []),
            *(["launches_by_path", "no_launch_reason"]
              if "launches_by_path" in r else []))})
    kernels.append(groups_kernel_entry(groups_row, paths))
    kernels.extend(serving_kernel_entries(serving_rows, paths))
    print(f"[done] {time.perf_counter() - t_start:.1f} s; {smi}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(ok, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
