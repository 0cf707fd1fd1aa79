"""Heavy-hitter (skew) handling: BASELINE config 3.

Port of ``distributed_join_tpu/parallel/skew.py``: the PRPD scheme
(partial redistribution, partial duplication) on static shapes. Each
rank counts its probe-side key runs and takes its local top K; the K-slot
candidate lists are all-gathered and aggregated into one replicated
heavy-hitter set. Probe rows with a heavy key skip the shuffle and stay
on their rank; build rows with a heavy key are broadcast to every rank;
each rank joins its heavy probe rows against the broadcast block. Every
row of a key takes exactly one path, so no match is lost or doubled.

Keys may be any int64/int32/float tensor, or uint64 bit patterns as a
``torch.uint64`` view (the join passes its key-tuple hashes so). torch
has no unsigned 64-bit sort, so uint64 keys are mapped to int64 with the
sign bit flipped, where signed order is their unsigned order, and mapped
back on the way out; the all-ones sentinel becomes INT64_MAX there.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from distributed_join_tpu_torch.ops.compact import stream_compact
from distributed_join_tpu_torch.ops.kernel_config import resolve
from distributed_join_tpu_torch.parallel.communicator import Communicator
from distributed_join_tpu_torch.table import Table

_SIGN = -(1 << 63)
# the JAX package's sampling index mix (an odd multiplier)
_MIX = 2654435761


@dataclasses.dataclass(frozen=True)
class HeavyHitters:
    """A fixed-K replicated set of heavy keys. Invalid slots hold the key
    dtype's max sentinel and are masked by ``slot_valid``."""

    keys: torch.Tensor        # (K,) key dtype
    counts: torch.Tensor      # (K,) int64 global counts (sampled tallies
    #                           scaled by ``sample``: estimates)
    slot_valid: torch.Tensor  # (K,) bool


def _ordered(keys: torch.Tensor):
    """``(t, back)``: a tensor whose signed order is the keys' order, and
    the map from it back to the keys' dtype."""
    if keys.dtype == torch.uint64:
        return (keys.view(torch.int64) ^ _SIGN,
                lambda t: (t ^ _SIGN).view(torch.uint64))
    return keys, lambda t: t


def _sentinel(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def _top_k(score: torch.Tensor, k: int):
    """``lax.top_k``: the k largest, ties to the lower index (a stable
    descending sort; ``torch.topk`` promises no tie order)."""
    srt = torch.sort(score, descending=True, stable=True)
    return srt.values[:k], srt.indices[:k]


def _zipf_partial_sum(alpha: float, n: int) -> float:
    """sum_{r=1..n} r^-alpha: exact head, midpoint-integral tail."""
    m = min(n, 1_000_000)
    s = float(np.sum(np.arange(1, m + 1, dtype=np.float64) ** -alpha))
    if n > m:
        if abs(alpha - 1.0) < 1e-9:
            s += math.log((n + 0.5) / (m + 0.5))
        else:
            s += ((m + 0.5) ** (1.0 - alpha)
                  - (n + 0.5) ** (1.0 - alpha)) / (alpha - 1.0)
    return s


def zipf_top_k_mass(alpha: float, n_keys: int, k: int) -> float:
    """Expected fraction of Zipf(``alpha``) draws over ``n_keys`` keys
    that land on the ``k`` most probable keys: the capacity model of the
    config driver's skew auto-policy."""
    if n_keys <= 0 or k <= 0:
        return 0.0
    return (_zipf_partial_sum(alpha, min(k, n_keys))
            / _zipf_partial_sum(alpha, n_keys))


def local_top_keys(keys: torch.Tensor, valid: torch.Tensor, k: int):
    """Per-shard top-``k`` keys by frequency: ``(keys, counts)`` (counts
    int32), padded slots carrying count 0 and the sentinel key. One sort;
    each run's end is a binary search for its key's upper bound, in place
    of the JAX package's reverse cummin (torch's cummin on a long 1-D
    CUDA tensor is slow)."""
    n = keys.shape[0]
    dev = keys.device
    ok, back = _ordered(keys)
    sentinel = _sentinel(ok.dtype)
    k_eff = min(k, n)
    sk = torch.sort(torch.where(valid, ok, torch.full_like(ok, sentinel))
                    ).values
    n_valid = valid.sum(dtype=torch.int32)
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = sk[1:] != sk[:-1]
    nxt = torch.searchsorted(sk, sk, right=True, out_int32=True)
    # valid rows sort before the sentinel block; clamping the run end to
    # n_valid counts only real rows
    run = torch.minimum(nxt, n_valid) - iota
    score = torch.where(first & (iota < n_valid), run,
                        torch.zeros_like(run))
    top_counts, top_idx = _top_k(score, k_eff)
    top_keys = torch.where(top_counts > 0, sk[top_idx],
                           torch.full_like(sk[top_idx], sentinel))
    if k_eff < k:
        pad = k - k_eff
        top_keys = torch.cat([top_keys, torch.full(
            (pad,), sentinel, dtype=ok.dtype, device=dev)])
        top_counts = torch.cat([top_counts, torch.zeros(
            pad, dtype=top_counts.dtype, device=dev)])
    return back(top_keys), top_counts


def global_heavy_hitters(comm: Communicator, keys: torch.Tensor,
                         valid: torch.Tensor, k: int, threshold: int,
                         sample: int = 16) -> HeavyHitters:
    """Replicated global top-``k`` keys with aggregated count >
    ``threshold``. Aggregation is exact over the union of the per-rank
    candidate lists.

    ``sample``: detection runs on a 1/``sample`` subset picked by a
    multiplicative index mix (not a fixed stride, which would miss a
    heavy key living at a period); counts and threshold are compared in
    sampled units (the threshold at least 1) and reported counts scaled
    back. Shards below 64*k*sample rows are not sampled."""
    n = keys.shape[0]
    ok, back = _ordered(keys)
    if sample > 1 and n >= 64 * k * sample:
        m = n // sample
        idx = ((torch.arange(m, dtype=torch.int64, device=keys.device)
                * _MIX) % n).long()
        keys_d, valid_d = ok[idx], valid[idx]
        thr = max(threshold // sample, 1)
    else:
        sample = 1
        keys_d, valid_d, thr = ok, valid, threshold
    lk, lc = local_top_keys(keys_d, valid_d, k)
    gk = comm.all_gather(lk)                      # (n_ranks*k,)
    gc = comm.all_gather(lc)
    nk = gk.shape[0]
    sentinel = _sentinel(ok.dtype)
    eq = gk[:, None] == gk[None, :]
    # int64 sums: a key hot on many ranks can pass 2^31
    tot = torch.where(eq, gc[None, :].to(torch.int64),
                      torch.zeros((), dtype=torch.int64,
                                  device=gk.device)).sum(1)
    iota = torch.arange(nk, device=gk.device)
    dup = (eq & (iota[None, :] < iota[:, None])).any(1)
    real = gk != sentinel
    score = torch.where(real & ~dup, tot, torch.zeros_like(tot))
    top_counts, top_idx = _top_k(score, k)
    slot_valid = top_counts > thr
    hh_keys = torch.where(slot_valid, gk[top_idx],
                          torch.full_like(gk[top_idx], sentinel))
    return HeavyHitters(back(hh_keys), top_counts * sample, slot_valid)


def mark_heavy(keys: torch.Tensor, hh: HeavyHitters) -> torch.Tensor:
    """Row-wise bool: the key is in the HH set, by a binary search of the
    K sorted slot keys (in place of the JAX package's K compare passes).
    Invalid slots hold the sentinel, so a row whose key is the sentinel
    is heavy only if a valid slot holds it too."""
    ok, _ = _ordered(keys)
    hk, _ = _ordered(hh.keys)
    sentinel = _sentinel(ok.dtype)
    sent_ok = (hh.slot_valid & (hk == sentinel)).any()
    slots = torch.sort(hk).values
    at = torch.searchsorted(slots, ok).clamp_(max=slots.shape[0] - 1)
    return (slots[at] == ok) & ((ok != sentinel) | sent_ok)


def extract_prefix(table: Table, sel: torch.Tensor, capacity: int,
                   kernel_config=None):
    """Stable-compact the rows where ``sel`` into a ``capacity``-row
    Table; returns ``(extracted, count, overflow)``. ``capacity`` may
    exceed the table's rows (extra slots are padding).

    The JAX package's branch rule: with the kernel pipeline on and
    ``n >= 2 * capacity``, the selected row indices are packed by the
    compaction kernel (``ops/compact.py``, launched from this call site
    and counted on ``extract_prefix.launches``), then one row gather
    fills the block, so the cost scales with ``capacity``; otherwise a
    stable sort of the selection flag does the same job."""
    n = sel.shape[0]
    cfg = resolve(kernel_config)
    count = sel.sum(dtype=torch.int32)
    lane = torch.arange(capacity, dtype=torch.int32, device=sel.device)
    if cfg.kernel_pipeline(sel.device) and n >= 2 * capacity:
        pos = torch.cumsum(sel.to(torch.int32), 0, dtype=torch.int32) - 1
        iota64 = torch.arange(n, dtype=torch.int64, device=sel.device)
        (packed,) = stream_compact(sel, pos, [iota64], capacity,
                                   launch_counter=extract_prefix)
        # slots past the survivor count are undefined by the kernel's
        # contract: clamp before gathering; `valid` masks them
        idx = packed.clamp(0, n - 1)
    else:
        order = torch.sort((~sel).to(torch.int8), stable=True).indices
        idx = order[torch.clamp(lane, max=n - 1).long()]
    cols = {name: c[idx] for name, c in table.columns.items()}
    valid = (lane < torch.clamp(count, max=capacity)) & (lane < n)
    return Table(cols, valid), count, count > capacity


extract_prefix.launches = 0


def broadcast_heavy_build(comm: Communicator, build: Table,
                          is_hh: torch.Tensor, capacity: int,
                          kernel_config=None):
    """All-gather each rank's HH build rows (``capacity`` slots each)
    into one replicated Table of n_ranks * capacity rows; returns it and
    the replicated overflow flag."""
    local, _, overflow = extract_prefix(build, is_hh & build.valid, capacity,
                                        kernel_config=kernel_config)
    cols = {n: comm.all_gather(c) for n, c in local.columns.items()}
    valid = comm.all_gather(local.valid)
    return Table(cols, valid), comm.psum(overflow.to(torch.int32)) > 0
