"""The Communicator seam: the collectives the join step calls, and
``spmd`` to run a per-rank function over row-sharded inputs.

Port of ``distributed_join_tpu/parallel/communicator.py`` (the ABC at
:51-183 with ``ragged_all_to_all`` and its emulation,
``ppermute_all_to_all`` at :68 and its chain at :208, the (slice, chip)
exchanges ``all_to_all_chip`` and ``all_to_all_slice`` at :118-145 and
``HierarchicalTpuCommunicator`` at :326, ``LocalCommunicator`` at :400,
``make_communicator`` at :423). Backends:

- :class:`LocalCommunicator` — one rank; collectives are identities.
- :class:`EmulatedCommunicator` — n ranks in one process, one thread
  per rank; every collective is a rendezvous of all ranks that
  exchanges the tensors themselves, on whatever device they live. It
  serves the CPU tests and a multi-rank run on one GPU.
- :class:`ProcessGroupCommunicator` — one OS process a rank over a
  ``torch.distributed`` process group (``parallel/bootstrap.py`` forms
  it): NCCL between CUDA devices, one process a card; gloo on the CPU.

The emulated and process-group backends nest their ranks as
``n_slices`` slices of chips when asked (the hierarchical shuffle's
mesh); a flat backend is one slice.

Staging (JAX ``device_put_sharded``): ``local_rows`` names the rows of a
global table that this process holds and stages, and ``spmd(...,
local_inputs=True)`` takes a table of those rows as it is.

Collectives run inside ``spmd``; ``axis_index`` is the calling rank.
"""

from __future__ import annotations

import abc
import dataclasses
import math
import threading
from typing import Callable, Optional

import torch
import torch.distributed as dist

from distributed_join_tpu_torch.parallel.bootstrap import shutdown
from distributed_join_tpu_torch.parallel.mesh import (
    Mesh,
    make_hierarchical_mesh,
    make_mesh,
)
from distributed_join_tpu_torch.telemetry import spans as _spans


class Communicator(abc.ABC):
    """Abstract communication backend."""

    name: str = "abstract"

    @property
    @abc.abstractmethod
    def n_ranks(self) -> int:
        ...

    @abc.abstractmethod
    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """x has shape (n_ranks * m, ...); block i (rows [i*m, (i+1)*m))
        goes to rank i; the result concatenates the blocks received from
        every rank in rank order."""

    @abc.abstractmethod
    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated along dim 0, in rank order."""

    def all_gather_counts(self, x: torch.Tensor) -> torch.Tensor:
        """:meth:`all_gather` of the ragged plan's count rows
        (``shuffle.prefetch_ragged_plans``, ``shuffle.ragged_plan``): a
        seam of its own, where ``faults.FaultInjectingCommunicator`` can
        tell every rank the same lie about the count matrix."""
        return self.all_gather(x)

    @abc.abstractmethod
    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise sum over ranks, replicated."""

    def ppermute_all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """:meth:`all_to_all`'s result by a chain of point-to-point
        steps where the backend has one (``ProcessGroupCommunicator``);
        the default, a plain ``all_to_all``, is correct by definition."""
        return self.all_to_all(x)

    def axis_index(self) -> int:
        """The calling rank (0 on a single-rank backend)."""
        return 0

    # The (slice, chip) split of the hierarchical shuffle (JAX :118-145).
    # A flat backend is one slice: the intra-slice exchange is the global
    # all_to_all and the cross-slice exchange the identity.

    @property
    def n_slices(self) -> int:
        """Slow-tier groups of ranks; 1 = no slow tier."""
        return 1

    @property
    def chips_per_slice(self) -> int:
        """Fast-tier ranks a slice."""
        return self.n_ranks

    def all_to_all_chip(self, x: torch.Tensor) -> torch.Tensor:
        """:meth:`all_to_all` inside this rank's slice: ``x`` has
        ``chips_per_slice`` leading blocks; block j goes to chip j of
        this slice."""
        return self.all_to_all(x)

    def all_to_all_slice(self, x: torch.Tensor) -> torch.Tensor:
        """:meth:`all_to_all` across slices at this rank's chip index:
        ``x`` has ``n_slices`` leading blocks; block t goes to this
        chip's peer on slice t."""
        return x

    # Counters the shuffles keep, read by the drivers (the ranks of an
    # emulated communicator count into one): reads of device values to
    # the host made through host_ints, the data-plane rows and bytes
    # the shuffles hand to the exchange (count_wire; own block included,
    # metadata not), and the hierarchical shuffle's bytes on each tier
    # with what its cross-slice codec saved (count_tiers).
    host_reads: int = 0
    wire_rows: int = 0
    wire_bytes: int = 0
    wire_bytes_ici: int = 0
    wire_bytes_dcn: int = 0
    wire_bytes_saved: int = 0

    def count_wire(self, rows: int, nbytes: int) -> None:
        with _COUNTER_LOCK:
            self.wire_rows += int(rows)
            self.wire_bytes += int(nbytes)

    def count_tiers(self, ici: int, dcn: int, saved: int = 0) -> None:
        with _COUNTER_LOCK:
            self.wire_bytes_ici += int(ici)
            self.wire_bytes_dcn += int(dcn)
            self.wire_bytes_saved += int(saved)

    def counters(self) -> dict:
        return {"host_reads": self.host_reads, "wire_rows": self.wire_rows,
                "wire_bytes": self.wire_bytes,
                "wire_bytes_ici": self.wire_bytes_ici,
                "wire_bytes_dcn": self.wire_bytes_dcn,
                "wire_bytes_saved": self.wire_bytes_saved}

    def host_ints(self, *vectors) -> list:
        """Small integer tensors read back to the host as (nested)
        lists, in one read (one device synchronisation), counted in
        ``host_reads``. A host sequence passes through as a list."""
        out = [None if isinstance(v, torch.Tensor) else list(v)
               for v in vectors]
        dev = [v for v in vectors if isinstance(v, torch.Tensor)]
        if dev:
            with _COUNTER_LOCK:
                self.host_reads += 1
            flat = torch.cat([v.reshape(-1).to(torch.int64) for v in dev])
            vals = iter(flat.tolist())
            for i, v in enumerate(vectors):
                if out[i] is None:
                    got = [next(vals) for _ in range(v.numel())]
                    out[i] = _reshape_list(got, tuple(v.shape))
        return out

    @abc.abstractmethod
    def spmd(self, fn: Callable, *, sharded_out=None,
             local_inputs: bool = False) -> Callable:
        """Run ``fn`` once per rank. Tensor arguments (also inside Tables
        and other dataclasses, dicts, tuples) are row-sharded: rank r
        gets rows [r*c/n, (r+1)*c/n). Outputs are concatenated over
        ranks, except those flagged replicated in ``sharded_out`` (a
        prefix structure of bools), which are taken from rank 0. (A
        process-group backend returns each process its own rank's
        outputs: see :class:`ProcessGroupCommunicator`.)
        ``local_inputs``: the arguments hold only this process's rows,
        :meth:`local_rows` of the global capacity; one process holds
        every rank's rows, so only a process-group backend reads the
        flag. A tuple of flags, one a positional argument, marks some
        arguments local and shards the others (a resident table's shard
        beside a global probe)."""

    def local_rows(self, capacity: int) -> range:
        """The rows of a table of ``capacity`` global rows that this
        process holds, and so stages onto its device (the counterpart of
        JAX ``Communicator.device_put_sharded``; the out-of-core batch
        loop pads and copies only these): every row where one process
        runs every rank."""
        return range(capacity)

    def ragged_all_to_all(self, operand, output, input_offsets,
                          send_sizes, output_offsets, recv_sizes,
                          recv_offsets=None):
        """Exact-size exchange: peer i receives ``operand[input_offsets[i]
        : + send_sizes[i]]`` (rows), written at ``output_offsets[i]`` of
        its ``output`` buffer. The (n_ranks,) int vectors must be
        consistent across ranks (``recv_sizes[j]`` = what rank j sends
        here); each is a tensor or a host sequence. ``recv_offsets``,
        where the caller knows it (a host sequence), is where each
        sender's window lands in this rank's ``output``: the senders'
        ``output_offsets`` entries for this rank, which a backend would
        otherwise exchange. Inside :meth:`spmd`; returns the filled
        output buffer (``output`` itself is not written)."""
        dev = operand.device
        vecs = [v if isinstance(v, torch.Tensor)
                else torch.tensor(list(v), dtype=torch.int64, device=dev)
                for v in (input_offsets, send_sizes, output_offsets)]
        return self._ragged_emulate(output,
                                    self._ragged_peers(operand, *vecs))

    def _ragged_peers(self, operand, input_offsets, send_sizes,
                      output_offsets) -> list:
        """Every rank's (operand, input_offsets, send_sizes,
        output_offsets), in rank order, by all-gathers (the operands
        must share a shape)."""
        g_op = self.all_gather(operand[None, ...])        # (n, len, ...)
        g = [self.all_gather(v[None, :]) for v in (
            input_offsets, send_sizes, output_offsets)]   # (n, n) each
        return [(g_op[j], *(v[j] for v in g)) for j in range(self.n_ranks)]

    def _ragged_emulate(self, output, peers):
        """The JAX package's exact emulation (JAX :152-176): fill each
        sender's window from its operand by masked copies.
        Wire-inefficient, bit-identical in semantics; no value is read
        back to the host."""
        me = self.axis_index()
        out = output
        idx = torch.arange(output.shape[0], dtype=torch.int64,
                           device=output.device)
        for op, ins, sizes, offs in peers:
            if op.shape[0] == 0:
                continue  # a sender with no rows sends none
            rel = idx - offs[me].to(torch.int64)
            take = (rel >= 0) & (rel < sizes[me])
            src = op[(ins[me] + rel).clamp(0, op.shape[0] - 1)]
            mask = take.reshape((-1,) + (1,) * (out.ndim - 1))
            out = torch.where(mask, src, out)
        return out

    def barrier(self) -> None:
        """Wait for every process of the job (no-op in one process)."""

    def host_max(self, value: float) -> float:
        """The largest of every process's ``value`` (a host float, such
        as a rank's elapsed time); itself in one process."""
        return value

    def finalize(self) -> None:
        """Release the transport (reference parity,
        ``Communicator::finalize``); no-op in one process."""


# -- structure helpers for spmd ----------------------------------------


_COUNTER_LOCK = threading.Lock()


def _reshape_list(flat: list, shape: tuple):
    """A flat list as nested lists of ``shape``."""
    if len(shape) <= 1:
        return flat
    step = len(flat) // shape[0]
    return [_reshape_list(flat[i * step:(i + 1) * step], shape[1:])
            for i in range(shape[0])]


def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: _map(fn, getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def _concat(outs):
    """Concatenate per-rank outputs leaf by leaf along dim 0."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(outs)
    if dataclasses.is_dataclass(first):
        return type(first)(**{
            f.name: _concat([getattr(o, f.name) for o in outs])
            for f in dataclasses.fields(first)})
    if isinstance(first, dict):
        return {k: _concat([o[k] for o in outs]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_concat(list(z)) for z in zip(*outs))
    return first


def _shard(t: torch.Tensor, r: int, n: int) -> torch.Tensor:
    """Rank ``r``'s rows of a tensor row-sharded over ``n`` ranks."""
    if t.shape[0] % n:
        raise ValueError(f"row count {t.shape[0]} is not divisible by "
                         f"{n} ranks")
    m = t.shape[0] // n
    return t[r * m:(r + 1) * m]


def _combine(outs, spec):
    if spec is None or spec is False:
        return _concat(outs)
    if spec is True:
        return outs[0]
    first = outs[0]
    if dataclasses.is_dataclass(spec):
        return type(first)(**{
            f.name: _combine([getattr(o, f.name) for o in outs],
                             getattr(spec, f.name))
            for f in dataclasses.fields(first)})
    if isinstance(spec, (tuple, list)):
        return type(first)(_combine([o[i] for o in outs], s)
                           for i, s in enumerate(spec))
    raise TypeError(f"unsupported sharded_out spec {spec!r}")


class LocalCommunicator(Communicator):
    """Single rank: collectives are identities."""

    name = "local"

    @property
    def n_ranks(self) -> int:
        return 1

    def all_to_all(self, x):
        return x

    def all_gather(self, x):
        return x

    def psum(self, x):
        return x

    def spmd(self, fn, *, sharded_out=None, local_inputs=False):
        return fn


class EmulatedCommunicator(Communicator):
    """``n_ranks`` ranks in one process, one thread per rank.

    A collective deposits the calling rank's tensor in its slot, waits
    for every rank, reads the slots it needs, and waits again before
    the slots are reused. Tensors are exchanged as they are, on their
    own device: on one GPU every rank's kernels run on the same stream,
    so stream order covers the hand-over. A failing rank breaks the
    barrier, so the others raise instead of waiting forever; ``spmd``
    re-raises the first rank's exception.

    Telemetry: every rank thread takes over the caller's span stack, and
    every rank but 0 is muted (``telemetry/spans.py``), so one call of a
    step records its spans once, on rank 0, under the caller's path.

    ``n_slices`` > 1 nests the ranks as ``(slice, chip)``
    (``mesh.make_hierarchical_mesh``), as the JAX package's CPU mesh
    fakes a multi-slice topology: ``all_to_all_chip`` and
    ``all_to_all_slice`` exchange among a rank's slice and among its
    chip's peers.
    """

    name = "emulated"

    def __init__(self, n_ranks: int, timeout_s: float = 600.0,
                 n_slices: int = 1):
        if n_ranks < 1:
            raise ValueError("n_ranks must be >= 1")
        self.hier = make_hierarchical_mesh(n_slices, n_ranks,
                                           process_group=False)
        self._n = n_ranks
        self._timeout = timeout_s
        self._local = threading.local()
        self._slots: list = [None] * n_ranks
        self._barrier = threading.Barrier(n_ranks, timeout=timeout_s)

    @property
    def n_ranks(self) -> int:
        return self._n

    def axis_index(self) -> int:
        rank = getattr(self._local, "rank", None)
        if rank is None:
            raise RuntimeError("collectives run inside spmd()")
        return rank

    def _exchange(self, x):
        me = self.axis_index()
        self._slots[me] = x
        self._barrier.wait()
        got = list(self._slots)
        self._barrier.wait()
        return me, got

    def all_to_all(self, x):
        me, got = self._exchange(x)
        return torch.cat([g.chunk(self._n)[me] for g in got])

    @property
    def n_slices(self) -> int:
        return self.hier.n_slices

    @property
    def chips_per_slice(self) -> int:
        return self.hier.chips_per_slice

    def all_to_all_chip(self, x):
        me, got = self._exchange(x)
        t, j = self.hier.coords(me)
        c = self.chips_per_slice
        return torch.cat([got[r].chunk(c)[j]
                          for r in self.hier.chip_group(t)])

    def all_to_all_slice(self, x):
        me, got = self._exchange(x)
        t, j = self.hier.coords(me)
        return torch.cat([got[r].chunk(self.n_slices)[t]
                          for r in self.hier.slice_group(j)])

    def _ragged_peers(self, operand, input_offsets, send_sizes,
                      output_offsets) -> list:
        # the slots take the ranks' operands as they are: no common shape
        _, got = self._exchange((operand, input_offsets, send_sizes,
                                 output_offsets))
        return got

    def all_gather(self, x):
        _, got = self._exchange(x)
        return torch.cat(got)

    def psum(self, x):
        _, got = self._exchange(x)
        return torch.stack(got).sum(0).to(x.dtype)

    def spmd(self, fn, *, sharded_out=None, local_inputs=False):
        n = self._n

        def run(*args):
            outs: list = [None] * n
            errors: list = [None] * n
            self._barrier.reset()
            caller = _spans.thread_context()

            def body(r):
                self._local.rank = r
                try:
                    with _spans.adopted(caller, mute=r != 0):
                        outs[r] = fn(*_map(lambda t: _shard(t, r, n),
                                           args))
                except BaseException as exc:  # noqa: BLE001 — re-raised below
                    errors[r] = exc
                    self._barrier.abort()
                finally:
                    self._local.rank = None

            threads = [threading.Thread(target=body, args=(r,),
                                        name=f"rank{r}")
                       for r in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(self._timeout)
            if any(t.is_alive() for t in threads):
                self._barrier.abort()
                raise TimeoutError("an emulated rank did not finish")
            # the first real failure, not the broken barriers it caused
            real = [e for e in errors
                    if e is not None
                    and not isinstance(e, threading.BrokenBarrierError)]
            if real or any(errors):
                raise (real or [e for e in errors if e])[0]
            return _combine(outs, sharded_out)

        return run



# Sums the backends cannot take in the tensor's own dtype (gloo has no
# unsigned type wider than a byte and no int16; NCCL no int16 and no
# bool sum): (wire dtype, by bit view or by a widening cast).
_SUM_WIRE = {
    torch.uint64: (torch.int64, "view"),
    torch.uint32: (torch.int32, "view"),
    torch.uint16: (torch.int32, "cast"),
    torch.int16: (torch.int32, "cast"),
    torch.bool: (torch.int32, "cast"),
}


def _window(rows: torch.Tensor, start: int, size: int) -> torch.Tensor:
    """``rows[start:start + size]``, zero-filled where it passes the end:
    only a corrupted plan asks for such a window (the emulation's clamped
    reads send some row there too), and the exchange keeps its sizes."""
    got = rows[start:start + size]
    if got.shape[0] == size:
        return got
    return torch.cat([got, got.new_zeros((size - got.shape[0],)
                                         + tuple(got.shape[1:]))])


def _to_bytes(x: torch.Tensor) -> torch.Tensor:
    """``x`` (rows, ...) as a contiguous (rows, row bytes) uint8 tensor:
    every backend moves bytes, so every dtype and width crosses the wire
    bit-exact. Viewed through one flat dimension: a contiguous tensor
    may carry any stride on a dimension of size 1 (a (2, 1) block of a
    2 x 1 slice mesh), which a byte view of the last dimension refuses."""
    x = x.contiguous()
    row = math.prod(x.shape[1:]) * x.element_size()
    return x.reshape(-1).view(torch.uint8).reshape(x.shape[0], row)


def _from_bytes(b: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`_to_bytes` for rows shaped like ``like``'s."""
    return b.view(like.dtype).reshape((b.shape[0],) + tuple(like.shape[1:]))


class ProcessGroupCommunicator(Communicator):
    """One OS process a rank over the ``torch.distributed`` process group
    (``parallel/bootstrap.py`` forms it; ``parallel/mesh.py`` maps rank
    to device). ``name`` is the backend: ``nccl`` when the ranks' tensors
    live on CUDA devices, one process a card; ``gloo`` on the CPU.

    ``spmd`` follows the JAX package's multi-controller contract: every
    process passes the same *global* tables (made deterministically from
    a seed), and ``fn`` gets its own rank's rows. A sharded output comes
    back as this rank's part, with no gather; a replicated output comes
    back as it is, equal on every rank (after a ``psum``), so a host
    decision on it is the same on every rank.

    Moves (``all_to_all``, ``all_gather``, ``ragged_all_to_all``) carry
    each row's bytes, so every dtype and 2-D column crosses bit-exact;
    ``psum`` sums in the tensor's dtype, through a same-width signed view
    or a widening cast where the backend lacks the dtype. Every
    collective returns a new tensor and leaves its argument as it was.
    """

    def __init__(self, mesh: Optional[Mesh] = None, n_slices: int = 1):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.name = self.mesh.backend
        self.hier = make_hierarchical_mesh(n_slices, self.mesh.n_ranks)
        self._chip_group = self._slice_group = None
        if n_slices > 1:
            # every rank creates every group, in the same order
            chip = [dist.new_group(self.hier.chip_group(t))
                    for t in range(self.hier.n_slices)]
            peers = [dist.new_group(self.hier.slice_group(j))
                     for j in range(self.hier.chips_per_slice)]
            t, j = self.hier.coords(self.mesh.rank)
            self._chip_group, self._slice_group = chip[t], peers[j]

    @property
    def n_ranks(self) -> int:
        return self.mesh.n_ranks

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def axis_index(self) -> int:
        return self.mesh.rank

    def all_to_all(self, x, group=None):
        b = _to_bytes(x)
        out = torch.empty_like(b)
        dist.all_to_all_single(out, b, group=group)
        return _from_bytes(out, x)

    @property
    def n_slices(self) -> int:
        return self.hier.n_slices

    @property
    def chips_per_slice(self) -> int:
        return self.hier.chips_per_slice

    def all_to_all_chip(self, x):
        """The exchange among this rank's slice, over its subgroup."""
        if self._chip_group is None:
            return self.all_to_all(x)
        return self.all_to_all(x, group=self._chip_group)

    def all_to_all_slice(self, x):
        """The exchange among this chip's peers on every slice, over
        its subgroup."""
        if self._slice_group is None:
            return x
        return self.all_to_all(x, group=self._slice_group)

    def all_gather(self, x):
        b = _to_bytes(x)
        out = b.new_empty((self.n_ranks * b.shape[0], b.shape[1]))
        dist.all_gather_into_tensor(out, b)
        return _from_bytes(out, x)

    def psum(self, x):
        wire, how = _SUM_WIRE.get(x.dtype, (x.dtype, "cast"))
        y = x.view(wire).clone() if how == "view" else x.to(wire, copy=True)
        dist.all_reduce(y)
        return y.view(x.dtype) if how == "view" else y.to(x.dtype)

    def ppermute_all_to_all(self, x):
        """:meth:`all_to_all` as a chain of n - 1 point-to-point steps
        (the JAX package's collective-permute chain, JAX :208-241): at
        step d this rank sends block ``(r + d) % n`` to rank ``(r + d) %
        n`` and receives rank ``(r - d) % n``'s block, one send and one
        receive a step through ``batch_isend_irecv``; its own block is a
        local copy. The bytes cross as ``all_to_all``'s do, and the
        result is the same, bit for bit. (Under NCCL the first step
        between a pair of ranks sets up their channel: warm up before
        timing.)"""
        n, r = self.n_ranks, self.axis_index()
        b = _to_bytes(x)
        m = b.shape[0] // n
        out = torch.empty_like(b)
        out[r * m:(r + 1) * m] = b[r * m:(r + 1) * m]
        for d in range(1, n):
            dst, src = (r + d) % n, (r - d) % n
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, b[dst * m:(dst + 1) * m], dst),
                dist.P2POp(dist.irecv, out[src * m:(src + 1) * m], src)])
            for q in reqs:
                q.wait()
        return _from_bytes(out, x)

    def ragged_all_to_all(self, operand, output, input_offsets,
                          send_sizes, output_offsets, recv_sizes,
                          recv_offsets=None):
        """``all_to_all_single`` with split sizes: the send windows are
        packed in peer order (one slice when they are contiguous), and
        each received window lands at the offset its sender chose. The
        size and offset vectors are read to the host in one read unless
        they are host sequences already; without ``recv_offsets`` the
        senders' ``output_offsets`` move by one small all-to-all first."""
        if recv_offsets is None:
            recv_offsets = self.all_to_all(
                torch.as_tensor(output_offsets, device=operand.device)
                .to(torch.int64))
        ins, sends, recvs, dsts = self.host_ints(
            input_offsets, send_sizes, recv_sizes, recv_offsets)
        src = _to_bytes(operand)
        if all(ins[i + 1] == ins[i] + sends[i] for i in range(len(ins) - 1)):
            packed = _window(src, ins[0], sum(sends))
        else:
            packed = torch.cat([_window(src, o, s)
                                for o, s in zip(ins, sends)])
        out = _to_bytes(output).clone()
        total = sum(recvs)
        if all(dsts[j] == sum(recvs[:j]) for j in range(len(dsts))):
            # the windows tile a prefix of the output: receive in place
            dist.all_to_all_single(out[:total], packed,
                                   output_split_sizes=recvs,
                                   input_split_sizes=sends)
            return _from_bytes(out, output)
        got = src.new_empty((total, src.shape[1]))
        dist.all_to_all_single(got, packed, output_split_sizes=recvs,
                               input_split_sizes=sends)
        at = 0
        for d, s in zip(dsts, recvs):
            if s:
                out[d:d + s] = got[at:at + s]
            at += s
        return _from_bytes(out, output)

    def spmd(self, fn, *, sharded_out=None, local_inputs=False):
        n, r = self.n_ranks, self.axis_index()
        if local_inputs is True:
            return fn

        def run(*args):
            local = local_inputs or (False,) * len(args)
            return fn(*(a if mine else _map(lambda t: _shard(t, r, n), a)
                        for a, mine in zip(args, local)))

        return run

    def local_rows(self, capacity: int) -> range:
        """This rank's rows ``[r*c/n, (r+1)*c/n)``."""
        n, r = self.n_ranks, self.axis_index()
        if capacity % n:
            raise ValueError(f"row count {capacity} is not divisible by "
                             f"{n} ranks")
        m = capacity // n
        return range(r * m, (r + 1) * m)

    def barrier(self) -> None:
        if self.name == "nccl":
            dist.barrier(device_ids=[self.device.index])
            torch.cuda.synchronize(self.device)
        else:
            dist.barrier()

    def host_max(self, value: float) -> float:
        t = torch.tensor([value], dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t[0])

    def finalize(self) -> None:
        shutdown()


def make_communicator(name: str, n_ranks: Optional[int] = None,
                      n_slices: Optional[int] = None) -> Communicator:
    """Factory keyed by the drivers' ``--communicator`` flag.

    ``local`` (one rank) and ``emulated`` (``n_ranks`` threads in one
    process) need no process group. ``nccl`` (the reference's own flag;
    the port's counterpart of the JAX package's ``tpu`` backend) and
    ``gloo`` run over the process group that ``parallel/bootstrap.py``
    formed, whose backend must be the one named; ``n_ranks``, where
    given, must equal its size. ``n_slices`` > 1 (the drivers'
    ``--slices``) nests the ranks as the hierarchical (slice, chip) mesh
    (``emulated``, ``nccl`` and ``gloo``); 1 or None keeps the flat
    one. ``ucx`` and ``tpu`` refuse by name, and so does ``local`` with
    more than one slice."""
    lname = name.lower()
    slices = n_slices or 1
    if lname == "local":
        if slices > 1:
            raise ValueError(
                "the local (1-rank) communicator has no hierarchical "
                "(multi-slice) topology; --slices needs emulated, nccl "
                "or gloo")
        if n_ranks not in (None, 1):
            raise ValueError("the local communicator has one rank")
        return LocalCommunicator()
    if lname == "emulated":
        if not n_ranks:
            raise ValueError("the emulated communicator needs n_ranks")
        return EmulatedCommunicator(n_ranks, n_slices=slices)
    if lname in ("nccl", "gloo"):
        mesh = make_mesh(n_ranks)
        if mesh.backend != lname:
            raise ValueError(
                f"communicator {name!r} asked for, but the process group "
                f"runs {mesh.backend!r}")
        return ProcessGroupCommunicator(mesh, n_slices=slices)
    if lname == "ucx":
        raise ValueError("communicator 'ucx': the UCX backend is not part "
                         "of the port; use nccl")
    if lname == "tpu":
        raise ValueError("communicator 'tpu' is the JAX package's; the "
                         "port's counterpart is nccl")
    raise ValueError(f"unknown communicator {name!r}")
