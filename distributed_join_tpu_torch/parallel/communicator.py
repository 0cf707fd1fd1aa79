"""The Communicator seam: the collectives the join step calls, and
``spmd`` to run a per-rank function over row-sharded inputs.

Port of ``distributed_join_tpu/parallel/communicator.py`` (the ABC at
:51-183 with ``ragged_all_to_all`` and its emulation, ``LocalCommunicator``
at :400, ``make_communicator`` at :423). Backends:

- :class:`LocalCommunicator` — one rank; collectives are identities.
- :class:`EmulatedCommunicator` — n ranks in one process, one thread
  per rank; every collective is a rendezvous of all ranks that
  exchanges the tensors themselves, on whatever device they live. It
  serves the CPU tests and a multi-rank run on one GPU.
- :class:`ProcessGroupCommunicator` — one OS process a rank over a
  ``torch.distributed`` process group (``parallel/bootstrap.py`` forms
  it): NCCL between CUDA devices, one process a card; gloo on the CPU.

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
from distributed_join_tpu_torch.parallel.mesh import Mesh, make_mesh


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

    @abc.abstractmethod
    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise sum over ranks, replicated."""

    def axis_index(self) -> int:
        """The calling rank (0 on a single-rank backend)."""
        return 0

    @abc.abstractmethod
    def spmd(self, fn: Callable, *, sharded_out=None) -> Callable:
        """Run ``fn`` once per rank. Tensor arguments (also inside Tables
        and other dataclasses, dicts, tuples) are row-sharded: rank r
        gets rows [r*c/n, (r+1)*c/n). Outputs are concatenated over
        ranks, except those flagged replicated in ``sharded_out`` (a
        prefix structure of bools), which are taken from rank 0. (A
        process-group backend returns each process its own rank's
        outputs: see :class:`ProcessGroupCommunicator`.)"""

    def ragged_all_to_all(self, operand, output, input_offsets,
                          send_sizes, output_offsets, recv_sizes):
        """Exact-size exchange: peer i receives ``operand[input_offsets[i]
        : + send_sizes[i]]`` (rows), written at ``output_offsets[i]`` of
        its ``output`` buffer. The (n_ranks,) int vectors must be
        consistent across ranks (``recv_sizes[j]`` = what rank j sends
        here). Inside :meth:`spmd`; returns the filled output buffer
        (``output`` itself is not written)."""
        return self._ragged_emulate(operand, output, input_offsets,
                                    send_sizes, output_offsets, recv_sizes)

    def _ragged_emulate(self, operand, output, input_offsets, send_sizes,
                        output_offsets, recv_sizes):
        """The JAX package's exact emulation (JAX :152-176): all-gather
        every operand and offset vector, then fill each sender's window
        by masked copies. Wire-inefficient, bit-identical in semantics;
        no value is read back to the host."""
        n = self.n_ranks
        me = self.axis_index()
        g_op = self.all_gather(operand[None, ...])        # (n, len, ...)
        g_in = self.all_gather(input_offsets[None, :])    # (n, n)
        g_sz = self.all_gather(send_sizes[None, :])
        g_out = self.all_gather(output_offsets[None, :])
        out = output
        idx = torch.arange(output.shape[0], dtype=torch.int64,
                           device=output.device)
        for j in range(n):
            rel = idx - g_out[j, me].to(torch.int64)
            take = (rel >= 0) & (rel < g_sz[j, me])
            src = g_op[j][(g_in[j, me] + rel).clamp(
                0, max(operand.shape[0] - 1, 0))]
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

    def spmd(self, fn, *, sharded_out=None):
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
    """

    name = "emulated"

    def __init__(self, n_ranks: int, timeout_s: float = 600.0):
        if n_ranks < 1:
            raise ValueError("n_ranks must be >= 1")
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

    def all_gather(self, x):
        _, got = self._exchange(x)
        return torch.cat(got)

    def psum(self, x):
        _, got = self._exchange(x)
        return torch.stack(got).sum(0).to(x.dtype)

    def spmd(self, fn, *, sharded_out=None):
        n = self._n

        def run(*args):
            outs: list = [None] * n
            errors: list = [None] * n
            self._barrier.reset()

            def body(r):
                self._local.rank = r
                try:
                    outs[r] = fn(*_map(lambda t: _shard(t, r, n), args))
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


def _to_bytes(x: torch.Tensor) -> torch.Tensor:
    """``x`` (rows, ...) as a contiguous (rows, row bytes) uint8 tensor:
    every backend moves bytes, so every dtype and width crosses the wire
    bit-exact."""
    x = x.contiguous()
    row = math.prod(x.shape[1:])
    return x.reshape(x.shape[0], row).view(torch.uint8)


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

    def __init__(self, mesh: Optional[Mesh] = None):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.name = self.mesh.backend

    @property
    def n_ranks(self) -> int:
        return self.mesh.n_ranks

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def axis_index(self) -> int:
        return self.mesh.rank

    def all_to_all(self, x):
        b = _to_bytes(x)
        out = torch.empty_like(b)
        dist.all_to_all_single(out, b)
        return _from_bytes(out, x)

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

    def ragged_all_to_all(self, operand, output, input_offsets,
                          send_sizes, output_offsets, recv_sizes):
        """``all_to_all_single`` with split sizes: the send windows are
        packed in peer order, and each received window lands at the
        offset its sender chose (the senders' ``output_offsets``, moved
        by one small all-to-all). Reads the size and offset vectors back
        to the host."""
        dst_off = self.all_to_all(output_offsets.to(torch.int64))
        ins, sends, recvs, dsts = (
            v.tolist() for v in (input_offsets, send_sizes, recv_sizes,
                                 dst_off))
        src = _to_bytes(operand)
        packed = torch.cat([src[o:o + s] for o, s in zip(ins, sends)])
        got = src.new_empty((sum(recvs), src.shape[1]))
        dist.all_to_all_single(got, packed, output_split_sizes=recvs,
                               input_split_sizes=sends)
        out = _to_bytes(output).clone()
        at = 0
        for d, s in zip(dsts, recvs):
            out[d:d + s] = got[at:at + s]
            at += s
        return _from_bytes(out, output)

    def spmd(self, fn, *, sharded_out=None):
        n, r = self.n_ranks, self.axis_index()

        def run(*args):
            return fn(*_map(lambda t: _shard(t, r, n), args))

        return run

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
    given, must equal its size. ``ucx``, ``tpu`` and ``n_slices`` > 1
    (the hierarchical mesh) refuse by name."""
    lname = name.lower()
    if n_slices is not None and n_slices > 1:
        raise ValueError(
            f"n_slices={n_slices}: the hierarchical (slice, chip) mesh is "
            "not part of the port; run the flat process group")
    if lname == "local":
        if n_ranks not in (None, 1):
            raise ValueError("the local communicator has one rank")
        return LocalCommunicator()
    if lname == "emulated":
        if not n_ranks:
            raise ValueError("the emulated communicator needs n_ranks")
        return EmulatedCommunicator(n_ranks)
    if lname in ("nccl", "gloo"):
        mesh = make_mesh(n_ranks)
        if mesh.backend != lname:
            raise ValueError(
                f"communicator {name!r} asked for, but the process group "
                f"runs {mesh.backend!r}")
        return ProcessGroupCommunicator(mesh)
    if lname == "ucx":
        raise ValueError("communicator 'ucx': the UCX backend is not part "
                         "of the port; use nccl")
    if lname == "tpu":
        raise ValueError("communicator 'tpu' is the JAX package's; the "
                         "port's counterpart is nccl")
    raise ValueError(f"unknown communicator {name!r}")
