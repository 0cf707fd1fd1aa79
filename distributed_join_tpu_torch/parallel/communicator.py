"""The Communicator seam: the collectives the join step calls, and
``spmd`` to run a per-rank function over row-sharded inputs.

Port of ``distributed_join_tpu/parallel/communicator.py`` (the ABC at
:51, ``LocalCommunicator`` at :400). Backends:

- :class:`LocalCommunicator` — one rank; collectives are identities.
- :class:`EmulatedCommunicator` — n ranks in one process, one thread
  per rank; every collective is a rendezvous of all ranks that
  exchanges the tensors themselves, on whatever device they live. It
  serves the CPU tests and a multi-rank run on one GPU. (An NCCL
  backend over ``torch.distributed`` is later work.)

Collectives run inside ``spmd``; ``axis_index`` is the calling rank.
"""

from __future__ import annotations

import abc
import dataclasses
import threading
from typing import Callable

import torch


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
        prefix structure of bools), which are taken from rank 0."""


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

        def shard(t, r):
            if t.shape[0] % n:
                raise ValueError(
                    f"row count {t.shape[0]} is not divisible by "
                    f"{n} ranks")
            m = t.shape[0] // n
            return t[r * m:(r + 1) * m]

        def run(*args):
            outs: list = [None] * n
            errors: list = [None] * n
            self._barrier.reset()

            def body(r):
                self._local.rank = r
                try:
                    outs[r] = fn(*_map(lambda t: shard(t, r), args))
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

