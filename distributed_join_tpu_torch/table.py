"""Fixed-capacity table: equal-length columns plus a validity mask.

The port of ``distributed_join_tpu/table.py``. Capacities stay static
because the join's output block and the shuffle's padded blocks are
sized ahead of the data, exactly as in the JAX package; ``valid`` marks
the real rows among them.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from distributed_join_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Table:
    """A fixed-capacity columnar table.

    columns: name -> 1-D tensor; all share the row count (the capacity).
    valid:   bool tensor of shape (capacity,); ``valid[i]`` marks row i
             as a real row rather than padding.
    """

    columns: Mapping[str, torch.Tensor]
    valid: torch.Tensor

    def __post_init__(self):
        if not self.columns:
            raise ValueError("Table needs at least one column")
        shapes = {name: tuple(c.shape) for name, c in self.columns.items()}
        if any(len(s) < 1 for s in shapes.values()):
            raise ValueError(f"every column needs a row dim, got {shapes}")
        if len({s[0] for s in shapes.values()}) != 1:
            raise ValueError(f"columns must share a row count, got {shapes}")
        cap = next(iter(shapes.values()))[0]
        if tuple(self.valid.shape) != (cap,) or self.valid.dtype != torch.bool:
            raise ValueError(
                f"valid must be bool of shape ({cap},), got "
                f"{self.valid.dtype} {tuple(self.valid.shape)}")

    @property
    def capacity(self) -> int:
        return next(iter(self.columns.values())).shape[0]

    @property
    def column_names(self):
        return list(self.columns)

    @property
    def device(self) -> torch.device:
        return self.valid.device

    def num_valid(self) -> torch.Tensor:
        """Count of real rows, a device scalar (JAX ``table.py:52``)."""
        return self.valid.sum(dtype=torch.int64)

    def select(self, names) -> "Table":
        """The columns ``names``, in that order (JAX ``table.py:92``)."""
        return Table({n: self.columns[n] for n in names}, self.valid)

    def to_host(self) -> dict:
        """The valid rows as numpy columns, in column order: what the JAX
        package's ``to_pandas`` gives, without pandas (the host oracles'
        frames)."""
        valid = self.valid
        return {n: c[valid].cpu().numpy() for n, c in self.columns.items()}

    def rename(self, mapping: Mapping[str, str]) -> "Table":
        """Rename columns; unlisted names pass through (JAX
        ``table.py:95``)."""
        return Table({mapping.get(n, n): c for n, c in self.columns.items()},
                     self.valid)

    @staticmethod
    def from_dense(columns: Mapping[str, torch.Tensor]) -> "Table":
        """All rows valid."""
        first = next(iter(columns.values()))
        return Table(dict(columns),
                     torch.ones(first.shape[0], dtype=torch.bool,
                                device=first.device))

    @staticmethod
    def from_numpy(columns: Mapping[str, np.ndarray], valid: np.ndarray,
                   device=None) -> "Table":
        """Copy numpy columns onto ``device`` (default: the GPU). This is
        how tables cross from the JAX package into the port: both sides
        speak numpy. Unsigned 64-bit columns travel as int64 bit
        patterns (torch has no general uint64 arithmetic)."""
        dev = resolve_device(device)

        def _t(a):
            a = np.ascontiguousarray(a)
            if a.dtype == np.uint64:
                a = a.view(np.int64)
            return torch.from_numpy(a.copy()).to(dev)

        return Table({n: _t(c) for n, c in columns.items()},
                     _t(np.asarray(valid, dtype=bool)))

    def to_numpy(self):
        """``(columns, valid)`` as numpy arrays on the host."""
        return ({n: c.cpu().numpy() for n, c in self.columns.items()},
                self.valid.cpu().numpy())

    def pad_to(self, capacity: int) -> "Table":
        """Grow to ``capacity`` rows with invalid zero padding."""
        cap = self.capacity
        if capacity == cap:
            return self
        if capacity < cap:
            raise ValueError(f"pad_to({capacity}) below capacity {cap}")
        extra = capacity - cap
        cols = {
            n: torch.cat([c, c.new_zeros((extra,) + tuple(c.shape[1:]))])
            for n, c in self.columns.items()
        }
        return Table(cols, torch.cat([self.valid,
                                      self.valid.new_zeros(extra)]))
