"""Kernel-path configuration for the join core: the one dispatch
authority.

Each kernel wrapper (ops/scan.py, ops/compact.py, ops/expand.py) launches
its CUDA kernel for CUDA tensors and runs its plain twin for CPU tensors.
This object decides the level above: which formulation of the local join
runs.

- ``expand="auto"``: the kernel pipeline on CUDA tensors, the plain
  formulation on CPU tensors.
- ``expand="kernel"``: the kernel pipeline on any device (on the CPU
  every stage then runs its wrapper's plain twin — the pipeline's
  structure, tested without a card).
- ``expand="plain"``: the plain formulation everywhere (the join's
  reference twin).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

EXPAND_MODES = ("auto", "kernel", "plain")


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    expand: str = "auto"

    def __post_init__(self):
        if self.expand not in EXPAND_MODES:
            raise ValueError(
                f"expand={self.expand!r}: expected one of {EXPAND_MODES}")

    def kernel_pipeline(self, device: torch.device) -> bool:
        if self.expand == "plain":
            return False
        return self.expand == "kernel" or device.type == "cuda"


def resolve(kernel_config: Optional[KernelConfig]) -> KernelConfig:
    return KernelConfig() if kernel_config is None else kernel_config
