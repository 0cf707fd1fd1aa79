"""The bound arithmetic of ``chip_smoke.py`` (``HBM_BYTES_PER_S``,
``SCALAR_OPS_PER_S``, ``bound_ms``), frozen from commit 5f4d2a6.

The least time one NVIDIA H100 SXM could take for a kernel's work: the
larger of its bytes over the HBM's bandwidth and its scalar operations
over the float32 rate outside the tensor cores (NVIDIA's data sheet, at
the 700 W limit).
"""

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
SCALAR_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores


def bound_ms(nbytes: float, ops: float) -> tuple:
    """``(ms, "bytes" | "operations")``: the bound and what sets it."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / SCALAR_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")
