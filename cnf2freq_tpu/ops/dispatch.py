"""The one place that picks each scan stage's implementation.

Every choice is keyed on the JAX backend (``backend()``) and the dtype —
never on an environment variable:

=================  =============================  ========================
backend, dtype     F2 scan layout                 stage implementations
=================  =============================  ========================
``gpu``, float32   feature-leading ``[M, X, R]``  forward-backward sweeps:
                   (ops/scan_v2.py)               a Pallas kernel through
                                                  Triton; emissions,
                                                  posterior statistics and
                                                  turn weights: XLA
otherwise          standard ``[B, M, NS, S]``     XLA throughout (``hmm/``)
=================  =============================  ========================

Without the sweep kernel the standard layout is the faster one, in
float32 and in float64 (Triton refuses the kernel's float64 products).
The marker-blocked scan always uses the feature-leading layout and takes
its sweep implementation from the same table.  The numgen==2 engine runs
the standard layout on every backend.  Tests call the kernel directly
with ``interpret=True``; no production path does.  PERF.md records the
measurements behind each choice.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import numpy as np

# Batch padding quantum of the feature-leading layout: the lane width of
# one block of the sweep kernel (ops/scan_v2.fb_sweeps_v2_triton), so a
# padded batch is a whole number of kernel blocks.
LANE_BLOCK = 32


def backend() -> str:
    return jax.default_backend()


class ScanPlan(NamedTuple):
    layout: str      # "v2" (feature-leading) or "std"
    fb: str          # "triton" or "xla"


def scan_plan(dtype) -> ScanPlan:
    """Stage implementations of the F2 chromosome scan for ``dtype``."""
    if backend() == "gpu" and np.dtype(dtype) == np.float32:
        return ScanPlan(layout="v2", fb="triton")
    return ScanPlan(layout="std", fb="xla")


def pad_lanes(n: int) -> int:
    """Batch size ``n`` padded up to a whole number of lane blocks."""
    return -(-n // LANE_BLOCK) * LANE_BLOCK


def device_memory_bytes():
    """Device memory one process may allocate, or None where the backend
    reports no limit (the CPU)."""
    stats = jax.local_devices()[0].memory_stats()
    if not stats or "bytes_limit" not in stats:
        return None
    return int(stats["bytes_limit"])


def full_f32(fn):
    """Trace ``fn`` with every matrix product at full float32 precision:
    on the GPU a float32 product may otherwise run in TF32, which keeps
    about three decimal digits."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)
    return wrapped
