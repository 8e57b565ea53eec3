"""Device-mesh scaling.

The reference's multi-core story is OpenMP-over-individuals with
threadprivate scratch (cnF2freq.cpp:5294, 403-408) and a vestigial,
non-compiling Boost.MPI path (cnF2freq.cpp:58-60).  Here scaling is one
mechanism at every size: a ``jax.sharding.Mesh`` with the analysis units
(individuals) on a ``data`` axis and a ``state`` axis available for
state-space model parallelism; tensors are placed with NamedSharding and
XLA inserts the collectives.  The mesh assumes no device topology: on
GPUs joined all to all (NVLink) every device reaches every other at the
same rate.

Accumulator merges across shards (the reference's per-marker OpenMP locks
and MPI reduce, cnF2freq.cpp:5265-5270, 6245-6255) disappear: the
per-focal statistics come back sharded over ``data`` and the host (or a
psum in the multi-host path) folds them per target individual.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..hmm.family import FamilyBatch


def make_mesh(n_devices: Optional[int] = None, data: Optional[int] = None,
              state: int = 1) -> Mesh:
    devs = np.asarray(jax.devices())
    if n_devices is not None:
        devs = devs[:n_devices]
    n = devs.size
    if data is None:
        data = n // state
    assert data * state == n, (data, state, n)
    return Mesh(devs.reshape(data, state), ("data", "state"))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Analysis units ride the data axis; everything else is replicated."""
    return NamedSharding(mesh, P("data"))


def pad_batch(fb: FamilyBatch, multiple: int) -> FamilyBatch:
    """Pad the B axis so it divides the data-axis size; padded units are
    vacant families (exists=False) whose statistics are all zero."""
    B = fb.num_units
    pad = (-B) % multiple
    if pad == 0:
        return fb

    def padb(x):
        widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return np.pad(np.asarray(x), widths)

    out = fb.map(padb)
    # keep padded rows inert: no shifts allowed except 0, no paths
    out.shiftignore[B:] = 0
    out.flag2ignore[B:] = 0
    return out


def pad_markers(fb: FamilyBatch, m_target: int) -> FamilyBatch:
    """Pad the marker axis to m_target with inert trailing markers
    (all-unknown genotypes, zero error, neutral phase weight) — the
    tensor form of the reference's mandatory trailing dummy marker
    (demo.sh:22-23).  With zero inter-marker distance the transition is
    the identity and the padded emissions are state-constant, so real
    markers' posteriors are unchanged; callers slice results back to
    the real length."""
    M = fb.num_markers
    pad = m_target - M
    if pad <= 0:
        return fb
    import dataclasses

    def padm(x, val):
        widths = [(0, 0), (0, 0), (0, pad)] + [(0, 0)] * (x.ndim - 3)
        return np.pad(np.asarray(x), widths, constant_values=val)

    relh = fb.relh
    if relh is not None:
        relh = np.pad(np.asarray(relh), [(0, 0), (0, pad)],
                      constant_values=0.5)
    return dataclasses.replace(
        fb, md=padm(fb.md, 0), ms=padm(fb.ms, 0.0), hw=padm(fb.hw, 0.5),
        relh=relh)


def shard_batch(fb: FamilyBatch, mesh: Mesh) -> FamilyBatch:
    sh = batch_sharding(mesh)
    return fb.map(lambda x: jax.device_put(jnp.asarray(x), sh))


def replicate(x, mesh: Mesh):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, P()))
