"""Multi-process execution.

The reference's only multi-node story is an ifdef'd-out Boost.MPI loop —
rank-0 broadcast of parameters, elementwise reduce of the accumulators,
round-robin individual assignment (cnF2freq.cpp:5197-5242, 6245-6255);
it does not even compile at HEAD.  Here it is the standard JAX
multi-controller model: every process runs the same Driver program,
`jax.distributed` wires the processes into one runtime, the mesh spans
every device, and the psum in
``parallel.collective.make_sharded_scan_merged`` rides the interconnect.
Host-side stages (flip optimisation, capped-GD updates) consume the
replicated merged accumulators, so every process computes identical
updates deterministically — no rank-0 special casing and no parameter
broadcast is needed.

Typical run, one process per host::

    from cnf2freq_tpu.parallel.multihost import init_distributed, pod_mesh
    init_distributed(coordinator="host0:1234", num_processes=n,
                     process_id=i)
    drv = Driver(ped, dtype=np.float32, mesh=pod_mesh())
    drv.preprocess()
    drv.run(iterations)
    if jax.process_index() == 0:
        ...write outputs...

Driver.batch_size="auto" caps each device's chunk by the device's own
memory (Driver._memory_budget), not the cluster's total.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

from .mesh import make_mesh


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Initialise the JAX multi-controller runtime.

    ``coordinator`` (host:port; default $COORDINATOR_ADDRESS),
    ``num_processes`` and ``process_id`` are passed to
    ``jax.distributed.initialize``.  A no-op when the process group is
    already up or when no coordinator is configured (single process)."""
    # must not query the backend here (jax.process_count() would
    # initialise XLA and make jax.distributed.initialize impossible);
    # inspect the distributed client state directly
    try:
        from jax._src import distributed as _dist
        if getattr(_dist.global_state, "client", None) is not None:
            return
    except Exception:
        pass
    if coordinator is None and "COORDINATOR_ADDRESS" in os.environ:
        coordinator = os.environ["COORDINATOR_ADDRESS"]
    if coordinator is None:
        return
    try:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except RuntimeError as e:
        # tolerate ONLY double initialisation (e.g. a launcher wrapper
        # beat us to it); anything else — unreachable coordinator, rank
        # mismatch — must not silently degrade to single-host
        if "already" in str(e).lower():
            return
        raise


def pod_mesh(state: int = 1) -> Mesh:
    """A data-parallel mesh over every device of every process.

    ``jax.devices()`` is the global device list under the
    multi-controller runtime, so the same call shapes single-host and
    pod runs identically."""
    return make_mesh(data=len(jax.devices()) // state, state=state)


def local_cohort_slice(n_units: int) -> slice:
    """The contiguous block of analysis units this host should gather
    and feed to its addressable devices.  Driver feeds globally-sharded
    batches, so each host materialises only its slice; the merged
    accumulators come back replicated."""
    p, np_ = jax.process_index(), jax.process_count()
    per = -(-n_units // np_)
    return slice(p * per, min((p + 1) * per, n_units))
