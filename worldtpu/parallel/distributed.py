"""Multi-host runtime entry: jax.distributed + a global ('data', 'time')
mesh over every process's devices.

The reference is strictly single-process shared memory (SURVEY.md §2 row
15: no NCCL/MPI/sockets anywhere; OpenMP threads only, e.g.
/root/reference/src/harvest.cpp:935).  On a multi-host GPU cluster the
equivalent runtime is the JAX distributed system: one Python process per
host, each seeing its local GPUs, with XLA collectives (NCCL) between
them.  This module is the one entry point a multi-host deployment needs;
everything downstream (parallel.batch.*) already takes an explicit `Mesh`
and is agnostic to whether its devices are local or global.

Single-host usage is unchanged — `make_mesh()` over local devices (the
four-GPU check is `python chip_smoke.py --four` on one host).  On a
cluster, each process calls::

    worldtpu.parallel.init_distributed(coordinator_address="host:port",
                                       num_processes=n, process_id=i)
    mesh = worldtpu.parallel.global_mesh(n_time=2)

and then passes `mesh` to batch_wav_to_wav / batch_copy_synthesis exactly
as on one host.  Per-process batch construction stays data-parallel:
each host loads its own shard of the corpus and the 'data' axis of the
mesh maps utterances to the chips that host them
(jax.make_array_from_process_local_data handles the host->global array
assembly).

The multi-process path is not exercised by the tests (the virtual
8-device CPU mesh covers the sharding semantics instead, and
`__graft_entry__.dryrun_multichip` covers compile+execute).
"""

from __future__ import annotations

import logging

import jax
import numpy as np
from jax.sharding import Mesh

log = logging.getLogger("worldtpu.distributed")

_initialized = False


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, local_device_ids=None):
    """Initialize the JAX distributed runtime (idempotent).

    On CPU/GPU clusters pass the coordinator address, process count and
    process index explicitly, mirroring jax.distributed.initialize's
    contract (without them it fails unless a cluster environment it
    recognizes provides them).

    Safe to call when already initialized or when running single-process
    (num_processes == 1 detected from the environment): both become
    no-ops, so the same launcher script works from a laptop to a cluster.
    """
    global _initialized
    if _initialized:
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids)
        _initialized = True
        log.info("jax.distributed initialized: process %d/%d, %d local / "
                 "%d global devices", jax.process_index(),
                 jax.process_count(), jax.local_device_count(),
                 jax.device_count())
    except (RuntimeError, ValueError) as e:
        # already initialized (e.g. by a launcher) or single-process run
        # with no coordinator configured (ValueError: 'coordinator_address
        # should be defined') — both are fine
        log.info("jax.distributed.initialize skipped: %s", e)
        _initialized = True


def global_mesh(n_data=None, n_time=1):
    """('data', 'time') mesh over ALL processes' devices.

    Like parallel.batch.make_mesh but over `jax.devices()` after
    init_distributed() — which on a cluster returns the global device list in
    a consistent order on every process.  Degrades to dp-only if the
    requested factorization does not cover the device count."""
    from worldtpu.parallel.batch import make_mesh
    return make_mesh(n_data=n_data, n_time=n_time, devices=jax.devices())


def process_local_batch(mesh, global_batch_arrays):
    """Assemble process-local numpy batches into global sharded arrays.

    Each process passes its local utterances ([B_local, ...] numpy); the
    result is a global [B_global, ...] jax.Array sharded over the mesh's
    'data' axis with each shard resident on the process that provided it.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P
    out = []
    for a in global_batch_arrays:
        spec = P("data", *([None] * (a.ndim - 1)))
        out.append(jax.make_array_from_process_local_data(
            NamedSharding(mesh, spec), np.asarray(a)))
    return tuple(out)
