"""Multi-process / multi-host runtime bootstrap (parallel phase 3).

Replacement of the reference's MPI bootstrap across nodes
(/root/reference/mpi.F90:83-178: MPI_INIT + COMM_RANK/COMM_SIZE + the
rank-0 log setup) and of its rank discipline:

  * `init_distributed` wires `jax.distributed.initialize`; afterwards
    `jax.devices()` spans every host, so the existing meshes
    (`parallel.source_shard.make_device_mesh`,
    `parallel.domain.make_domain_mesh`) lay their collectives over the
    interconnect within a host (NVLink) and the network across hosts
    (NCCL chooses the transport) with no further changes — the
    psum/ppermute layouts ARE the multi-host communication plan.
  * Every file write is gated on process 0 (the reference gates every
    write on `rank == 0`: output.F90:179, sourceprops.F90:154, the logf
    unit in mpi.F90:93-151) — see `is_io_rank`.
  * Input files are read once on process 0 and broadcast (the reference
    reads catalogs/densities on the master rank and MPI_BCASTs them:
    sourceprops.F90:154-209, density_module.F90:82-125) — see
    `broadcast_obj` / `read_on_io_rank`.
  * Source dealing: the shard_map source axis is the per-rank deal; the
    host-side flux-sorted round-robin (models/sources.sort_sources_by_flux)
    balances it exactly like the reference's static decomposition
    (master_slave.F90:41-62), and because every process holds the same
    broadcast catalog, each process's devices receive their slice of the
    same global ordering deterministically.

Initialization is env-driven so the same program text runs under any
launcher (the `mpirun` analogue):

  C2RAY_COORDINATOR    host:port of process 0's coordinator service
  C2RAY_NUM_PROCESSES  total number of processes
  C2RAY_PROCESS_ID     this process's id (0-based)

Under a cluster launcher that jax.distributed recognises (SLURM, or an
Open MPI / MPICH `mpirun`) the three are auto-detected from the
launcher's environment when C2RAY_DISTRIBUTED=1 is set; other launches
pass them explicitly.  One process can drive all local GPUs of a host,
so a single-host run needs none of this.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Optional

import numpy as np

_initialized = False


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """Connect this process to the distributed runtime (MPI_INIT analogue,
    mpi.F90:86-105).

    Arguments fall back to the C2RAY_* environment variables; with
    nothing set, the call is a no-op (single-process run); with
    C2RAY_DISTRIBUTED=1 it auto-detects a recognised cluster launcher.  Returns True when a multi-process runtime
    was initialized.  Safe to call twice (subsequent calls no-op).
    """
    global _initialized
    import jax

    if _initialized:
        return jax.process_count() > 1

    coordinator_address = (coordinator_address
                           or os.environ.get("C2RAY_COORDINATOR"))
    if num_processes is None:
        env = os.environ.get("C2RAY_NUM_PROCESSES")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("C2RAY_PROCESS_ID")
        process_id = int(env) if env else None

    if coordinator_address is None and num_processes is None:
        # strictly opt-in: C2RAY_DISTRIBUTED=1 requests the launcher
        # auto-detection (jax.distributed.initialize with no arguments);
        # without it a single-chip/single-host run stays a no-op, since a
        # bare initialize() fails once the backend is up
        if os.environ.get("C2RAY_DISTRIBUTED") == "1":
            jax.distributed.initialize()
            _initialized = True
            return jax.process_count() > 1
        return False

    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    _initialized = True
    return jax.process_count() > 1


def process_index() -> int:
    """COMM_RANK analogue (mpi.F90:108)."""
    import jax

    return jax.process_index()


def process_count() -> int:
    """COMM_SIZE analogue (mpi.F90:111)."""
    import jax

    return jax.process_count()


def is_io_rank() -> bool:
    """True on the process that owns file I/O (the reference's rank 0;
    output.F90:179, sourceprops.F90:154)."""
    import jax

    return jax.process_index() == 0


def broadcast_obj(obj: Any = None) -> Any:
    """Broadcast an arbitrary picklable object from process 0 to all
    (MPI_BCAST analogue, e.g. sourceprops.F90:246-263).

    Non-zero processes pass anything (typically None); every process
    returns process 0's value.  Single-process: identity.  The payload
    travels as a device byte array (length first, then data), so it uses
    the same fabric as the compute collectives.
    """
    import jax

    if jax.process_count() == 1:
        return obj
    from jax.experimental import multihost_utils

    if is_io_rank():
        data = np.frombuffer(pickle.dumps(obj), np.uint8)
    else:
        data = np.zeros(0, np.uint8)
    n = multihost_utils.broadcast_one_to_all(
        np.array([data.size], np.int64))
    buf = np.zeros(int(n[0]), np.uint8)
    if is_io_rank():
        buf[:] = data
    buf = multihost_utils.broadcast_one_to_all(buf)
    return pickle.loads(buf.tobytes())


def read_on_io_rank(fn, *args, **kwargs) -> Any:
    """Run a host-side read on process 0 only and broadcast the result
    (the reference's rank-gated read + MPI_BCAST pattern)."""
    import jax

    if jax.process_count() == 1:
        return fn(*args, **kwargs)
    return broadcast_obj(fn(*args, **kwargs) if is_io_rank() else None)


def sync(name: str = "c2ray") -> None:
    """Barrier over all processes (MPI_BARRIER analogue); no-op when
    single-process.  Used to order rank-0 file writes against reads by
    other processes on a shared filesystem."""
    import jax

    if jax.process_count() == 1:
        return
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)
