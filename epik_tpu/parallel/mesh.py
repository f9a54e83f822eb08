"""Device mesh construction for distributed placement.

The reference has no distribution layer at all -- one process, OpenMP
shared-memory threads (reference: epik/src/epik/place.cpp:218-229;
SURVEY.md "Parallelism & communication inventory").  This design uses a
2D ``jax.sharding.Mesh``:

* axis ``"data"``  -- reads are data-parallel (the analog of the reference's
  read-level OpenMP parallel-for);
* axis ``"model"`` -- the phylo-k-mer database is hash-sharded when it does
  not fit (or is not wanted) replicated in device memory; per-branch
  partial score
  matrices merge with ``psum`` over this axis (BASELINE.json north star).

Multi-host: call :func:`init_distributed` first (jax.distributed), then build
the mesh over the global device list.
"""

from __future__ import annotations

import os
import sys
import threading
import time

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = [
    "make_mesh",
    "init_distributed",
    "BatchWatchdog",
    "STALL_EXIT_CODE",
    "DATA_AXIS",
    "MODEL_AXIS",
]

DATA_AXIS = "data"
MODEL_AXIS = "model"

#: process exit code of a watchdog-detected collective stall -- distinct
#: from ordinary failures so a supervisor can restart the rank with
#: ``--resume`` (the per-batch jplace sidecar makes restart cheap)
STALL_EXIT_CODE = 42


class BatchWatchdog:
    """Fail-fast guard for multi-host collectives (SURVEY.md section 5.3).

    The reference aborts on any error (reference: epik/src/epik/
    main.cpp:384-388) but has no multi-process layer; this framework adds
    one, and a dead rank leaves the others BLOCKED inside an XLA
    collective -- uninterruptible from Python.  The watchdog is the honest
    mechanism available: ``arm()`` before each device step, ``disarm()``
    after; a monitor thread that sees a step exceed ``timeout_s`` prints a
    diagnosis and hard-exits the process with :data:`STALL_EXIT_CODE` so a
    supervisor can restart the job, which then resumes from the jplace
    sidecar (io/jplace.py; tested end-to-end in tests/test_multihost.py::
    test_kill_restart_resume).
    """

    def __init__(self, timeout_s: float, rank: int | None = None,
                 _exit=os._exit):
        self.timeout_s = float(timeout_s)
        self.rank = rank
        self._exit = _exit  # injectable for unit tests
        self._deadline: float | None = None
        self._tag = ""
        self._lock = threading.Lock()
        self._stop = False
        self._thread = threading.Thread(target=self._monitor, daemon=True)
        self._thread.start()

    def arm(self, tag: str = "") -> None:
        with self._lock:
            self._deadline = time.monotonic() + self.timeout_s
            self._tag = tag

    def disarm(self) -> None:
        with self._lock:
            self._deadline = None

    def stop(self) -> None:
        self._stop = True

    def _monitor(self) -> None:
        while not self._stop:
            time.sleep(min(1.0, self.timeout_s / 4))
            with self._lock:
                dl, tag = self._deadline, self._tag
            if dl is not None and time.monotonic() > dl:
                who = f"rank {self.rank}" if self.rank is not None else "rank"
                print(
                    f"COLLECTIVE STALL: {who} step {tag!r} exceeded "
                    f"{self.timeout_s:.0f}s -- a peer process is likely "
                    f"dead; exiting {STALL_EXIT_CODE} for supervised "
                    f"restart (resume from the jplace sidecar)",
                    file=sys.stderr,
                    flush=True,
                )
                self._exit(STALL_EXIT_CODE)
                return


def make_mesh(
    n_data: int | None = None,
    n_model: int = 1,
    devices: list | None = None,
) -> Mesh:
    """Build a ('data', 'model') mesh.

    Defaults: all visible devices on the data axis, model unsharded
    (replicated DB -- the fast path whenever the DB fits in device memory).
    """
    devices = devices if devices is not None else jax.devices()
    n_dev = len(devices)
    if n_data is None:
        if n_dev % n_model:
            raise ValueError(f"{n_dev} devices not divisible by n_model={n_model}")
        n_data = n_dev // n_model
    if n_data * n_model > n_dev:
        raise ValueError(
            f"mesh {n_data}x{n_model} needs {n_data * n_model} devices, have {n_dev}"
        )
    grid = np.asarray(devices[: n_data * n_model]).reshape(n_data, n_model)
    return Mesh(grid, (DATA_AXIS, MODEL_AXIS))


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     initialization_timeout: float | None = None,
                     local_device_ids: list[int] | None = None) -> None:
    """Multi-process initialization (green-field vs the reference; SURVEY.md
    section 5.8).  Nothing tells JAX of a cluster, so the coordinator
    address (``host:port``, served by rank 0), the process count and this
    process's rank are all required.

    ``local_device_ids`` binds this process to those local devices --
    needed when several processes share one host, which otherwise would
    each take every device.  ``initialization_timeout`` bounds the
    coordinator barrier so a rank that never starts surfaces an error
    instead of hanging forever (runtime stalls are covered by
    :class:`BatchWatchdog`)."""
    kw = {}
    if initialization_timeout is not None:
        kw["initialization_timeout"] = int(initialization_timeout)
    if local_device_ids is not None:
        kw["local_device_ids"] = list(local_device_ids)
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        **kw,
    )
