"""Device mesh construction for distributed query execution.

Axes convention:
  * ``shard``  — data-partition axis (files / row ranges). The primary axis:
    scans split across it, shuffles exchange over it.
  * ``lane``   — optional intra-operator axis (wide sort/join stages can
    subdivide work); degree 1 unless requested.

The ``shard`` axis is a plain 1-D list of devices: shuffles exchange over
it with all_to_all, which assumes every device reaches every other at the
same rate.

Multi-host: ``init_distributed`` brings up ``jax.distributed`` (from
arguments or EXON_TPU_* environment variables); ``make_mesh`` then builds
the shard axis over the *global* device list ordered so each process's
addressable devices are contiguous — per-wave work is purely local, and
the single end-of-query exchange is the only one that crosses hosts.
Scans split their file lists per process with ``iter_scan_files`` so every
host decodes only its own shard of the input (the multi-host analog of the
reference's regroup_files_by_size partitioning,
exon-core/src/datasources/exon_file_scan_config.rs:79-110).
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

_DIST_INITIALIZED = False


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """Initialize ``jax.distributed`` for multi-host execution.

    Arguments fall back to ``EXON_TPU_COORDINATOR`` /
    ``EXON_TPU_NUM_PROCESSES`` / ``EXON_TPU_PROCESS_ID``. Returns True if
    a multi-process runtime is (already) up; False for single-process
    operation. Safe to call more than once."""
    global _DIST_INITIALIZED
    if _DIST_INITIALIZED:
        return jax.process_count() > 1
    coordinator_address = coordinator_address or \
        os.environ.get("EXON_TPU_COORDINATOR")
    if num_processes is None and "EXON_TPU_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["EXON_TPU_NUM_PROCESSES"])
    if process_id is None and "EXON_TPU_PROCESS_ID" in os.environ:
        process_id = int(os.environ["EXON_TPU_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return False  # single process; nothing to bring up
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)
    _DIST_INITIALIZED = True
    return jax.process_count() > 1


def make_mesh(n_devices: Optional[int] = None, lane: int = 1,
              devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
        if jax.process_count() > 1:
            # order the shard axis so each process's devices are contiguous:
            # per-wave compute is process-local; only the final group-state
            # all_to_all crosses hosts
            devices = sorted(devices,
                             key=lambda d: (d.process_index, d.id))
        if n_devices is not None and len(devices) < n_devices:
            raise ValueError(
                f"need {n_devices} devices, have {len(devices)}")
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if n % lane != 0:
        raise ValueError(f"{n} devices not divisible by lane={lane}")
    arr = np.asarray(devices).reshape(n // lane, lane)
    return Mesh(arr, ("shard", "lane"))


def local_shard_count(mesh: Mesh) -> int:
    """Shard-axis rows whose devices are addressable by this process."""
    if jax.process_count() <= 1:
        return mesh.shape["shard"]
    pid = jax.process_index()
    rows = 0
    for row in mesh.devices:
        if all(d.process_index == pid for d in np.atleast_1d(row)):
            rows += 1
    return rows


_SCAN_SHARD: contextvars.ContextVar[Optional[tuple]] = \
    contextvars.ContextVar("exon_scan_shard", default=None)


@contextlib.contextmanager
def scan_shard_context(index: int, count: int):
    """While active, ``iter_scan_files`` yields only this process's slice
    of each scan's file list (round-robin by position)."""
    tok = _SCAN_SHARD.set((index, count))
    try:
        yield
    finally:
        _SCAN_SHARD.reset(tok)


def iter_scan_files(files: Sequence):
    """Apply the active process file-shard (if any) to a scan's file list.

    Providers call this at decode time so multi-host runs split ingest:
    process p decodes files[p::P]. Single-process (no active context):
    identity."""
    shard = _SCAN_SHARD.get()
    if shard is None:
        return list(files)
    index, count = shard
    return list(files)[index::count]


_DEFAULT: Optional[Mesh] = None


def default_mesh() -> Mesh:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = make_mesh()
    return _DEFAULT


def set_default_mesh(mesh: Mesh) -> None:
    global _DEFAULT
    _DEFAULT = mesh
