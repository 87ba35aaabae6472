"""Multi-host (multi-process) execution: the DCN half of the distributed
plan.

The reference scales across host cores with fork pools
(heuristicount.py:720-722, distillreads.py:350-433); the generalization
here is one JAX process per host joined into a single global
device mesh by ``jax.distributed``, with the SAME shard_map programs the
single-process engines compile running unchanged — XLA routes the psum /
all_gather / ppermute segments that cross a host boundary over DCN (Gloo on
CPU meshes, which is how the multi-process tests prove correctness without
pod hardware; see tests/test_multihost.py).

What changes at the framework layer is only array PLACEMENT and FETCH:

- inputs are placed with :func:`put_global` (addressable shards only — no
  whole-array ``device_put``, which requires every device to be local) or
  :func:`put_process_local` (each host contributes its own rows: the
  data-parallel read-counting feed);
- replicated outputs (``out_specs=P()``) fetch with plain ``np.asarray``
  on every host; row-sharded outputs fetch with :func:`fetch_local_rows`
  (this host's addressable rows only).

Processes must make the same jitted calls in the same order (single-
controller SPMD, one controller per host) — the engines here already do:
every retry/caps decision in ``sharded_scan`` is computed from a fully
replicated header, so all hosts branch identically.

CPU-mesh caveat: XLA's Gloo collective backend prints ``[Gloo] Rank ...``
banners directly to fd 1 (C++ iostream) when ranks first connect, and the
unbuffered native writes can interleave mid-line with Python's stdout. The
CLI shields against this by re-pointing fd 1 at stderr and keeping a
private dup of the original stdout for data (cli.main._shield_stdout), so
CLI stdout stays byte-clean even on the CPU stand-in. GPU meshes use NCCL
and never print these banners. Library users embedding multi-host
engines with machine-read stdout should apply the same shield.
"""

from __future__ import annotations

import os

import numpy as np

import jax

_ENV_COORD = "BARCODER_TPU_COORDINATOR"
_ENV_NPROC = "BARCODER_TPU_NUM_PROCESSES"
_ENV_PID = "BARCODER_TPU_PROCESS_ID"

_initialized = False


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
) -> bool:
    """Join this process into a multi-host JAX cluster.

    Arguments fall back to ``BARCODER_TPU_COORDINATOR`` /
    ``BARCODER_TPU_NUM_PROCESSES`` / ``BARCODER_TPU_PROCESS_ID`` (and from
    there to JAX's own auto-detection env vars). Returns True if a
    multi-process runtime was (or already had been) initialized, False for
    the single-process no-op — callers can use it unconditionally:

        multihost.initialize()          # no-op unless env/args say otherwise
        mesh = make_mesh()              # spans ALL processes' devices

    Must run before the first jax.devices() touch in this process. After
    it, ``jax.devices()`` returns the GLOBAL device list, so every mesh
    built by :mod:`parallel.mesh` spans processes with no further changes.
    """
    global _initialized
    if _initialized:
        return True
    coordinator_address = coordinator_address or os.environ.get(_ENV_COORD)
    if num_processes is None and os.environ.get(_ENV_NPROC):
        num_processes = int(os.environ[_ENV_NPROC])
    if process_id is None and os.environ.get(_ENV_PID):
        process_id = int(os.environ[_ENV_PID])
    if coordinator_address is None and num_processes is None:
        return False  # single-process run: nothing to do
    if num_processes is not None and num_processes <= 1:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    _initialized = True
    return True


def process_count() -> int:
    return jax.process_count()


def process_index() -> int:
    return jax.process_index()


def is_multiprocess() -> bool:
    return jax.process_count() > 1


def put_global(host, sharding):
    """Place a (globally-shaped) host array onto a possibly
    process-spanning mesh, shipping only the shards addressable from THIS
    process. ``host`` may be the array or a zero-arg builder (the builder
    runs once per process). Single-process reduces to ``device_put``."""
    arr = host() if callable(host) else host
    arr = np.asarray(arr)
    if jax.process_count() == 1:
        return jax.device_put(arr, sharding)
    return jax.make_array_from_callback(arr.shape, sharding, lambda idx: arr[idx])


def put_process_local(local_rows: np.ndarray, sharding):
    """Build a global row-sharded array from each process's OWN rows (the
    host-local data feed: global row count = sum over processes, in process
    order). All processes must contribute the same number of rows per call
    — the lockstep contract of the data-parallel counting driver."""
    if jax.process_count() == 1:
        return jax.device_put(local_rows, sharding)
    return jax.make_array_from_process_local_data(sharding, local_rows)


def allgather_bytes(data: bytes) -> list[bytes]:
    """All-gather one variable-length byte string per process; every
    process returns the same K-element list, in process order. Two
    collectives (length exchange, then padded payload) over the global
    device set — DCN traffic, used only for small host-side state like
    the counting CLI's undocumented-barcode tally merge. Single-process
    reduces to ``[data]``."""
    if jax.process_count() == 1:
        return [data]
    from jax.experimental import multihost_utils

    lens = np.asarray(
        multihost_utils.process_allgather(np.int64(len(data)))
    ).reshape(-1)
    mx = max(int(lens.max()), 1)
    buf = np.zeros(mx, np.uint8)
    buf[: len(data)] = np.frombuffer(data, np.uint8)
    allbuf = np.asarray(multihost_utils.process_allgather(buf))
    return [allbuf[i, : int(lens[i])].tobytes() for i in range(len(lens))]


def agree_int(value: int) -> tuple[int, bool]:
    """All-gather one int per process; returns ``(value, True)`` when every
    process reported the same value, else ``(min over processes, False)``.
    The cross-host checkpoint-resume agreement primitive: all processes
    see the identical gathered vector, so every process takes the same
    branch."""
    if jax.process_count() == 1:
        return value, True
    from jax.experimental import multihost_utils

    vals = np.asarray(
        multihost_utils.process_allgather(np.int64(value))
    ).reshape(-1)
    return int(vals.min()), bool((vals == vals[0]).all())


def fetch_local_rows(arr) -> np.ndarray:
    """This process's addressable rows of a leading-axis row-sharded global
    array, concatenated in global row order (the inverse of
    :func:`put_process_local` for outputs like the counting engine's
    per-read matched bits)."""
    shards = sorted(
        arr.addressable_shards, key=lambda s: s.index[0].start or 0
    )
    return np.concatenate([np.asarray(s.data) for s in shards])
