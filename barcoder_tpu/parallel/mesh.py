"""Device mesh helpers.

The framework's distributed model (SURVEY.md §2 parallelism inventory):
genome-axis sharding over a 1-D ``genome`` mesh axis (each device scans a
contiguous tile of positions, with wrap halos materialized host-side), the
spacer library replicated, per-shard hit counts merged with ``psum`` and hit
lists gathered with ``all_gather``. This replaces the reference's host-only
process pools and Bowtie threads (heuristicount.py:720-722,
targets.py:499-504); collectives are XLA's (NCCL between GPUs, Gloo between
CPU processes). Every card of a host reaches every other at the same rate,
so the mesh follows the algorithm: a 1-D genome axis, optionally a library
axis.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


GENOME_AXIS = "genome"
LIBRARY_AXIS = "library"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the genome axis."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            if n_devices > len(devices):
                # silently truncating mislabels results: the scaling
                # harness would report an 8-device measurement as 16
                # devices with ~2x-understated efficiency (r5 review)
                raise ValueError(
                    f"requested {n_devices} devices, have {len(devices)}"
                )
            devices = devices[:n_devices]
    return Mesh(np.array(devices), (GENOME_AXIS,))


def make_mesh_2d(
    n_library: int, n_genome: int | None = None, devices=None
) -> Mesh:
    """2-D ``(library, genome)`` mesh: the TP analog noted in SURVEY.md §2 —
    shard the spacer-library axis when the library outgrows per-device
    memory, with the genome axis sharded within each library row."""
    if devices is None:
        devices = jax.devices()
    if n_genome is None:
        n_genome = len(devices) // n_library
    if n_genome < 1 or n_library * n_genome > len(devices):
        # n_genome == 0 (n_library > device count) built a degenerate
        # (n_library, 0) mesh that failed far from the cause (r5 review)
        raise ValueError(
            f"mesh {n_library}x{n_genome} needs {max(n_library * n_genome, n_library)} devices,"
            f" have {len(devices)}"
        )
    grid = np.array(devices[: n_library * n_genome]).reshape(n_library, n_genome)
    return Mesh(grid, (LIBRARY_AXIS, GENOME_AXIS))
