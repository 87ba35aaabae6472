"""Public scan API: dispatches between the device engines (the sharded
engine and the phase-chained single-device engine), the XLA reference
path, and the numpy oracle.

This is the framework's replacement for the reference's alignment engine
(Bowtie 1 invoked via subprocess, targets.py:467-539 / BowtieRunner.py:87-141).
All backends share the same contract:

    scan(spacers, contig, max_mismatches, pam, pam_direction) -> Hits

reporting every site on either strand with Hamming distance <= v whose PAM
context matches — the semantics of ``bowtie -a -v N`` followed by the
reference's PAM rejection (targets.py:350-352), with no -k cap. (The
targets pipeline's ``--max-sites N`` reproduces the reference's ``-k 100``
reporting cap post-scan when apples-to-apples diffs are needed;
pipeline/targets._cap_sites.)
"""

from __future__ import annotations

import os
from typing import Literal

from ..core.genome import Contig, Genome
from .types import Hits

Backend = Literal["auto", "pallas", "sharded", "jax", "oracle"]

_BACKENDS = ("oracle", "jax", "pallas", "sharded")


def resolve_backend(backend: Backend = "auto") -> str:
    """``auto`` is the sharded engine over all local devices on every
    platform (a 1-device mesh on one card or one CPU), unless
    BARCODER_TPU_BACKEND names another backend."""
    if backend != "auto":
        return backend
    env = os.environ.get("BARCODER_TPU_BACKEND")
    if env and env != "auto":
        # validate here, not deep inside the first scan: a typo'd env var
        # previously surfaced as "unknown scan backend" minutes later
        if env not in _BACKENDS:
            raise ValueError(
                f"BARCODER_TPU_BACKEND={env!r} is not a scan backend; "
                f"choose one of {('auto',) + _BACKENDS}"
            )
        return env
    return "sharded"


def _sharded_mesh():
    """(mesh, tile P) for the sharded backend."""
    from ..parallel.mesh import make_mesh
    from ..utils.platform import TILE_P

    return make_mesh(), TILE_P


def scan_contig(
    spacers,
    contig: Contig,
    max_mismatches: int,
    pam: str = "",
    pam_direction: str = "downstream",
    backend: Backend = "auto",
) -> Hits:
    b = resolve_backend(backend)
    if b == "oracle":
        from .oracle import oracle_scan

        return oracle_scan(spacers, contig, max_mismatches, pam, pam_direction)
    if b == "pallas":
        from .pallas_scan import pallas_scan

        return pallas_scan(spacers, contig, max_mismatches, pam, pam_direction)
    if b == "sharded":
        # the multi-device engine over ALL local devices (a 1-device mesh
        # on a single card): one fused shard_map program and one packed
        # fetch per scan. PAMs longer than the fused-mask budget fall back
        # to the XLA path, same as the pallas backend.
        from .pallas_scan import MAX_PAM

        if len(pam) > MAX_PAM:
            from .ref_scan import jax_scan

            return jax_scan(spacers, contig, max_mismatches, pam, pam_direction)
        from ..parallel.sharded_scan import sharded_scan

        mesh, tile_p = _sharded_mesh()
        return sharded_scan(
            spacers, contig, max_mismatches, pam, pam_direction,
            mesh=mesh, P=tile_p,
        )
    if b == "jax":
        from .ref_scan import jax_scan

        return jax_scan(spacers, contig, max_mismatches, pam, pam_direction)
    raise ValueError(f"unknown scan backend {b!r}")


def scan_contigs(
    spacers,
    contigs: list[Contig],
    max_mismatches: int,
    pam: str = "",
    pam_direction: str = "downstream",
    backend: Backend = "auto",
) -> list[Hits]:
    """Batched multi-contig scan; returns Hits in INPUT ORDER (robust to
    duplicate contig ids, unlike an id-keyed dict). Multi-replicon genomes
    pipeline their per-contig device work where the backend supports it:
    the pallas path shares one spacer prep across contigs
    (pallas_scan_contigs), the sharded path dispatches every contig's
    fused program before any fetch (sharded_scan_contigs)."""
    b = resolve_backend(backend)
    if b == "pallas":
        from .pallas_scan import pallas_scan_contigs

        return pallas_scan_contigs(
            spacers, contigs, max_mismatches, pam, pam_direction
        )
    if b == "sharded" and len(contigs) > 1:
        from .pallas_scan import MAX_PAM

        if len(pam) <= MAX_PAM:
            from ..parallel.sharded_scan import sharded_scan_contigs

            mesh, tile_p = _sharded_mesh()
            return sharded_scan_contigs(
                spacers, contigs, max_mismatches, pam, pam_direction,
                mesh=mesh, P=tile_p,
            )
    return [
        scan_contig(spacers, c, max_mismatches, pam, pam_direction, backend)
        for c in contigs
    ]


def scan_genome(
    spacers,
    genome: Genome,
    max_mismatches: int,
    pam: str = "",
    pam_direction: str = "downstream",
    backend: Backend = "auto",
) -> dict[str, Hits]:
    """Scan every contig; returns {contig_id: Hits} (see scan_contigs).
    Raises on duplicate contig ids — the dict form cannot represent them
    (use scan_contigs directly for positional results)."""
    ids = [c.id for c in genome.contigs]
    if len(set(ids)) != len(ids):
        raise ValueError(
            "scan_genome requires unique contig ids; use scan_contigs for "
            f"positional results (got duplicates among {ids})"
        )
    hits = scan_contigs(
        spacers, genome.contigs, max_mismatches, pam, pam_direction, backend
    )
    return dict(zip(ids, hits))
