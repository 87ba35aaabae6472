"""Multi-device scaling-efficiency harness (SURVEY.md §7 step 6).

Measures the sharded scan at mesh sizes 1..N on whatever devices are
present and reports throughput + efficiency vs the single-device run. On
real multi-chip hardware this is the ≥85%-scaling acceptance check
(BASELINE.md); on a fake-device CPU mesh the numbers only validate the
mechanics (the "devices" share one socket), which the report flags.

The engine is the full sharded_scan path ("flagship"): strand-fused
folded-bias hit-indicator phase 1, device pair compaction, device-resident
phase 2, all_gathered hit lists (parallel.sharded_scan).

Run: ``python -m barcoder_tpu.parallel.scaling [n_bp] [n_spacers]
[--single-chip]``.

``--single-chip`` also times ops.pallas_scan.pallas_scan on one device
(the flagship single-chip engine) so the sharded-vs-single per-device gap
is printed directly.
"""

from __future__ import annotations

import json
import time

import numpy as np

import jax


def _make_workload(n_bp: int, n_spacers: int, L: int):
    from ..core.encode import decode, encode
    from ..core.genome import Contig

    rng = np.random.default_rng(0)
    seq = decode(rng.integers(0, 4, size=n_bp).astype(np.int8))
    contig = Contig(
        id="SCALE0.1", length=n_bp, codes=encode(seq), seq=seq, topology="circular"
    )
    spacers = [seq[p : p + L] for p in range(64, 64 + n_spacers * 11, 11)][:n_spacers]
    return contig, spacers


def _best_of(fn, repeats):
    """Steady-state wall time: 2 warm calls (cold compile, then cache/engine
    promotion), then best-of-N."""
    fn()
    last = fn()
    dt = float("inf")
    for _ in range(repeats):
        t0 = time.time()
        last = fn()
        dt = min(dt, time.time() - t0)
    return dt, last


def _time_flagship(contig, spacers, mesh, P, repeats):
    from .sharded_scan import sharded_scan

    dt, hits = _best_of(
        lambda: sharded_scan(spacers, contig, 1, pam="NGG", mesh=mesh, P=P),
        repeats,
    )
    return dt, len(hits)


def _time_single_chip(contig, spacers, repeats):
    """The flagship single-chip engine (both strands, full extraction)."""
    from ..ops.pallas_scan import pallas_scan

    dt, hits = _best_of(
        lambda: pallas_scan(spacers, contig, 1, pam="NGG"), repeats
    )
    return dt, len(hits)


def measure_scaling(
    n_bp: int = 1 << 21,
    n_spacers: int = 1024,
    L: int = 20,
    P: int | None = None,
    repeats: int = 3,
    device_counts=None,
    single_chip: bool = False,
) -> dict:
    from ..utils.platform import TILE_P, device_platform
    from .mesh import make_mesh

    devices = jax.devices()
    platform = device_platform(devices)
    if P is None:
        P = TILE_P
    if device_counts is None:
        device_counts = sorted({1, 2, len(devices)} & set(range(1, len(devices) + 1)))

    contig, spacers = _make_workload(n_bp, n_spacers, L)
    positions = 2 * len(spacers) * n_bp  # both strands

    out = {
        "platform": platform,
        "genome_bp": n_bp,
        "spacers": len(spacers),
        "fake_devices": platform == "cpu",
        "note": (
            "fake CPU devices share one socket — efficiency numbers are NOT "
            "meaningful, only the mechanics"
            if platform == "cpu"
            else "real accelerator mesh"
        ),
    }
    results = []
    base_rate = None
    for nd in device_counts:
        dt, n_hits = _time_flagship(contig, spacers, make_mesh(nd), P, repeats)
        rate = positions / dt
        if base_rate is None:
            base_rate = rate
        results.append(
            {
                "devices": nd,
                "seconds": dt,
                "spacer_positions_per_s": rate,
                "per_device_rate": rate / nd,
                "speedup": rate / base_rate,
                "efficiency": rate / (base_rate * nd),
                "hits": n_hits,
            }
        )
    out["flagship"] = results
    if single_chip and platform == "cpu":
        # the single-device engine's phase 1 is the compiled GPU kernel;
        # timing its CPU stand-in says nothing about the engine
        out["single_chip"] = {"skipped": "cpu mesh (timed on the GPU only)"}
    elif single_chip:
        dt, n_hits = _time_single_chip(contig, spacers, repeats)
        out["single_chip"] = {
            "seconds": dt,
            "spacer_positions_per_s": positions / dt,
            "hits": n_hits,
        }
        if "flagship" in out:
            one_dev = out["flagship"][0]["per_device_rate"]
            out["sharded_vs_single_chip"] = one_dev / (positions / dt)
    return out


def _make_count_workload(d: str, n_reads: int = 200_000, n_barcodes: int = 2_000):
    """Deterministic counting inputs for the multi-host harness: a FASTQ
    of flank-anchored barcode reads + the barcode FASTA, written under d."""
    import os

    from ..core.encode import decode

    rng = np.random.default_rng(1)
    barcodes = sorted(
        {decode(rng.integers(0, 4, 20).astype(np.int8)) for _ in range(n_barcodes)}
    )
    pre, l_fl, r_fl, tail = "ACGTG", "GGTAGCT", "CTTAAGC", "TCCATGGA"
    fq = os.path.join(d, "count.fastq")
    with open(fq, "w") as fh:
        for i in rng.integers(0, len(barcodes), size=n_reads):
            r = pre + l_fl + barcodes[i] + r_fl + tail
            fh.write(f"@r\n{r}\n+\n{'I' * len(r)}\n")
    bc = os.path.join(d, "barcodes.fasta")
    with open(bc, "w") as fh:
        for i, b in enumerate(barcodes):
            fh.write(f">b{i}\n{b}\n")
    return fq, bc, n_reads


def measure_multihost(
    n_bp: int,
    n_spacers: int,
    n_processes: int,
    devices_per_process: int = 4,
    P: int = 2048,
    repeats: int = 3,
    force_cpu: bool = True,
    workload: str = "scan",
) -> dict:
    """Multi-HOST mechanics/efficiency harness (the DCN half of SURVEY §7
    step 6): spawns ``n_processes`` real worker processes joined by
    ``jax.distributed`` over a localhost coordinator, times the unchanged
    flagship sharded scan over the process-spanning global mesh, and
    checks every process observed the identical hit set. On one machine
    with fake CPU devices the wall numbers only validate mechanics (all
    "hosts" share one socket — flagged in the report); on a real pod the
    same harness reports cross-host scaling."""
    import json as _json
    import os
    import socket
    import subprocess
    import sys
    import tempfile

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    if force_cpu:
        # fake devices only make sense on the CPU path; APPEND so a
        # launcher's own XLA flags survive
        env["XLA_FLAGS"] = (
            env.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={devices_per_process}"
        ).strip()
    env["PYTHONPATH"] = repo + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
    )
    d = tempfile.mkdtemp(prefix="scaling_mh_")
    count_args: list[str] = []
    n_reads = None
    if workload == "count":
        fq, bc, n_reads = _make_count_workload(d)
        count_args = ["--workload", "count", "--fastq", fq, "--barcodes", bc]
    procs, outs = [], []
    for pid in range(n_processes):
        out = os.path.join(d, f"p{pid}.json")
        outs.append(out)
        cmd = [
            sys.executable, "-m", "barcoder_tpu.parallel.scaling",
            "--mh-worker", str(pid), str(n_processes), str(port), out,
            str(n_bp), str(n_spacers), "--P", str(P),
            "--repeats", str(repeats),
        ] + count_args + (["--cpu"] if force_cpu else [])
        # capture worker output: Gloo rank banners must not pollute the
        # harness's own JSON stdout
        procs.append(subprocess.Popen(
            cmd, env=env, cwd=repo,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        ))
    try:
        for p in procs:
            if p.wait(timeout=900) != 0:
                raise RuntimeError(
                    f"multihost worker failed (rc={p.returncode})"
                )
    except BaseException:
        for q in procs:
            q.kill()
        raise
    results = [_json.load(open(o)) for o in outs]
    note = (
        "all processes share one socket — wall times validate DCN "
        "mechanics only" if force_cpu else "real multi-host mesh"
    )
    if workload == "count":
        owned = [r["owned_reads"] for r in results]
        return {
            "workload": "count",
            "processes": n_processes,
            "devices_per_process": devices_per_process,
            "global_devices": results[0]["global_devices"],
            "reads": n_reads,
            "per_process_seconds": [r["seconds"] for r in results],
            "counts_identical": len({r["counts_digest"] for r in results}) == 1,
            # chunk-ownership proof: disjoint per-host parse shares
            # covering the stream exactly once
            "owned_reads": owned,
            "owned_covers_stream": sum(owned) == n_reads,
            "note": note,
        }
    hit_sets = {r["hits_digest"] for r in results}
    return {
        "workload": "scan",
        "processes": n_processes,
        "devices_per_process": devices_per_process,
        "global_devices": results[0]["global_devices"],
        "genome_bp": n_bp,
        "spacers": n_spacers,
        "per_process_seconds": [r["seconds"] for r in results],
        "hits": results[0]["hits"],
        "hit_sets_identical": len(hit_sets) == 1,
        "note": note,
    }


def _mh_worker(pid, nproc, port, out_path, n_bp, n_spacers, P, repeats,
               workload="scan", fastq=None, barcodes=None) -> int:
    """One scaling worker: join the cluster, scan over the global mesh."""
    import hashlib
    import json as _json

    from . import multihost

    # join the cluster BEFORE anything touches the XLA backend — importing
    # ops.pallas_scan initializes it via the compilation-cache probe
    multihost.initialize(f"localhost:{port}", nproc, pid)
    if workload == "count":
        # the chunk-ownership counting driver over the shared FASTQ: each
        # run re-samples + re-counts (the production cold path); the
        # owned_reads share proves the parse division
        from ..pipeline.heuristic_count import run_count
        from ..seqio.fasta import read_barcode_fasta

        bset = read_barcode_fasta(barcodes)

        def one():
            return run_count(bset, fastq, engine="sharded", chunk_size=2**14)

        dt, (doc, undoc, total, info) = _best_of(one, repeats)
        digest = hashlib.blake2b(
            repr((sorted(doc.items()), sorted(undoc.items()), total)).encode(),
            digest_size=12,
        ).hexdigest()
        with open(out_path, "w") as fh:
            _json.dump({
                "process": pid,
                "global_devices": jax.device_count(),
                "seconds": dt,
                "counts_digest": digest,
                "owned_reads": info["owned_reads"],
            }, fh)
        return 0
    from .mesh import make_mesh
    from .sharded_scan import sharded_scan
    contig, spacers = _make_workload(n_bp, n_spacers, 20)
    mesh = make_mesh()
    dt, hits = _best_of(
        lambda: sharded_scan(spacers, contig, 1, pam="NGG", mesh=mesh, P=P),
        repeats,
    )
    tup = repr(sorted(zip(
        hits.spacer_idx.tolist(), hits.pos.tolist(),
        hits.strand.tolist(), hits.mismatches.tolist(),
    ))).encode()
    with open(out_path, "w") as fh:
        _json.dump({
            "process": pid,
            "global_devices": jax.device_count(),
            "seconds": dt,
            "hits": len(hits),
            "hits_digest": hashlib.blake2b(tup, digest_size=12).hexdigest(),
        }, fh)
    return 0


def main(argv=None) -> int:
    import sys

    args = list(sys.argv[1:] if argv is None else argv)
    single = False
    P = None
    if "--cpu" in args:
        # fake-device count comes from XLA_FLAGS
        # --xla_force_host_platform_device_count=N
        jax.config.update("jax_platforms", "cpu")
        args.remove("--cpu")
    repeats = 3
    if "--repeats" in args:
        i = args.index("--repeats")
        repeats = int(args[i + 1])
        del args[i : i + 2]
    workload = "scan"
    fastq = barcodes_path = None
    if "--workload" in args:
        i = args.index("--workload")
        workload = args[i + 1]
        del args[i : i + 2]
    if "--fastq" in args:
        i = args.index("--fastq")
        fastq = args[i + 1]
        del args[i : i + 2]
    if "--barcodes" in args:
        i = args.index("--barcodes")
        barcodes_path = args[i + 1]
        del args[i : i + 2]
    if "--mh-worker" in args:
        i = args.index("--mh-worker")
        pid, nproc, port, out_path = args[i + 1 : i + 5]
        del args[i : i + 5]
        p_w = 2048
        if "--P" in args:
            j = args.index("--P")
            p_w = int(args[j + 1])
            del args[j : j + 2]
        n_bp_w = int(args[0]) if args else 1 << 21
        n_sp_w = int(args[1]) if len(args) > 1 else 1024
        return _mh_worker(int(pid), int(nproc), port, out_path,
                          n_bp_w, n_sp_w, p_w, repeats,
                          workload=workload, fastq=fastq,
                          barcodes=barcodes_path)
    if "--processes" in args:
        i = args.index("--processes")
        nproc = int(args[i + 1])
        del args[i : i + 2]
        # default: fake CPU devices (mechanics validation on one machine);
        # --real-devices launches workers on whatever accelerators each
        # process sees — the pod path that yields the actual efficiency
        # number
        force_cpu = True
        if "--real-devices" in args:
            force_cpu = False
            args.remove("--real-devices")
        dpp = 4
        if "--devices-per-process" in args:
            i = args.index("--devices-per-process")
            dpp = int(args[i + 1])
            del args[i : i + 2]
        p_m = 2048
        if "--P" in args:
            i = args.index("--P")
            p_m = int(args[i + 1])
            del args[i : i + 2]
        n_bp_m = int(args[0]) if args else 1 << 21
        n_sp_m = int(args[1]) if len(args) > 1 else 1024
        print(json.dumps(measure_multihost(
            n_bp_m, n_sp_m, nproc, devices_per_process=dpp, P=p_m,
            repeats=repeats, force_cpu=force_cpu, workload=workload,
        ), indent=2))
        return 0
    if "--single-chip" in args:
        single = True
        args.remove("--single-chip")
    if "--P" in args:
        i = args.index("--P")
        P = int(args[i + 1])
        del args[i : i + 2]
    device_counts = None
    if "--devices" in args:
        i = args.index("--devices")
        device_counts = [int(x) for x in args[i + 1].split(",")]
        del args[i : i + 2]
    n_bp = int(args[0]) if args else 1 << 21
    n_spacers = int(args[1]) if len(args) > 1 else 1024
    print(
        json.dumps(
            measure_scaling(
                n_bp=n_bp, n_spacers=n_spacers,
                single_chip=single, P=P, device_counts=device_counts,
            ),
            indent=2,
        )
    )
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
