"""Multi-host execution proof (VERDICT r3 item 1): 2 REAL processes x 4
fake CPU devices each, joined by ``jax.distributed`` over a localhost
coordinator, run the unchanged sharded engines over the process-spanning
8-device mesh. The hit set (both sharded-scan engines) and the psum-merged
documented counts must equal this (single-)process's own 8-device run.

This is the DCN half of SURVEY.md §2's communication plan made testable
without multi-host hardware: the per-process mesh segments talk over Gloo
exactly where a multi-host GPU deployment would use NCCL. Reference precedent being
replaced: the fork-pool parallelism of heuristicount.py:720-722.
"""

import json
import os
import socket
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest

import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def worker_results(tmp_path_factory):
    d = tmp_path_factory.mktemp("mh")
    port = _free_port()
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    # scripts run by path put tests/ (not the repo root) on sys.path;
    # APPEND to PYTHONPATH so a preexisting site path survives
    env["PYTHONPATH"] = REPO + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
    )
    env["MH_WORKER_TMP"] = str(d)
    procs, outs = [], []
    for pid in range(2):
        out = d / f"res{pid}.json"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", "multihost_worker.py"),
             str(pid), "2", str(port), str(out)],
            env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    logs = []
    for p in procs:
        try:
            stdout, stderr = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append((p.returncode, stdout, stderr))
    for rc, stdout, stderr in logs:
        assert rc == 0, f"worker failed:\n{stderr[-3000:]}"
    return [json.loads(out.read_text()) for out in outs]


@pytest.mark.slow
def test_scan_matches_single_process(worker_results):
    from barcoder_tpu.core.genome import contig_from_record
    from barcoder_tpu.parallel.mesh import make_mesh
    from barcoder_tpu.parallel.sharded_scan import sharded_scan

    from .genomes import make_record, plant_guide, random_seq

    assert all(r["n_global_devices"] == 8 for r in worker_results)
    # the same case the workers built, on THIS process's 8-device mesh
    rng = np.random.default_rng(0)
    rec = make_record(n=9000, topology="circular", seed=0)
    spacers = [random_seq(20, rng) for _ in range(5)]
    for i, s in enumerate(spacers):
        plant_guide(rec, s, 700 + 1500 * i, pam="TGG", strand="F" if i % 2 else "R")
    contig = contig_from_record(rec)
    from barcoder_tpu.parallel.mesh import make_mesh_2d

    mesh = make_mesh(8)
    cases = [
        ("hits_auto", dict(mesh=mesh, site_mode="auto", v=1)),
        ("hits_never", dict(mesh=mesh, site_mode="never", v=1)),
        # library axis crossing the process boundary in the workers
        ("hits_2d", dict(mesh=make_mesh_2d(2), site_mode="auto", v=2)),
    ]
    for key, kw in cases:
        h = sharded_scan(
            spacers, contig, kw["v"], pam="NGG", mesh=kw["mesh"], P=256,
            site_mode=kw["site_mode"],
        )
        expect = sorted(
            zip(h.spacer_idx.tolist(), h.pos.tolist(),
                h.strand.tolist(), h.mismatches.tolist())
        )
        assert len(expect) >= 5
        for r in worker_results:
            got = [tuple(t) for t in r[key]]
            assert got == expect, f"process {r['process_index']} ({key})"

    # batched serving (sharded_scan_many) over the process-spanning mesh:
    # per-library results identical on every host and equal to this
    # process's own 8-device serving pass
    from barcoder_tpu.parallel.sharded_scan import sharded_scan_many

    libs = []
    for i in range(4):
        rng_i = np.random.default_rng(100 + i)
        libs.append([random_seq(20, rng_i) for _ in range(3)])
    libs[0][0] = spacers[0]
    many = sharded_scan_many(
        libs, contig, 1, pam="NGG", mesh=mesh, P=256, max_pending=2
    )
    expect_many = [
        sorted(zip(hm.spacer_idx.tolist(), hm.pos.tolist(),
                   hm.strand.tolist(), hm.mismatches.tolist()))
        for hm in many
    ]
    assert sum(len(e) for e in expect_many) >= 1
    for r in worker_results:
        got = [[tuple(t) for t in lib_hits] for lib_hits in r["serving_many"]]
        assert got == [[tuple(t) for t in e] for e in expect_many], (
            f"process {r['process_index']} serving_many"
        )

    # the full targets pipeline over the process-spanning mesh: every host
    # computed the identical final table, equal to this process's own
    import hashlib

    from barcoder_tpu.core.genome import Genome
    from barcoder_tpu.pipeline.targets import run_targets
    from barcoder_tpu.seqio.library import BarcodeLibrary

    lib = BarcodeLibrary.from_list(spacers)
    tr = run_targets(lib, Genome(contigs=[contig]), "NGG", 1, backend="sharded")
    digest = hashlib.blake2b(
        tr.table.to_csv(sep="\t", index=False, na_rep="None").encode(),
        digest_size=12,
    ).hexdigest()
    assert len(tr.table) >= 5
    for r in worker_results:
        assert r["targets_tsv_digest"] == digest


@pytest.mark.slow
def test_counts_match_single_process(worker_results):
    from barcoder_tpu.pipeline.heuristic_count import CountConfig, VectorCounter

    from .test_heuristic_count import (
        L_FLANK, PREFIX, R_FLANK, make_barcodes, make_reads,
    )

    barcodes = make_barcodes(n=10, seed=2)
    reads1, _, _ = make_reads(barcodes, n_reads=777, seed=2)
    cfg = CountConfig(
        barcodes=set(barcodes), bc_len=20,
        L_fwd=L_FLANK, R_fwd=R_FLANK, L_rev=None, R_rev=None,
        L_fwd_start=len(PREFIX), L_rev_start=None, need_swap=False,
    )
    vc = VectorCounter(cfg)
    vc.process_chunk((reads1, None))
    doc, undoc = vc.results()
    # every host holds the identical GLOBAL psum-merged documented counts
    # and reports the GLOBAL read total (no double counting: both workers
    # fed the identical full stream)
    for r in worker_results:
        assert Counter(dict(r["counts"])) == doc, f"process {r['process_index']}"
        assert r["total_reads"] == len(reads1)
    # undocumented reads resolve host-locally; the union over hosts is the
    # single-process undoc tally
    merged = Counter()
    for r in worker_results:
        merged.update(dict(r["undoc_local"]))
    assert merged == undoc


@pytest.mark.slow
def test_targets_cli_multihost_env(tmp_path):
    """The DOCUMENTED user flow: two `python -m barcoder_tpu targets ...`
    processes with identical argv, joined only by the
    BARCODER_TPU_COORDINATOR/_NUM_PROCESSES/_PROCESS_ID env vars
    (cli/main._join_cluster). Both hosts must exit 0 with identical TSV on
    stdout, equal to a plain single-process run."""
    from barcoder_tpu.seqio.genbank import write_genbank

    from .genomes import make_record, plant_guide, random_seq

    rng = np.random.default_rng(3)
    rec = make_record(n=6000, topology="circular", seed=3, n_genes=5)
    guides = [random_seq(20, rng) for _ in range(4)]
    for i, g in enumerate(guides):
        plant_guide(rec, g, 600 + 1200 * i, pam="TGG")
    write_genbank([rec], tmp_path / "g.gb")
    with open(tmp_path / "lib.fasta", "w") as fh:
        for i, g in enumerate(guides):
            fh.write(f">g{i}\n{g}\n")
    argv = [sys.executable, "-m", "barcoder_tpu", "targets",
            str(tmp_path / "lib.fasta"), str(tmp_path / "g.gb"), "NGG", "1",
            "--backend", "sharded"]
    base_env = dict(os.environ, JAX_PLATFORMS="cpu")
    base_env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(base_env,
                   BARCODER_TPU_COORDINATOR=f"localhost:{port}",
                   BARCODER_TPU_NUM_PROCESSES="2",
                   BARCODER_TPU_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(
            argv, env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    outs = []
    for p in procs:
        try:
            stdout, stderr = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, stderr[-3000:]
        # cli.main._shield_stdout reroutes the Gloo CPU-collective banners
        # (native fd-1 writes) to stderr, so stdout must be EXACTLY the TSV
        outs.append(stdout)
    single = subprocess.run(argv, env=base_env, cwd=REPO, timeout=420,
                            capture_output=True, text=True)
    assert single.returncode == 0, single.stderr[-3000:]
    assert outs[0] == outs[1] == single.stdout
    assert all(g in outs[0] for g in guides)


@pytest.mark.slow
def test_count_cli_multihost_env(tmp_path):
    """The `count` twin of the targets CLI flow (VERDICT r4 item 2): two
    `python -m barcoder_tpu count ...` processes with identical argv,
    joined only by the env vars, must print byte-identical stdout
    (including every documented barcode line) equal to a single-process
    run — the host-local undocumented tallies are gathered inside
    run_count so the collated output is global on every host."""
    from .test_heuristic_count import make_barcodes, write_run_count_fastq

    barcodes = make_barcodes(n=10, seed=2)
    fq = tmp_path / "reads.fastq"
    write_run_count_fastq(fq, barcodes)
    with open(tmp_path / "bc.fasta", "w") as fh:
        for i, b in enumerate(barcodes):
            fh.write(f">b{i}\n{b}\n")
    argv = [sys.executable, "-m", "barcoder_tpu", "count",
            str(tmp_path / "bc.fasta"), str(fq)]
    base_env = dict(os.environ, JAX_PLATFORMS="cpu")
    base_env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(base_env,
                   BARCODER_TPU_COORDINATOR=f"localhost:{port}",
                   BARCODER_TPU_NUM_PROCESSES="2",
                   BARCODER_TPU_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(
            argv, env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    outs = []
    for p in procs:
        try:
            stdout, stderr = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, stderr[-3000:]
        # _shield_stdout keeps Gloo banners off stdout (see the targets twin)
        outs.append(stdout)
    single = subprocess.run(argv, env=base_env, cwd=REPO, timeout=420,
                            capture_output=True, text=True)
    assert single.returncode == 0, single.stderr[-3000:]
    assert outs[0] == outs[1] == single.stdout
    assert all(b in outs[0] for b in barcodes)


@pytest.mark.slow
def test_run_count_driver_matches_single_process(worker_results, tmp_path):
    """The FULL run_count driver (sampling + reader + chunk loop) with the
    sharded engine over CHUNK OWNERSHIP (VERDICT r4 item 1): each host
    parses a disjoint chunk subset that sums to the whole stream, engine
    'auto' selects sharded under multi-process, and every host reports the
    identical GLOBAL doc AND undoc counts (undoc gathered over DCN)."""
    from barcoder_tpu.pipeline.heuristic_count import run_count

    from .test_heuristic_count import make_barcodes, write_run_count_fastq

    barcodes = make_barcodes(n=10, seed=2)
    fq = tmp_path / "rc.fastq"
    write_run_count_fastq(fq, barcodes)
    doc, undoc, total, _ = run_count(
        set(barcodes), str(fq), engine="vector", chunk_size=256
    )
    assert sum(undoc.values()) > 0  # the undoc merge path is not vacuous
    for r2 in worker_results:
        assert r2["run_count_engine"] == "sharded"  # auto picked sharded
        assert Counter(dict(r2["run_count"])) == doc
        assert r2["run_count_total"] == total
        # merged undoc identical on EVERY host (not a per-host partial)
        assert Counter(dict(r2["run_count_undoc"])) == undoc
    # input sharding proof: hosts parsed disjoint, non-trivial chunk
    # subsets covering the full stream exactly once
    owned = [r2["run_count_owned_reads"] for r2 in worker_results]
    assert all(o > 0 for o in owned)
    assert sum(owned) == total


@pytest.mark.slow
def test_paired_run_count_owned(worker_results, tmp_path):
    """PAIRED run_count through the multi-host owned path: the revcomp
    consistency check, both flank windows, and the undoc slicing all run
    on owning hosts only — results must equal a single-process run and
    the hosts must split the parse work."""
    from barcoder_tpu.pipeline.heuristic_count import run_count

    from .genomes import random_seq
    from .test_heuristic_count import make_barcodes, make_reads, write_reads

    barcodes = make_barcodes(n=10, seed=2)
    reads1, reads2, _t = make_reads(
        barcodes, n_reads=1300, seed=9,
        undocumented=[random_seq(20, np.random.default_rng(55))],
    )
    f1, f2 = tmp_path / "p1.fastq", tmp_path / "p2.fastq"
    write_reads(f1, reads1), write_reads(f2, reads2)
    doc, undoc, total, _ = run_count(
        set(barcodes), str(f1), str(f2), engine="vector", chunk_size=256
    )
    assert sum(undoc.values()) > 0
    for r in worker_results:
        assert Counter(dict(r["run_count_paired"])) == doc
        assert Counter(dict(r["run_count_paired_undoc"])) == undoc
        assert r["run_count_paired_total"] == total
    owned = [r["run_count_paired_owned"] for r in worker_results]
    assert all(o > 0 for o in owned) and sum(owned) == total


@pytest.mark.slow
def test_multihost_distill(worker_results):
    """Multi-host distill (VERDICT r4 item 7): hosts spill DISJOINT chunk
    subsets covering the whole stream (the sort+zstd bound divided by K),
    host 0 merges, and the outputs equal a single-process distill
    byte-for-byte at the line level."""
    from .test_distill import make_distill_reads, read_zst_lines

    r1, r2 = make_distill_reads()
    want = sorted(zip(r1, r2))
    outs = worker_results[0]["distill_outputs"]
    assert worker_results[1]["distill_outputs"] == outs
    got1, got2 = read_zst_lines(outs[0]), read_zst_lines(outs[1])
    assert got1 == [a for a, _ in want]
    assert got2 == [b for _, b in want]
    spilled = [set(r["distill_spilled_chunks"]) for r in worker_results]
    assert spilled[0] and spilled[1]  # both hosts did real sort work
    assert spilled[0].isdisjoint(spilled[1])
    n_chunks = -(-len(r1) // 128)
    assert spilled[0] | spilled[1] == set(range(n_chunks))


@pytest.mark.slow
def test_multihost_checkpoint_agreement(worker_results):
    """ADVICE r4 (medium): per-host checkpoints at DIFFERENT chunk_no must
    be discarded in agreement (no double counting, no collective desync);
    checkpoints at the SAME chunk_no with genuine partial state must
    resume and land on the full-run result."""
    for r in worker_results:
        assert r["ckpt_disagree_matches"], f"process {r['process_index']}"
        assert r["ckpt_resume_matches"], f"process {r['process_index']}"


@pytest.mark.slow
def test_multihost_flush_windows(worker_results):
    """Mid-stream lockstep flush windows (dispatch buffer smaller than
    the stream): the feed_owned threshold branch must actually FIRE
    (instrumented: two non-empty 512-row threshold flushes per host
    before the final drain) and global counts must be unchanged; the
    separate checkpoint_every=2 run pins lockstep save/drain
    interleaving."""
    for r in worker_results:
        assert r["flush_windows_match"], f"process {r['process_index']}"
        assert r["ckpt_interleave_match"], f"process {r['process_index']}"
        # the first flush is the mid-stream THRESHOLD flush at exactly
        # 512 buffered rows (proving feed_owned's trigger branch ran);
        # the second is the final drain of the remaining tail
        assert r["flush_rows"][0] == 512, r["flush_rows"]
        assert len(r["flush_rows"]) == 2, r["flush_rows"]


@pytest.mark.slow
def test_paired_counts_match_single_process(worker_results):
    from barcoder_tpu.pipeline.heuristic_count import VectorCounter

    from .genomes import random_seq
    from .test_heuristic_count import make_barcodes, make_reads, paired_cfg

    barcodes = make_barcodes(n=10, seed=2)
    undoc_bc = [random_seq(20, np.random.default_rng(77))]
    reads1, reads2, _ = make_reads(
        barcodes, n_reads=501, seed=3, undocumented=undoc_bc
    )
    vc = VectorCounter(paired_cfg(barcodes))
    vc.process_chunk((reads1, reads2))
    doc, undoc = vc.results()
    assert sum(doc.values()) > 400  # the paired geometry actually matches
    assert sum(undoc.values()) > 10  # undoc slicing path is NOT vacuous
    for r in worker_results:
        assert Counter(dict(r["counts_paired"])) == doc
    merged = Counter()
    for r in worker_results:
        merged.update(dict(r["undoc_paired_local"]))
    assert merged == undoc
