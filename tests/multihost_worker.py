"""Worker process for tests/test_multihost.py.

Joins a small multi-process CPU cluster (jax.distributed over a localhost
coordinator, N fake devices per process set by the parent via XLA_FLAGS),
then runs the UNCHANGED sharded engines over the process-spanning global
mesh and dumps the results as JSON for the parent to compare against its
own single-process 8-device run.

Usage: python tests/multihost_worker.py <process_id> <num_processes> <port> <out.json>
"""

import json
import sys


def main() -> None:
    pid, nproc, port, out_path = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    )
    import jax

    # force CPU like tests/conftest.py
    jax.config.update("jax_platforms", "cpu")
    from barcoder_tpu.parallel import multihost

    assert multihost.initialize(f"localhost:{port}", nproc, pid)
    assert jax.process_count() == nproc
    n_global = jax.device_count()

    import numpy as np

    from barcoder_tpu.core.genome import contig_from_record
    from barcoder_tpu.parallel.mesh import make_mesh
    from barcoder_tpu.parallel.sharded_scan import sharded_scan
    from tests.genomes import make_record, plant_guide, random_seq

    # the same deterministic scan case as tests/test_parallel.py
    # TestShardedScan.test_agreement — every process builds it identically
    rng = np.random.default_rng(0)
    rec = make_record(n=9000, topology="circular", seed=0)
    spacers = [random_seq(20, rng) for _ in range(5)]
    for i, s in enumerate(spacers):
        plant_guide(rec, s, 700 + 1500 * i, pam="TGG", strand="F" if i % 2 else "R")
    contig = contig_from_record(rec)

    mesh = make_mesh()  # spans ALL processes' devices
    assert mesh.devices.size == n_global
    res = {"process_index": jax.process_index(), "n_global_devices": n_global}
    for site_mode in ("auto", "never"):
        h = sharded_scan(
            spacers, contig, 1, pam="NGG", mesh=mesh, P=256, site_mode=site_mode
        )
        res[f"hits_{site_mode}"] = sorted(
            zip(h.spacer_idx.tolist(), h.pos.tolist(),
                h.strand.tolist(), h.mismatches.tolist())
        )

    # 2-D (library, genome) mesh with the LIBRARY axis crossing the process
    # boundary: each host holds different spacer rows (the TP analog over
    # DCN), genome tiles within each library row
    from barcoder_tpu.parallel.mesh import make_mesh_2d

    h = sharded_scan(
        spacers, contig, 2, pam="NGG", mesh=make_mesh_2d(2), P=256
    )
    res["hits_2d"] = sorted(
        zip(h.spacer_idx.tolist(), h.pos.tolist(),
            h.strand.tolist(), h.mismatches.tolist())
    )

    # the FULL targets pipeline (scan + locus join + postprocess) through
    # the sharded backend on the process-spanning mesh: plain SPMD — every
    # host computes the identical final table
    from barcoder_tpu.core.genome import Genome
    from barcoder_tpu.pipeline.targets import run_targets
    from barcoder_tpu.seqio.library import BarcodeLibrary

    lib = BarcodeLibrary.from_list(spacers)
    tr = run_targets(lib, Genome(contigs=[contig]), "NGG", 1, backend="sharded")
    res["targets_tsv_digest"] = __import__("hashlib").blake2b(
        tr.table.to_csv(sep="\t", index=False, na_rep="None").encode(),
        digest_size=12,
    ).hexdigest()

    # batched SERVING over the process-spanning mesh: every library's
    # fused program dispatched before any fetch, windowed collect — the
    # dispatch/collect order is identical on every host (input order), so
    # the pipelining stays lockstep across processes
    from barcoder_tpu.parallel.sharded_scan import sharded_scan_many

    libs = []
    for i in range(4):
        rng_i = np.random.default_rng(100 + i)
        libs.append([random_seq(20, rng_i) for _ in range(3)])
    libs[0][0] = spacers[0]  # at least one planted guide in the set
    many = sharded_scan_many(
        libs, contig, 1, pam="NGG", mesh=mesh, P=256, max_pending=2
    )
    res["serving_many"] = [
        sorted(zip(hm.spacer_idx.tolist(), hm.pos.tolist(),
                   hm.strand.tolist(), hm.mismatches.tolist()))
        for hm in many
    ]

    # ShardedCounter over the global mesh: every process feeds the SAME
    # full chunk stream (plain SPMD — identical argv on each host); the
    # engine slices equal per-host row windows internally and the psum
    # leaves every host the whole-read-set documented counts
    from barcoder_tpu.parallel.sharded_count import ShardedCounter, make_read_mesh
    from barcoder_tpu.pipeline.heuristic_count import CountConfig
    from tests.test_heuristic_count import (
        L_FLANK, PREFIX, R_FLANK, make_barcodes, make_reads,
    )

    barcodes = make_barcodes(n=10, seed=2)
    # 777 is odd on purpose: the equal-width window padding path runs
    reads1, _, _truth = make_reads(barcodes, n_reads=777, seed=2)
    cfg = CountConfig(
        barcodes=set(barcodes), bc_len=20,
        L_fwd=L_FLANK, R_fwd=R_FLANK, L_rev=None, R_rev=None,
        L_fwd_start=len(PREFIX), L_rev_start=None, need_swap=False,
    )
    sc = ShardedCounter(cfg, mesh=make_read_mesh())
    sc.process_chunk((reads1, None))
    doc, undoc = sc.results()
    res["total_reads"] = sc.total_reads

    # paired-end: revcomp-consistency + both flank sides run through the
    # same per-host row slicing; undocumented barcodes planted so the
    # per-host undoc-window union is NOT vacuous
    from tests.genomes import random_seq as _rs
    from tests.test_heuristic_count import paired_cfg

    undoc_bc = [_rs(20, np.random.default_rng(77))]
    reads1p, reads2p, _t = make_reads(
        barcodes, n_reads=501, seed=3, undocumented=undoc_bc
    )
    scp = ShardedCounter(paired_cfg(barcodes), mesh=make_read_mesh())
    scp.process_chunk((reads1p, reads2p))
    doc_p, undoc_p = scp.results()
    res["counts_paired"] = sorted(doc_p.items())
    res["undoc_paired_local"] = sorted(undoc_p.items())
    res["counts"] = sorted(doc.items())
    res["undoc_local"] = sorted(undoc.items())

    # the FULL run_count driver (sampling + reader + chunk loop) with the
    # sharded engine over CHUNK OWNERSHIP: each host parses only its own
    # chunks (i mod K), dispatches stay lockstep from the shared scan, and
    # every host must report the identical GLOBAL doc+undoc counts
    import os
    import tempfile

    from barcoder_tpu.pipeline.heuristic_count import run_count
    from tests.test_heuristic_count import write_run_count_fastq

    fq_dir = os.environ.get("MH_WORKER_TMP") or tempfile.gettempdir()
    fq = os.path.join(fq_dir, "mh_run_count.fastq")
    if pid == 0:  # one writer; content is deterministic either way
        write_run_count_fastq(fq + ".tmp", barcodes)
        os.replace(fq + ".tmp", fq)
    else:
        import time

        for _ in range(200):
            if os.path.exists(fq):
                break
            time.sleep(0.1)
    # engine="auto" must select sharded under multi-process; chunk_size=256
    # gives 6 chunks so both hosts own several
    doc_rc, undoc_rc, total_rc, info_rc = run_count(
        set(barcodes), fq, engine="auto", chunk_size=256
    )
    res["run_count"] = sorted(doc_rc.items())
    res["run_count_total"] = total_rc
    res["run_count_undoc"] = sorted(undoc_rc.items())
    res["run_count_engine"] = info_rc["engine"]
    res["run_count_owned_reads"] = info_rc["owned_reads"]

    # mid-stream lockstep flush windows: shrink the dispatch buffer so the
    # _DISPATCH_ROWS threshold flush in feed_owned actually fires
    # mid-stream (the production geometry at millions of reads).
    # Instrument flush_owned to prove the threshold branch ran: with
    # chunk_size=256, K=2, threshold 512 and NO checkpoint drains, each
    # owner's buffer reaches 512 after its 2nd owned chunk → exactly two
    # non-empty threshold flushes before the final drain.
    from barcoder_tpu.parallel.sharded_count import ShardedCounter as _SC

    flush_rows: list = []
    orig_flush = _SC.flush_owned

    def counting_flush(self):
        if self._owned_mode and self._owned_rows is not None:
            m = int(self._owned_rows.max())
            if m > 0:
                flush_rows.append(m)
        return orig_flush(self)

    old_rows = _SC._DISPATCH_ROWS
    _SC._DISPATCH_ROWS = 512
    _SC.flush_owned = counting_flush
    try:
        doc_f, undoc_f, total_f, _ = run_count(
            set(barcodes), fq, engine="sharded", chunk_size=256
        )
    finally:
        _SC._DISPATCH_ROWS = old_rows
        _SC.flush_owned = orig_flush
    res["flush_windows_match"] = (
        sorted(doc_f.items()) == res["run_count"]
        and sorted(undoc_f.items()) == res["run_count_undoc"]
        and total_f == total_rc
    )
    res["flush_rows"] = flush_rows  # threshold flushes at exactly 512

    # ...and separately, mid-stream CHECKPOINT drains every 2 chunks
    # (lockstep save/drain interleaving with the owned feed)
    doc_c, undoc_c, total_c, _ = run_count(
        set(barcodes), fq, engine="sharded", chunk_size=256,
        checkpoint_path=os.path.join(fq_dir, "mh_ck_flush.npz"),
        checkpoint_every=2,
    )
    res["ckpt_interleave_match"] = (
        sorted(doc_c.items()) == res["run_count"]
        and sorted(undoc_c.items()) == res["run_count_undoc"]
        and total_c == total_rc
    )

    # PAIRED multi-host run_count through the owned path: both mates are
    # chunk-owned, revcomp-consistency and both flank sides run on the
    # owning host only
    from tests.test_heuristic_count import make_reads, write_reads

    reads1mh, reads2mh, _tr = make_reads(
        barcodes, n_reads=1300, seed=9,
        undocumented=[_rs(20, np.random.default_rng(55))],
    )
    fq1p = os.path.join(fq_dir, "mh_rc_p1.fastq")
    fq2p = os.path.join(fq_dir, "mh_rc_p2.fastq")
    if pid == 0:
        write_reads(fq1p + ".tmp", reads1mh)
        write_reads(fq2p + ".tmp", reads2mh)
        os.replace(fq1p + ".tmp", fq1p)
        os.replace(fq2p + ".tmp", fq2p)
    else:
        import time

        for _ in range(200):
            if os.path.exists(fq1p) and os.path.exists(fq2p):
                break
            time.sleep(0.1)
    doc_p2, undoc_p2, total_p2, info_p2 = run_count(
        set(barcodes), fq1p, fq2p, engine="sharded", chunk_size=256
    )
    res["run_count_paired"] = sorted(doc_p2.items())
    res["run_count_paired_undoc"] = sorted(undoc_p2.items())
    res["run_count_paired_total"] = total_p2
    res["run_count_paired_owned"] = info_p2["owned_reads"]

    # ---- multi-host checkpoint/resume (ADVICE r4 medium) ----
    from barcoder_tpu.pipeline.heuristic_count import (
        _CheckpointState, discover_config,
    )

    bset = set(barcodes)
    _sample, cfg = discover_config(bset, fq, None, False)

    # (a) DISAGREEING per-host resume points (a crash between hosts'
    # saves): every host must detect the mismatch, discard, and recount
    # from scratch — results identical to the checkpoint-free run
    ck_a = os.path.join(fq_dir, f"mh_ck_a.npz.p{pid}")
    bad = ShardedCounter(cfg, mesh=make_read_mesh())
    _CheckpointState(ck_a, cfg).save(bad, 4 if pid == 0 else 8)
    doc_a, undoc_a, total_a, _ = run_count(
        bset, fq, engine="sharded", chunk_size=256,
        checkpoint_path=os.path.join(fq_dir, "mh_ck_a.npz"),
    )
    res["ckpt_disagree_matches"] = (
        sorted(doc_a.items()) == res["run_count"]
        and sorted(undoc_a.items()) == res["run_count_undoc"]
        and total_a == total_rc
    )

    # (b) AGREEING genuine partial state: both hosts count chunks 1..4 via
    # the owned feed, save at the same chunk_no, then run_count must
    # resume at chunk 5 and land on the full-run result
    from barcoder_tpu.seqio.fast_reader import iter_owned_matrix_chunks

    part = ShardedCounter(cfg, mesh=make_read_mesh())
    for chunk_idx, nrec, r1, _r2 in iter_owned_matrix_chunks(
        fq, None, 256, owner=pid, num_owners=nproc
    ):
        if chunk_idx >= 4:
            break
        part.feed_owned(chunk_idx, nrec, r1[0] if r1 else None, None)
    ck_b = os.path.join(fq_dir, "mh_ck_b.npz")
    _CheckpointState(ck_b + f".p{pid}", cfg).save(part, 4)
    doc_b, undoc_b, total_b, _ = run_count(
        bset, fq, engine="sharded", chunk_size=256, checkpoint_path=ck_b,
    )
    res["ckpt_resume_matches"] = (
        sorted(doc_b.items()) == res["run_count"]
        and sorted(undoc_b.items()) == res["run_count_undoc"]
        and total_b == total_rc
    )

    # ---- multi-host distill (VERDICT r4 item 7): chunk-owned per-host
    # spill runs into the shared checkpoint dir, host-0 k-way merge;
    # outputs must be byte-identical to a single-process distill
    from barcoder_tpu.pipeline.distill import distill_reads
    from tests.test_distill import make_distill_reads

    d1 = os.path.join(fq_dir, "mh_distill_r1.fastq")
    d2 = os.path.join(fq_dir, "mh_distill_r2.fastq")
    if pid == 0:
        r1, r2 = make_distill_reads()
        for p, reads in ((d1, r1), (d2, r2)):
            with open(p + ".tmp", "w") as fh:
                for i, rd in enumerate(reads):
                    fh.write(f"@d{i}\n{rd}\n+\n{'I' * len(rd)}\n")
            os.replace(p + ".tmp", p)
    else:
        import time

        for _ in range(200):
            if os.path.exists(d1) and os.path.exists(d2):
                break
            time.sleep(0.1)

    class _CapLog:
        def __init__(self):
            self.msgs = []

        def info(self, m):
            self.msgs.append(str(m))

        warn = info

    cap = _CapLog()
    outs = [os.path.join(fq_dir, "mh_distill_out1.reads.zst"),
            os.path.join(fq_dir, "mh_distill_out2.reads.zst")]
    got = distill_reads(
        [d1, d2], outs, chunk_size=128, log=cap,
        checkpoint_dir=os.path.join(fq_dir, "mh_distill_ckpt"),
    )
    res["distill_outputs"] = got
    res["distill_spilled_chunks"] = sorted(
        int(m.split("spilled chunk ")[1].split()[0])
        for m in cap.msgs if "spilled chunk" in m
    )

    with open(out_path, "w") as fh:
        json.dump(res, fh)


if __name__ == "__main__":
    main()
