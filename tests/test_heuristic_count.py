"""heuristicount workload tests: simulated read sets with known truth;
vectorized engine vs the per-read reference port."""

import gzip
from collections import Counter

import numpy as np
import pytest

from barcoder_tpu.core.encode import revcomp
from barcoder_tpu.pipeline.heuristic_count import (
    CountConfig,
    check_flank_complementarity,
    count_chunk_reference,
    find_flanks,
    rev_comp,
    run_count,
    sample_reads,
    validate_barcodes,
    VectorCounter,
)
from barcoder_tpu.seqio.fasta import write_fastq

from .genomes import random_seq

L_FLANK = "GGTAGCT"
R_FLANK = "CTTAAGC"
PREFIX = "ACGTG"  # bases before the left flank in each read


def make_barcodes(n=20, bc_len=20, seed=0):
    rng = np.random.default_rng(seed)
    out = set()
    while len(out) < n:
        out.add(random_seq(bc_len, rng))
    return sorted(out)


TAIL = "TCCATGGA"  # constant vector context after the right flank


def make_reads(barcodes, n_reads=2000, seed=1, paired=True, undocumented=None,
               n_frac=0.0, random_tail=False):
    """Reads: PREFIX + L_FLANK + barcode + R_FLANK + tail; mate =
    revcomp(read). The context is constant (like a real amplicon construct)
    so flank discovery converges on small samples — the reference's
    extract_best_flank needs *strictly* >3x support to shorten a flank
    (heuristicount.py:405-421)."""
    rng = np.random.default_rng(seed)
    reads1, reads2 = [], []
    truth = Counter()
    undocumented = undocumented or []
    pool = list(barcodes) + undocumented
    for i in range(n_reads):
        bc = pool[rng.integers(0, len(pool))]
        tail = random_seq(8, rng) if random_tail else TAIL
        read = PREFIX + L_FLANK + bc + R_FLANK + tail
        if n_frac and rng.random() < n_frac:
            k = rng.integers(0, len(read))
            read = read[:k] + "N" + read[k + 1 :]
        else:
            truth[bc] += 1
        reads1.append(read)
        reads2.append(revcomp(read))
    return reads1, reads2, truth


def write_reads(path, reads):
    write_fastq([(f"r{i}", r) for i, r in enumerate(reads)], path, quality=35)


def write_run_count_fastq(path, barcodes, n=1500, undoc_every=97):
    """The deterministic multi-chunk FASTQ shared by the multi-host worker
    and its parent asserts (tests/multihost_worker.py): mostly documented
    reads plus a fixed undocumented barcode every ``undoc_every`` rows so
    the cross-host undoc merge path is not vacuous."""
    pre, tail = "ACGTG", "TCCATGGA"
    undoc_bc = "ACACGTGTACACGTGTACAC"
    assert undoc_bc not in set(barcodes)
    rng = np.random.default_rng(6)
    with open(path, "w") as fh:
        for j, i in enumerate(rng.integers(0, len(barcodes), size=n)):
            bc = undoc_bc if j % undoc_every == 0 else barcodes[i]
            rd = pre + L_FLANK + bc + R_FLANK + tail
            fh.write(f"@r\n{rd}\n+\n{'I' * len(rd)}\n")


class TestHelpers:
    def test_rev_comp(self):
        assert rev_comp("ACGTN") == "NACGT"

    def test_validate_barcodes(self):
        with pytest.raises(ValueError):
            validate_barcodes({"ACGT"})
        validate_barcodes(set(make_barcodes(10)))

    def test_find_flanks_recovers_planted(self):
        barcodes = make_barcodes()
        reads1, _, _ = make_reads(barcodes, n_reads=300)
        start = len(PREFIX) + len(L_FLANK)
        L, R = find_flanks(reads1, start, 20)
        # flanks recovered up to the max_flank=10 window of constant context
        assert L == (PREFIX + L_FLANK)[-10:]
        assert R == (R_FLANK + TAIL)[:10]

    def test_flank_complementarity_consistent(self):
        # rev flanks seen on mate reads are revcomps of fwd flanks
        L_rev = rev_comp(R_FLANK)
        R_rev = rev_comp(L_FLANK)
        assert check_flank_complementarity(L_FLANK, R_FLANK, L_rev, R_rev) == []

    def test_flank_complementarity_violation(self):
        # L_rev revcomp'd is TTTT, which does not match R_fwd=CCCC
        assert check_flank_complementarity("AAAA", "CCCC", "AAAA", "CCCC")


class TestSampling:
    def test_sample_orientation_and_offset(self, tmp_path):
        barcodes = make_barcodes()
        reads1, reads2, _ = make_reads(barcodes, n_reads=1500)
        f1, f2 = tmp_path / "r1.fastq", tmp_path / "r2.fastq"
        write_reads(f1, reads1)
        write_reads(f2, reads2)
        s = sample_reads(str(f1), str(f2), set(barcodes), True)
        assert not s.need_swap
        assert s.bc_start1 == len(PREFIX) + len(L_FLANK)
        assert s.observed_barcodes
        assert s.num_chunks >= 1

    def test_sample_swapped_files(self, tmp_path):
        barcodes = make_barcodes()
        reads1, reads2, _ = make_reads(barcodes, n_reads=1500)
        f1, f2 = tmp_path / "r1.fastq", tmp_path / "r2.fastq"
        write_reads(f1, reads2)  # swapped on purpose
        write_reads(f2, reads1)
        s = sample_reads(str(f1), str(f2), set(barcodes), True)
        assert s.need_swap
        assert s.bc_start1 == len(PREFIX) + len(L_FLANK)

    def test_sample_unresolvable_raises(self, tmp_path):
        barcodes = make_barcodes()
        rng = np.random.default_rng(9)
        junk = [random_seq(50, rng) for _ in range(200)]
        f1 = tmp_path / "r1.fastq"
        write_reads(f1, junk)
        with pytest.raises(ValueError):
            sample_reads(str(f1), None, set(barcodes), False)


class TestCounting:
    def make_cfg(self, barcodes):
        return CountConfig(
            barcodes=set(barcodes),
            bc_len=20,
            L_fwd=(PREFIX + L_FLANK)[-10:],
            R_fwd=R_FLANK[:8],
            L_rev=rev_comp(R_FLANK)[-8:],
            R_rev=rev_comp((PREFIX + L_FLANK))[:10],
            L_fwd_start=len(PREFIX) + len(L_FLANK) - 10,
            L_rev_start=0,
            need_swap=False,
        )

    def test_vector_matches_reference_paired(self):
        barcodes = make_barcodes()
        reads1, reads2, _ = make_reads(
            barcodes, n_reads=1200, undocumented=[random_seq(20, np.random.default_rng(5))],
            n_frac=0.05,
        )
        # read2 = revcomp(read1): layout revcomp(tail)(8) + revcomp(R_FLANK)
        # (7) + revcomp(bc)(20) + ... → barcode starts at 15; L_rev window
        # starts at 15 - len(L_rev)
        cfg = self.make_cfg(barcodes)
        cfg.L_rev_start = 15 - len(cfg.L_rev)
        ref = Counter()
        total_ref = 0
        counts, n = count_chunk_reference((reads1, reads2), cfg)
        ref.update(counts)
        total_ref += n

        vc = VectorCounter(cfg)
        vc.process_chunk((reads1, reads2))
        doc, undoc = vc.results()
        ref_doc = Counter({k: v for k, v in ref.items() if not k.endswith("*")})
        ref_undoc = Counter({k: v for k, v in ref.items() if k.endswith("*")})
        assert doc == ref_doc
        assert undoc == ref_undoc
        assert sum(doc.values()) > 0
        assert sum(undoc.values()) > 0

    def test_vector_matches_reference_single(self):
        barcodes = make_barcodes()
        reads1, _, truth = make_reads(barcodes, n_reads=800, n_frac=0.02)
        cfg = self.make_cfg(barcodes)
        counts, _ = count_chunk_reference((reads1, None), cfg)
        vc = VectorCounter(cfg)
        vc.process_chunk((reads1, None))
        doc, undoc = vc.results()
        ref_doc = Counter({k: v for k, v in counts.items() if not k.endswith("*")})
        assert doc == ref_doc
        assert doc == truth

    def test_single_end_reverse_orientation(self):
        barcodes = make_barcodes()
        reads1, reads2, truth = make_reads(barcodes, n_reads=400)
        cfg = self.make_cfg(barcodes)
        cfg.L_rev_start = 15 - len(cfg.L_rev)
        cfg.need_swap = False
        counts, _ = count_chunk_reference((None, reads2), cfg)
        vc = VectorCounter(cfg)
        vc.process_chunk((None, reads2))
        doc, undoc = vc.results()
        ref_doc = Counter({k: v for k, v in counts.items() if not k.endswith("*")})
        assert doc == ref_doc
        assert doc == truth  # reported in fwd orientation


class TestEndToEnd:
    @pytest.mark.parametrize("engine", ["vector", "reference"])
    def test_run_count_paired(self, tmp_path, engine):
        barcodes = make_barcodes(n=15)
        undoc_bc = random_seq(20, np.random.default_rng(42))
        reads1, reads2, truth = make_reads(
            barcodes, n_reads=2500, undocumented=[undoc_bc]
        )
        f1, f2 = tmp_path / "r1.fastq", tmp_path / "r2.fastq"
        write_reads(f1, reads1)
        write_reads(f2, reads2)
        doc, undoc, total, info = run_count(set(barcodes), str(f1), str(f2), engine=engine)
        assert total == 2500
        for bc in doc:
            assert doc[bc] == truth[bc]
        assert sum(undoc.values()) == truth[undoc_bc]
        assert set(doc) == {b for b in barcodes if truth[b] > 0}

    def test_run_count_single_end_gz(self, tmp_path):
        barcodes = make_barcodes(n=12)
        reads1, _, truth = make_reads(barcodes, n_reads=1500)
        f1 = tmp_path / "r1.fastq.gz"
        with gzip.open(f1, "wt") as fh:
            write_fastq([(f"r{i}", r) for i, r in enumerate(reads1)], fh, quality=35)
        doc, undoc, total, info = run_count(set(barcodes), str(f1), engine="vector")
        assert total == 1500
        assert doc == truth

    def test_run_count_engines_agree(self, tmp_path):
        barcodes = make_barcodes(n=15)
        reads1, reads2, _ = make_reads(barcodes, n_reads=1800, n_frac=0.03)
        f1, f2 = tmp_path / "r1.fastq", tmp_path / "r2.fastq"
        write_reads(f1, reads1)
        write_reads(f2, reads2)
        a = run_count(set(barcodes), str(f1), str(f2), engine="vector")
        b = run_count(set(barcodes), str(f1), str(f2), engine="reference")
        assert a[0] == b[0]
        assert a[1] == b[1]
        assert a[2] == b[2]

    def test_cli(self, tmp_path, capsys):
        from barcoder_tpu.cli.count import main

        barcodes = make_barcodes(n=12)
        reads1, reads2, truth = make_reads(barcodes, n_reads=1500)
        f1, f2 = tmp_path / "r1.fastq", tmp_path / "r2.fastq"
        write_reads(f1, reads1)
        write_reads(f2, reads2)
        bc_fasta = tmp_path / "bc.fasta"
        bc_fasta.write_text("".join(f">{b}\n{b}\n" for b in barcodes))
        rc = main([str(bc_fasta), str(f1), str(f2)])
        assert rc == 0
        out = capsys.readouterr().out
        lines = [l for l in out.strip().splitlines() if l]
        parsed = dict(l.split("\t") for l in lines)
        for bc, cnt in parsed.items():
            assert truth[bc] == int(cnt)


class TestSamplingPrefilter:
    """The packed-key candidate prefilter in sample_reads must replay the
    reference's membership tests exactly (candidates are a superset; the
    original string tests decide) and fall back for unpackable barcodes."""

    def test_lowercase_kmer_does_not_match(self, tmp_path):
        # packing is case-insensitive (a superset source), but membership is
        # string equality: a lowercase copy of a barcode must not vote
        barcodes = make_barcodes()
        reads1, reads2, _ = make_reads(barcodes, n_reads=1200)
        lower = (PREFIX + L_FLANK + barcodes[0] + R_FLANK + TAIL).lower()
        reads1 = [lower] * 50 + reads1
        reads2 = [revcomp(lower)] * 50 + reads2
        f1, f2 = tmp_path / "r1.fastq", tmp_path / "r2.fastq"
        write_reads(f1, reads1)
        write_reads(f2, reads2)
        s = sample_reads(str(f1), str(f2), set(barcodes), True)
        assert s.bc_start1 == len(PREFIX) + len(L_FLANK)
        assert not any(r.islower() for r in s.sample1)

    def test_n_barcode_falls_back_and_matches(self, tmp_path):
        # an N in a barcode defeats 2-bit packing -> unfiltered loop; the
        # N-containing barcode still matches by string equality
        barcodes = make_barcodes()
        bc_n = "N" + barcodes[0][1:]
        all_bcs = set(barcodes) | {bc_n}
        pool = []
        for bc in barcodes:
            pool.extend([bc, bc_n])  # interleave so sampling sees bc_n early
        reads = [PREFIX + L_FLANK + bc + R_FLANK + TAIL for bc in pool * 30]
        f1 = tmp_path / "r1.fastq"
        write_reads(f1, reads)
        s = sample_reads(str(f1), None, all_bcs, False)
        assert s.bc_start1 == len(PREFIX) + len(L_FLANK)
        assert bc_n in s.observed_barcodes

    def test_prefilter_matches_unfiltered_result(self, tmp_path, monkeypatch):
        # same inputs through both paths -> identical SampleResult fields
        import barcoder_tpu.pipeline.heuristic_count as hc

        barcodes = make_barcodes(n=15)
        reads1, reads2, _ = make_reads(barcodes, n_reads=400, seed=7)
        f1, f2 = tmp_path / "r1.fastq", tmp_path / "r2.fastq"
        write_reads(f1, reads1)
        write_reads(f2, reads2)
        fast = sample_reads(str(f1), str(f2), set(barcodes), True)
        monkeypatch.setattr(
            hc, "_pack_strings",
            lambda seqs: np.full(len(seqs), hc._KEY_SENTINEL, np.uint64),
        )  # force the fallback path
        slow = sample_reads(str(f1), str(f2), set(barcodes), True)
        assert fast.bc_start1 == slow.bc_start1
        assert fast.bc_start2 == slow.bc_start2
        assert fast.sample1 == slow.sample1
        assert fast.sample2 == slow.sample2
        assert fast.observed_barcodes == slow.observed_barcodes
        assert fast.new_reads_sampled == slow.new_reads_sampled
        assert fast.num_chunks == slow.num_chunks


class TestDeviceEngine:
    """DeviceCounter (device-resident matching; one-hot matmul) must agree
    exactly with VectorCounter on every data shape. Runs on the CPU jax
    backend in tests."""

    def _run_both(self, tmp_path, paired, seed=3, undocumented=None):
        from barcoder_tpu.pipeline.heuristic_count import run_count

        barcodes = make_barcodes(n=25, seed=seed)
        reads1, reads2, truth = make_reads(
            barcodes, n_reads=3000, seed=seed, undocumented=undocumented or [],
        )
        f1, f2 = tmp_path / "r1.fastq", tmp_path / "r2.fastq"
        write_reads(f1, reads1)
        write_reads(f2, reads2)
        args = (set(barcodes), str(f1), str(f2) if paired else None)
        doc_v, undoc_v, n_v, _ = run_count(*args, engine="vector")
        doc_d, undoc_d, n_d, info = run_count(*args, engine="device")
        assert info["engine"] == "device"
        assert n_v == n_d
        assert doc_v == doc_d
        assert undoc_v == undoc_d
        return doc_d, undoc_d, truth

    def test_single_end_agrees(self, tmp_path):
        doc, _, truth = self._run_both(tmp_path, paired=False)
        assert doc == truth

    def test_paired_agrees(self, tmp_path):
        doc, _, truth = self._run_both(tmp_path, paired=True)
        assert doc == truth

    def test_undocumented_agrees(self, tmp_path):
        undoc_bc = [random_seq(20, np.random.default_rng(99)) for _ in range(2)]
        doc, undoc, _ = self._run_both(tmp_path, paired=False, undocumented=undoc_bc)
        assert sum(undoc.values()) > 0
        assert all(k.endswith("*") for k in undoc)

    def test_dispatch_worker_error_surfaces(self, tmp_path, monkeypatch):
        """A dispatch failure on the worker thread must raise on the
        caller thread (at the next flush or drain), never hang, and the
        counter must not silently discard the rest of the stream."""
        from barcoder_tpu.pipeline.heuristic_count import DeviceCounter

        boom = RuntimeError("injected dispatch failure")

        def bad_dispatch(self, *a, **k):
            raise boom

        monkeypatch.setattr(DeviceCounter, "_device_match_async", bad_dispatch)
        monkeypatch.setattr(DeviceCounter, "_DISPATCH_ROWS", 256)
        from .test_heuristic_count import make_barcodes  # self-import ok

        barcodes = make_barcodes(n=12, seed=7)
        reads1, _, _ = make_reads(barcodes, n_reads=2000, seed=7)
        f1 = tmp_path / "r1.fastq"
        write_reads(f1, reads1)
        from barcoder_tpu.pipeline.heuristic_count import run_count

        with pytest.raises(RuntimeError, match="injected dispatch"):
            run_count(set(barcodes), str(f1), engine="device", chunk_size=256)
        # the error path must also tear the worker down (vc.abort())
        import threading

        assert not [
            t for t in threading.enumerate() if t.name == "count-dispatch"
        ]

    def test_abort_on_midstream_reader_error(self, tmp_path, monkeypatch):
        """A reader error mid-stream (paired-end length mismatch) must
        tear the dispatch worker down via run_count's vc.abort() path —
        without it every failed call in a long-lived API process leaks a
        daemon thread blocked on q.get() plus its pinned batch buffers."""
        import threading

        from barcoder_tpu.pipeline.heuristic_count import (
            DeviceCounter,
            run_count,
        )

        monkeypatch.setattr(DeviceCounter, "_DISPATCH_ROWS", 256)
        barcodes = make_barcodes(n=12, seed=9)
        reads1, reads2, _ = make_reads(barcodes, n_reads=2000, seed=9)
        f1, f2 = tmp_path / "r1.fastq", tmp_path / "r2.fastq"
        write_reads(f1, reads1)
        write_reads(f2, reads2[:1200])  # pair mismatch hits mid-stream
        with pytest.raises(ValueError, match="paired-end"):
            run_count(
                set(barcodes), str(f1), str(f2), engine="device",
                chunk_size=256,
            )
        assert not [
            t for t in threading.enumerate() if t.name == "count-dispatch"
        ]

    def test_dispatch_worker_stops_after_drain(self, tmp_path):
        """The worker thread must not outlive a drain (a long-lived loop
        closure would pin the counter + its device arrays forever)."""
        import threading

        from barcoder_tpu.pipeline.heuristic_count import run_count

        barcodes = make_barcodes(n=12, seed=8)
        reads1, _, truth = make_reads(barcodes, n_reads=1500, seed=8)
        f1 = tmp_path / "r1.fastq"
        write_reads(f1, reads1)
        doc, _, _, _ = run_count(set(barcodes), str(f1), engine="device")
        assert doc == truth
        assert not [
            t for t in threading.enumerate() if t.name == "count-dispatch"
        ]

    def test_acc_spill_mid_stream(self, tmp_path, monkeypatch):
        """The int32 accumulator overflow guard (spill to the int64 host
        array every _ACC_SPILL_ROWS tallied rows): lower the threshold so
        EVERY dispatch spills mid-stream — counts must still be exact on
        both accelerator engines (the spill restarts accumulation, so a
        bug would double- or drop-count whole batches)."""
        from barcoder_tpu.pipeline.heuristic_count import DeviceCounter, run_count
        from barcoder_tpu.parallel.sharded_count import ShardedCounter

        monkeypatch.setattr(DeviceCounter, "_ACC_SPILL_ROWS", 1)
        # small dispatch buffer → several dispatches, EACH spilling, so the
        # spill composes additively across a real mid-stream sequence
        monkeypatch.setattr(DeviceCounter, "_DISPATCH_ROWS", 512)
        assert ShardedCounter._ACC_SPILL_ROWS == 1  # inherited

        barcodes = make_barcodes(n=25, seed=4)
        reads1, _, truth = make_reads(barcodes, n_reads=2500, seed=4)
        f1 = tmp_path / "r1.fastq"
        write_reads(f1, reads1)
        for engine in ("device", "sharded"):
            doc, undoc, n, _ = run_count(
                set(barcodes), str(f1), engine=engine, chunk_size=512
            )
            assert doc == truth, engine
            assert n == len(reads1)

    def test_n_in_core_agrees(self, tmp_path):
        """An N INSIDE the barcode slot: the reference drops any read
        containing an N outright (heuristicount.py:489-490,524-525), so
        N'd reads must count NOWHERE — and the device engines' 2-bit core
        packing (_pack_cores_u32, which cannot represent N) must not let
        them alias to an A-substituted barcode. All engines must agree."""
        from barcoder_tpu.pipeline.heuristic_count import run_count

        barcodes = make_barcodes(n=20, seed=17)
        reads1, _, _ = make_reads(barcodes, n_reads=2000, seed=17)
        # corrupt a deterministic slice of cores with an N mid-barcode
        start = len(PREFIX) + len(L_FLANK)
        for i in range(0, 300):
            r = reads1[i]
            reads1[i] = r[: start + 7] + "N" + r[start + 8 :]
        f1 = tmp_path / "r1.fastq"
        write_reads(f1, reads1)
        args = (set(barcodes), str(f1), None)
        results = {
            e: run_count(*args, engine=e)
            for e in ("vector", "device", "sharded", "reference")
        }
        doc_v, undoc_v = results["vector"][0], results["vector"][1]
        assert sum(doc_v.values()) + sum(undoc_v.values()) == 2000 - 300
        for e in ("device", "sharded", "reference"):
            assert results[e][0] == doc_v, e
            assert results[e][1] == undoc_v, e


class TestBarcodeLengthBoundaries:
    """bc_len=32 saturates the uint64 2-bit packing (the reference's CN-32
    library length); bc_len>32 must fall back to the per-read engine."""

    def test_len32_engines_agree(self, tmp_path):
        barcodes = make_barcodes(n=12, bc_len=32, seed=21)
        reads1, reads2, truth = make_reads(barcodes, n_reads=1500, seed=21)
        f1, f2 = tmp_path / "r1.fastq", tmp_path / "r2.fastq"
        write_reads(f1, reads1)
        write_reads(f2, reads2)
        args = (set(barcodes), str(f1), str(f2))
        results = {
            e: run_count(*args, engine=e)
            for e in ("vector", "device", "reference")
        }
        doc_v = results["vector"][0]
        assert doc_v == truth
        for e in ("device", "reference"):
            assert results[e][0] == doc_v, e
            assert results[e][1] == results["vector"][1], e

    @pytest.mark.parametrize("engine", ["auto", "vector", "device"])
    def test_len40_falls_back(self, tmp_path, engine):
        # auto skips the array engines; explicit array engines degrade to
        # the per-read engine instead of crashing in the uint64 packing
        barcodes = make_barcodes(n=12, bc_len=40, seed=22)
        reads1, _, truth = make_reads(barcodes, n_reads=800, seed=22)
        f1 = tmp_path / "r1.fastq"
        write_reads(f1, reads1)
        doc, undoc, total, info = run_count(set(barcodes), str(f1), engine=engine)
        assert info["engine"] == "reference"
        assert doc == truth


class TestShardedEngine:
    """ShardedCounter (read-batch axis sharded over the mesh, doc counts
    psum-merged on device) must agree exactly with VectorCounter. Runs on
    the 8-fake-device CPU mesh from conftest."""

    @pytest.mark.parametrize("paired", [False, True])
    def test_run_count_sharded_agrees(self, tmp_path, paired):
        from barcoder_tpu.pipeline.heuristic_count import run_count

        barcodes = make_barcodes(n=25, seed=11)
        undoc_bc = [random_seq(20, np.random.default_rng(5))]
        reads1, reads2, truth = make_reads(
            barcodes, n_reads=3000, seed=11, undocumented=undoc_bc
        )
        f1, f2 = tmp_path / "r1.fastq", tmp_path / "r2.fastq"
        write_reads(f1, reads1)
        write_reads(f2, reads2)
        args = (set(barcodes), str(f1), str(f2) if paired else None)
        doc_v, undoc_v, n_v, _ = run_count(*args, engine="vector")
        doc_s, undoc_s, n_s, info = run_count(*args, engine="sharded")
        assert info["engine"] == "sharded"
        assert (n_v, doc_v, undoc_v) == (n_s, doc_s, undoc_s)
        assert doc_s == Counter(
            {bc: truth[bc] for bc in barcodes if truth[bc] > 0}
        )
        assert sum(undoc_s.values()) == truth[undoc_bc[0]] > 0

    def test_explicit_small_mesh(self, tmp_path):
        # a 4-device sub-mesh (not all devices) with an uneven tail chunk
        import jax

        from barcoder_tpu.pipeline.heuristic_count import (
            CountConfig, VectorCounter,
        )
        from barcoder_tpu.parallel.sharded_count import (
            ShardedCounter, make_read_mesh,
        )

        assert len(jax.devices()) >= 8
        barcodes = make_barcodes(n=10, seed=2)
        reads1, _, truth = make_reads(barcodes, n_reads=777, seed=2)
        cfg = CountConfig(
            barcodes=set(barcodes), bc_len=20,
            L_fwd=L_FLANK, R_fwd=R_FLANK, L_rev=None, R_rev=None,
            L_fwd_start=len(PREFIX), L_rev_start=None, need_swap=False,
        )
        sc = ShardedCounter(cfg, mesh=make_read_mesh(4))
        sc.process_chunk((reads1, None))
        doc_s, undoc_s = sc.results()
        vc = VectorCounter(cfg)
        vc.process_chunk((reads1, None))
        doc_v, undoc_v = vc.results()
        assert doc_s == doc_v == truth
        assert undoc_s == undoc_v


def paired_cfg(barcodes, bc_len=20):
    """The paired-end CountConfig matching make_reads' amplicon geometry:
    read2 = revcomp(read1) = rc(TAIL)[8] + rc(R_FLANK)[7] + rc(bc)[bc_len]
    + rc(PREFIX + L_FLANK)[12]. Shared by the multi-host worker and its
    expected-value computation so the two cannot drift."""
    return CountConfig(
        barcodes=set(barcodes), bc_len=bc_len,
        L_fwd=L_FLANK, R_fwd=R_FLANK,
        L_rev=rev_comp(R_FLANK), R_rev=rev_comp(PREFIX + L_FLANK)[:10],
        L_fwd_start=len(PREFIX), L_rev_start=len(TAIL), need_swap=False,
    )


class TestTruncatedReadParity:
    """r5 review repros: reads whose scan window is truncated by the read
    end must match count_chunk_reference exactly (the vector engines'
    fixed-width zero-padded windows route them through the per-read slow
    path now)."""

    @staticmethod
    def _diff(cfg, reads1, reads2=None):
        from barcoder_tpu.pipeline.heuristic_count import (
            VectorCounter,
            count_chunk_reference,
        )

        ref_counts, _ = count_chunk_reference((reads1, reads2), cfg)
        ref_doc = Counter({k: v for k, v in ref_counts.items() if not k.endswith("*")})
        ref_un = Counter({k: v for k, v in ref_counts.items() if k.endswith("*")})
        vc = VectorCounter(cfg)
        vc.process_chunk((reads1, reads2))
        doc, un = vc.results()
        assert doc == ref_doc, (doc, ref_doc)
        assert un == ref_un, (un, ref_un)

    def test_truncated_tail_endswith_flank(self):
        # reference: swf.endswith('GG') on the TRUNCATED slice counts
        # 'ACGT*'; the padded-column compare silently dropped the read
        from barcoder_tpu.pipeline.heuristic_count import CountConfig

        cfg = CountConfig(
            barcodes={"ACGTACGTAC"}, bc_len=10, L_fwd="AA", R_fwd="GG",
            L_fwd_start=0,
        )
        self._diff(cfg, ["AAACGTGG", "AA" + "ACGTACGTAC" + "GG"])

    def test_sentinel_library_barcode_never_matches(self):
        # an N-containing barcode packs to the sentinel key; a truncated
        # (null-padded) core must not "match" it as documented
        from barcoder_tpu.pipeline.heuristic_count import CountConfig

        cfg = CountConfig(
            barcodes={"ACGNACGTAC", "ACGTACGTAC"}, bc_len=10, L_fwd="AA",
            R_fwd="", L_fwd_start=0,
        )
        self._diff(cfg, ["AAACGTAC", "AAACGTACGTAC"])

    def test_paired_truncated_cores_not_consistent(self):
        # both truncated cores packed to the sentinel and compared equal;
        # reference compares the truncated strings and skips the pair
        from barcoder_tpu.pipeline.heuristic_count import CountConfig

        cfg = CountConfig(
            barcodes={"GGGGGCCCCC"}, bc_len=10, L_fwd="AA", R_fwd="",
            L_rev="TT", R_rev="", L_fwd_start=0, L_rev_start=0,
        )
        self._diff(cfg, ["AAGGGGG"], ["TTCCC"])

    def test_rev_single_end_truncated_key(self):
        # reference reports the truncated rev_comp string; the padded
        # reversal produced leading-N junk keys
        from barcoder_tpu.pipeline.heuristic_count import CountConfig

        cfg = CountConfig(
            barcodes={"ACGTACGTAC"}, bc_len=10, L_rev="TT", R_rev=None,
            L_rev_start=0,
        )
        from barcoder_tpu.pipeline.heuristic_count import (
            VectorCounter,
            count_chunk_reference,
        )

        reads2 = ["TTGCAT", "TT" + "GTACGTACGT"]
        ref_counts, _ = count_chunk_reference((None, reads2), cfg)
        vc = VectorCounter(cfg)
        vc.process_chunk((None, reads2))
        doc, un = vc.results()
        ref_doc = Counter({k: v for k, v in ref_counts.items() if not k.endswith("*")})
        ref_un = Counter({k: v for k, v in ref_counts.items() if k.endswith("*")})
        assert doc == ref_doc and un == ref_un, (doc, un, ref_counts)

    def test_random_truncation_differential(self):
        # random reads randomly truncated: vector engine == oracle
        from barcoder_tpu.pipeline.heuristic_count import CountConfig

        rng = np.random.default_rng(77)
        bcs = {random_seq(8, rng) for _ in range(12)}
        cfg = CountConfig(
            barcodes=set(bcs), bc_len=8, L_fwd="CA", R_fwd="TG",
            L_fwd_start=1,
        )
        reads = []
        for _ in range(300):
            bc = list(bcs)[int(rng.integers(0, len(bcs)))]
            full = "G" + "CA" + bc + "TG" + random_seq(3, rng)
            cut = int(rng.integers(3, len(full) + 1))
            reads.append(full[:cut])
        self._diff(cfg, reads)
