"""Differential parity: run the REFERENCE toolkit's Bowtie-free scripts
(heuristicount.py, mismatch.py) as subprocesses on the same inputs and
require identical stdout to this framework's CLIs.

These are the strongest parity proofs available in-repo: the alignment
workloads are pinned by golden files (test_golden_parity) because Bowtie is
not installable here, but the counting and mismatch-model workloads run the
reference's own code end to end."""

import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

REF = "/root/reference"

from .test_heuristic_count import make_barcodes, make_reads, write_reads

pytestmark = pytest.mark.skipif(
    not os.path.exists(os.path.join(REF, "heuristicount.py")),
    reason="reference checkout unavailable",
)


def run_script(script, args, cwd=REF, timeout=600):
    env = dict(os.environ)
    env["PYTHONPATH"] = REF
    env.pop("JAX_PLATFORMS", None)
    # the reference Logger formats numbers with babel, which rejects the
    # container's default locale "C"
    env["LANG"] = env["LC_ALL"] = "en_US.UTF-8"
    proc = subprocess.run(
        [sys.executable, os.path.join(REF, script), *args],
        capture_output=True, text=True, cwd=cwd, env=env, timeout=timeout,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


def run_ours(argv, timeout=600):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["BARCODER_TPU_BACKEND"] = "jax"
    proc = subprocess.run(
        [sys.executable, "-m", "barcoder_tpu", *argv],
        capture_output=True, text=True, cwd="/root/repo", env=env, timeout=timeout,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


def counts_of(stdout: str) -> Counter:
    out = Counter()
    for line in stdout.strip().splitlines():
        if line:
            bc, n = line.split("\t")
            out[bc] = int(n)
    return out


@pytest.mark.slow
class TestHeuristicountDifferential:
    def _setup(self, tmp_path, paired, n_reads=1200, seed=9, undocumented=None):
        barcodes = make_barcodes(n=14, seed=seed)
        reads1, reads2, _ = make_reads(
            barcodes, n_reads=n_reads, seed=seed, undocumented=undocumented or []
        )
        f1, f2 = tmp_path / "r1.fastq", tmp_path / "r2.fastq"
        write_reads(f1, reads1)
        write_reads(f2, reads2)
        bc_fasta = tmp_path / "bc.fasta"
        bc_fasta.write_text("".join(f">{b}\n{b}\n" for b in barcodes))
        args = [str(bc_fasta), str(f1)] + ([str(f2)] if paired else [])
        return args

    @pytest.mark.parametrize("paired", [False, True])
    def test_counts_identical(self, tmp_path, paired):
        args = self._setup(tmp_path, paired)
        ref = counts_of(run_script("heuristicount.py", args))
        ours = counts_of(run_ours(["count", *args]))
        assert ours == ref and sum(ref.values()) > 0

    def test_counts_identical_with_undocumented(self, tmp_path):
        undoc = [make_barcodes(n=1, seed=77)[0]]
        args = self._setup(tmp_path, paired=True, undocumented=undoc)
        ref = counts_of(run_script("heuristicount.py", args))
        ours = counts_of(run_ours(["count", *args]))
        assert ours == ref
        assert undoc[0] not in ref  # undocumented stays off stdout

    def test_counts_identical_swapped_orientation(self, tmp_path):
        # file1 = reverse reads, file2 = forward: exercises need_swap
        barcodes = make_barcodes(n=14, seed=5)
        reads1, reads2, _ = make_reads(barcodes, n_reads=1000, seed=5)
        f1, f2 = tmp_path / "r1.fastq", tmp_path / "r2.fastq"
        write_reads(f1, reads2)
        write_reads(f2, reads1)
        bc_fasta = tmp_path / "bc.fasta"
        bc_fasta.write_text("".join(f">{b}\n{b}\n" for b in barcodes))
        args = [str(bc_fasta), str(f1), str(f2)]
        ref = counts_of(run_script("heuristicount.py", args))
        ours = counts_of(run_ours(["count", *args]))
        assert ours == ref and sum(ref.values()) > 0


@pytest.mark.slow
class TestHeuristicountFuzzDifferential:
    """Randomized construct geometries (prefix/flank/tail lengths, paired
    or single, undocumented barcodes, barcode length) through BOTH
    implementations — the sampling/orientation/flank-voting heuristics are
    the reference's most intricate logic, so equality is checked on the
    full stdout count dict."""

    @pytest.mark.parametrize("seed", range(5))
    def test_random_geometry(self, tmp_path, seed):
        from barcoder_tpu.core.encode import revcomp

        from .genomes import random_seq
        from .test_heuristic_count import make_barcodes

        rng = np.random.default_rng(200 + seed)
        bc_len = int(rng.choice([16, 20, 24, 32]))
        barcodes = make_barcodes(n=int(rng.integers(10, 20)), bc_len=bc_len,
                                 seed=300 + seed)
        prefix = random_seq(int(rng.integers(0, 10)), rng)
        l_fl = random_seq(int(rng.integers(1, 9)), rng)
        r_fl = random_seq(int(rng.integers(1, 9)), rng)
        tail = random_seq(int(rng.integers(4, 12)), rng)
        paired = bool(rng.integers(0, 2))
        undoc = [make_barcodes(n=1, bc_len=bc_len, seed=400 + seed)[0]]
        pool = list(barcodes) + undoc
        reads1, reads2 = [], []
        for _ in range(1200):
            bc = pool[int(rng.integers(0, len(pool)))]
            read = prefix + l_fl + bc + r_fl + tail
            reads1.append(read)
            reads2.append(revcomp(read))
        f1, f2 = tmp_path / "r1.fastq", tmp_path / "r2.fastq"
        for path, reads in ((f1, reads1), (f2, reads2)):
            with open(path, "w") as fh:
                for i, r in enumerate(reads):
                    fh.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
        bc_fasta = tmp_path / "bc.fasta"
        bc_fasta.write_text("".join(f">{b}\n{b}\n" for b in barcodes))
        args = [str(bc_fasta), str(f1)] + ([str(f2)] if paired else [])
        try:
            ref_out = run_script("heuristicount.py", args)
        except AssertionError as e:
            # geometries the reference itself rejects (e.g. flank
            # complementarity violations) are out of scope here
            pytest.skip(f"reference errored on this geometry: {e}"[:200])
        ref = counts_of(ref_out)
        ours = counts_of(run_ours(["count", *args]))
        assert ours == ref, (
            f"seed={seed} bc_len={bc_len} prefix={len(prefix)} "
            f"flanks=({len(l_fl)},{len(r_fl)}) paired={paired}"
        )


PYZSTD_SHIM = """\
# pyzstd shim over zstandard (pyzstd is not installed in this image);
# covers the three calls distillreads.py makes
import zstandard as _z

def compress(data, *a, **k):
    return _z.ZstdCompressor().compress(data)

def decompress(data, *a, **k):
    return _z.ZstdDecompressor().decompress(data)

def open(*a, **k):
    return _z.open(*a, **k)
"""


@pytest.mark.slow
class TestDistillDifferential:
    def test_paired_outputs_identical(self, tmp_path):
        import gzip

        import zstandard

        from .genomes import random_seq

        rng = np.random.default_rng(17)
        reads1 = [random_seq(40, rng) for _ in range(400)]
        reads2 = [random_seq(40, rng) for _ in range(400)]

        def write_fastq_gz(path, reads):
            with gzip.open(path, "wt") as fh:
                for i, r in enumerate(reads):
                    fh.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")

        shim_dir = tmp_path / "shim"
        shim_dir.mkdir()
        (shim_dir / "pyzstd.py").write_text(PYZSTD_SHIM)
        ref_dir = tmp_path / "refrun"
        our_dir = tmp_path / "ourrun"
        for d in (ref_dir, our_dir):
            d.mkdir()
            write_fastq_gz(d / "r1.fastq.gz", reads1)
            write_fastq_gz(d / "r2.fastq.gz", reads2)

        env = dict(os.environ)
        env["PYTHONPATH"] = f"{shim_dir}:{REF}"
        env["LANG"] = env["LC_ALL"] = "en_US.UTF-8"
        env.pop("JAX_PLATFORMS", None)
        proc = subprocess.run(
            [sys.executable, os.path.join(REF, "distillreads.py"),
             str(ref_dir / "r1.fastq.gz"), str(ref_dir / "r2.fastq.gz")],
            capture_output=True, text=True, cwd=REF, env=env, timeout=600,
        )
        assert proc.returncode == 0, proc.stderr[-2000:]
        run_ours(["distill", str(our_dir / "r1.fastq.gz"), str(our_dir / "r2.fastq.gz")])

        def read_zst(path):
            with zstandard.open(path, "rt") as fh:
                return fh.read().splitlines()

        for name in ("r1.reads.zst", "r2.reads.zst"):
            ref_out = read_zst(ref_dir / name)
            our_out = read_zst(our_dir / name)
            assert our_out == ref_out, name
        assert len(read_zst(ref_dir / "r1.reads.zst")) == 400


@pytest.mark.slow
class TestMismatchDifferential:
    PARAMS = os.path.join(REF, "mismatch_parameters.csv")

    def _spacers_tsv(self, tmp_path, n=25, L=20, seed=3) -> Path:
        rng = np.random.default_rng(seed)
        from .genomes import random_seq

        f = tmp_path / "spacers.tsv"
        pd.DataFrame({"target": [random_seq(L, rng) for _ in range(n)]}).to_csv(
            f, sep="\t", index=False
        )
        return f

    def test_mismatches_mode_identical(self, tmp_path):
        sp = self._spacers_tsv(tmp_path)
        args = [
            "mismatches", "--spacers_file", str(sp),
            "--parameters_file", self.PARAMS,
            "--min", "0.1", "--max", "0.9", "--step", "0.1",
        ]
        ref = run_script("mismatch.py", args)
        ours = run_ours(["mismatch", *args])
        ref_df = pd.read_csv(pd.io.common.StringIO(ref), sep="\t")
        our_df = pd.read_csv(pd.io.common.StringIO(ours), sep="\t")
        assert list(ref_df.columns) == list(our_df.columns)
        pd.testing.assert_frame_equal(our_df, ref_df, check_exact=False, rtol=1e-9)

    def test_recalculate_mode_identical(self, tmp_path):
        # recalculate over a table produced by the reference's own
        # mismatches mode (column aliasing original/variant)
        sp = self._spacers_tsv(tmp_path, n=15, seed=8)
        gen_args = [
            "mismatches", "--spacers_file", str(sp),
            "--parameters_file", self.PARAMS,
            "--min", "0.2", "--max", "0.8", "--step", "0.2",
        ]
        table = run_script("mismatch.py", gen_args)
        existing = tmp_path / "existing.tsv"
        existing.write_text(table)
        args = [
            "recalculate", "--existing_mismatches", str(existing),
            "--parameters_file", self.PARAMS,
        ]
        ref = run_script("mismatch.py", args)
        ours = run_ours(["mismatch", *args])
        ref_df = pd.read_csv(pd.io.common.StringIO(ref), sep="\t")
        our_df = pd.read_csv(pd.io.common.StringIO(ours), sep="\t")
        pd.testing.assert_frame_equal(our_df, ref_df, check_exact=False, rtol=1e-9)
