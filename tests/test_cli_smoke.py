"""CLI surface smoke tests: every subcommand as a real subprocess
(`python -m barcoder_tpu ...`), forced onto the CPU backend."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import zstandard as zstd

from barcoder_tpu.seqio.fasta import write_fastq
from barcoder_tpu.seqio.genbank import write_genbank

from .genomes import make_record, plant_guide, random_seq

ENV = dict(os.environ, JAX_PLATFORMS="cpu", BARCODER_TPU_BACKEND="jax")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(args, timeout=240):
    return subprocess.run(
        [sys.executable, "-m", "barcoder_tpu", *args],
        capture_output=True, text=True, env=ENV, cwd=REPO, timeout=timeout,
    )


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    rec = make_record(n=6000, topology="circular", seed=7, n_genes=6)
    g = random_seq(20, rng)
    plant_guide(rec, g, 800, pam="TGG")
    write_genbank([rec], d / "genome.gb")
    with open(d / "lib.fasta", "w") as fh:
        fh.write(f">g1\n{g}\n>miss\n{'A'*20}\n")
    return d, g


@pytest.mark.slow
def test_targets_cli(data):
    d, g = data
    p = run_cli(["targets", str(d / "lib.fasta"), str(d / "genome.gb"), "NGG", "0"])
    assert p.returncode == 0, p.stderr[-2000:]
    lines = p.stdout.strip().splitlines()
    assert lines[0].split("\t")[0] == "spacer"
    assert any(g in line for line in lines[1:])


@pytest.mark.slow
def test_targets_json_flag(data):
    d, g = data
    p = run_cli(["targets", str(d / "lib.fasta"), str(d / "genome.gb"), "NGG", "0", "--json"])
    assert p.returncode == 0, p.stderr[-2000:]
    records = json.loads(p.stdout)
    assert isinstance(records, list) and any(r["spacer"] == g for r in records)


@pytest.mark.slow
def test_design_cli(data):
    d, _ = data
    p = run_cli(["design", str(d / "genome.gb"), "NGG", "20", "--keep-top", "2"])
    assert p.returncode == 0, p.stderr[-2000:]
    lines = p.stdout.strip().splitlines()
    assert len(lines) > 2
    assert "spacer" in lines[0]


@pytest.mark.slow
def test_mismatch_cli(data, tmp_path):
    spacers = tmp_path / "sp.tsv"
    spacers.write_text("target\nACGTACGTACGTACGTACGT\n")
    p = run_cli([
        "mismatch", "mismatches", "--spacers_file", str(spacers),
        "--parameters_file", "/root/reference/mismatch_parameters.csv",
        "--min", "0", "--max", "0.4", "--step", "0.2",
    ])
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.startswith("original\t")


def test_count_cli(tmp_path):
    rng = np.random.default_rng(1)
    barcodes = sorted({random_seq(20, rng) for _ in range(12)})
    reads = []
    for _ in range(1500):
        bc = barcodes[rng.integers(0, len(barcodes))]
        reads.append("ACGTG" + "GGTAGCT" + bc + "CTTAAGC" + "TCCATGGA")
    write_fastq([(f"r{i}", r) for i, r in enumerate(reads)], tmp_path / "r1.fastq", quality=35)
    (tmp_path / "bc.fasta").write_text("".join(f">{b}\n{b}\n" for b in barcodes))
    p = run_cli(["count", str(tmp_path / "bc.fasta"), str(tmp_path / "r1.fastq")])
    assert p.returncode == 0, p.stderr[-2000:]
    counts = dict(l.split("\t") for l in p.stdout.strip().splitlines())
    assert sum(map(int, counts.values())) == 1500


def test_distill_cli(tmp_path):
    rng = np.random.default_rng(2)
    reads = [random_seq(25, rng) for _ in range(200)]
    write_fastq([(f"r{i}", r) for i, r in enumerate(reads)], tmp_path / "x.fastq", quality=30)
    p = run_cli(["distill", str(tmp_path / "x.fastq")])
    assert p.returncode == 0, p.stderr[-2000:]
    with zstd.open(tmp_path / "x.reads.zst", "rt") as fh:
        lines = [l.strip() for l in fh]
    assert lines == sorted(reads)


def test_unknown_command():
    p = run_cli(["frobnicate"])
    assert p.returncode == 2
    assert "unknown command" in p.stderr


class TestGui:
    def test_build_argv(self):
        from barcoder_tpu.cli.gui import build_argv

        argv = build_argv(
            "targets",
            {"sgrna_file": "lib.fasta", "genome_file": "g.gb", "pam": "NGG",
             "mismatches": "1", "--pam_direction": "upstream"},
        )
        assert argv == [
            "targets", "lib.fasta", "g.gb", "NGG", "1",
            "--pam_direction", "upstream",
        ]
        assert build_argv("distill", {"files": "a.fastq b.fastq"}) == [
            "distill", "a.fastq", "b.fastq"
        ]

    def test_tui_runs_targets_end_to_end(self, data, monkeypatch, capsys):
        # scripted prompts drive a real in-process targets run
        from rich.prompt import Confirm, Prompt

        from barcoder_tpu.cli.gui import run_tui

        d, g = data
        answers = iter([
            "targets", str(d / "lib.fasta"), str(d / "genome.gb"),
            "NGG", "1", "downstream",
        ])
        monkeypatch.setattr(Prompt, "ask", staticmethod(lambda *a, **k: next(answers)))
        monkeypatch.setattr(Confirm, "ask", staticmethod(lambda *a, **k: True))
        rc = run_tui()
        assert rc == 0
        out = capsys.readouterr().out
        assert g in out  # the planted guide appears in the TSV

    def test_tui_decline(self, monkeypatch):
        from rich.prompt import Confirm, Prompt

        from barcoder_tpu.cli.gui import run_tui

        answers = iter(["distill", "x.fastq"])
        monkeypatch.setattr(Prompt, "ask", staticmethod(lambda *a, **k: next(answers)))
        monkeypatch.setattr(Confirm, "ask", staticmethod(lambda *a, **k: False))
        assert run_tui() == 1


class TestArgValidation:
    def test_compat_columns_requires_insert_site(self, capsys):
        """ADVICE r2: --compat-columns without --insert-site was silently
        ignored; it must be a hard argparse error."""
        import pytest

        from barcoder_tpu.cli.targets import main

        with pytest.raises(SystemExit) as exc:
            main(["lib.tsv", "genome.gb", "NGG", "0", "--compat-columns"])
        assert exc.value.code == 2
        assert "--insert-site" in capsys.readouterr().err


def test_shield_stdout_idempotent():
    """_shield_stdout must be a no-op the second time: multihost
    .initialize() short-circuits True on a second main() call in the same
    process, and re-shielding would dup the already-redirected fd 1 (now
    stderr), silently sending all machine-readable output to stderr."""
    code = (
        "from barcoder_tpu.cli.main import _shield_stdout\n"
        "_shield_stdout()\n"
        "_shield_stdout()\n"
        "import sys\n"
        "print('DATA-ON-STDOUT')\n"
        "sys.stdout.flush()\n"
        "print('noise-on-stderr', file=sys.stderr)\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, env=ENV, cwd=REPO, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout == "DATA-ON-STDOUT\n"
    assert "DATA-ON-STDOUT" not in r.stderr
