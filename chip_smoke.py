#!/usr/bin/env python3
"""Smoke test of barcoder_tpu on an NVIDIA GPU — the quickest proof that
the system still starts and is right on the card.

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # the multi-card mesh path only

Everything runs in this one process (a JAX process reserves most of the
card's memory), the CLI included, through ``barcoder_tpu.cli.main.main``.
Data is synthetic and seeded; nothing is read from outside the repository.

One card, in phases:
  1. kernel parity — the compiled phase-1 kernel (ops.pallas_scan
     .scan_block_hits) equals the plain-XLA phase 1 at real widths: dense
     strand-fused with folded bias, L=32 additive, site matrix rows;
  2. ``targets`` CLI on an E. coli-shaped GenBank (4.6 Mbp, 4,200 genes)
     with a 9,984-spacer library, NGG, v=3: the TSV is byte-identical with
     the kernel and with the plain-XLA phase 1;
  3. chip-independent hit counts (745 / 632 / 125,202 hits and 41,993
     ``design`` rows), each engine run with the kernel and with the
     plain-XLA phase 1, timed end to end;
  4. ``count --engine device``: 1M simulated reads x 10k barcodes, counts
     exact;
  5. oracle cross-check: the engines equal the numpy oracle (ops/oracle.py)
     at 200 kbp x 1k spacers, v=3.

With --four-cards: the headline scan on make_mesh(4) and make_mesh_2d(2, 2)
equals the same scan on make_mesh(1), and ``count --engine sharded`` over
the four-card read mesh is exact.

Exit code 0 only if every phase passed. The last line of stdout is one
JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)


def card_lines() -> list[str]:
    """One ``name, power.limit`` line per card, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


class Phases:
    """Runs named phases, printing each one's wall time with the card; a
    failure is printed and remembered, and fails the run at the end."""

    def __init__(self, card: str):
        self.card = card
        self.failed: list[str] = []

    def run(self, name, fn):
        t0 = time.perf_counter()
        try:
            fn()
            status = "ok"
        except Exception:
            traceback.print_exc()
            sys.stdout.flush()
            self.failed.append(name)
            status = "FAILED"
        print(f"[phase] {name}: {status} in {time.perf_counter() - t0:.3f} s "
              f"({self.card})", flush=True)


def run_cli(argv, **env) -> str:
    """One CLI command in this process; returns its stdout, raises on a
    nonzero exit. ``env`` is set for the call only."""
    from barcoder_tpu.cli.main import main

    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = main(list(argv))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if rc != 0:
        raise RuntimeError(f"barcoder_tpu {' '.join(argv)} exited {rc}")
    return buf.getvalue()


def best_of(fn, n=3):
    """(best wall seconds of n warm calls, last result); one warm-up call
    first pays compilation."""
    out = fn()
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return best, out


def tuples(h) -> set:
    return set(zip(h.spacer_idx.tolist(), h.pos.tolist(), h.strand.tolist(),
                   h.mismatches.tolist()))


def expect(name, got, want):
    print(f"  {name}: {got} (expected {want})", flush=True)
    if got != want:
        raise AssertionError(f"{name}: got {got}, expected {want}")


# ---------------------------------------------------------------- phase 1
def _phase1_operands(rng, *, L, S_pad, P, n_tiles, fold, matrix):
    """Real-width phase-1 operands: random one-hot spacers, random genome
    or site codes with exact copies of every 97th spacer planted at
    unmasked positions (90% of the others are masked)."""
    import jax.numpy as jnp
    import numpy as np

    from barcoder_tpu.ops.pallas_scan import MASK_BIAS

    K = max(-(-4 * L // 128) * 128, 128)
    codes = rng.integers(0, 4, size=(S_pad, L))
    q = np.zeros((S_pad, K), np.float32)
    q[np.arange(S_pad)[:, None], 4 * np.arange(L)[None, :] + codes] = 1.0
    if fold:
        q[: S_pad // 2, 4 * L] = 1.0
        q[S_pad // 2 :, 4 * L + 1] = 1.0
    rows = 2 if fold else 1
    bias = np.where(rng.random((n_tiles, rows, P)) < 0.1, 0.0, MASK_BIAS)
    bias = bias.astype(np.float32)
    if matrix:
        tiles = rng.integers(0, 4, size=(n_tiles, -(-L // 8) * 8, P)).astype(np.int32)
        bias = np.zeros((n_tiles, 1, P), np.float32)
    else:
        tiles = rng.integers(0, 4, size=(n_tiles, 1, P + K // 4)).astype(np.int32)
    for s in range(0, S_pad, 97):
        t, p = rng.integers(n_tiles), rng.integers(P)
        if matrix:
            tiles[t, :L, p] = codes[s]
        else:
            tiles[t, 0, p : p + L] = codes[s]
            bias[t, :, p] = 0.0
    return K, jnp.asarray(q, jnp.bfloat16), jnp.asarray(tiles), jnp.asarray(bias)


def phase_kernel_parity(card):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from barcoder_tpu.ops import pallas_scan as ps

    rng = np.random.default_rng(0)
    P = 16384
    # (name, L, S_pad, n_tiles, fold, matrix, v): the headline library's
    # padded rows (both strands when fused) against 4.6 Mbp dense, the
    # 9,984 x 32-nt library against 2 Mbp, and against 575k NGG sites
    shapes = [
        ("dense_fused_fold_L20", 20, 20480, 282, True, False, 3),
        ("dense_additive_L32", 32, 10240, 123, False, False, 1),
        ("site_matrix_rows_L20", 20, 10240, 36, False, True, 3),
    ]
    for name, L, S_pad, n_tiles, fold, matrix, v in shapes:
        K, q, tiles, bias = _phase1_operands(
            rng, L=L, S_pad=S_pad, P=P, n_tiles=n_tiles, fold=fold, matrix=matrix
        )
        th = jnp.full((1,), L - v, jnp.float32)
        kw = dict(L=L, K=K, P=P, SUB=P // 512, BS_M=512, fold_bias=fold,
                  matrix_rows=matrix)
        kern = jax.jit(lambda *a: ps.scan_block_hits(*a, **kw))
        ref = jax.jit(lambda *a: ps.phase1_reference(*a, **kw))
        times = {}
        outs = {}
        for label, f in (("kernel", kern), ("xla", ref)):
            def call(f=f):
                return jax.block_until_ready(f(th, q, tiles, bias))

            times[label], outs[label] = best_of(call)
        a, b = np.asarray(outs["kernel"]), np.asarray(outs["xla"])
        flops = 2 * S_pad * K * n_tiles * P
        print(f"  {name}: kernel {times['kernel']:.6f} s "
              f"({flops / times['kernel'] / 1e12:.1f} TFLOP/s), plain XLA "
              f"{times['xla']:.6f} s ({flops / times['xla'] / 1e12:.1f} TFLOP/s), "
              f"nonzero pairs {int((b > 0).sum())} ({card})", flush=True)
        if a.shape != b.shape or not (a == b).all() or not (b > 0).any():
            raise AssertionError(f"{name}: kernel and plain phase 1 differ")


# ---------------------------------------------------------------- data
def strided_library(seq: str, n: int, L: int, step_mod: int):
    """bench.build_config's library: L-mer windows of the genome at a fixed
    stride (every spacer has a real site)."""
    out, pos = [], 0
    step = len(seq) // (n + 1)
    while len(out) < n:
        pos = (pos + step) % (len(seq) - L - step_mod)
        out.append(seq[pos : pos + L])
    return out


def write_ecoli_genbank(d: str):
    from barcoder_tpu.seqio.genbank import write_genbank
    from tests.genomes import make_record

    rec = make_record(n=4_600_000, n_genes=4200, wrapped_gene=True, seed=5)
    path = os.path.join(d, "ecoli_like.gb")
    write_genbank([rec], path)
    return rec, path


def write_fasta(path: str, seqs, prefix: str):
    with open(path, "w") as fh:
        for i, s in enumerate(seqs):
            fh.write(f">{prefix}{i}\n{s}\n")


def write_count_workload(d: str, n_reads=1_000_000, n_barcodes=10_000):
    """bench.bench_counting's workload: flank-anchored reads drawn from 10k
    random 20-nt barcodes; returns (barcodes fasta, fastq, true counts)."""
    import numpy as np

    from barcoder_tpu.core.encode import decode

    rng = np.random.default_rng(1)
    barcodes = sorted(
        {decode(rng.integers(0, 4, 20).astype(np.int8)) for _ in range(n_barcodes)}
    )
    pre, l_fl, r_fl, tail = "ACGTG", "GGTAGCT", "CTTAAGC", "TCCATGGA"
    idx = rng.integers(0, len(barcodes), size=n_reads)
    fq = os.path.join(d, "reads.fastq")
    qual = "I" * (len(pre) + len(l_fl) + 20 + len(r_fl) + len(tail))
    with open(fq, "w") as fh:
        fh.writelines(
            f"@r\n{pre}{l_fl}{barcodes[i]}{r_fl}{tail}\n+\n{qual}\n" for i in idx
        )
    bc = os.path.join(d, "barcodes.fasta")
    write_fasta(bc, barcodes, "b")
    truth = dict(zip(barcodes, np.bincount(idx, minlength=len(barcodes)).tolist()))
    return bc, fq, {b: c for b, c in truth.items() if c}


def check_counts(tsv: str, truth: dict):
    got = {}
    for line in tsv.splitlines():
        bc, c = line.split("\t")
        got[bc] = int(c)
    expect("reads counted", sum(got.values()), sum(truth.values()))
    expect("barcodes with exact counts", sum(got.get(b) == c for b, c in truth.items()),
           len(truth))


# ---------------------------------------------------------------- one card
def one_card(phases: Phases, work: str):
    import numpy as np

    card = phases.card
    phases.run("1 kernel parity", lambda: phase_kernel_parity(card))

    state = {}

    def targets_cli():
        rec, gb = write_ecoli_genbank(work)
        state["rec"], state["gb"] = rec, gb
        lib = os.path.join(work, "library.fasta")
        write_fasta(lib, strided_library(rec.seq, 9_984, 20, 3), "s")
        argv = ["targets", lib, gb, "NGG", "3"]
        out = {}
        for phase1 in ("kernel", "xla"):
            t0 = time.perf_counter()
            out[phase1] = run_cli(argv, BARCODER_TPU_PHASE1=phase1)
            print(f"  targets CLI, phase 1 = {phase1}: {time.perf_counter() - t0:.3f} s "
                  f"(first call, compile included; {card})", flush=True)
        print(f"  targets TSV: {out['kernel'].count(chr(10)) - 1} rows", flush=True)
        expect("TSV has rows", out["kernel"].count("\n") > 1, True)
        expect("TSV byte-identical (kernel vs plain phase 1)",
               out["kernel"] == out["xla"], True)

    phases.run("2 targets CLI", targets_cli)

    def hit_counts():
        import bench
        from barcoder_tpu.core.encode import decode, encode
        from barcoder_tpu.core.genome import Contig, Genome
        from barcoder_tpu.ops.pallas_scan import pallas_scan
        from barcoder_tpu.parallel.mesh import make_mesh
        from barcoder_tpu.parallel.sharded_scan import sharded_scan
        from barcoder_tpu.pipeline.design import find_candidate_guides
        from barcoder_tpu.utils.platform import TILE_P as P

        mesh = make_mesh(1)

        def ab(name, want, **kw):
            """The sharded engine end to end, kernel vs plain-XLA phase 1."""
            res = {}
            for use in (True, False):
                dt, hits = best_of(lambda: sharded_scan(mesh=mesh, P=P, use_pallas=use, **kw))
                res[use] = hits
                print(f"  {name}, phase 1 = {'kernel' if use else 'xla'}: "
                      f"{dt:.6f} s end to end, {len(hits)} hits ({card})", flush=True)
            expect(f"{name} hits", len(res[True]), want)
            expect(f"{name} kernel == plain", tuples(res[True]) == tuples(res[False]), True)

        contig, spacers = bench.build_config()
        ab("headline sites (auto)", 745, spacers=spacers, contig=contig,
           max_mismatches=3, pam="NGG")
        ab("headline dense fused", 745, spacers=spacers, contig=contig,
           max_mismatches=3, pam="NGG", site_mode="never")

        rng = np.random.default_rng(3)
        n = 2_000_000
        seq = decode(rng.integers(0, 4, size=n).astype(np.int8))
        c32 = Contig(id="CN32.1", length=n, codes=encode(seq), seq=seq,
                     topology="circular")
        sp32 = strided_library(seq, bench.N_SPACERS, 32, 4)
        ab("cn32 dense additive", 632, spacers=sp32, contig=c32,
           max_mismatches=1, pam="NGNC", site_mode="never")
        expect("cn32 --backend pallas hits",
               len(pallas_scan(sp32, c32, 1, pam="NGNC", P=P, site_mode="always")), 632)

        rng = np.random.default_rng(0)
        n = 1_000_000
        seq = decode(rng.integers(0, 4, size=n).astype(np.int8))
        cd = Contig(id="D.1", length=n, codes=encode(seq), seq=seq, topology="circular")
        cands = find_candidate_guides(Genome(contigs=[cd]), 20, "NGG")
        ab("design scan", 125_202, spacers=cands, contig=cd, max_mismatches=1, pam="NGG")
        expect("design scan --backend pallas hits",
               len(pallas_scan(cands, cd, 1, pam="NGG", P=P)), 125_202)

        if "gb" not in state:
            state["rec"], state["gb"] = write_ecoli_genbank(work)
        t0 = time.perf_counter()
        tsv = run_cli(["design", state["gb"], "NGG", "20", "--omit_offtargets"])
        print(f"  design CLI: {time.perf_counter() - t0:.3f} s (first call; {card})",
              flush=True)
        expect("design rows", tsv.count("\n") - 1, 41_993)

    phases.run("3 hit counts", hit_counts)

    def count_device():
        bc, fq, truth = write_count_workload(work)
        t0 = time.perf_counter()
        tsv = run_cli(["count", bc, fq, "--engine", "device"])
        print(f"  count --engine device: {time.perf_counter() - t0:.3f} s "
              f"(first call; {card})", flush=True)
        check_counts(tsv, truth)

    phases.run("4 count --engine device", count_device)

    def oracle():
        from barcoder_tpu.core.genome import contig_from_record
        from barcoder_tpu.ops.oracle import oracle_scan
        from barcoder_tpu.ops.scan import scan_contig
        from tests.genomes import make_record

        rng = np.random.default_rng(11)
        rec = make_record(n=200_000, seed=11)
        contig = contig_from_record(rec)
        seq = rec.seq
        # spacers at NGG sites, with 0..3 substitutions
        sites = [p for p in range(0, len(seq) - 23, 7) if seq[p + 21 : p + 23] == "GG"]
        spacers = []
        for i, p in enumerate(sites[:1000]):
            s = list(seq[p : p + 20])
            for j in rng.choice(20, size=i % 4, replace=False):
                s[j] = "ACGT"[("ACGT".index(s[j]) + 1) % 4]
            spacers.append("".join(s))
        t0 = time.perf_counter()
        want = tuples(oracle_scan(spacers, contig, 3, pam="NGG"))
        print(f"  oracle: {time.perf_counter() - t0:.3f} s, {len(want)} hits", flush=True)
        for backend in ("auto", "pallas"):
            got = tuples(scan_contig(spacers, contig, 3, pam="NGG", backend=backend))
            expect(f"backend {backend} == oracle", got == want, True)
        expect("oracle hits >= spacers", len(want) >= len(spacers), True)

    phases.run("5 oracle cross-check", oracle)


# ---------------------------------------------------------------- four cards
def four_cards(phases: Phases, work: str):
    import jax

    card = phases.card

    def mesh_scan():
        import bench
        from barcoder_tpu.parallel import sharded_scan as ss
        from barcoder_tpu.parallel.mesh import make_mesh, make_mesh_2d
        from barcoder_tpu.utils.platform import TILE_P as P

        if len(jax.devices()) < 4:
            raise RuntimeError(f"--four-cards needs 4 cards, JAX sees {len(jax.devices())}")
        contig, spacers = bench.build_config()
        for site_mode in ("auto", "never"):
            one = None
            for name, mesh in (("make_mesh(1)", make_mesh(1)), ("make_mesh(4)", make_mesh(4)),
                               ("make_mesh_2d(2, 2)", make_mesh_2d(2, 2))):
                dt, hits = best_of(lambda: ss.sharded_scan(
                    spacers, contig, 3, pam="NGG", mesh=mesh, P=P, site_mode=site_mode))
                print(f"  headline site_mode={site_mode} on {name}: {len(hits)} hits, "
                      f"{dt:.6f} s end to end ({card})", flush=True)
                if one is None:
                    one = tuples(hits)
                    expect("headline hits", len(hits), 745)
                else:
                    expect(f"{name} == make_mesh(1)", tuples(hits) == one, True)
        print("  device-resident inputs and their shardings:")
        for cache in (ss._GENOME_SHARD_CACHE, ss._Q_SHARD_CACHE):
            for key, v in cache.items():
                sh = getattr(v, "sharding", None)
                if sh is not None and len(sh.device_set) > 1:
                    label = key[0] if isinstance(key[0], str) else "q_onehot"
                    print(f"    {label:>10} {tuple(v.shape)}: {sh}")

    phases.run("4-card mesh scan", mesh_scan)

    def sharded_count():
        from barcoder_tpu.parallel.sharded_count import make_read_mesh

        print(f"  read mesh: {make_read_mesh()}")
        bc, fq, truth = write_count_workload(work)
        t0 = time.perf_counter()
        tsv = run_cli(["count", bc, fq, "--engine", "sharded"])
        print(f"  count --engine sharded on {len(jax.devices())} cards: "
              f"{time.perf_counter() - t0:.3f} s (first call; {card})", flush=True)
        check_counts(tsv, truth)

    phases.run("4-card count --engine sharded", sharded_count)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh path and its comparison")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform {dev.platform!r})", file=sys.stderr)
        return 2
    import barcoder_tpu  # noqa: F401  (fails outside the repository)

    cards = card_lines()
    # the label every timing carries: the card, and how many when several
    card = cards[0] if len(set(cards)) == 1 else " / ".join(cards)
    if len(cards) > 1:
        card = f"{len(cards)} x {card}"
    print(f"jax {jax.__version__}; device_kind {dev.device_kind}; "
          f"devices {len(jax.devices())}")
    for line in cards:
        print(f"card: {line}")
    for mod in ("pandas", "rich", "zstandard"):
        try:
            m = __import__(mod)
            print(f"import {mod}: ok {getattr(m, '__version__', '')}")
        except ImportError as e:
            print(f"import {mod}: missing ({e})")
    from barcoder_tpu.utils.jaxcache import cache_dir

    print(f"compile cache: {cache_dir()}", flush=True)

    phases = Phases(card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        (four_cards if args.four_cards else one_card)(phases, work)
    if phases.failed:
        print(f"chip_smoke: failed phases: {', '.join(phases.failed)}", file=sys.stderr)
        return 1
    for line in cards:
        print(f"card: {line}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
