"""Scan-engine correctness: planted-guide property tests + oracle↔XLA
agreement (SURVEY.md §4 test strategy)."""

import numpy as np
import pytest

from barcoder_tpu.core.encode import decode, revcomp
from barcoder_tpu.core.genome import contig_from_record
from barcoder_tpu.ops.oracle import oracle_scan
from barcoder_tpu.ops.ref_scan import jax_scan
from barcoder_tpu.ops.types import STRAND_F, STRAND_R, Hits

from .genomes import make_record, plant_guide, random_seq


def hits_tuples(h: Hits):
    return set(zip(h.spacer_idx.tolist(), h.pos.tolist(), h.strand.tolist(), h.mismatches.tolist()))


def mutate(seq: str, positions, rng) -> str:
    s = list(seq)
    for p in positions:
        s[p] = {"A": "C", "C": "G", "G": "T", "T": "A"}[s[p]]
    return "".join(s)


@pytest.fixture(scope="module")
def circ_contig():
    rec = make_record(n=8000, topology="circular", seed=1)
    return rec, contig_from_record(rec)


class TestPlantedGuides:
    def test_exact_forward(self):
        rec = make_record(n=4000, seed=2)
        rng = np.random.default_rng(3)
        g = random_seq(20, rng)
        plant_guide(rec, g, 1000)
        contig = contig_from_record(rec)
        hits = oracle_scan([g], contig, 0)
        assert (0, 1000, STRAND_F, 0) in hits_tuples(hits)

    def test_exact_reverse(self):
        rec = make_record(n=4000, seed=4)
        rng = np.random.default_rng(5)
        g = random_seq(20, rng)
        plant_guide(rec, g, 2000, strand="R")
        contig = contig_from_record(rec)
        hits = hits_tuples(oracle_scan([g], contig, 0))
        assert (0, 2000, STRAND_R, 0) in hits

    def test_mismatch_threshold(self):
        rng = np.random.default_rng(6)
        rec = make_record(n=4000, seed=6)
        g = random_seq(24, rng)
        plant_guide(rec, mutate(g, [3, 10], rng), 500)
        contig = contig_from_record(rec)
        t1 = hits_tuples(oracle_scan([g], contig, 1))
        t2 = hits_tuples(oracle_scan([g], contig, 2))
        assert not any(p == 500 for _, p, _, _ in t1)
        assert (0, 500, STRAND_F, 2) in t2

    def test_origin_wrap(self, circ_contig):
        rec, _ = circ_contig
        rng = np.random.default_rng(7)
        g = random_seq(20, rng)
        rec2 = make_record(n=8000, topology="circular", seed=1)
        plant_guide(rec2, g, 7990)  # wraps: 10 bases at end, 10 at start
        contig = contig_from_record(rec2)
        hits = hits_tuples(oracle_scan([g], contig, 0))
        assert (0, 7990, STRAND_F, 0) in hits

    def test_linear_no_wrap(self):
        rec = make_record(n=4000, topology="linear", seed=8)
        rng = np.random.default_rng(8)
        g = random_seq(20, rng)
        plant_guide(rec, g, 3990)  # would wrap; linear must not report
        contig = contig_from_record(rec)
        hits = hits_tuples(oracle_scan([g], contig, 3))
        assert not any(p == 3990 for _, p, _, _ in hits)

    def test_pam_filtering(self):
        rec = make_record(n=4000, seed=9)
        rng = np.random.default_rng(9)
        g = random_seq(20, rng)
        plant_guide(rec, g, 700, pam="CGG", strand="F")
        plant_guide(rec, g, 1700)  # no PAM planted
        contig = contig_from_record(rec)
        hits = hits_tuples(oracle_scan([g], contig, 0, pam="NGG"))
        assert (0, 700, STRAND_F, 0) in hits
        nopam = {t for t in hits if t[1] == 1700}
        # site at 1700 only reported if the random context happens to be NGG
        ctx = rec.seq[1720:1723]
        assert bool(nopam) == (ctx[1:3] == "GG")

    def test_pam_reverse_strand(self):
        rec = make_record(n=4000, seed=10)
        rng = np.random.default_rng(10)
        g = random_seq(20, rng)
        plant_guide(rec, g, 900, pam="AGG", strand="R")
        contig = contig_from_record(rec)
        hits = hits_tuples(oracle_scan([g], contig, 0, pam="NGG"))
        assert (0, 900, STRAND_R, 0) in hits

    def test_upstream_pam(self):
        rec = make_record(n=4000, seed=11)
        rng = np.random.default_rng(11)
        g = random_seq(20, rng)
        plant_guide(rec, g, 800, pam="TTTC", strand="F", pam_direction="upstream")
        contig = contig_from_record(rec)
        hits = hits_tuples(
            oracle_scan([g], contig, 0, pam="TTTN", pam_direction="upstream")
        )
        assert (0, 800, STRAND_F, 0) in hits

    def test_n_in_genome_never_matches(self):
        rec = make_record(n=2000, seed=12)
        rng = np.random.default_rng(12)
        g = random_seq(20, rng)
        plant_guide(rec, g, 300)
        rec.seq = rec.seq[:305] + "N" + rec.seq[306:]
        contig = contig_from_record(rec)
        assert not any(
            p == 300 for _, p, _, _ in hits_tuples(oracle_scan([g], contig, 0))
        )
        assert (0, 300, STRAND_F, 1) in hits_tuples(oracle_scan([g], contig, 1))

    def test_palindrome_both_strands(self):
        # a palindromic site matches F and R at the same position
        rec = make_record(n=2000, seed=13)
        g = "ACGTACGTACGCGTACGTACGT"[:20]
        g = g[:10] + revcomp(g[:10])
        plant_guide(rec, g, 600)
        contig = contig_from_record(rec)
        hits = hits_tuples(oracle_scan([g], contig, 0))
        assert (0, 600, STRAND_F, 0) in hits
        assert (0, 600, STRAND_R, 0) in hits


class TestJaxOracleAgreement:
    @pytest.mark.parametrize("topology", ["circular", "linear"])
    @pytest.mark.parametrize("v", [0, 1, 3])
    def test_random_agreement(self, topology, v):
        rng = np.random.default_rng(42 + v)
        rec = make_record(n=6000, topology=topology, seed=42)
        spacers = [random_seq(20, rng) for _ in range(8)]
        # plant some with varying mutations so hits exist
        for i, s in enumerate(spacers[:6]):
            mutated = mutate(s, list(range(i % 4)), rng)
            plant_guide(rec, mutated, 500 + 700 * i, strand="F" if i % 2 else "R")
        contig = contig_from_record(rec)
        a = hits_tuples(oracle_scan(spacers, contig, v))
        b = hits_tuples(jax_scan(spacers, contig, v))
        assert a == b
        if v >= (0 % 4):
            assert len(a) > 0

    def test_agreement_with_pam(self):
        rng = np.random.default_rng(77)
        rec = make_record(n=6000, seed=77)
        spacers = [random_seq(20, rng) for _ in range(6)]
        for i, s in enumerate(spacers):
            plant_guide(rec, s, 400 + 800 * i, pam="TGG", strand="F" if i % 2 else "R")
        contig = contig_from_record(rec)
        a = hits_tuples(oracle_scan(spacers, contig, 1, pam="NGG"))
        b = hits_tuples(jax_scan(spacers, contig, 1, pam="NGG"))
        assert a == b
        assert len(a) >= 6

    def test_agreement_chunk_boundary(self):
        # position chunking must not drop hits at chunk edges
        rng = np.random.default_rng(88)
        rec = make_record(n=3000, seed=88)
        g = random_seq(20, rng)
        for p in [1020, 1023, 1024, 1025, 2040]:
            plant_guide(rec, g, p)
        contig = contig_from_record(rec)
        a = hits_tuples(oracle_scan([g], contig, 0))
        b = hits_tuples(jax_scan([g], contig, 0, chunk=1024))
        assert a == b


def test_long_pam_falls_back_to_jax():
    # PAM longer than the traced spec's MAX_PAM slots routes pallas_scan to
    # the XLA path; results must still match the oracle
    rng = np.random.default_rng(61)
    rec = make_record(n=2000, topology="circular", seed=61)
    g = random_seq(20, rng)
    pam = "NGGNGGNGGNGGN"  # 13 nt > ops.pallas_scan.MAX_PAM (12)
    plant_guide(rec, g, 600, pam="AGGTGGCGGAGGA")
    contig = contig_from_record(rec)
    from barcoder_tpu.ops.pallas_scan import MAX_PAM, pallas_scan

    assert len(pam) > MAX_PAM
    a = oracle_scan([g], contig, 1, pam=pam)
    b = pallas_scan([g], contig, 1, pam=pam, P=512, interpret=True)
    at = set(zip(a.spacer_idx.tolist(), a.pos.tolist(), a.strand.tolist(), a.mismatches.tolist()))
    bt = set(zip(b.spacer_idx.tolist(), b.pos.tolist(), b.strand.tolist(), b.mismatches.tolist()))
    assert at == bt and len(at) >= 1


def test_sharded_backend_dispatch_matches_oracle():
    """ops.scan backend='sharded' routes through the multi-device engine
    (1..N-device mesh over whatever devices exist) with the same contract
    as every other backend; long PAMs fall back to the XLA path."""
    from barcoder_tpu.ops.scan import scan_contig

    rng = np.random.default_rng(77)
    rec = make_record(n=3000, topology="circular", seed=77)
    g = random_seq(20, rng)
    plant_guide(rec, g, 700, pam="TGG")
    plant_guide(rec, g, 1500, pam="AGG")
    contig = contig_from_record(rec)
    a = oracle_scan([g], contig, 1, pam="NGG")
    b = scan_contig([g], contig, 1, pam="NGG", backend="sharded")
    at = set(zip(a.spacer_idx.tolist(), a.pos.tolist(), a.strand.tolist(), a.mismatches.tolist()))
    bt = set(zip(b.spacer_idx.tolist(), b.pos.tolist(), b.strand.tolist(), b.mismatches.tolist()))
    assert at == bt and len(at) >= 2

    # long-PAM fallback keeps the contract too
    pam13 = "NGGNGGNGGNGGN"
    c = scan_contig([g], contig, 1, pam=pam13, backend="sharded")
    d = oracle_scan([g], contig, 1, pam=pam13)
    ct = set(zip(c.spacer_idx.tolist(), c.pos.tolist(), c.strand.tolist(), c.mismatches.tolist()))
    dt = set(zip(d.spacer_idx.tolist(), d.pos.tolist(), d.strand.tolist(), d.mismatches.tolist()))
    assert ct == dt


def test_auto_backend_prefers_sharded_on_multichip(monkeypatch):
    """auto = the sharded engine on every platform and device count (a
    1-device mesh on one card); the one platform decision
    (utils.platform.device_platform) refuses anything but gpu/cpu."""
    import jax

    from barcoder_tpu.ops import scan as scan_mod
    from barcoder_tpu.utils import platform as plat

    class _Dev:
        def __init__(self, platform):
            self.platform = platform

    monkeypatch.delenv("BARCODER_TPU_BACKEND", raising=False)
    for devs in ([_Dev("cpu")], [_Dev("gpu")], [_Dev("gpu")] * 4):
        monkeypatch.setattr(jax, "devices", lambda devs=devs: devs)
        assert scan_mod.resolve_backend("auto") == "sharded"
        assert plat.device_platform() == devs[0].platform
    monkeypatch.setattr(jax, "devices", lambda: [_Dev("rocm")])
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        plat.device_platform()
    monkeypatch.setenv("BARCODER_TPU_BACKEND", "oracle")
    assert scan_mod.resolve_backend("auto") == "oracle"


def test_small_sub_width_rejected():
    """sub_width so small that the phase-2 subtile (P2) cannot cover the
    halo (K//4) silently CLAMPED tile slices and scored the last spacer
    bases against wrong genome codes (r5 review) — must raise up front,
    matching the sharded engine's guard."""
    from barcoder_tpu.ops.pallas_scan import pallas_scan

    rec = make_record(n=2000, seed=62)
    contig = contig_from_record(rec)
    with pytest.raises(ValueError, match="halo"):
        pallas_scan([random_seq(20, np.random.default_rng(0))], contig, 1,
                    pam="NGG", P=512, sub_width=16, interpret=True)


def test_compact_hits_k_clamped_to_row_width():
    """The retry protocol grows k to powers of two, which for
    non-power-of-two row widths can exceed the row width — lax.top_k then
    raises mid-retry. _compact_hits clamps k internally; results must
    stay complete (k=P captures every hit in a row)."""
    import jax.numpy as jnp

    from barcoder_tpu.ops.pallas_scan import _compact_hits

    rng = np.random.default_rng(7)
    hit = rng.random((2, 4, 6)) < 0.5  # row width 6, not a power of two
    mm = rng.integers(0, 3, size=hit.shape)
    idx, mm_vals, n_hits, n_rows, max_rh = _compact_hits(
        jnp.asarray(hit), jnp.asarray(mm), cap=64, cap_rows=16, k=16
    )
    idx = np.asarray(idx)
    got = {(int(i) // 6, int(i) % 6) for i in idx if i >= 0}
    want = {(r, c) for r in range(8) for c in range(6) if hit.reshape(8, 6)[r, c]}
    assert got == want
    assert int(n_hits) == hit.sum()


def test_tiny_circular_contig_pam_wrap():
    """Circular left-halo PAM reads on a contig SHORTER than the PAM spec
    window (MAX_PAM=12): dynamic_slice clamped the negative start and read
    the contig head instead of the wrapped tail (r5 review) — the DEVICE
    site mask (_pam_ok_device, the one the kernels fuse) must agree with
    the host-side oracle masks for both strands and directions."""
    import jax.numpy as jnp

    from barcoder_tpu.core.encode import encode
    from barcoder_tpu.core.genome import Contig
    from barcoder_tpu.ops import pallas_scan as ps
    from barcoder_tpu.ops.prep import build_scan_array, site_masks

    seq = "ACGTACGG"  # 8 bp circular; left halo must wrap multiply
    contig = Contig(id="tiny", length=8, codes=encode(seq), seq=seq,
                    topology="circular")
    L = 4
    scan = build_scan_array(contig, L)
    n_starts_b = 8
    scan_padded = np.full(n_starts_b + len(scan) - 8 + ps.MAX_PAM, 4,
                          np.int8)
    scan_padded[: len(scan)] = scan
    # the engine appends MAX_PAM wrap codes after the L-1 halo; replicate
    for j in range(ps.MAX_PAM):
        scan_padded[len(scan) + j] = contig.codes[(L - 1 + j) % 8]
    scan_dev = jnp.asarray(scan_padded)
    for pam, direction in [("GG", "upstream"), ("GG", "downstream"),
                           ("NG", "upstream"), ("NGG", "downstream")]:
        mask_f, mask_r = site_masks(contig, L, pam, direction)
        shift_f, pat_f, shift_r, pat_r = ps._pam_specs(pam, direction, L)
        for shift, pat, host in [(shift_f, pat_f, mask_f),
                                 (shift_r, pat_r, mask_r)]:
            pat_arr = np.full(ps.MAX_PAM, 7, np.int8)
            pat_arr[: len(pat)] = pat
            dev = np.asarray(ps._pam_ok_device(
                scan_dev, jnp.int32(8), jnp.int32(shift),
                jnp.asarray(pat_arr), n_starts_b=n_starts_b, L=L,
                circular=True,
            ))[:8]
            assert (dev == host[:8].astype(bool)).all(), (
                pam, direction, shift, dev, host[:8])


def test_short_contig_and_empty_library_all_backends(mesh8_or_none=None):
    """r5 review repros: a contig shorter than the spacer and an
    empty-list library must yield empty Hits on EVERY backend (the shared
    contract), not crash in site enumeration / spacer_matrix."""
    import jax

    from barcoder_tpu.core.genome import Contig
    from barcoder_tpu.core.encode import encode
    from barcoder_tpu.ops.pallas_scan import pallas_scan
    from barcoder_tpu.parallel.mesh import make_mesh
    from barcoder_tpu.parallel.sharded_scan import sharded_scan

    seq = "ACGTACGTAC"  # 10 bp
    for topo in ("linear", "circular"):
        tiny = Contig(id="t", length=10, codes=encode(seq), seq=seq,
                      topology=topo)
        sp = ["A" * 20]
        assert len(oracle_scan(sp, tiny, 1, pam="NGG")) == 0
        assert len(jax_scan(sp, tiny, 1, pam="NGG")) == 0
        assert len(pallas_scan(sp, tiny, 1, pam="NGG", P=512,
                               interpret=True)) == 0
        mesh = make_mesh(min(8, len(jax.devices())))
        assert len(sharded_scan(sp, tiny, 1, pam="NGG", mesh=mesh,
                                P=256)) == 0

    rec = make_record(n=3000, seed=70)
    contig = contig_from_record(rec)
    for fn in (oracle_scan, jax_scan):
        assert len(fn([], contig, 1, pam="NGG")) == 0
    assert len(pallas_scan([], contig, 1, pam="NGG", P=512,
                           interpret=True)) == 0


def test_env_backend_validated(monkeypatch):
    """BARCODER_TPU_BACKEND typos must fail at resolution with the valid
    choices listed, and 'auto' must mean automatic, not a literal
    backend name."""
    from barcoder_tpu.ops.scan import resolve_backend

    monkeypatch.setenv("BARCODER_TPU_BACKEND", "shardd")
    with pytest.raises(ValueError, match="not a scan backend"):
        resolve_backend("auto")
    monkeypatch.setenv("BARCODER_TPU_BACKEND", "auto")
    assert resolve_backend("auto") in ("jax", "sharded", "pallas")
    monkeypatch.setenv("BARCODER_TPU_BACKEND", "oracle")
    assert resolve_backend("auto") == "oracle"
