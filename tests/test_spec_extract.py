"""Speculative device-chained phase 2 (extract_spec): the single-fetch
fast path must agree with the oracle, and overflow must fall back to the
batched extract_full path with identical results.

Runs the FULL pallas_scan flow (phase-1 Pallas kernel in interpret mode +
pure-XLA speculative extraction) on CPU."""

import numpy as np
import pytest

from barcoder_tpu.core.genome import contig_from_record
from barcoder_tpu.ops.oracle import oracle_scan
from barcoder_tpu.ops.pallas_scan import _QPrep, _ScanJob, pallas_scan
from barcoder_tpu.ops.prep import spacer_matrix

from .genomes import make_record, plant_guide, random_seq


def tuples(h):
    return set(
        zip(h.spacer_idx.tolist(), h.pos.tolist(), h.strand.tolist(), h.mismatches.tolist())
    )


@pytest.mark.parametrize("topology", ["circular", "linear"])
@pytest.mark.slow
def test_spec_path_matches_oracle(topology):
    rng = np.random.default_rng(7)
    rec = make_record(n=4000, topology=topology, seed=7)
    guides = [random_seq(20, rng) for _ in range(8)]
    for i, g in enumerate(guides):
        plant_guide(
            rec, g, 137 + i * 413,
            pam="TGG" if i % 3 else "AGG",
            strand="F" if i % 2 else "R",
        )
    contig = contig_from_record(rec)
    got = pallas_scan(guides, contig, 2, pam="NGG", P=512, interpret=True)
    want = oracle_scan(guides, contig, 2, pam="NGG")
    assert tuples(got) == tuples(want)
    assert len(got) >= 8  # every planted guide found (PAM planted)


@pytest.mark.slow
def test_spec_overflow_falls_back():
    rng = np.random.default_rng(9)
    rec = make_record(n=4000, topology="circular", seed=9)
    guides = [random_seq(20, rng) for _ in range(8)]
    for i, g in enumerate(guides):
        plant_guide(rec, g, 120 + i * 410, pam="TGG", strand="R" if i % 2 else "F")
    contig = contig_from_record(rec)
    q_f = spacer_matrix(guides)
    prep = _QPrep(q_f, 2, "NGG", "downstream", 512, 128)
    prep.spec_B = 1  # force n_pairs > spec_B on every scan with >1 pair
    job = _ScanJob(prep, contig, True)
    got = job.collect()
    want = oracle_scan(guides, contig, 2, pam="NGG")
    assert tuples(got) == tuples(want)
    assert len(got) >= 8


@pytest.mark.slow
def test_spec_hit_cap_overflow_falls_back():
    # many hits of one spacer: n_hits > spec_cap must discard the
    # speculative result and produce the same table via the batched path
    rng = np.random.default_rng(11)
    rec = make_record(n=3000, topology="circular", seed=11)
    g = random_seq(20, rng)
    positions = list(range(0, 2900, 29))
    for p in positions:
        plant_guide(rec, g, p, pam="TGG")
    contig = contig_from_record(rec)
    q_f = spacer_matrix([g])
    prep = _QPrep(q_f, 0, "NGG", "downstream", 512, 128)
    prep.spec_cap = 16  # far below the ~100 planted hits
    job = _ScanJob(prep, contig, True)
    got = job.collect()
    want = oracle_scan([g], contig, 0, pam="NGG")
    assert tuples(got) == tuples(want)
    assert len(got) > 16


@pytest.mark.slow
def test_n_bases_through_2bit_ship():
    # genomic Ns ride the sparse exception list of the 2-bit device ship
    # (_build_scan_device); windows covering an N must never match, and
    # the PAM N-wildcard must still match a genomic N
    rng = np.random.default_rng(13)
    rec = make_record(n=2000, topology="circular", seed=13)
    g = random_seq(20, rng)
    plant_guide(rec, g, 300, pam="TGG")
    plant_guide(rec, g, 900, pam="TGG")
    s = list(rec.seq)
    s[905] = "N"  # poisons the 900 plant
    for i in range(1500, 1540):
        s[i] = "N"  # a run of Ns elsewhere
    s[3] = "N"  # near the origin: wrap halo must carry it
    rec.seq = "".join(s)
    contig = contig_from_record(rec)
    got = tuples(pallas_scan([g], contig, 0, pam="NGG", P=512, interpret=True))
    want = tuples(oracle_scan([g], contig, 0, pam="NGG"))
    assert got == want
    assert any(p == 300 for _, p, _, _ in got)
    assert not any(p == 900 for _, p, _, _ in got)


def test_n_at_position_zero():
    """An N at genome position 0 must survive the sparse-exception scatter
    (r5 review, reproduced: -1 fill slots clip to index 0 and their
    duplicate .set() write could clobber the real N restoration in XLA's
    unspecified update order — a contig starting with an assembly gap was
    scored as starting with 'A'). Now a commutative max scatter."""
    rng = np.random.default_rng(17)
    rec = make_record(n=2000, topology="circular", seed=17)
    g = random_seq(20, rng)
    plant_guide(rec, g, 600, pam="TGG")
    s = list(rec.seq)
    s[0] = "N"
    rec.seq = "".join(s)
    # a spacer whose window covers position 0 with 'A' there: must NOT
    # match at mm=0 (N never matches)
    probe = "A" + rec.seq[1:20]
    contig = contig_from_record(rec)
    got = tuples(pallas_scan([g, probe], contig, 0, pam="NGG", P=512, interpret=True))
    want = tuples(oracle_scan([g, probe], contig, 0, pam="NGG"))
    assert got == want
    assert not any(si == 1 and p == 0 for si, p, _, _ in got)
    assert any(si == 0 and p == 600 for si, p, _, _ in got)


@pytest.mark.slow
def test_tiny_contig_nibble_fallback():
    # contigs shorter than the wrap-halo length use the nibble ship path
    rng = np.random.default_rng(17)
    rec = make_record(n=30, topology="circular", seed=17)
    g = rec.seq[5:25]
    contig = contig_from_record(rec)
    got = tuples(pallas_scan([g], contig, 0, P=512, interpret=True))
    want = tuples(oracle_scan([g], contig, 0))
    assert got == want and any(p == 5 for _, p, _, _ in got)


@pytest.mark.slow
def test_dense_repeat_topk_retry():
    # >4 hits of one spacer inside a single phase-2 subtile forces the
    # max_row_hits > k retry in _compact_hits; results must stay exact
    rng = np.random.default_rng(19)
    rec = make_record(n=4000, topology="circular", seed=19)
    g = random_seq(20, rng)
    positions = list(range(1000, 1000 + 17 * 24, 24))  # 17 plants in 408 bp
    for p in positions:
        plant_guide(rec, g, p, pam="TGG")
    contig = contig_from_record(rec)
    got = tuples(pallas_scan([g], contig, 0, pam="NGG", P=512, interpret=True))
    want = tuples(oracle_scan([g], contig, 0, pam="NGG"))
    assert got == want
    found = {p for _, p, _, _ in got}
    assert sum(p in found for p in positions) >= 12  # later plants can clobber earlier ones


def test_strided_pack_roundtrips():
    """Block-strided 2-bit/nibble packing (r5: the device unpack must be a
    flat plane concat, never a small-minor-axis stack whose tiled lane
    padding inflates 32-64x — the 250 Mb site-table OOM class): host pack →
    device unpack is the identity for every length class."""
    import numpy as np

    from barcoder_tpu.ops.pallas_scan import (
        _pack_2bit,
        _pack_nibbles,
        _unpack_2bit_planes,
        _unpack_nibbles,
    )

    rng = np.random.default_rng(0)
    import jax.numpy as jnp

    for n in (1, 2, 3, 4, 5, 7, 8, 257, 4096, 10001):
        codes = rng.integers(0, 4, size=n).astype(np.int8)
        got = np.asarray(_unpack_2bit_planes(jnp.asarray(_pack_2bit(codes)), n))
        assert got.tolist() == codes.tolist(), f"2bit n={n}"
        codes7 = rng.integers(0, 6, size=n).astype(np.int8)
        got = np.asarray(_unpack_nibbles(jnp.asarray(_pack_nibbles(codes7)), total=n))
        assert got.tolist() == codes7.tolist(), f"nibble n={n}"
