"""Phase 1 (the per-(spacer block, subtile) hit-column counts): the
Triton-route kernel in Pallas interpret mode against the plain-XLA
reference, the reference's bounded stepping against one unbounded step,
the kernel's block geometry, and the platform's choice between the two.
The compiled kernel itself runs only on the card (marked ``gpu``)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from barcoder_tpu.ops import pallas_scan as ps
from barcoder_tpu.utils import platform as plat


def _inputs(*, L, S, S_pad, P, n_tiles, fold, bias_rows, matrix, seed):
    """Random phase-1 operands with planted copies of spacers at 0..3
    mismatches, so every threshold has hits; rows >= S are padding (zero
    one-hot rows, as the engines pad)."""
    rng = np.random.default_rng(seed)
    K = max(-(-4 * L // 128) * 128, 128)
    codes = rng.integers(0, 4, size=(S, L))
    q = np.zeros((S_pad, K), np.float32)
    q[np.arange(S)[:, None], 4 * np.arange(L)[None, :] + codes] = 1.0
    if fold:
        q[: S_pad // 2, 4 * L] = 1.0
        q[S_pad // 2 :, 4 * L + bias_rows - 1] = 1.0
    if matrix:
        L_pad = -(-L // 8) * 8
        tiles = rng.integers(0, 5, size=(n_tiles, L_pad, P)).astype(np.int32)
    else:
        tiles = rng.integers(0, 4, size=(n_tiles, 1, P + K // 4)).astype(np.int32)
    bias = np.where(
        rng.random((n_tiles, bias_rows, P)) < 0.6, 0.0, ps.MASK_BIAS
    ).astype(np.float32)
    # non-overlapping planting slots, left unmasked
    per_tile = (P - L) // (L + 1)
    for i, s in enumerate(range(0, S, 5)[: per_tile * n_tiles]):
        site = codes[s].copy()
        site[: i % 4] = (site[: i % 4] + 1) % 4  # i % 4 mismatches
        t, p = i % n_tiles, (i // n_tiles) * (L + 1)
        if matrix:
            tiles[t, :L, p] = site
        else:
            tiles[t, 0, p : p + L] = site
        bias[t, :, p] = 0.0
    if matrix:
        bias = np.zeros((n_tiles, 1, P), np.float32)
    return K, jnp.asarray(q, jnp.bfloat16), jnp.asarray(tiles), jnp.asarray(bias)


# (name, geometry): n_sblocks = S_pad // BS_M is never a multiple of 8 here
CASES = {
    "fold_two_bias_rows": dict(L=20, S=370, S_pad=384, BS_M=128, P=512, SUB=1,
                               n_tiles=3, fold=True, bias_rows=2, matrix=False),
    "fold_one_bias_row": dict(L=20, S=1200, S_pad=1280, BS_M=256, P=512, SUB=4,
                              n_tiles=2, fold=True, bias_rows=1, matrix=False),
    "additive_L32": dict(L=32, S=250, S_pad=256, BS_M=128, P=256, SUB=2,
                         n_tiles=2, fold=False, bias_rows=1, matrix=False),
    "matrix_rows": dict(L=20, S=600, S_pad=640, BS_M=128, P=512, SUB=1,
                        n_tiles=2, fold=False, bias_rows=1, matrix=True),
}


def _run(case, v, *, group=ps.HIT_GROUP, seed=0):
    g = dict(CASES[case])
    L, P, SUB, BS_M = g["L"], g["P"], g["SUB"], g["BS_M"]
    K, q, tiles, bias = _inputs(
        L=L, S=g["S"], S_pad=g["S_pad"], P=P, n_tiles=g["n_tiles"],
        fold=g["fold"], bias_rows=g["bias_rows"], matrix=g["matrix"], seed=seed,
    )
    th = jnp.full((1,), L - v, jnp.float32)
    kw = dict(L=L, K=K, P=P, SUB=SUB, BS_M=BS_M, fold_bias=g["fold"],
              matrix_rows=g["matrix"])
    got = ps.scan_block_hits(th, q, tiles, bias, interpret=True, group=group, **kw)
    want = ps.phase1_reference(th, q, tiles, bias, **kw)
    return np.asarray(got), np.asarray(want), g


@pytest.mark.parametrize("v", [0, 1, 2, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_reference(case, v):
    got, want, g = _run(case, v)
    n_sblocks = g["S_pad"] // g["BS_M"]
    assert got.shape == want.shape == (
        g["n_tiles"], -(-n_sblocks // 8) * 8, g["SUB"]
    )
    assert (got == want).all()
    assert (want > 0).any()  # the planted sites hit at every threshold
    assert (got[:, n_sblocks:, :] == 0).all()  # padding block rows


def test_kernel_spacer_groups_split_across_programs():
    """More spacer blocks than one program scores: the groups' loop bounds
    (including a short last group) cover every block exactly once."""
    got, want, _ = _run("fold_one_bias_row", 2, group=2)
    assert (got == want).all() and (want > 0).any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_bounded_reference_matches_unbounded(case):
    """The bounded plain-XLA phase 1 (lax.map over tiles and spacer-block
    chunks) equals one unbounded step over everything."""
    g = dict(CASES[case])
    L, P = g["L"], g["P"]
    K, q, tiles, bias = _inputs(
        L=L, S=g["S"], S_pad=g["S_pad"], P=P, n_tiles=g["n_tiles"],
        fold=g["fold"], bias_rows=g["bias_rows"], matrix=g["matrix"], seed=1,
    )
    th = jnp.full((1,), L - 2, jnp.float32)
    kw = dict(L=L, K=K, P=P, SUB=g["SUB"], BS_M=g["BS_M"], fold_bias=g["fold"],
              matrix_rows=g["matrix"])
    one_step = ps.phase1_reference(th, q, tiles, bias, budget_bytes=1 << 40, **kw)
    # one spacer block per step, one tile per step
    tiny = ps.phase1_reference(th, q, tiles, bias, budget_bytes=1, **kw)
    # two blocks per step: the last chunk is padded with zero rows
    two = ps.phase1_reference(
        th, q, tiles, bias, budget_bytes=2 * P * 4 * g["BS_M"], **kw
    )
    assert (np.asarray(one_step) == np.asarray(tiny)).all()
    assert (np.asarray(one_step) == np.asarray(two)).all()
    assert (np.asarray(one_step) > 0).any()


@pytest.mark.parametrize(
    "P,SUB,want", [(512, 1, 128), (16384, 32, 128), (512, 16, 32), (256, 4, 64)]
)
def test_block_cols_divide_the_subtile(P, SUB, want):
    assert ps._hit_block_cols(P, SUB) == want


def test_block_cols_reject_narrow_subtiles():
    with pytest.raises(ValueError, match="divisible by 16"):
        ps._hit_block_cols(96, 4)  # 24-wide subtiles


def test_phase1_hits_follows_the_platform(monkeypatch):
    """The compiled kernel on the GPU, the reference on the CPU; the
    BARCODER_TPU_PHASE1=xla override and interpret mode as documented."""
    calls = []
    monkeypatch.setattr(ps, "scan_block_hits",
                        lambda *a, interpret=False, **k: calls.append(("kernel", interpret)))
    monkeypatch.setattr(ps, "phase1_reference", lambda *a, **k: calls.append(("xla",)))
    monkeypatch.delenv("BARCODER_TPU_PHASE1", raising=False)
    for platform, want in (("gpu", ("kernel", False)), ("cpu", ("xla",))):
        monkeypatch.setattr(ps, "device_platform", lambda p=platform: p)
        ps.phase1_hits(None, None, None, None)
        assert calls.pop() == want
    ps.phase1_hits(None, None, None, None, interpret=True)
    assert calls.pop() == ("kernel", True)
    monkeypatch.setattr(ps, "device_platform", lambda: "gpu")
    monkeypatch.setenv("BARCODER_TPU_PHASE1", "xla")
    ps.phase1_hits(None, None, None, None)
    assert calls.pop() == ("xla",)


def test_phase1_choice_validated(monkeypatch):
    monkeypatch.setenv("BARCODER_TPU_PHASE1", "pallas")
    with pytest.raises(ValueError, match="BARCODER_TPU_PHASE1"):
        plat.phase1_kernel_enabled("gpu")
    monkeypatch.setenv("BARCODER_TPU_PHASE1", "kernel")
    assert plat.phase1_kernel_enabled("gpu") is True
    assert plat.phase1_kernel_enabled("cpu") is False


def _tuples(h):
    return set(zip(h.spacer_idx.tolist(), h.pos.tolist(), h.strand.tolist(),
                   h.mismatches.tolist()))


def test_sharded_engine_runs_the_kernel_in_interpret_mode():
    """The sharded engine with the kernel (interpret mode) inside its
    shard_map agrees with the oracle, dense and site paths."""
    from barcoder_tpu.core.genome import contig_from_record
    from barcoder_tpu.ops.oracle import oracle_scan
    from barcoder_tpu.parallel.mesh import make_mesh
    from barcoder_tpu.parallel.sharded_scan import sharded_scan

    from .genomes import make_record, plant_guide, random_seq

    rng = np.random.default_rng(5)
    rec = make_record(n=3000, topology="circular", seed=5)
    g = random_seq(20, rng)
    plant_guide(rec, g, 700, pam="TGG")
    plant_guide(rec, g, 1900, pam="AGG", strand="R")
    contig = contig_from_record(rec)
    want = oracle_scan([g], contig, 2, pam="NGG")
    mesh = make_mesh(2)
    for site_mode in ("never", "always"):
        got = sharded_scan([g], contig, 2, pam="NGG", mesh=mesh, P=256,
                           use_pallas=True, interpret=True, site_mode=site_mode)
        assert _tuples(got) == _tuples(want) and len(want) == 2, site_mode


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA card; chip_smoke.py runs this check there")


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_compiled_kernel_matches_reference(gpu, case):
    g = dict(CASES[case])
    L, P = g["L"], g["P"]
    K, q, tiles, bias = _inputs(
        L=L, S=g["S"], S_pad=g["S_pad"], P=P, n_tiles=g["n_tiles"],
        fold=g["fold"], bias_rows=g["bias_rows"], matrix=g["matrix"], seed=2,
    )
    th = jnp.full((1,), L - 3, jnp.float32)
    kw = dict(L=L, K=K, P=P, SUB=g["SUB"], BS_M=g["BS_M"], fold_bias=g["fold"],
              matrix_rows=g["matrix"])
    got = ps.scan_block_hits(th, q, tiles, bias, **kw)
    want = ps.phase1_reference(th, q, tiles, bias, **kw)
    assert (np.asarray(got) == np.asarray(want)).all()
