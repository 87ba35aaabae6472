"""Hamming-scan engine — the framework's alignment engine.

Replaces Bowtie's FM-index seed-and-extend search (reference:
targets.py:467-539) with brute-force scoring of every (spacer, genome
position) pair as a one-hot matrix product on the tensor cores.

Formulation
-----------
For spacers of length L, let K = 4L rounded up to a multiple of 128. Each
spacer row is one-hot encoded as Q[s, 4j+b] = 1 iff spacer_s[j] is base b
(N → zero row). For a block of genome positions the phase-1 kernel builds
G[4j+b, p] = 1 iff genome[p+j] == b from int32 base codes, then

    scores = Q @ G          # bf16 in / f32 accumulate
    mismatches = L - scores

A position hits iff mismatches <= v and the precomputed PAM/site mask allows
it. The scan is *two-phase* to avoid materializing the S×N score matrix:

  phase 1 (scan_block_hits): per (spacer-block, subtile) hit *counts* — a
      tiny output with the threshold + PAM mask fused into the product's
      epilogue, so no score leaves the kernel;
  phase 2 (XLA): re-score only the nonzero (block, subtile) pairs — a
      sparse, hit-proportional workload — and emit exact positions +
      mismatch counts.

The product spends 2·K FLOPs per (spacer, position) pair scanned (K = 128
for L <= 32).
"""

from __future__ import annotations

import functools
import hashlib
from collections import OrderedDict

import numpy as np

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ..core.genome import Contig
from ..utils.jaxcache import enable_compilation_cache
from ..utils.platform import TILE_P, device_platform, phase1_kernel_enabled
from .prep import build_scan_array, spacer_matrix
from .types import STRAND_F, STRAND_R, Hits

enable_compilation_cache()

BS = 128  # smallest spacer block (rows per phase-1 block)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def onehot_rows(q_codes: np.ndarray, K: int) -> np.ndarray:
    """(S, L) codes → (S, K) one-hot rows with layout col = 4*j + base."""
    S, L = q_codes.shape
    out = np.zeros((S, K), dtype=np.float32)
    cols = 4 * np.arange(L)[None, :] + np.clip(q_codes, 0, 3)
    valid = q_codes < 4
    rows = np.broadcast_to(np.arange(S)[:, None], cols.shape)
    out[rows[valid], cols[valid]] = 1.0
    return out


MASK_BIAS = -16384.0  # added to masked-out positions; far below any score


# phase-1 kernel geometry: each program owns HIT_BP genome columns and a
# group of spacer blocks, scored HIT_BM rows per product
HIT_BP = 128  # columns per program (the product's N)
HIT_BM = 128  # spacer rows per product (the product's M)
HIT_GROUP = 64  # spacer blocks per program: bounds each program's share of
# Q (64 x 512 rows x 256 B = 8 MB) so the programs in flight keep one
# group resident in L2 while they sweep the genome columns
HIT_NUM_WARPS = 4  # (4, 2) was the fastest of (4|8 warps) x (2|3|4 stages)
HIT_NUM_STAGES = 2  # on the H100 at the headline, L=32 and design shapes


def _hits_kernel(th_ref, q_ref, tiles_ref, bias_ref, out_ref, *, L, K, P, BP, BM,
                 BS_M, n_sblocks, group, fold_bias, bias_rows, matrix_rows):
    """Phase-1 body for one (column block, spacer-block group) program.

    G (K, BP) is built in registers from the int32 base codes with one
    gathered load (row 4j+b reads code j of each column's window), and the
    folded site/PAM bias rows (4L, 4L+1) are spliced in from the bias
    tiles. Each spacer block of BS_M rows is scored BM rows at a time; the
    epilogue keeps only the per-column max, thresholds it and stores the
    count of hit columns — no score leaves the program. Programs are
    independent (no carry between them), so they run in any order."""
    c, grp = pl.program_id(0), pl.program_id(1)
    t = c // (P // BP)
    off = (c % (P // BP)) * BP
    r = jax.lax.broadcasted_iota(jnp.int32, (K, BP), 0)
    p = jax.lax.broadcasted_iota(jnp.int32, (K, BP), 1)
    j = jnp.minimum(r // 4, L - 1)
    if matrix_rows:
        codes = tiles_ref[t, j, off + p]
    else:
        codes = tiles_ref[t, 0, off + p + j]
    g = jnp.where((r < 4 * L) & (codes == r % 4), 1.0, 0.0)
    cols = pl.ds(off, BP)
    add = None
    if fold_bias:
        for i in range(bias_rows):
            g = jnp.where(r == 4 * L + i, bias_ref[t, i, cols][None, :], g)
    else:
        add = bias_ref[t, 0, cols]
    g = g.astype(jnp.bfloat16)
    th = th_ref[0]

    def block(sb, carry):
        # one Q load per loop step: the pipeliner keeps num_stages copies
        # of each load of the innermost loop in shared memory
        def rows(i, colmax):
            q = q_ref[pl.ds(sb * BS_M + i * BM, BM), :]
            return jnp.maximum(colmax, jnp.max(pl.dot(q, g), axis=0))

        colmax = jax.lax.fori_loop(
            0, BS_M // BM, rows, jnp.full((BP,), -jnp.inf, jnp.float32)
        )
        if add is not None:
            colmax = colmax + add
        out_ref[sb, c] = jnp.sum(jnp.where(colmax >= th, 1.0, 0.0))
        return carry

    lo = grp * group
    jax.lax.fori_loop(lo, jnp.minimum(lo + group, n_sblocks), block, 0)


def _hit_block_cols(P: int, SUB: int) -> int:
    """Columns per kernel program: a power of two that divides the
    phase-2 subtile width P // SUB (each program's count then belongs to
    exactly one subtile) and is at least 16 wide (the product's minimum)."""
    P2 = P // SUB
    bp = HIT_BP
    while bp > 16 and P2 % bp:
        bp //= 2
    if P2 % bp or SUB * P2 != P:
        raise ValueError(
            f"phase-1 kernel needs a subtile width divisible by 16 (P={P}, SUB={SUB})"
        )
    return bp


def scan_block_hits(thresh, q_onehot, tiles, bias_tiles, *, L, K, P, SUB=1,
                    BS_M=BS, interpret=False, fold_bias=False, matrix_rows=False,
                    group=HIT_GROUP):
    """Phase 1 (hit-indicator), compiled for the GPU through Pallas on the
    Triton route. thresh f32 (1,) — a score >= thresh is a hit (callers
    pass L - v); q_onehot (S_pad, K) bf16 with a constant-1 column at 4L
    (and 4L+1 for the second bias row) when fold_bias; tiles
    (n_tiles, 1, P + K//4) int32 overlapped genome codes, or with
    ``matrix_rows`` (n_tiles, L_pad, P) independent site-window codes;
    bias_tiles (n_tiles, bias_rows, P) f32 (0 where the site/PAM mask
    allows, MASK_BIAS where not).

    Returns (n_tiles, n_sb_pad8, SUB) f32: the number of hit columns per
    (tile, spacer block, subtile of P // SUB positions); entry > 0 iff the
    pair contains a hit. The spacer-block dim is padded to a multiple of 8
    with zero rows (the pair decode indexes this layout). ``group`` is the
    number of spacer blocks one program scores."""
    bias_rows = bias_tiles.shape[1]
    if fold_bias and 4 * L + bias_rows > K:
        raise ValueError(
            f"fold_bias needs spare G rows: 4L+{bias_rows}={4*L+bias_rows} > K={K}"
        )
    if not fold_bias and bias_rows != 1:
        raise ValueError("multiple bias rows require fold_bias")
    S_pad = q_onehot.shape[0]
    n_sblocks = S_pad // BS_M
    n_sb_pad8 = _cdiv(n_sblocks, 8) * 8
    n_tiles = tiles.shape[0]
    BP = _hit_block_cols(P, SUB)
    BM = min(HIT_BM, BS_M)
    n_cblocks = n_tiles * (P // BP)
    group = min(group, n_sblocks)
    kernel = functools.partial(
        _hits_kernel, L=L, K=K, P=P, BP=BP, BM=BM, BS_M=BS_M,
        n_sblocks=n_sblocks, group=group, fold_bias=fold_bias,
        bias_rows=bias_rows, matrix_rows=matrix_rows,
    )
    counts = pl.pallas_call(
        kernel,
        grid=(n_cblocks, _cdiv(n_sblocks, group)),
        out_shape=jax.ShapeDtypeStruct((n_sblocks, n_cblocks), jnp.float32),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=HIT_NUM_WARPS, num_stages=HIT_NUM_STAGES
        ),
        cost_estimate=pl.CostEstimate(
            flops=2 * n_cblocks * S_pad * K * BP,
            bytes_accessed=S_pad * K * 2 * _cdiv(n_sblocks, group)
            + tiles.size * 4 + bias_tiles.size * 4,
            transcendentals=0,
        ),
        interpret=interpret,
        name="scan_block_hits",
    )(thresh, q_onehot, tiles.astype(jnp.int32), bias_tiles)
    return _counts_to_subtiles(counts, n_tiles=n_tiles, SUB=SUB, n_sb_pad8=n_sb_pad8)


def _counts_to_subtiles(counts, *, n_tiles, SUB, n_sb_pad8):
    """(n_sblocks, n_cblocks) per-program counts → the phase-1 contract
    (n_tiles, n_sb_pad8, SUB): column blocks sum into their subtile."""
    n_sblocks = counts.shape[0]
    per_sub = counts.reshape(n_sblocks, n_tiles, SUB, -1).sum(axis=3)
    return jnp.pad(
        per_sub.transpose(1, 0, 2), ((0, 0), (0, n_sb_pad8 - n_sblocks), (0, 0))
    )


PHASE1_BUDGET_BYTES = 1 << 30  # score transient of one phase1_reference step


def phase1_reference(thresh, q_onehot, tiles, bias_tiles, *, L, K, P, SUB=1,
                     BS_M=BS, fold_bias=False, matrix_rows=False,
                     budget_bytes=PHASE1_BUDGET_BYTES):
    """Plain-XLA phase 1 with scan_block_hits' exact contract (same folded
    bias rows, same per-subtile hit-column counts).

    Bounded: the f32 score transient of one step stays within
    ``budget_bytes`` — ``lax.map`` walks the tiles (several per step when
    they fit) and, inside a tile, chunks of spacer blocks — so a
    design-scale library against a whole genome never materializes the
    (n_tiles, S_pad, P) score tensor."""
    S_pad = q_onehot.shape[0]
    n_sblocks = S_pad // BS_M
    n_sb_pad8 = _cdiv(n_sblocks, 8) * 8
    col_bytes = P * 4
    n_chunks = _cdiv(n_sblocks, max(1, budget_bytes // (col_bytes * BS_M)))
    chunk = _cdiv(n_sblocks, n_chunks)
    rows = chunk * BS_M
    q_ch = jnp.pad(q_onehot, ((0, n_chunks * rows - S_pad), (0, 0))).reshape(
        n_chunks, rows, K
    )  # zero rows score 0 < thresh: padding never hits

    def per_tile(args):
        tile, bias = args
        if matrix_rows:
            g = (
                tile[:L, None, :] == jnp.arange(4, dtype=tile.dtype)[None, :, None]
            ).reshape(4 * L, P).astype(jnp.bfloat16)
            if 4 * L < K:
                g = jnp.pad(g, ((0, K - 4 * L), (0, 0)))
        else:
            g = _build_g_onehot(tile[0], L=L, K=K, P=P)
        add = None
        if fold_bias:
            for i in range(bias.shape[0]):
                g = g.at[4 * L + i, :].set(bias[i].astype(g.dtype))
        else:
            add = bias[0]

        def per_chunk(qc):
            scores = jnp.dot(qc, g, preferred_element_type=jnp.float32)
            colmax = scores.reshape(chunk, BS_M, P).max(axis=1)
            if add is not None:
                colmax = colmax + add[None, :]
            hit = colmax >= thresh[0]
            return hit.reshape(chunk, SUB, P // SUB).sum(axis=2).astype(jnp.float32)

        cnt = jax.lax.map(per_chunk, q_ch).reshape(-1, SUB)[:n_sblocks]
        return jnp.pad(cnt, ((0, n_sb_pad8 - n_sblocks), (0, 0)))

    tiles_per_step = max(1, budget_bytes // (col_bytes * rows)) if n_chunks == 1 else 1
    return jax.lax.map(
        per_tile, (tiles.astype(jnp.int32), bias_tiles),
        batch_size=min(tiles_per_step, tiles.shape[0]),
    )


def phase1_hits(thresh, q_onehot, tiles, bias_tiles, *, use_kernel=None,
                interpret=False, **kw):
    """Phase 1 as the platform decides: the compiled kernel on the GPU,
    the plain-XLA reference on the CPU. ``interpret=True`` runs the kernel
    in Pallas interpret mode (tests); ``use_kernel`` overrides the choice
    (the kernel-vs-XLA comparison)."""
    if use_kernel is None:
        use_kernel = phase1_kernel_enabled(device_platform())
    if use_kernel or interpret:
        return scan_block_hits(
            thresh, q_onehot, tiles, bias_tiles, interpret=interpret, **kw
        )
    return phase1_reference(thresh, q_onehot, tiles, bias_tiles, **kw)


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_starts", "halo", "L", "K", "P", "thresh", "cap", "cap_rows", "k",
        "circular",
    ),
)
def extract_full(q_blocks_all, scan_dev, n_real, shift, pat, sc_p, tc_p, valid, *, n_starts, halo, L, K, P, thresh, cap, circular, cap_rows=0, k=4):
    """One-dispatch phase 2: subtile arrays + PAM mask built on device,
    scoring + compaction fused; shift/pat traced (shared executable across
    strands and PAMs). Production batches use _tiles_and_mask +
    _extract_chunk instead (genome inputs built once, not per batch);
    this single-dispatch form remains for profiling/one-shot use and is
    composed from the SAME helpers so the two cannot drift."""
    tiles, mask_tiles = _tiles_and_mask_impl(
        scan_dev, n_real, shift, pat, n_starts=n_starts, halo=halo, L=L, P=P,
        circular=circular,
    )
    return _extract_body(q_blocks_all, tiles, mask_tiles, sc_p, tc_p, valid, L=L, K=K, P=P, thresh=thresh, cap=cap, cap_rows=cap_rows, k=k)


def _tiles_and_mask_impl(scan_dev, n_real, shift, pat, *, n_starts, halo, L,
                         P, circular):
    tiles = _tiles_device_impl(scan_dev, n_starts=n_starts, P=P, halo=halo)
    ok = _pam_ok_device(
        scan_dev, n_real, shift, pat, n_starts_b=n_starts, L=L,
        circular=circular,
    )
    n_tiles = _cdiv(n_starts, P)
    return tiles, ok.astype(jnp.int32).reshape(n_tiles, 1, P)


@functools.partial(
    jax.jit, static_argnames=("n_starts", "halo", "L", "P", "circular")
)
def _tiles_and_mask(scan_dev, n_real, shift, pat, *, n_starts, halo, L, P,
                    circular):
    """Phase-2 genome inputs built ONCE per (contig, strand): the subtile
    matrix and the PAM mask tiles. The batched fallback used to rebuild
    both inside EVERY extract_full dispatch — identical work per batch,
    ~4 bytes/bp of transient HBM traffic each time (r5 review)."""
    return _tiles_and_mask_impl(
        scan_dev, n_real, shift, pat, n_starts=n_starts, halo=halo, L=L, P=P,
        circular=circular,
    )


@functools.partial(jax.jit, static_argnames=("n_starts", "halo", "P"))
def _tiles_only(scan_dev, *, n_starts, halo, P):
    """Strand-independent half of _tiles_and_mask: the subtile matrix is
    the same for both strands, so the batched fallback builds it once per
    contig and only the PAM mask per strand."""
    return _tiles_device_impl(scan_dev, n_starts=n_starts, P=P, halo=halo)


@functools.partial(jax.jit, static_argnames=("n_starts", "L", "P", "circular"))
def _mask_only(scan_dev, n_real, shift, pat, *, n_starts, L, P, circular):
    """Per-strand half of _tiles_and_mask (shift/pat traced: one executable
    serves every strand and PAM)."""
    ok = _pam_ok_device(
        scan_dev, n_real, shift, pat, n_starts_b=n_starts, L=L,
        circular=circular,
    )
    n_tiles = _cdiv(n_starts, P)
    return ok.astype(jnp.int32).reshape(n_tiles, 1, P)


@functools.partial(jax.jit, static_argnames=("L", "K", "P", "thresh", "cap", "cap_rows", "k"))
def _extract_chunk(q_blocks_all, tiles, mask_tiles, sc_p, tc_p, valid, *, L, K, P, thresh, cap, cap_rows=0, k=4):
    return _extract_body(q_blocks_all, tiles, mask_tiles, sc_p, tc_p, valid, L=L, K=K, P=P, thresh=thresh, cap=cap, cap_rows=cap_rows, k=k)


def _extract_body(q_blocks_all, tiles, mask_tiles, sc_p, tc_p, valid, *, L, K, P, thresh, cap, cap_rows=0, k=4):
    """Phase 2 scoring for a batch of (spacer-block, tile) pairs, with
    on-device hit compaction — only ``cap`` flat indices + mismatch counts
    cross the device boundary, never the dense n×BS×P hit matrix — and all
    gathers fused into this one dispatch.

    Compaction is HIERARCHICAL: XLA lowers sized nonzero as a sort, and a
    flat nonzero over the full B*bs*P hit tensor (67M elements at design
    batch sizes) would sort all of it — so first compact the (B*bs,) rows that
    contain any hit (a row = one spacer in one subtile, so n_rows <=
    n_hits), then nonzero only the gathered rows. Row capacity cap//16
    scales with the caller's retry doubling; overflow of either level is
    signaled through the returned count.

    q_blocks_all (n_sblocks, BS, K) bf16; tiles (n_tiles, 1, P + K//4);
    mask_tiles (n_tiles, 1, P); sc_p/tc_p (B,) pair indices; valid (B,)
    masks padding pairs →
    (flat_idx int32 (cap,) with -1 fill, mm_vals int32 (cap,),
     n_hits, n_rows, max_row_hits int32 — if n_hits > cap, n_rows > the
     row capacity, or max_row_hits > k, the caller must retry with
     capacities >= those counts)."""
    q_oh_blocks = q_blocks_all[sc_p]
    g_tiles = tiles[tc_p]
    mask_chunk = mask_tiles[tc_p]
    g_oh = _build_g_onehot(g_tiles[:, 0, :], L=L, K=K, P=P)
    scores = jnp.einsum(
        "nsk,nkp->nsp", q_oh_blocks, g_oh, preferred_element_type=jnp.float32
    )
    mm = (L - scores).astype(jnp.int32)
    hit = (
        (mm <= thresh)
        & (mask_chunk[:, 0, :][:, None, :] > 0)
        & valid[:, None, None]
    )
    # default floor sized for design-scale batches (~1-2 hit rows per pair
    # at EXTRACT_BATCH pairs); the row gather is (cap_rows, P) int32
    cap_rows = cap_rows or max(cap // 16, 2 * EXTRACT_BATCH)
    return _compact_hits(hit, mm, cap=cap, cap_rows=cap_rows, k=k)


def _compact_hits(hit, mm, *, cap, cap_rows, k=4):
    """Hierarchical on-device hit compaction shared by every phase-2 body.

    XLA lowers a sized ``jnp.nonzero`` as a full sort, so neither the dense
    B*bs*P tensor nor the row-gathered (cap_rows, P) matrix is nonzero'd
    directly. Three levels instead:

      1. compact the (B*bs,) rows containing any hit (nonzero over B*bs);
      2. per gathered row, take the top-``k`` hit POSITIONS with
         ``lax.top_k`` (hits/row is ~1; k=4 default) instead of a flat
         sort of the (cap_rows, P) matrix;
      3. nonzero only the (cap_rows*k,) slot-validity vector.

    mm values are gathered per final index from the original tensor (a
    (cap,) gather) rather than materializing a row-gathered mm matrix.

    Returns (flat row-space indices int32 (cap,) -1-filled, mm int32
    (cap,), n_hits, n_rows, max_row_hits); results are complete iff
    n_hits <= cap AND n_rows <= cap_rows AND max_row_hits <= k — otherwise
    the caller retries with capacities sized from the returned counts (one
    retry, not a doubling walk)."""
    B, bs_, P_ = hit.shape
    # a row holds at most P_ hits, so k > P_ is never needed — and the
    # retry protocol grows k to powers of two, which for non-power-of-two
    # row widths could exceed P_ and crash lax.top_k mid-retry (r5
    # review); the clamp keeps results complete (k=P_ captures every hit)
    # and the caller's worst_rh <= k_top convergence check intact
    k = min(k, P_)
    rows = hit.reshape(B * bs_, P_)
    anyrow = rows.any(axis=1)
    n_rows = anyrow.sum().astype(jnp.int32)
    (ridx,) = jnp.nonzero(anyrow, size=cap_rows, fill_value=-1)
    safe = jnp.clip(ridx, 0, B * bs_ - 1)
    sub_hit = rows[safe] & (ridx >= 0)[:, None]  # (cap_rows, P)
    max_row_hits = rows.sum(axis=1).max().astype(jnp.int32)
    keyed = jnp.where(sub_hit, jax.lax.iota(jnp.int32, P_)[None, :] + 1, 0)
    topv = jax.lax.top_k(keyed, k)[0]  # (cap_rows, k) position+1; 0 = none
    flat2 = (topv > 0).reshape(-1)
    (s,) = jnp.nonzero(flat2, size=cap, fill_value=-1)
    s_safe = jnp.clip(s, 0, flat2.shape[0] - 1)
    row_g = ridx[s_safe // k]
    col = topv.reshape(-1)[s_safe] - 1
    flat_src = jnp.clip(row_g, 0, B * bs_ - 1) * P_ + jnp.clip(col, 0, P_ - 1)
    mm_vals = mm.reshape(-1)[flat_src]
    idx = jnp.where(s >= 0, row_g * P_ + col, -1).astype(jnp.int32)
    n_hits = hit.sum().astype(jnp.int32)
    return idx, mm_vals.astype(jnp.int32), n_hits, n_rows, max_row_hits


def _pam_specs(pam: str, direction: str, L: int):
    """Static (shift, pattern-codes) per strand, mirroring
    core.pam.pam_site_masks window placement. Pattern codes: 0-3 bases,
    4 = N wildcard, 6 = letter outside ACGTN (never matches)."""
    def enc(ch: str) -> int:
        return "ACGT".index(ch) if ch in "ACGT" else (4 if ch == "N" else 6)

    if not pam:
        return 0, (), 0, ()
    p = pam.upper()
    pat = tuple(enc(c) for c in p)
    # reverse-complement-of-window match: window matches revcomp(pat)
    # with complemented codes (wildcards stay wildcards)
    comp = {0: 3, 1: 2, 2: 1, 3: 0, 4: 4, 6: 6}
    pat_rc_comp = tuple(comp[c] for c in pat[::-1])
    m = len(pat)
    if direction == "downstream":
        return L, pat, -m, pat_rc_comp
    if direction == "upstream":
        return -m, pat, L, pat_rc_comp
    raise ValueError(f"pam direction must be 'downstream' or 'upstream', got {direction!r}")


K_SPEC = 4  # top-k row capacity of the one-shot speculative phase 2: the
# spec paths run _compact_hits at this fixed k and signal overflow past it
# (the batched fallback then grows k dynamically); ONE constant so the
# compaction call and the overflow signal can never diverge

EXTRACT_BATCH = 4096  # pairs per phase-2 dispatch: at bs=512/P2=128 a
# 4096-pair batch stays ~3 GB of HBM intermediates — design-scale scans
# (every candidate hits its own site -> pairs ~ S) drop from hundreds of
# dispatches to a handful


def _batch_buckets(n: int, cap: int = EXTRACT_BATCH) -> int:
    """Pad pair batches to a few fixed sizes so compiles are reused.

    ``cap`` bounds the bucket at the caller's batch size: _QPrep shrinks
    extract_batch below EXTRACT_BATCH when P2 > 512 specifically to bound
    the phase-2 score tensor, and re-inflating a full chunk back to 4096
    pairs would double that HBM budget (r5 review)."""
    for b in (32, 256, 1024, EXTRACT_BATCH):
        if b >= cap:
            break
        if n <= b:
            return b
    return cap


def _geom_bucket(n: int, quantum: int) -> int:
    """Round n up to quantum * {8..16}/8 * 2^k — geometric size buckets so
    jit compiles (keyed on static shapes) are reused across genomes and
    libraries at <= 12.5% padding waste. Padding is real matmul work, so
    bucket waste converts into scan time (the E.coli config pads 14% at
    1/4 steps, 2.5% at these 1/8 steps); each distinct bucket costs one
    persistent-cached compile."""
    n = max(n, 1)
    units = _cdiv(n, quantum)
    k = max(units.bit_length() - 1, 0)
    base = 1 << k
    for m in range(8, 17):
        cand = (base * m) // 8
        if units <= cand:
            return cand * quantum
    return 2 * base * quantum


def _build_g_onehot(g_flat, *, L, K, P):
    """codes (..., W) → one-hot G (..., K, P) with layout row = 4j+b,
    built from a stacked window tensor in one vectorized compare (keeps the
    XLA graph small — an unrolled .at[].set loop here costs minutes of
    compile time for L=32)."""
    windows = jnp.stack(
        [jax.lax.dynamic_slice_in_dim(g_flat, j, P, axis=-1) for j in range(L)],
        axis=-2,
    )  # (..., L, P)
    onehot = windows[..., :, None, :] == jnp.arange(4, dtype=g_flat.dtype)[None, :, None]
    g4l = onehot.astype(jnp.bfloat16).reshape(*g_flat.shape[:-1], 4 * L, P)
    if 4 * L < K:
        pad = [(0, 0)] * (g4l.ndim - 2) + [(0, K - 4 * L), (0, 0)]
        g4l = jnp.pad(g4l, pad)
    return g4l


@functools.partial(jax.jit, static_argnames=("L", "K", "P", "thresh", "cap"))
def _extract_tile(q_blocks, valid, g_tile, mask_tile, *, L, K, P, thresh, cap):
    """Phase-2 scoring for many spacer blocks against ONE tile (the
    dense-hit path: G is built once and shared across all pairs of the
    tile). q_blocks (m, BS, K) bf16; valid (m,) bool (padding rows off);
    g_tile (1, 1, W) int32; mask_tile (1, 1, P) int32."""
    m = q_blocks.shape[0]
    g_oh = _build_g_onehot(g_tile[0, 0], L=L, K=K, P=P)
    scores = jnp.dot(
        q_blocks.reshape(-1, K), g_oh, preferred_element_type=jnp.float32
    ).reshape(m, BS, P)
    mm = (L - scores).astype(jnp.int32)
    hit = (mm <= thresh) & (mask_tile[0, 0][None, None, :] > 0) & valid[:, None, None]
    flat = hit.reshape(-1)
    (idx,) = jnp.nonzero(flat, size=cap, fill_value=-1)
    mm_vals = mm.reshape(-1)[jnp.clip(idx, 0, flat.shape[0] - 1)]
    return idx.astype(jnp.int32), mm_vals, flat.sum().astype(jnp.int32)


def extract_hits_grouped(
    t_idx: np.ndarray,
    s_idx: np.ndarray,
    tiles,
    mask_tiles,
    q_blocks_all,
    *,
    S: int,
    L: int,
    K: int,
    P: int,
    thresh: int,
    strand: int,
    group_width: int = 512,
) -> list[Hits]:
    """Dense-hit phase-2 driver: pairs grouped by tile so G is built once
    per tile; pair lists chunked to a fixed ``group_width`` for a single
    compiled shape.

    SMALL-SHAPE TEST DRIVER ONLY (kept for the phase-2 agreement tests):
    its inner _extract_tile runs a sized ``jnp.nonzero`` over the dense
    per-chunk hit tensor, which XLA lowers as a SORT — at production
    shapes (group_width 512, P 16384) that is a ~1e9-element device sort
    per tile group (CLAUDE.md nonzero rule). The production paths are
    _ScanJob/_SiteScanJob.collect, which compact hierarchically
    (_compact_hits)."""
    out: list[Hits] = []
    order = np.argsort(t_idx, kind="stable")
    t_sorted = t_idx[order]
    s_sorted = s_idx[order]
    boundaries = np.nonzero(np.diff(t_sorted))[0] + 1
    starts = np.concatenate(([0], boundaries))
    ends = np.concatenate((boundaries, [len(t_sorted)]))
    valid_template = np.zeros(group_width, dtype=bool)
    for g0, g1 in zip(starts, ends):
        tile = int(t_sorted[g0])
        sbs = s_sorted[g0:g1]
        for c0 in range(0, len(sbs), group_width):
            chunk = sbs[c0 : c0 + group_width]
            m = len(chunk)
            sc_p = np.zeros(group_width, dtype=chunk.dtype)
            sc_p[:m] = chunk
            valid = valid_template.copy()
            valid[:m] = True
            q_blocks = q_blocks_all[jnp.asarray(sc_p)]
            cap = 1 << 14
            while True:
                idx, mm_vals, n_hits = _extract_tile(
                    q_blocks, jnp.asarray(valid), tiles[tile : tile + 1],
                    mask_tiles[tile : tile + 1],
                    L=L, K=K, P=P, thresh=thresh, cap=cap,
                )
                n_hits = int(n_hits)
                if n_hits <= cap:
                    break
                cap = max(cap * 2, 1 << (n_hits - 1).bit_length())
            idx = np.asarray(idx)[:n_hits]
            mm_vals = np.asarray(mm_vals)[:n_hits]
            if n_hits == 0:
                continue
            mi = idx // (BS * P)
            rem = idx % (BS * P)
            si = rem // P
            pi = rem % P
            spacer_idx = chunk[mi] * BS + si
            pos = tile * P + pi
            keep = spacer_idx < S
            out.append(
                Hits(
                    spacer_idx=spacer_idx[keep].astype(np.int64),
                    pos=pos[keep].astype(np.int64),
                    strand=np.full(int(keep.sum()), strand, np.int8),
                    mismatches=mm_vals[keep].astype(np.int32),
                )
            )
    return out


def extract_hits_for_pairs(
    t_idx: np.ndarray,
    s_idx: np.ndarray,
    tiles,
    mask_tiles,
    q_blocks_all,
    *,
    S: int,
    L: int,
    K: int,
    P: int,
    thresh: int,
    strand: int,
    extract_batch: int = 1024,
    bs: int = BS,
) -> list[Hits]:
    """STANDALONE phase-2 reference driver (tests/test_extract.py): score
    the nonzero (tile, spacer-block) pairs in bucketed batches (one fused
    dispatch each) with on-device hit compaction, returning Hits
    fragments. All batches dispatch before any result is fetched; overflow
    retries synchronously. The production engines run their own
    pipelined variants of this loop (_ScanJob.collect /
    _SiteScanJob.collect); ``bs`` must match q_blocks_all's block height
    (production preps use 256/512 for larger libraries, not BS)."""
    out: list[Hits] = []
    pending = []
    for c0 in range(0, len(t_idx), extract_batch):
        tc = t_idx[c0 : c0 + extract_batch]
        sc = s_idx[c0 : c0 + extract_batch]
        nb = len(tc)
        bucket = _batch_buckets(nb)
        pad = bucket - nb
        tc_p = np.concatenate([tc, np.zeros(pad, tc.dtype)])
        sc_p = np.concatenate([sc, np.zeros(pad, sc.dtype)])
        valid = np.zeros(bucket, dtype=bool)
        valid[:nb] = True
        cap = 1 << 16
        args = (
            q_blocks_all, tiles, mask_tiles,
            jnp.asarray(sc_p), jnp.asarray(tc_p), jnp.asarray(valid),
        )
        kw = dict(L=L, K=K, P=P, thresh=thresh)
        fut = _extract_chunk(*args, cap=cap, **kw)
        pending.append((tc, sc, nb, cap, fut, args, kw))

    for tc, sc, nb, cap, fut, args, kw in pending:
        idx, mm_vals, n_hits, n_rows, max_rh = (
            fut[0], fut[1], int(fut[2]), int(fut[3]), int(fut[4])
        )
        cap_rows, k = max(cap // 16, 2 * EXTRACT_BATCH), 4
        while n_hits > cap or n_rows > cap_rows or max_rh > k:
            # counts are exact, so one retry at the next power of two suffices
            cap = max(cap, 1 << (max(n_hits, 1) - 1).bit_length())
            cap_rows = max(cap_rows, 1 << (max(n_rows, 1) - 1).bit_length())
            k = max(k, 1 << (max(max_rh, 1) - 1).bit_length())
            idx, mm_vals, n_hits, n_rows, max_rh = _extract_chunk(
                *args, cap=cap, cap_rows=cap_rows, k=k, **kw
            )
            n_hits, n_rows, max_rh = int(n_hits), int(n_rows), int(max_rh)
        idx = np.asarray(idx)[:n_hits]
        mm_vals = np.asarray(mm_vals)[:n_hits]
        if n_hits == 0:
            continue
        bi = idx // (bs * P)
        rem = idx % (bs * P)
        si = rem // P
        pi = rem % P
        keep = bi < nb
        bi, si, pi, mm_vals = bi[keep], si[keep], pi[keep], mm_vals[keep]
        spacer_idx = sc[bi] * bs + si
        pos = tc[bi] * P + pi
        keep2 = spacer_idx < S  # padding rows can't hit, but be safe
        out.append(
            Hits(
                spacer_idx=spacer_idx[keep2].astype(np.int64),
                pos=pos[keep2].astype(np.int64),
                strand=np.full(int(keep2.sum()), strand, np.int8),
                mismatches=mm_vals[keep2].astype(np.int32),
            )
        )
    return out


MAX_PAM = 12  # pattern slots in the traced PAM spec (reference PAMs are 2-4 nt)


_DIGEST_MEMO: OrderedDict = OrderedDict()
_DIGEST_MEMO_MAX = 64


def _content_digest(arr: np.ndarray) -> bytes:
    """Collision-safe content key for the device caches: blake2b-128 of the
    raw buffer (~1 GB/s — noise next to the h2d ship it guards). adler32
    was rejected: a 32-bit checksum colliding across two genomes with the
    same contig id/length would silently serve a stale site table.

    Memoized per live array object (id + data pointer + nbytes, validated
    by weakref): steady-state re-scans were spending ~10 ms/scan re-hashing
    the same 4.6 MB genome (shard_gap breakdown, r3). Only NON-WRITEABLE
    arrays are memoized — that enforces the immutability contract instead
    of documenting it (Contig freezes ``codes`` at construction; a writable
    array that might be mutated in place is simply re-hashed every call,
    the pre-r3 behavior)."""
    import weakref

    key = id(arr)
    ent = _DIGEST_MEMO.get(key)
    if ent is not None:
        ref, ptr, nbytes, dig = ent
        if ref() is arr and arr.ctypes.data == ptr and arr.nbytes == nbytes:
            _DIGEST_MEMO.move_to_end(key)
            return dig
        del _DIGEST_MEMO[key]
    c = arr if arr.flags.c_contiguous else np.ascontiguousarray(arr)
    dig = hashlib.blake2b(c.tobytes(), digest_size=16).digest()
    if not arr.flags.writeable:
        try:
            _DIGEST_MEMO[key] = (
                weakref.ref(arr), arr.ctypes.data, arr.nbytes, dig
            )
            while len(_DIGEST_MEMO) > _DIGEST_MEMO_MAX:
                _DIGEST_MEMO.popitem(last=False)
        except TypeError:  # pragma: no cover - non-weakrefable array subclass
            pass
    return dig


class _DeviceScanCache(OrderedDict):
    """Tiny LRU of device-resident scan arrays keyed by contig identity +
    content checksum. Re-scanning the same genome (the design pipeline
    scans it for enumeration AND for the off-target map-back; repeated CLI
    benches) skips the h2d ship + reconstruction entirely. Entries are a
    few MB of HBM each."""

    MAX = 8

    def get(self, key):
        v = super().get(key)
        if v is not None:
            self.move_to_end(key)
        return v

    def put(self, key, value):
        self[key] = value
        self.move_to_end(key)
        while len(self) > self.MAX:
            self.popitem(last=False)


_SCAN_DEV_CACHE = _DeviceScanCache()
_QPREP_CACHE = _DeviceScanCache()  # content-keyed _QPrep (library device prep)


# ONE-slot cache for design-scale _QPreps (S_pad >= the site-mode
# threshold): those pin hundreds of MB of HBM each, so the LRU-of-8
# _QPREP_CACHE must not hold them (ADVICE r3) — but evicting them entirely
# makes every repeat design run re-ship and re-prepare a ~600k-row library
# (~1 s/scan). A single slot (cleared before each insert) caps the exposure
# at one large library while keeping the repeat-design path warm.
_BIG_QPREP_SLOT: dict = {}


def _pack_nibbles(arr: np.ndarray) -> np.ndarray:
    """int8 codes 0..7 → uint8 nibble pairs, BLOCK-STRIDED: the array is
    split into 2 equal half-blocks and byte j packs (half0[j], half1[j]).

    Scan codes need 3 bits (0-5 incl. N and the OOB sentinel), so nibble
    packing halves the shipped bytes losslessly. The block-strided order
    lets the device unpack be a 1-D CONCAT of shifted planes instead of an
    interleaving stack along a size-2 minor axis (a layout that a tiled
    backend pads 2 → 128 lanes: 64x transient device memory at chromosome
    scale, r5). Whether the GPU still needs this layout is open (ROADMAP)."""
    a = arr.astype(np.uint8)
    if len(a) % 2:
        a = np.concatenate([a, np.zeros(1, np.uint8)])
    m = a.reshape(2, -1)
    return (m[0] | (m[1] << 4)).astype(np.uint8)


@functools.partial(jax.jit, static_argnames=("total",))
def _unpack_nibbles(packed, *, total):
    return jnp.concatenate([packed & 0xF, packed >> 4])[:total].astype(jnp.int8)


def _pack_2bit(arr: np.ndarray) -> np.ndarray:
    """int8 codes → uint8 with 4 codes/byte, BLOCK-STRIDED (4 equal
    quarter-blocks; byte j packs (q0[j], q1[j], q2[j], q3[j]) low crumb
    first), keeping only the 2 low bits of each code. Callers ship the
    lost information (N positions, padding, wrap halo) separately /
    reconstruct it on device — see _build_scan_device. This halves the
    nibble-packed host→device bytes. Block-strided for the same layout
    reason as _pack_nibbles: the device unpack is a flat concat of 4
    planes, never a (N, 4) stack."""
    a = arr.astype(np.uint8) & 3
    pad = (-len(a)) % 4
    if pad:
        a = np.concatenate([a, np.zeros(pad, np.uint8)])
    m = a.reshape(4, -1)
    return (m[0] | (m[1] << 2) | (m[2] << 4) | (m[3] << 6)).astype(np.uint8)


def _unpack_2bit_planes(packed, total: int):
    """Device-side inverse of _pack_2bit: flat int8 codes via a 1-D plane
    concat (layout-friendly at any scale)."""
    return jnp.concatenate(
        [packed & 3, (packed >> 2) & 3, (packed >> 4) & 3, (packed >> 6) & 3]
    )[:total].astype(jnp.int8)


@functools.partial(
    jax.jit, static_argnames=("total", "pad_code", "halo_len", "circular")
)
def _build_scan_device(packed, exc_idx, n_real, *, total, pad_code, halo_len,
                       circular):
    """Reconstruct the padded scan array (prep_scan_padded semantics) from
    2-bit genome codes + a sparse N-exception index list:

      * positions < n_real: genome codes (0-3), with exc_idx positions
        (genomic Ns) restored to 4;
      * circular wrap halo [n_real, n_real + halo_len): copy of the genome
        start (halo_len = L - 1 + MAX_PAM, static) — including restored Ns,
        since the scatter runs before the halo copy;
      * everything else: pad_code (4 = N for circular, 5 = OOB sentinel
        for linear).

    n_real is traced (one executable per size bucket); exc_idx is -1-padded
    to a power-of-two bucket. Callers must guarantee n_real >= halo_len
    (tiny contigs fall back to the nibble path)."""
    codes4 = _unpack_2bit_planes(packed, total)
    pos = jnp.arange(total, dtype=jnp.int32)
    out = jnp.where(pos < n_real, codes4, jnp.int8(pad_code))
    # commutative N-restoration scatter: -1 fill slots clip to index 0,
    # and a duplicate .set() there races (XLA's duplicate-update order is
    # unspecified) — a fill slot's stale pre-scatter value could clobber a
    # REAL N at position 0 (r5 review, reproduced). max() is order-free:
    # fills contribute 0 (<= any code), real exceptions contribute 4
    # (> codes 0-3).
    safe = jnp.clip(exc_idx, 0, total - 1)
    out = out.at[safe].max(jnp.where(exc_idx >= 0, jnp.int8(4), jnp.int8(0)))
    if circular:
        head = jax.lax.dynamic_slice(out, (0,), (halo_len,))
        out = jax.lax.dynamic_update_slice(out, head, (n_real,))
    return out


@functools.partial(jax.jit, static_argnames=("K", "fold", "rev_bias_col"))
def _q_onehot_device(q_codes, *, K, fold, rev_bias_col=0):
    """(S_pad, L) int8 spacer codes → ((S_pad, K) bf16 fwd, rev) one-hot
    matrices built on device — only ~L bytes/spacer cross the link instead
    of 2K. Layout col = 4j + base (N rows zero); constant-1 column at 4L
    when ``fold`` (folded-bias kernel contract, incl. padding rows). With
    ``rev_bias_col`` the reverse matrix's constant column lands at
    4L + rev_bias_col instead (strand-fused scans pair it with a second
    bias row in G)."""
    S_pad, L = q_codes.shape
    c = q_codes.astype(jnp.int32)
    comp = jnp.where(c < 4, 3 - c, c)[:, ::-1]  # revcomp, N stays N

    def onehot(cc, bias_col):
        oh = cc[:, :, None] == jnp.arange(4, dtype=jnp.int32)[None, None, :]
        flat = oh.reshape(S_pad, 4 * L).astype(jnp.bfloat16)
        if 4 * L < K:
            flat = jnp.pad(flat, ((0, 0), (0, K - 4 * L)))
        if fold:
            flat = flat.at[:, 4 * L + bias_col].set(1.0)
        return flat

    return onehot(c, 0), onehot(comp, rev_bias_col)


def _pam_ok_device(scan_dev, n_real, shift, pat, *, n_starts_b, L, circular):
    """Device-side PAM site mask: ok[p] = pattern matches at genome position
    p + shift (wrapping for circular contigs).

    ``shift`` (int32 scalar) and ``pat`` (int8[MAX_PAM]) are TRACED so one
    compiled executable serves every strand, direction, and PAM pattern —
    one compile instead of one per variant, for a negligible per-slot
    compute cost. Pattern
    codes: 0-3 base, 4 = N wildcard (matches genomic N, like the
    reference's '.' regex), 6 = letter outside ACGTN (never matches),
    7 = unused slot. n_real is the traced true contig length so one
    executable also serves every genome in a size bucket.

    Implementation note: each slot reads its shifted base vector as one
    CONTIGUOUS dynamic slice of a left-halo-extended array instead of a
    gather over the whole genome axis.
    Correct wrap therefore relies on scan_dev carrying L-1+MAX_PAM wrap
    codes after the genome (pallas_scan fills them) and the MAX_PAM-wide
    left halo prepended below; out-of-bounds on linear contigs is decided
    arithmetically so the N-wildcard never matches past the ends.

    Linear windows must fit ([p, p+L) within the contig)."""
    p = jnp.arange(n_starts_b, dtype=jnp.int32)
    ok = p < n_real
    if not circular:
        ok &= p <= n_real - L
    if circular:
        # modular gather, not dynamic_slice: a contig shorter than MAX_PAM
        # makes the slice start negative, and dynamic_slice CLAMPS it to 0
        # — the "left halo" would silently read the contig START instead
        # of the wrapped tail (r5 review). 12 elements, negligible cost.
        left = scan_dev[
            (n_real - MAX_PAM + jnp.arange(MAX_PAM, dtype=jnp.int32))
            % jnp.maximum(n_real, 1)
        ]
    else:
        left = jnp.full((MAX_PAM,), 5, dtype=scan_dev.dtype)  # OOB sentinel
    ext = jnp.concatenate([left, scan_dev])
    for i in range(MAX_PAM):
        pc = pat[i].astype(jnp.int32)
        base = jax.lax.dynamic_slice(
            ext, (MAX_PAM + shift + i,), (n_starts_b,)
        ).astype(jnp.int32)
        if circular:
            in_bounds = jnp.ones_like(ok)
        else:
            idx = p + (shift + i)
            in_bounds = (idx >= 0) & (idx < n_real)
        here = jnp.where(
            pc == 7,
            True,  # unused slot
            jnp.where(pc == 4, in_bounds, in_bounds & (base == pc)),
        )
        ok &= here
    return ok


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_starts", "P", "halo", "L", "K", "SUB", "BS_M", "pair_cap", "circular",
        "use_kernel", "interpret",
    ),
)
def phase1_full(scan_dev, n_real, q_onehot, shift, pat, thresh, *, n_starts, P, halo,
                L, K, SUB, BS_M=BS, pair_cap=0, circular, use_kernel=None,
                interpret=False):
    """One-dispatch phase 1: overlapped tiles, the PAM site mask, and the
    bias are all built on device from the 1-D int8 scan array, then phase 1
    runs (phase1_hits) — one dispatch per strand. shift/pat/thresh are traced
    (see _pam_ok_device) so both strands, every PAM, and every mismatch
    budget share one executable.

    With pair_cap == 0, returns the scan_block_hits indicator tensor
    (n_tiles, n_sb_pad8, SUB), entry > 0 iff the (subtile, spacer-block)
    pair has a score >= thresh. With pair_cap > 0, the nonzero entries are
    compacted ON DEVICE and only (flat_idx int32 (pair_cap,) -1-filled,
    vals int32 (pair_cap,) hit-column counts per pair, n_pairs int32) come
    back — a few-KB d2h instead of the multi-MB tensor; callers retry with
    a bigger cap when
    n_pairs > pair_cap. The per-pair counts size the phase-2 hit/row
    capacities upfront (count <= hits in the pair)."""
    tiles = _tiles_device_impl(scan_dev, n_starts=n_starts, P=P, halo=halo)
    ok = _pam_ok_device(
        scan_dev, n_real, shift, pat, n_starts_b=n_starts, L=L, circular=circular,
    )
    n_tiles = _cdiv(n_starts, P)
    bias = jnp.where(ok, 0.0, MASK_BIAS).astype(jnp.float32).reshape(n_tiles, 1, P)
    fold = 4 * L < K  # caller must have set q_onehot[:, 4L] = 1 when it holds
    ind = phase1_hits(
        thresh, q_onehot, tiles, bias, L=L, K=K, P=P, SUB=SUB, BS_M=BS_M,
        use_kernel=use_kernel, interpret=interpret, fold_bias=fold,
    )
    if pair_cap == 0:
        return ind
    return _compact_pairs(ind, pair_cap)


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_starts", "P", "halo", "L", "K", "SUB", "BS_M", "pair_cap", "circular",
        "use_kernel", "interpret",
    ),
)
def phase1_fused(scan_dev, n_real, q_all, shift_f, pat_f, shift_r, pat_r, thresh, *,
                 n_starts, P, halo, L, K, SUB, BS_M=BS, pair_cap, circular,
                 use_kernel=None, interpret=False):
    """Strand-fused phase 1: ONE kernel dispatch scores both strands.

    q_all stacks the forward one-hot rows (constant-1 column at 4L) over
    the reverse-complement rows (constant-1 column at 4L+1); G carries two
    folded bias rows — row 4L masked by the forward-strand PAM sites, row
    4L+1 by the reverse — so each spacer row picks up its own strand's
    mask from the same matmul. Halves kernel dispatches, G builds, and
    pair fetches vs per-strand phase1_full. Requires 4L + 2 <= K (L=32
    callers use the per-strand additive path)."""
    tiles = _tiles_device_impl(scan_dev, n_starts=n_starts, P=P, halo=halo)
    n_tiles = _cdiv(n_starts, P)
    biases = []
    for shift, pat in ((shift_f, pat_f), (shift_r, pat_r)):
        ok = _pam_ok_device(
            scan_dev, n_real, shift, pat, n_starts_b=n_starts, L=L, circular=circular,
        )
        biases.append(jnp.where(ok, 0.0, MASK_BIAS).astype(jnp.float32))
    bias = jnp.stack(biases, axis=0).reshape(2, n_tiles, P).transpose(1, 0, 2)
    ind = phase1_hits(
        thresh, q_all, tiles, bias, L=L, K=K, P=P, SUB=SUB, BS_M=BS_M,
        use_kernel=use_kernel, interpret=interpret, fold_bias=True,
    )
    return _compact_pairs(ind, pair_cap)


def _compact_pairs(ind, pair_cap: int):
    """(pairs int32 (pair_cap,) -1-filled, vals int32 (pair_cap,) hit-column
    counts, n_pairs int32) from the phase-1 indicator tensor."""
    flat_vals = ind.reshape(-1)
    flat = flat_vals > 0
    (pairs,) = jnp.nonzero(flat, size=pair_cap, fill_value=-1)
    vals = jnp.where(
        pairs >= 0, flat_vals[jnp.clip(pairs, 0, flat_vals.shape[0] - 1)], 0.0
    ).astype(jnp.int32)
    return pairs.astype(jnp.int32), vals, flat.sum().astype(jnp.int32)


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_starts", "halo", "L", "K", "P2", "thresh", "cap", "B", "circular",
        "n_sb_pad8", "SUB", "half_blocks",
    ),
)
def extract_spec(q_blocks_all, scan_dev, n_real, shift_f, pat_f, shift_r, pat_r,
                 pairs, n_pairs, *, n_starts, halo, L, K, P2, thresh, cap, B,
                 circular, n_sb_pad8, SUB, half_blocks):
    """Speculative phase 2, chained on the DEVICE-RESIDENT phase-1 pair list
    with no host round trip: dispatched immediately after phase1_fused, it
    scores the first ``B`` compacted pair slots (both strands — forward
    spacer blocks are s_idx < half_blocks, reverse above) and returns ONE
    packed int32 array

        [n_pairs, n_hits_signal, slots (B,), idx (cap,), mm (cap,)]

    so the entire common-case scan (phase 1 + phase 2) costs a single d2h
    fetch instead of four (pairs, n_pairs, idx/mm, n_hits). The host
    discards the result and falls back to the batched _extract_chunk path
    when n_pairs > B or n_hits_signal > cap (dense-hit scans, e.g. design).

    idx entries are flat over (B*bs, P2) row space exactly as
    _compact_hits emits them: row = slot*bs + si, column = position within
    the slot's subtile."""
    slots = pairs[:B]
    slot_ok = (jnp.arange(B, dtype=jnp.int32) < jnp.minimum(n_pairs, B)) & (slots >= 0)
    safe_slots = jnp.where(slot_ok, slots, 0)
    t_big = safe_slots // (n_sb_pad8 * SUB)
    rem = safe_slots % (n_sb_pad8 * SUB)
    s_idx = rem // SUB
    t_idx = t_big * SUB + rem % SUB  # subtile index on the P2 grid
    tiles = _tiles_device_impl(scan_dev, n_starts=n_starts, P=P2, halo=halo)
    ok_f = _pam_ok_device(
        scan_dev, n_real, shift_f, pat_f, n_starts_b=n_starts, L=L, circular=circular
    )
    ok_r = _pam_ok_device(
        scan_dev, n_real, shift_r, pat_r, n_starts_b=n_starts, L=L, circular=circular
    )
    is_rev = s_idx >= half_blocks
    mask_sel = jnp.where(
        is_rev[:, None], ok_r.reshape(-1, P2)[t_idx], ok_f.reshape(-1, P2)[t_idx]
    )  # (B, P2)
    g_oh = _build_g_onehot(tiles[t_idx][:, 0, :], L=L, K=K, P=P2)
    q = q_blocks_all[jnp.clip(s_idx, 0, q_blocks_all.shape[0] - 1)]  # (B, bs, K)
    scores = jnp.einsum("nsk,nkp->nsp", q, g_oh, preferred_element_type=jnp.float32)
    mm = (L - scores).astype(jnp.int32)
    hit = (mm <= thresh) & mask_sel[:, None, :] & slot_ok[:, None, None]
    cap_rows = max(cap // 16, 2 * B)
    idx, mm_vals, n_hits, n_rows, max_row_hits = _compact_hits(
        hit, mm, cap=cap, cap_rows=cap_rows, k=K_SPEC
    )
    # single overflow signal: > cap forces the host to fall back to the
    # batched path (which sizes its capacities from phase-1 counts)
    n_signal = jnp.where(
        (n_rows > cap_rows) | (max_row_hits > K_SPEC),
        jnp.maximum(n_hits, cap + 1),
        n_hits,
    )
    header = jnp.stack([n_pairs.astype(jnp.int32), n_signal])
    return jnp.concatenate([header, slots.astype(jnp.int32), idx, mm_vals])


def _tiles_device_impl(scan_dev: jnp.ndarray, *, n_starts: int, P: int, halo: int):
    """Device-side overlapped tile construction from the 1-D int8 scan
    array — only ~1 byte/base crosses the host↔device link instead of the
    4-byte overlapped tile matrix.

    Built from two contiguous reshapes + a concat (row t's halo is the first
    ``halo`` columns of the P-shifted reshape) instead of a whole-array
    gather."""
    n_tiles = _cdiv(n_starts, P)
    total = (n_tiles + 1) * P  # >= n_tiles*P + halo since halo <= P
    padded = jnp.full(total, 4, dtype=jnp.int32)
    usable = min(scan_dev.shape[0], total)
    padded = padded.at[:usable].set(scan_dev[:usable].astype(jnp.int32))
    body = padded[: n_tiles * P].reshape(n_tiles, P)
    shifted = padded[P : (n_tiles + 1) * P].reshape(n_tiles, P)
    return jnp.concatenate([body, shifted[:, :halo]], axis=1)[:, None, :]


def prep_scan_padded(
    contig: Contig, scan: np.ndarray, L: int, n_starts_b: int, halo_total: int
) -> np.ndarray:
    """The device scan array: genome + full wrap halo (L - 1 + MAX_PAM codes
    for circular contigs, so the slice-based PAM mask can read past the
    origin), padded to the bucketed length with 4 (N, circular) or 5 (OOB
    sentinel, linear — distinguishes real genomic N, which the PAM wildcard
    matches, from past-the-end, which it must not)."""
    n = contig.length
    pad_code = 4 if contig.circular else 5
    scan_padded = np.full(n_starts_b + halo_total, pad_code, dtype=np.int8)
    usable = min(len(scan), len(scan_padded))
    scan_padded[:usable] = scan[:usable]
    if contig.circular:
        end = min(n + L - 1 + MAX_PAM, len(scan_padded))
        if end > n + L - 1:
            extra = contig.fetch_codes(n + L - 1, end)
            scan_padded[n + L - 1 : end] = extra
    return scan_padded


def _prep_tiles(scan_codes: np.ndarray, n_starts: int, P: int, halo: int) -> np.ndarray:
    """(n_tiles, 1, P + halo) int32 overlapped tile matrix; padding positions
    get code 4 (N) so they can never match."""
    n_tiles = _cdiv(n_starts, P)
    padded = np.full(n_tiles * P + halo, 4, dtype=np.int32)
    usable = min(len(scan_codes), len(padded))
    padded[:usable] = scan_codes[:usable]
    view = np.lib.stride_tricks.sliding_window_view(padded, P + halo)[:: P]
    return np.ascontiguousarray(view[:n_tiles])[:, None, :]


def _prep_mask(mask: np.ndarray, n_starts: int, P: int) -> np.ndarray:
    n_tiles = _cdiv(n_starts, P)
    out = np.zeros((n_tiles, 1, P), dtype=np.int32)
    flat = out.reshape(-1)
    flat[:n_starts] = mask[:n_starts]
    return out


class _QPrep:
    """Per-(spacers, PAM, v) device state shared across contig scan jobs:
    spacer one-hot matrices, PAM specs, threshold, and geometry. Building
    this once and scanning many contigs against it is how multi-replicon
    genomes avoid re-shipping and re-preparing the library per contig."""

    def __init__(self, q_f, max_mismatches, pam, pam_direction, P, sub_width):
        self.S, self.L = q_f.shape
        S, L = self.S, self.L
        self.P = P
        self.K = K = max(_cdiv(4 * L, 128) * 128, 128)
        self.halo = K // 4  # tile overlap; >= L, keeps tile width 32-aligned
        # total device halo also carries MAX_PAM extra wrap codes so the
        # slice-based PAM mask can read past position n (see _pam_ok_device)
        self.halo_total = self.halo + MAX_PAM
        sub_width = min(sub_width, P)
        self.SUB = max(P // sub_width, 1)
        self.P2 = P // self.SUB  # phase-2 tile width (= subtile width)
        if self.SUB * self.P2 != P:
            # the hit kernel's segment matrix and the subtile decode both
            # assume SUB * P2 == P; a non-dividing P would silently drop
            # the trailing positions of every tile (r5 review)
            raise ValueError(
                f"P ({P}) must be divisible by its subtile count "
                f"({self.SUB}); pick P a multiple of sub_width"
            )
        if self.P2 < self.halo:
            # subtiles narrower than the halo silently CLAMP the tile
            # slice (shifted[:, :halo] on a 2*P2-wide array) and then the
            # phase-2 dynamic_slice clamps its start — the last spacer
            # bases score against wrong genome codes with no exception.
            # Same guard the sharded engine enforces.
            raise ValueError(
                f"subtile width {self.P2} must cover the halo {self.halo} "
                f"(sub_width too small for L={L})"
            )
        # phase-2 pair batches: 4096 pairs (few dispatches + compaction
        # sorts) fit device memory up to P2=512 (~4.3 GB score tensor);
        # shrink proportionally past that
        self.extract_batch = max(256, (EXTRACT_BATCH * 512) // max(self.P2, 512))
        # spacer-block height: large blocks amortize per-step grid overhead
        # and the q-block DMA; small libraries keep small blocks so padding
        # doesn't dominate.
        self.bs = 512 if S >= 2048 else (256 if S >= 512 else BS)
        self.S_pad = _geom_bucket(S, self.bs)
        self.max_mismatches = max_mismatches

        # per-strand PAM specs (shift, pattern codes) as traced device values
        shift_f, pat_f, shift_r, pat_r = _pam_specs(pam, pam_direction, L)

        def _pat_arr(pat):
            arr = np.full(MAX_PAM, 7, dtype=np.int8)
            arr[: len(pat)] = pat
            return jnp.asarray(arr)

        self.pat_dev = {STRAND_F: _pat_arr(pat_f), STRAND_R: _pat_arr(pat_r)}
        self.shift_dev = {STRAND_F: jnp.int32(shift_f), STRAND_R: jnp.int32(shift_r)}

        # ship spacer codes once (S_pad x L int8); both strands' one-hot
        # rows (incl. the constant-1 folded-bias columns, harmless in phase
        # 2 whose G keeps rows >= 4L zero) are built on device. With two
        # spare G rows, phase 1 runs strand-FUSED: one kernel dispatch.
        self.fused = 4 * L + 2 <= K
        q_pad = np.full((self.S_pad, L), 4, dtype=np.int8)
        q_pad[:S] = q_f
        q_f_dev, q_r_dev = _q_onehot_device(
            jnp.asarray(q_pad), K=K, fold=4 * L < K,
            rev_bias_col=1 if self.fused else 0,
        )
        self.q_dev = {STRAND_F: q_f_dev, STRAND_R: q_r_dev}
        self.q_all = (
            jnp.concatenate([q_f_dev, q_r_dev], axis=0) if self.fused else None
        )
        self.q_blocks_fused = (
            self.q_all.reshape(-1, self.bs, K) if self.fused else None
        )
        self.thresh_dev = jnp.full((1,), L - max_mismatches, jnp.float32)
        # speculative phase-2 sizing: covers scans with <= spec_B nonzero
        # (subtile, block) pairs and <= spec_cap hits in ONE device-chained
        # dispatch + ONE fetch (typical targets runs; design-scale scans
        # overflow and fall back to the batched path)
        self.spec_B = 1024
        self.spec_cap = 1 << 14
        # design-style scans produce >= one pair per spacer (every candidate
        # hits its own site), so size the device-side pair compaction to the
        # library upfront — a phase-1 overflow retry re-runs the whole kernel
        self.pair_cap = 1 << max(
            14, ((2 if self.fused else 1) * self.S_pad - 1).bit_length()
        )


class _ScanJob:
    """One contig's scan against a _QPrep library: construction ships the
    (nibble-packed) scan array and DISPATCHES phase 1 without fetching, so
    many jobs pipeline their device work; collect() fetches pairs, runs the
    batched phase-2 extraction, and assembles Hits."""

    def __init__(self, prep: _QPrep, contig: Contig, interpret: bool):
        self.prep = prep
        self.contig = contig
        self.interpret = interpret
        self.use_kernel = phase1_kernel_enabled(device_platform())
        p = prep
        n = contig.length
        halo_len = p.L - 1 + MAX_PAM
        # len(build_scan_array(contig, L)) without building it — the disk
        # artifact path must know every structural size up front
        scan_len = n + (p.L - 1) if (contig.circular and p.L > 1) else n
        self.n_starts = min(n, scan_len - p.L + 1) if scan_len >= p.L else 0
        if self.n_starts <= 0:
            return
        # bucket the genome axis so the fused jits recompile only per size
        # bucket, not per genome
        self.n_starts_b = _geom_bucket(self.n_starts, p.P)
        total = self.n_starts_b + p.halo_total
        digest = _content_digest(contig.codes)
        cache_key = (
            contig.id, n, bool(contig.circular), total, halo_len, digest,
        )
        cached = _SCAN_DEV_CACHE.get(cache_key)
        if cached is not None:
            self.scan_dev = cached
        elif n >= halo_len:
            # 2-bit ship: genome crumbs + sparse N exceptions; wrap halo and
            # padding reconstructed on device (half the nibble-path bytes).
            # The packed payload persists on disk keyed by content digest +
            # structural sizes, so a fresh process skips host prep entirely.
            from ..utils import artifacts

            # v2 = block-strided _pack_2bit (r5): the pack FORMAT is part
            # of the key — unversioned keys would silently unpack pre-r5
            # interleaved artifacts into a scrambled genome
            art_key = (
                f"{digest.hex()}-{n}-{int(bool(contig.circular))}"
                f"-{total}-{halo_len}-v2"
            )
            art = artifacts.load("scan", art_key)
            if art is not None:
                packed, exc_p = art["packed"], art["exc"]
            else:
                scan = build_scan_array(contig, p.L)
                scan_padded = prep_scan_padded(
                    contig, scan, p.L, self.n_starts_b, p.halo_total
                )
                exc = np.nonzero(scan_padded[:n] >= 4)[0].astype(np.int32)
                exc_cap = max(16, 1 << (len(exc) - 1).bit_length()) if len(exc) else 16
                exc_p = np.full(exc_cap, -1, dtype=np.int32)
                exc_p[: len(exc)] = exc
                packed = _pack_2bit(scan_padded)
                artifacts.store("scan", art_key, packed=packed, exc=exc_p)
            self.scan_dev = _build_scan_device(
                jnp.asarray(packed),
                jnp.asarray(exc_p),
                jnp.int32(n),
                total=total,
                pad_code=4 if contig.circular else 5,
                halo_len=halo_len,
                circular=bool(contig.circular),
            )
        else:  # tiny contig: the halo copy would read padding
            scan = build_scan_array(contig, p.L)
            scan_padded = prep_scan_padded(
                contig, scan, p.L, self.n_starts_b, p.halo_total
            )
            self.scan_dev = _unpack_nibbles(
                jnp.asarray(_pack_nibbles(scan_padded)), total=len(scan_padded)
            )
        if cached is None:
            _SCAN_DEV_CACHE.put(cache_key, self.scan_dev)
        self.n_real = jnp.int32(contig.length)
        self.n_tiles2 = _cdiv(self.n_starts_b, p.P2)
        self.circular = bool(contig.circular)
        self.spec_fut = None
        if p.fused:
            self.futures = {"fused": self._phase1_fused(p.pair_cap)}
            # chain the speculative phase 2 on the device-resident pair
            # list — no host sync; the whole common-case scan becomes one
            # packed fetch in collect()
            pairs_dev, _vals_dev, n_pairs_dev = self.futures["fused"]
            self.spec_fut = extract_spec(
                p.q_blocks_fused, self.scan_dev, self.n_real,
                p.shift_dev[STRAND_F], p.pat_dev[STRAND_F],
                p.shift_dev[STRAND_R], p.pat_dev[STRAND_R],
                pairs_dev, n_pairs_dev,
                n_starts=self.n_starts_b, halo=p.halo, L=p.L, K=p.K, P2=p.P2,
                thresh=int(p.max_mismatches), cap=p.spec_cap, B=p.spec_B,
                circular=self.circular, n_sb_pad8=self._n_sb_pad8(),
                SUB=p.SUB, half_blocks=p.S_pad // p.bs,
            )
        else:
            self.futures = {
                strand: self._phase1(strand, p.pair_cap)
                for strand in (STRAND_F, STRAND_R)
            }

    def _n_sb_pad8(self) -> int:
        p = self.prep
        n_sblocks = ((2 if p.fused else 1) * p.S_pad) // p.bs
        return _cdiv(n_sblocks, 8) * 8

    def _phase1_fused(self, cap_p):
        p = self.prep
        return phase1_fused(
            self.scan_dev, self.n_real, p.q_all,
            p.shift_dev[STRAND_F], p.pat_dev[STRAND_F],
            p.shift_dev[STRAND_R], p.pat_dev[STRAND_R], p.thresh_dev,
            n_starts=self.n_starts_b, P=p.P, halo=p.halo, L=p.L, K=p.K,
            SUB=p.SUB, BS_M=p.bs, pair_cap=cap_p, circular=self.circular,
            use_kernel=self.use_kernel, interpret=self.interpret,
        )

    def _phase1(self, strand, cap_p):
        p = self.prep
        return phase1_full(
            self.scan_dev, self.n_real, p.q_dev[strand],
            p.shift_dev[strand], p.pat_dev[strand], p.thresh_dev,
            n_starts=self.n_starts_b, P=p.P, halo=p.halo, L=p.L, K=p.K,
            SUB=p.SUB, BS_M=p.bs, pair_cap=cap_p, circular=self.circular,
            use_kernel=self.use_kernel, interpret=self.interpret,
        )

    def _decode_spec(self, packed: np.ndarray, n_hits: int) -> Hits:
        """Hits from extract_spec's packed array (see its docstring for the
        layout); inverse of the slot/row-space encoding."""
        p = self.prep
        B, cap, bs, P2 = p.spec_B, p.spec_cap, p.bs, p.P2
        if n_hits == 0:
            return Hits()
        slots = packed[2 : 2 + B]
        idx = packed[2 + B : 2 + B + n_hits]
        mm_vals = packed[2 + B + cap : 2 + B + cap + n_hits]
        slot_i = idx // (bs * P2)
        rem = idx % (bs * P2)
        si = rem // P2
        pi = rem % P2
        pair = slots[slot_i]
        n_sb_pad8 = self._n_sb_pad8()
        t_big = pair // (n_sb_pad8 * p.SUB)
        rem2 = pair % (n_sb_pad8 * p.SUB)
        s_blk = rem2 // p.SUB
        t_idx = t_big * p.SUB + rem2 % p.SUB
        half = p.S_pad // bs
        rev = s_blk >= half
        spacer_idx = (s_blk - rev * half) * bs + si
        pos = t_idx * P2 + pi
        keep = spacer_idx < p.S
        return Hits(
            spacer_idx=spacer_idx[keep].astype(np.int64),
            pos=pos[keep].astype(np.int64),
            strand=np.where(rev[keep], STRAND_R, STRAND_F).astype(np.int8),
            mismatches=mm_vals[keep].astype(np.int32),
        )

    def _decode_pairs(self, key, fetch_again):
        """(t_idx subtile indices, s_idx block indices, counts hit-column
        counts per pair) from a phase-1 (pairs, vals, count) future, with
        overflow retry."""
        p = self.prep
        pairs, vals, n_pairs = self.futures[key]
        n_pairs = int(n_pairs)
        cap_p = p.pair_cap
        while n_pairs > cap_p:  # rare: designs with very dense hits
            cap_p = max(cap_p * 2, 1 << (n_pairs - 1).bit_length())
            pairs, vals, n_pairs = fetch_again(cap_p)
            n_pairs = int(n_pairs)
        pairs = np.asarray(pairs)[:n_pairs]
        vals = np.asarray(vals)[:n_pairs]
        # decode flat index over (n_tiles, n_sb_pad8, SUB); indicator
        # padding rows are zero, so s_idx < n_sblocks always
        n_sb_pad8 = self._n_sb_pad8()
        t_big = pairs // (n_sb_pad8 * p.SUB)
        rem = pairs % (n_sb_pad8 * p.SUB)
        s_idx = rem // p.SUB
        sub_idx = rem % p.SUB
        t_idx = t_big * p.SUB + sub_idx  # subtile index on the P2 grid
        in_range = t_idx < self.n_tiles2
        return t_idx[in_range], s_idx[in_range], vals[in_range]

    def collect(self) -> Hits:
        if self.n_starts <= 0:
            return Hits()
        p = self.prep
        SUB, P2, bs, K, S = p.SUB, p.P2, p.bs, p.K, p.S

        if self.spec_fut is not None:
            packed = np.asarray(self.spec_fut)  # the ONE fetch, common case
            n_pairs, n_sig = int(packed[0]), int(packed[1])
            if n_pairs <= p.spec_B and n_sig <= p.spec_cap:
                return self._decode_spec(packed, n_sig).sorted()
            # overflow: fall through to the batched path (phase-1 futures
            # are still live)

        strand_pairs = {}
        if p.fused:
            t_idx, s_idx, counts = self._decode_pairs("fused", self._phase1_fused)
            n_sb_half = p.S_pad // bs
            rev = s_idx >= n_sb_half
            strand_pairs[STRAND_F] = (t_idx[~rev], s_idx[~rev], counts[~rev])
            strand_pairs[STRAND_R] = (t_idx[rev], s_idx[rev] - n_sb_half, counts[rev])
        else:
            for strand in (STRAND_F, STRAND_R):
                strand_pairs[strand] = self._decode_pairs(
                    strand, lambda cap_p, s=strand: self._phase1(s, cap_p)
                )

        # phase 2: exact positions for the nonzero (subtile, sblock) pairs,
        # compacted on device (fixed capacity + overflow retry). ALL batches
        # for both strands are dispatched before any result is fetched.
        pending = []
        tiles_shared = None  # strand-independent: build ONCE per contig
        for strand in (STRAND_F, STRAND_R):
            t_idx, s_idx, counts = strand_pairs[strand]
            if len(t_idx) == 0:
                continue
            q_blocks_all = p.q_dev[strand].reshape(-1, bs, K)
            if tiles_shared is None:
                tiles_shared = _tiles_only(
                    self.scan_dev, n_starts=self.n_starts_b, halo=p.halo,
                    P=P2,
                )
            tiles_s = tiles_shared
            # only the PAM mask differs per strand (rebuilding the tile
            # matrix per strand was one redundant full-genome device pass,
            # r5 review)
            mask_s = _mask_only(
                self.scan_dev, self.n_real,
                p.shift_dev[strand], p.pat_dev[strand],
                n_starts=self.n_starts_b, L=p.L, P=P2,
                circular=self.circular,
            )
            for c0 in range(0, len(t_idx), p.extract_batch):
                tc = t_idx[c0 : c0 + p.extract_batch]
                sc = s_idx[c0 : c0 + p.extract_batch]
                nb = len(tc)
                bucket = _batch_buckets(nb, p.extract_batch)
                pad = bucket - nb
                tc_p = np.concatenate([tc, np.zeros(pad, tc.dtype)]).astype(np.int32)
                sc_p = np.concatenate([sc, np.zeros(pad, sc.dtype)]).astype(np.int32)
                valid = np.zeros(bucket, dtype=bool)
                valid[:nb] = True
                # size hit/row capacities from the phase-1 per-pair hit-
                # column counts (a lower bound on hits: a column can hold
                # several hitting spacers) — 2x headroom makes first-try
                # success the norm; the exact counts returned by a miss
                # make any retry converge in one step
                colsum = int(counts[c0 : c0 + p.extract_batch].sum())
                cap = max(1 << 14, 1 << (2 * max(colsum, 1) - 1).bit_length())
                cap_rows = min(
                    max(2 * EXTRACT_BATCH,
                        1 << (2 * max(colsum, 1) - 1).bit_length()),
                    bucket * bs,  # can never exceed the batch's total rows
                )
                args = (
                    q_blocks_all, tiles_s, mask_s,
                    jnp.asarray(sc_p), jnp.asarray(tc_p), jnp.asarray(valid),
                )
                kw = dict(L=p.L, K=K, P=P2, thresh=int(p.max_mismatches))
                fut = _extract_chunk(*args, cap=cap, cap_rows=cap_rows, **kw)
                pending.append((strand, tc, sc, nb, cap, cap_rows, fut, args, kw))

        out = []
        for strand, tc, sc, nb, cap, cap_rows, fut, args, kw in pending:
            idx, mm_vals, n_hits, n_rows, max_rh = (
                fut[0], fut[1], int(fut[2]), int(fut[3]), int(fut[4])
            )
            k = 4
            while n_hits > cap or n_rows > cap_rows or max_rh > k:
                cap = max(cap, 1 << (max(n_hits, 1) - 1).bit_length())
                cap_rows = max(cap_rows, 1 << (max(n_rows, 1) - 1).bit_length())
                k = max(k, 1 << (max(max_rh, 1) - 1).bit_length())
                idx, mm_vals, n_hits, n_rows, max_rh = _extract_chunk(
                    *args, cap=cap, cap_rows=cap_rows, k=k, **kw
                )
                n_hits, n_rows, max_rh = int(n_hits), int(n_rows), int(max_rh)
            idx = np.asarray(idx)[:n_hits]
            mm_vals = np.asarray(mm_vals)[:n_hits]
            if n_hits == 0:
                continue
            bi = idx // (bs * P2)
            rem = idx % (bs * P2)
            si = rem // P2
            pi = rem % P2
            keep = bi < nb
            bi, si, pi, mm_vals = bi[keep], si[keep], pi[keep], mm_vals[keep]
            spacer_idx = sc[bi] * bs + si
            pos = tc[bi] * P2 + pi
            keep2 = spacer_idx < S
            out.append(
                Hits(
                    spacer_idx=spacer_idx[keep2].astype(np.int64),
                    pos=pos[keep2].astype(np.int64),
                    strand=np.full(int(keep2.sum()), strand, np.int8),
                    mismatches=mm_vals[keep2].astype(np.int32),
                )
            )
        return Hits.concat(out).sorted()


@functools.partial(
    jax.jit,
    static_argnames=("n_sites_b", "P", "L", "K", "SUB", "BS_M", "pair_cap",
                     "use_kernel", "interpret"),
)
def phase1_matrix(codes_lp, q_onehot, thresh, *, n_sites_b, P, L, K, SUB, BS_M,
                  pair_cap, use_kernel=None, interpret=False):
    """Site-compacted phase 1: the 'genome' axis is an explicit site-code
    matrix (L, n_sites_b) int8 (column = one PAM-valid window, R-strand
    windows pre-revcomped), so only forward spacer rows are needed and no
    PAM bias exists (every column is PAM-valid by construction; padding
    columns are all-N and can never reach thresh >= 1)."""
    n_tiles = n_sites_b // P
    L_pad = codes_lp.shape[0]  # row axis padded to a multiple of 8
    tiles = (
        codes_lp.astype(jnp.int32).reshape(L_pad, n_tiles, P).transpose(1, 0, 2)
    )
    bias = jnp.zeros((n_tiles, 1, P), jnp.float32)
    ind = phase1_hits(
        thresh, q_onehot, tiles, bias, L=L, K=K, P=P, SUB=SUB, BS_M=BS_M,
        fold_bias=False, matrix_rows=True, use_kernel=use_kernel,
        interpret=interpret,
    )
    return _compact_pairs(ind, pair_cap)


@functools.partial(
    jax.jit,
    static_argnames=("L", "K", "P2", "thresh", "cap", "cap_rows", "k"),
)
def extract_matrix(q_blocks_all, codes_lp, n_sites, sc_p, tc_p, valid, *, L, K,
                   P2, thresh, cap, cap_rows, k=4):
    """Site-compacted phase 2: score the nonzero (spacer-block, site-
    subtile) pairs against gathered site-code subtiles, compact on device
    (same contract as _extract_body)."""
    n_t2 = codes_lp.shape[1] // P2
    L_pad = codes_lp.shape[0]
    tiles2 = codes_lp.reshape(L_pad, n_t2, P2).transpose(1, 0, 2)[:, :L, :]
    g = tiles2[tc_p]  # (B, L, P2) int8
    oh = (
        g[:, :, None, :] == jnp.arange(4, dtype=g.dtype)[None, None, :, None]
    ).reshape(g.shape[0], 4 * L, P2)
    g_oh = oh.astype(jnp.bfloat16)
    if 4 * L < K:
        g_oh = jnp.pad(g_oh, ((0, 0), (0, K - 4 * L), (0, 0)))
    q = q_blocks_all[sc_p]  # (B, bs, K)
    scores = jnp.einsum("nsk,nkp->nsp", q, g_oh, preferred_element_type=jnp.float32)
    mm = (L - scores).astype(jnp.int32)
    col_ok = tc_p[:, None] * P2 + jnp.arange(P2, dtype=jnp.int32)[None, :] < n_sites
    hit = (mm <= thresh) & col_ok[:, None, :] & valid[:, None, None]
    return _compact_hits(hit, mm, cap=cap, cap_rows=cap_rows, k=k)


@functools.partial(
    jax.jit,
    static_argnames=("L", "K", "P2", "thresh", "cap", "B", "n_sb_pad8", "SUB"),
)
def extract_spec_matrix(q_blocks_all, codes_lp, n_sites, pairs, n_pairs, *, L,
                        K, P2, thresh, cap, B, n_sb_pad8, SUB):
    """Site-mode twin of extract_spec: speculative phase 2 chained on the
    DEVICE-RESIDENT phase-1 pair list, returning the same packed layout

        [n_pairs, n_hits_signal, slots (B,), idx (cap,), mm (cap,)]

    so a small-library site scan (the cached-_SiteTable steady state) costs
    ONE d2h fetch instead of two or more."""
    slots = pairs[:B]
    slot_ok = (jnp.arange(B, dtype=jnp.int32) < jnp.minimum(n_pairs, B)) & (slots >= 0)
    safe_slots = jnp.where(slot_ok, slots, 0)
    t_big = safe_slots // (n_sb_pad8 * SUB)
    rem = safe_slots % (n_sb_pad8 * SUB)
    s_idx = rem // SUB
    t_idx = t_big * SUB + rem % SUB  # subtile index on the P2 grid
    n_t2 = codes_lp.shape[1] // P2
    L_pad = codes_lp.shape[0]
    t_safe = jnp.clip(t_idx, 0, n_t2 - 1)
    tiles2 = codes_lp.reshape(L_pad, n_t2, P2).transpose(1, 0, 2)[:, :L, :]
    g = tiles2[t_safe]  # (B, L, P2) int8
    oh = (
        g[:, :, None, :] == jnp.arange(4, dtype=g.dtype)[None, None, :, None]
    ).reshape(g.shape[0], 4 * L, P2)
    g_oh = oh.astype(jnp.bfloat16)
    if 4 * L < K:
        g_oh = jnp.pad(g_oh, ((0, 0), (0, K - 4 * L), (0, 0)))
    q = q_blocks_all[jnp.clip(s_idx, 0, q_blocks_all.shape[0] - 1)]  # (B, bs, K)
    scores = jnp.einsum("nsk,nkp->nsp", q, g_oh, preferred_element_type=jnp.float32)
    mm = (L - scores).astype(jnp.int32)
    col_ok = t_safe[:, None] * P2 + jnp.arange(P2, dtype=jnp.int32)[None, :] < n_sites
    hit = (mm <= thresh) & col_ok[:, None, :] & (slot_ok & (t_idx < n_t2))[:, None, None]
    cap_rows = max(cap // 16, 2 * B)
    idx, mm_vals, n_hits, n_rows, max_row_hits = _compact_hits(
        hit, mm, cap=cap, cap_rows=cap_rows, k=K_SPEC
    )
    n_signal = jnp.where(
        (n_rows > cap_rows) | (max_row_hits > K_SPEC),
        jnp.maximum(n_hits, cap + 1),
        n_hits,
    )
    header = jnp.stack([n_pairs.astype(jnp.int32), n_signal])
    return jnp.concatenate([header, slots.astype(jnp.int32), idx, mm_vals])


class _SiteTable:
    """Device-resident site-compacted representation of one contig's
    PAM-valid windows: column j of codes_lp is the L-mer at positions[j]
    (R-strand windows revcomped at enumeration). Built once per
    (contig content, L, pam, direction, P) and cached in _SITE_DEV_CACHE —
    the host enumeration (~0.2 s/Mb) and the site-matrix ship are what set
    the dense↔site crossover, so a cache hit makes site mode the fastest
    engine at ANY library size."""

    __slots__ = ("positions", "strands", "codes_lp", "n_sites", "n_sites_b")

    def __init__(self, P: int, L: int, positions, strands, codes):
        self.positions = positions
        self.strands = strands
        n_sites = len(positions)
        self.n_sites = n_sites
        self.n_sites_b = _geom_bucket(max(n_sites, 1), P)
        L_pad = _cdiv(L, 8) * 8  # 8-aligned rows (int8 codes, 8-byte columns)
        codes_pad = np.full((self.n_sites_b, L_pad), 4, dtype=np.int8)
        codes_pad[:n_sites, :L] = codes
        flat = codes_pad.T.reshape(-1)  # (L_pad * n_sites_b), row j = base j
        # exceptions = genomic Ns only; the all-N padding columns are
        # reconstructed on device from (n_sites, n_sites_b)
        col_n, j_n = np.nonzero(codes >= 4) if n_sites else (np.array([]),) * 2
        exc = (np.asarray(j_n) * self.n_sites_b + np.asarray(col_n)).astype(np.int32)
        if len(exc) * 4 < len(flat) // 8:
            exc_cap = max(16, 1 << (len(exc) - 1).bit_length()) if len(exc) else 16
            exc_p = np.full(exc_cap, -1, dtype=np.int32)
            exc_p[: len(exc)] = exc
            flat_dev = _build_codes_device(
                jnp.asarray(_pack_2bit(flat)), jnp.asarray(exc_p),
                jnp.int32(n_sites), total=len(flat), cols=self.n_sites_b,
            )
        else:
            flat_dev = _unpack_nibbles(
                jnp.asarray(_pack_nibbles(flat)), total=len(flat)
            )
        self.codes_lp = flat_dev.reshape(L_pad, self.n_sites_b)


_SITE_DEV_CACHE = _DeviceScanCache()


class _SeenCounter(OrderedDict):
    """Bounded occurrence counter for (contig, pam, L) scan keys."""

    MAX = 64

    def bump(self, key) -> int:
        v = super().get(key, 0) + 1
        self[key] = v
        self.move_to_end(key)
        while len(self) > self.MAX:
            self.popitem(last=False)
        return v


_SITE_SEEN = _SeenCounter()


class _SiteScanJob:
    """Site-compacted scan of one contig (PAM scans whose dense genome-axis
    kernel cost dwarfs host site enumeration — the design workload's
    all-vs-all map-back being the canonical case — plus ANY repeat scan of
    a cached _SiteTable).

    For a |PAM|-constrained scan every hit lies at a PAM-valid site, so the
    genome axis contracts from contig.length to n_sites (~N/8 for NGG):
    columns are the site windows themselves (R-strand windows revcomped at
    enumeration, prep.enumerate_sites), which also halves the spacer rows —
    no reverse one-hot matrix, no PAM bias, no wrap halo. Exact for every
    mismatch budget (it is the same brute-force scoring over a provably
    sufficient subset of positions)."""

    def __init__(self, prep: _QPrep, contig: Contig, table: _SiteTable,
                 interpret: bool = False):
        self.prep = prep
        self.interpret = interpret
        self.use_kernel = phase1_kernel_enabled(device_platform())
        self.contig = contig
        p = prep
        self.positions = table.positions
        self.strands = table.strands
        self.n_sites = table.n_sites
        self.n_sites_b = table.n_sites_b
        self.codes_lp = table.codes_lp
        self.n_tiles2 = _cdiv(self.n_sites_b, p.P2)
        self.fut = phase1_matrix(
            self.codes_lp, p.q_dev[STRAND_F], p.thresh_dev,
            n_sites_b=self.n_sites_b, P=p.P, L=p.L, K=p.K, SUB=p.SUB,
            BS_M=p.bs, pair_cap=p.pair_cap, use_kernel=self.use_kernel,
            interpret=interpret,
        )
        # small-library scans (the cached-table steady state) chain the
        # speculative phase 2 so the whole scan is one packed fetch;
        # design-scale libraries would always overflow the spec budget
        self.spec_fut = None
        if p.S_pad < _SITE_MODE_MIN_SPACERS:
            self.spec_fut = extract_spec_matrix(
                p.q_dev[STRAND_F].reshape(-1, p.bs, p.K), self.codes_lp,
                jnp.int32(self.n_sites), self.fut[0], self.fut[2],
                L=p.L, K=p.K, P2=p.P2, thresh=int(p.max_mismatches),
                cap=p.spec_cap, B=p.spec_B, n_sb_pad8=self._n_sb_pad8(),
                SUB=p.SUB,
            )

    def _n_sb_pad8(self) -> int:
        p = self.prep
        return _cdiv(p.S_pad // p.bs, 8) * 8

    def _decode_spec(self, packed: np.ndarray, n_hits: int) -> Hits:
        """Hits from extract_spec_matrix's packed array; inverse of the
        slot/row-space encoding, with site columns mapped back through the
        table's positions/strands."""
        p = self.prep
        B, cap, bs, P2 = p.spec_B, p.spec_cap, p.bs, p.P2
        if n_hits == 0:
            return Hits()
        slots = packed[2 : 2 + B]
        idx = packed[2 + B : 2 + B + n_hits]
        mm_vals = packed[2 + B + cap : 2 + B + cap + n_hits]
        slot_i = idx // (bs * P2)
        rem = idx % (bs * P2)
        si = rem // P2
        pi = rem % P2
        pair = slots[slot_i]
        n_sb_pad8 = self._n_sb_pad8()
        t_big = pair // (n_sb_pad8 * p.SUB)
        rem2 = pair % (n_sb_pad8 * p.SUB)
        s_blk = rem2 // p.SUB
        t_idx = t_big * p.SUB + rem2 % p.SUB
        spacer_idx = s_blk * bs + si
        col = t_idx * P2 + pi
        keep = (spacer_idx < p.S) & (col < self.n_sites)
        spacer_idx, col, mm_vals = spacer_idx[keep], col[keep], mm_vals[keep]
        return Hits(
            spacer_idx=spacer_idx.astype(np.int64),
            pos=self.positions[col].astype(np.int64),
            strand=self.strands[col].astype(np.int8),
            mismatches=mm_vals.astype(np.int32),
        )

    def collect(self) -> Hits:
        p = self.prep
        bs, K, P2, S = p.bs, p.K, p.P2, p.S
        if self.spec_fut is not None:
            packed = np.asarray(self.spec_fut)  # the ONE fetch, common case
            n_pairs, n_sig = int(packed[0]), int(packed[1])
            if n_pairs <= p.spec_B and n_sig <= p.spec_cap:
                return self._decode_spec(packed, n_sig).sorted()
            # overflow: fall through to the batched path (phase-1 future
            # is still live)
        pairs, vals, n_pairs = self.fut
        n_pairs = int(n_pairs)
        cap_p = p.pair_cap
        while n_pairs > cap_p:
            cap_p = max(cap_p * 2, 1 << (n_pairs - 1).bit_length())
            pairs, vals, n_pairs = phase1_matrix(
                self.codes_lp, p.q_dev[STRAND_F], p.thresh_dev,
                n_sites_b=self.n_sites_b, P=p.P, L=p.L, K=p.K, SUB=p.SUB,
                BS_M=p.bs, pair_cap=cap_p, use_kernel=self.use_kernel,
                interpret=self.interpret,
            )
            n_pairs = int(n_pairs)
        pairs = np.asarray(pairs)[:n_pairs]
        counts = np.asarray(vals)[:n_pairs]
        n_sb_pad8 = self._n_sb_pad8()
        t_big = pairs // (n_sb_pad8 * p.SUB)
        rem = pairs % (n_sb_pad8 * p.SUB)
        s_idx = rem // p.SUB
        t_idx = t_big * p.SUB + rem % p.SUB
        in_range = t_idx < self.n_tiles2
        t_idx, s_idx, counts = t_idx[in_range], s_idx[in_range], counts[in_range]

        q_blocks_all = p.q_dev[STRAND_F].reshape(-1, bs, K)
        n_sites_dev = jnp.int32(self.n_sites)
        pending = []
        for c0 in range(0, len(t_idx), p.extract_batch):
            tc = t_idx[c0 : c0 + p.extract_batch]
            sc = s_idx[c0 : c0 + p.extract_batch]
            nb = len(tc)
            bucket = _batch_buckets(nb, p.extract_batch)
            pad = bucket - nb
            tc_p = np.concatenate([tc, np.zeros(pad, tc.dtype)]).astype(np.int32)
            sc_p = np.concatenate([sc, np.zeros(pad, sc.dtype)]).astype(np.int32)
            valid = np.zeros(bucket, dtype=bool)
            valid[:nb] = True
            colsum = int(counts[c0 : c0 + p.extract_batch].sum())
            cap = max(1 << 14, 1 << (2 * max(colsum, 1) - 1).bit_length())
            cap_rows = min(
                max(2 * EXTRACT_BATCH, 1 << (2 * max(colsum, 1) - 1).bit_length()),
                bucket * bs,
            )
            args = (
                q_blocks_all, self.codes_lp, n_sites_dev,
                jnp.asarray(sc_p), jnp.asarray(tc_p), jnp.asarray(valid),
            )
            kw = dict(L=p.L, K=K, P2=P2, thresh=int(p.max_mismatches))
            fut = extract_matrix(*args, cap=cap, cap_rows=cap_rows, **kw)
            pending.append((tc, sc, nb, cap, cap_rows, fut, args, kw))

        out = []
        for tc, sc, nb, cap, cap_rows, fut, args, kw in pending:
            idx, mm_vals, n_hits, n_rows, max_rh = (
                fut[0], fut[1], int(fut[2]), int(fut[3]), int(fut[4])
            )
            k = 4
            while n_hits > cap or n_rows > cap_rows or max_rh > k:
                cap = max(cap, 1 << (max(n_hits, 1) - 1).bit_length())
                cap_rows = max(cap_rows, 1 << (max(n_rows, 1) - 1).bit_length())
                k = max(k, 1 << (max(max_rh, 1) - 1).bit_length())
                idx, mm_vals, n_hits, n_rows, max_rh = extract_matrix(
                    *args, cap=cap, cap_rows=cap_rows, k=k, **kw
                )
                n_hits, n_rows, max_rh = int(n_hits), int(n_rows), int(max_rh)
            idx = np.asarray(idx)[:n_hits]
            mm_vals = np.asarray(mm_vals)[:n_hits]
            if n_hits == 0:
                continue
            bi = idx // (bs * P2)
            rem = idx % (bs * P2)
            si = rem // P2
            pi = rem % P2
            keep = bi < nb
            bi, si, pi, mm_vals = bi[keep], si[keep], pi[keep], mm_vals[keep]
            spacer_idx = sc[bi] * bs + si
            col = tc[bi] * P2 + pi
            keep2 = (spacer_idx < S) & (col < self.n_sites)
            spacer_idx, col, mm_vals = spacer_idx[keep2], col[keep2], mm_vals[keep2]
            out.append(
                Hits(
                    spacer_idx=spacer_idx.astype(np.int64),
                    pos=self.positions[col].astype(np.int64),
                    strand=self.strands[col].astype(np.int8),
                    mismatches=mm_vals.astype(np.int32),
                )
            )
        return Hits.concat(out).sorted()


@functools.partial(jax.jit, static_argnames=("total", "cols"))
def _build_codes_device(packed, exc_idx, n_sites, *, total, cols):
    """2-bit crumbs + sparse exception list → flat int8 codes (the
    row-major (L, cols) site matrix) with genomic-N exceptions restored to
    4 and the padding columns (col >= n_sites, every row) forced to 4. The
    site-code twin of _build_scan_device. The padding-column mask works on
    the (L, cols) view with a (1, cols) iota — a flat arange(total) % cols
    would cost 4*total transient bytes (3 GB at 250 Mb scale)."""
    out = _unpack_2bit_planes(packed, total)
    colv = jax.lax.broadcasted_iota(jnp.int32, (1, cols), 1)
    out = jnp.where(colv < n_sites, out.reshape(-1, cols), jnp.int8(4)).reshape(-1)
    # commutative N-restoration (see _build_scan_device: duplicate .set()
    # at the clipped fill index raced with a real N at flat position 0)
    safe = jnp.clip(exc_idx, 0, total - 1)
    return out.at[safe].max(jnp.where(exc_idx >= 0, jnp.int8(4), jnp.int8(0)))


# library size above which the site-compacted matrix scan wins for PAM
# scans. Crossover math: site mode pays host enumeration ~2e-7 s/bp
# (masks + window gather) regardless of S, while the dense kernel pays
# ~3e-12 s per (spacer, bp) — so sites win once S exceeds their ratio
# (~65k), nearly independent of genome size. Measured: 125k-spacer 1 Mb
# design 1.04 s dense vs 0.48 s sites; 10k-spacer E.coli targets 0.20 s
# dense vs ~1 s sites.
_SITE_MODE_MIN_SPACERS = 1 << 16


def pallas_scan_contigs(
    spacers,
    contigs: list[Contig],
    max_mismatches: int,
    pam: str = "",
    pam_direction: str = "downstream",
    P: int | None = None,
    interpret: bool = False,
    sub_width: int = 512,
    site_mode: str = "auto",
) -> list[Hits]:
    """Scan many contigs against one library (results in INPUT ORDER —
    robust to duplicate contig ids) with the spacer prep BUILT AND SHIPPED
    ONCE and shared across contigs — multi-replicon genomes (e.g. the
    bundled 4-plasmid Zymomonas set) pay one library prep instead of N.
    Contigs themselves run sequentially
    (parallel.sharded_scan.sharded_scan_contigs provides a windowed
    dispatch-ahead variant for the sharded engine).

    site_mode: "auto" switches a PAM scan to the site-compacted matrix
    engine (_SiteScanJob) for design-scale libraries
    (S_pad >= _SITE_MODE_MIN_SPACERS); "always"/"never" override (tests).

    Note: under "auto", repeat scans of the same (genome, pam, L) key are
    promoted to site mode from the SECOND occurrence in a process
    (_SITE_SEEN) — results are identical either way, but perf/compile
    behavior of otherwise-identical calls is intentionally order-dependent
    (steady-state serving of many libraries against one genome). Benchmarks
    that need a fixed engine must pass site_mode="always"/"never"."""
    q_f = spacer_matrix(list(spacers)) if not isinstance(spacers, np.ndarray) else spacers
    S, L = q_f.shape
    if S == 0:
        return [Hits() for _ in contigs]
    if P is None:
        P = TILE_P
    if len(pam) > MAX_PAM:
        from .ref_scan import jax_scan

        return [
            jax_scan(spacers, c, max_mismatches, pam, pam_direction)
            for c in contigs
        ]
    # library prep (one-hot device blocks, PAM specs) is immutable after
    # construction and was rebuilt + re-shipped (~200 KB h2d + dispatches)
    # on EVERY scan; steady-state serving re-scans the same library, so
    # cache it content-keyed like the genome-side device arrays
    qp_key = (
        _content_digest(q_f), q_f.shape, str(q_f.dtype),
        max_mismatches, pam, pam_direction, P, sub_width,
    )
    prep = _QPREP_CACHE.get(qp_key) or _BIG_QPREP_SLOT.get(qp_key)
    if prep is None:
        # release the previous big prep BEFORE building a new one — clearing
        # after construction would pin TWO design-scale preps in HBM during
        # the swap (S_pad >= threshold implies the bs=512 bucket)
        if _geom_bucket(S, 512) >= _SITE_MODE_MIN_SPACERS:
            _BIG_QPREP_SLOT.clear()
        prep = _QPrep(q_f, max_mismatches, pam, pam_direction, P, sub_width)
        # the LRU exists for steady-state serving libraries (a few MB of
        # HBM each); a design-scale prep pins hundreds of MB (q_dev fwd/rev
        # + q_all at S_pad x K bf16), and MAX=8 of those OOMs a long-lived
        # process scanning several distinct large libraries — those go to
        # the one-slot _BIG_QPREP_SLOT instead
        if prep.S_pad < _SITE_MODE_MIN_SPACERS:
            _QPREP_CACHE.put(qp_key, prep)
        else:
            _BIG_QPREP_SLOT[qp_key] = prep
    # contigs run sequentially (shared prep amortizes the library shipping
    # and one-hot builds)
    from .prep import enumerate_sites

    results: list[Hits] = []
    for c in contigs:
        site_tab = site_key = art_key = None
        if bool(pam) and site_mode != "never":
            digest = _content_digest(c.codes)
            site_key = (
                c.id, c.length, bool(c.circular), L, pam, pam_direction, P,
                digest,
            )
            site_tab = _SITE_DEV_CACHE.get(site_key)
            art_key = (
                f"{digest.hex()}-{c.length}-{int(bool(c.circular))}"
                f"-{L}-{pam}-{pam_direction}"
            )
        # a cached site table makes site mode the fastest engine at ANY
        # library size (the crossover cost — host enumeration + matrix
        # ship — is already paid); without one it wins only at design scale.
        # A site-table artifact on DISK counts too: a previous process
        # already promoted this (genome, pam, L) — starting in site mode
        # from call 1 skips compiling the dense engine entirely in this
        # process (VERDICT r2 item 2: cold start).
        from ..utils import artifacts

        # an all-wildcard PAM ('N', 'NN') makes every window-valid position
        # a site — the site matrix would ship ~L_pad bytes/genome base (vs
        # ~1 dense) for zero FLOP savings; only an explicit "always" takes
        # the site path then
        pam_informative = any(ch != "N" for ch in pam)
        use_sites = bool(pam) and site_mode != "never" and (
            site_mode == "always"
            or (pam_informative and (
                prep.S_pad >= _SITE_MODE_MIN_SPACERS
                or site_tab is not None
                or artifacts.exists("sites", art_key)
            ))
        )
        if not use_sites and site_key is not None and pam_informative:
            # repeat scans of the same (genome, pam, L): pay the one-time
            # table build on the second occurrence so steady-state re-scans
            # (serving many libraries against one genome) run compacted
            use_sites = _SITE_SEEN.bump(site_key) >= 2
        if use_sites:
            if site_tab is None:
                art = artifacts.load("sites", art_key)
                if art is not None:
                    positions, strands, codes = (
                        art["positions"], art["strands"], art["codes"],
                    )
                else:
                    positions, strands, codes = enumerate_sites(c, L, pam, pam_direction)
                    artifacts.store(
                        "sites", art_key,
                        positions=positions, strands=strands, codes=codes,
                    )
                site_tab = _SiteTable(P, L, positions, strands, codes)
                _SITE_DEV_CACHE.put(site_key, site_tab)
            if site_tab.n_sites == 0:
                results.append(Hits())
                continue
            results.append(_SiteScanJob(prep, c, site_tab, interpret).collect())
        else:
            results.append(_ScanJob(prep, c, interpret).collect())
    return results


def pallas_scan(
    spacers,
    contig: Contig,
    max_mismatches: int,
    pam: str = "",
    pam_direction: str = "downstream",
    P: int | None = None,
    interpret: bool = False,
    sub_width: int = 512,
    site_mode: str = "auto",
) -> Hits:
    """Same contract as oracle_scan/jax_scan, on the device (the
    phase-chained single-device engine, ``--backend pallas``).

    Phase 1 runs at tile width P (default utils.platform.TILE_P);
    its output keys on subtiles of ``sub_width`` positions so phase-2
    re-scoring (memory-bound one-hot builds) only touches narrow windows
    around actual hits; wider subtiles merge adjacent dense hits into fewer
    phase-2 pairs, and per-pair phase-2 cost is held by scaling the batch
    size with 1/P2 (_QPrep.extract_batch)."""
    return pallas_scan_contigs(
        spacers, [contig], max_mismatches, pam, pam_direction,
        P=P, interpret=interpret, sub_width=sub_width, site_mode=site_mode,
    )[0]
