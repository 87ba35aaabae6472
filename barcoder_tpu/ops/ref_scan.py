"""Pure-JAX (XLA) Hamming scan — one-hot matmul formulation.

This is the portable device path: scores[s, p] = Σ_j <onehot(q[s, j]),
onehot(g[p + j])>, computed per position chunk as a plain GEMM (the G
one-hot build is shared with the phase-2 path), which XLA lowers to a
library matrix product on the GPU and to vectorized code on the CPU (where
tests run on fake devices). The phase-1 kernel (pallas_scan.py) computes the same
quantity with fused PAM masking and without materializing the S×N score
matrix; this module is its reference semantics.

mismatches(s, p) = L_eff(s) - scores(s, p), where L_eff counts the spacer's
non-N positions... in fact an N in the spacer can never match, so
mismatches = L - scores always (the N position contributes 0 to the score).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..core.genome import Contig
from .prep import build_scan_array, revcomp_matrix, site_masks, spacer_matrix
from .types import STRAND_F, STRAND_R, Hits


@functools.partial(jax.jit, static_argnames=("L", "K", "thresh"))
def _chunk_hitmask_mm(q_oh_rows, g_codes, mask_chunk, L: int, K: int, thresh: int):
    """Matmul chunk scorer: q_oh_rows (S_pad, K) one-hot rows (layout
    4j+b), g_codes (P + L - 1,) int32 → (mismatch_matrix int32, selected
    bool) with the site mask fused so only PAM-valid positions survive.
    Shares the G build with the Pallas phase-2 path."""
    from .pallas_scan import _build_g_onehot

    P = mask_chunk.shape[0]
    g_oh = _build_g_onehot(g_codes, L=L, K=K, P=P)  # (K, P)
    # f32 one-hots: HIGHEST keeps the product exact on GPUs, where an f32
    # product otherwise runs in TF32
    scores = jnp.dot(
        q_oh_rows, g_oh, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    mm = (L - scores).astype(jnp.int32)
    sel = (mm <= thresh) & mask_chunk[None, :]
    return mm, sel


def jax_scan(
    spacers: list[str] | np.ndarray,
    contig: Contig,
    max_mismatches: int,
    pam: str = "",
    pam_direction: str = "downstream",
    chunk: int = 1 << 17,
) -> Hits:
    """Same contract as oracle_scan, via XLA; hits are extracted per
    position chunk so the dense S×N score matrix is never materialized."""
    q_f = spacer_matrix(list(spacers)) if not isinstance(spacers, np.ndarray) else spacers
    S, L = q_f.shape
    scan = build_scan_array(contig, L) if S else contig.codes
    n = contig.length
    n_starts = min(n, len(scan) - L + 1) if (S and len(scan) >= L) else 0
    if S == 0 or n_starts <= 0:
        return Hits()
    q_r = revcomp_matrix(q_f)
    mask_f, mask_r = site_masks(contig, L, pam, pam_direction)

    # pad shapes to stable buckets so XLA compiles are reused across calls:
    # spacer count to the next power of two (all-N pad rows never match),
    # position chunks to the full chunk width (N codes + False mask).
    chunk = min(chunk, max(256, 1 << (n_starts - 1).bit_length()))
    S_pad = max(8, 1 << (S - 1).bit_length())
    # bound the per-chunk dense (S_pad, chunk) mm/score/sel buffers:
    # without this a design-scale library (S_pad 131072) at the default
    # chunk width asked for tens of GB per chunk (r5 review) — cap the
    # cell count at ~2^26 (~0.75 GB across the three buffers)
    chunk = max(1024, min(chunk, (1 << 26) // S_pad))
    pad_rows = np.full((S_pad - S, L), 4, dtype=q_f.dtype)

    from .pallas_scan import onehot_rows

    K = max(-(-4 * L // 128) * 128, 128)
    q_ohs = {
        STRAND_F: jnp.asarray(
            onehot_rows(np.concatenate([q_f, pad_rows]), K), dtype=jnp.float32
        ),
        STRAND_R: jnp.asarray(
            onehot_rows(np.concatenate([q_r, pad_rows]), K), dtype=jnp.float32
        ),
    }
    out = []
    for p0 in range(0, n_starts, chunk):
        p1 = min(p0 + chunk, n_starts)
        # ONE genome-chunk build + ship per chunk — only the PAM mask
        # differs between strands (shipping g per strand doubled the
        # largest transfer in the loop, r5 review)
        g = np.full(chunk + L - 1, 4, dtype=np.int32)
        g[: p1 + L - 1 - p0] = scan[p0 : p1 + L - 1]
        g_dev = jnp.asarray(g)
        for strand, mask in ((STRAND_F, mask_f), (STRAND_R, mask_r)):
            m = np.zeros(chunk, dtype=bool)
            m[: p1 - p0] = mask[p0:p1]
            mm, sel = _chunk_hitmask_mm(
                q_ohs[strand], g_dev, jnp.asarray(m), L, K, int(max_mismatches)
            )
            sel = np.asarray(sel)
            if sel.any():
                mm = np.asarray(mm)
                sp, pos = np.nonzero(sel)
                keep = sp < S
                sp, pos = sp[keep], pos[keep]
                out.append(
                    Hits(
                        spacer_idx=sp.astype(np.int64),
                        pos=(pos + p0).astype(np.int64),
                        strand=np.full(len(pos), strand, np.int8),
                        mismatches=mm[sp, pos].astype(np.int32),
                    )
                )
    return Hits.concat(out).sorted()
