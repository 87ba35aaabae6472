"""Workload 2 — genome-wide guide-library design.

Equivalent of the reference's ``design_guides.py``: enumerate every
PAM-adjacent k-mer on both strands, map all of them back through the targets
engine to find off-targets, then apply the selection-filter cascade
(orientation, offtargets, ambiguity, intergenic, full-overlap, tiling,
top-N per gene).

Differences from the reference:
  - candidate enumeration is the PAM site mask + a packed-key dedup
    (vectorized) instead of a Python regex over both strand strings
    (design_guides.py:22-49);
  - the targets stage runs in-process on the device engine instead of
    ``subprocess: python targets.py`` (design_guides.py:90-104);
  - the all-vs-all off-target scan uses the dense-hit grouped phase-2
    extraction path (every candidate hits its own site).

Filter semantics reproduce design_guides.py:111-310 exactly, including the
note-regex-derived sites/genes/intergenic counts.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import pandas as pd
from numpy.lib.stride_tricks import sliding_window_view

from ..core.genome import Genome
from ..ops.prep import build_scan_array, site_masks
from ..pipeline.targets import TargetsResult, run_targets
from ..seqio.library import BarcodeLibrary


def is_dna(sequence: str) -> bool:
    """design_guides.py:18-19."""
    return all(base in "GATC" for base in sequence)


def _pack_windows(codes_mat: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(n, L) codes → (words uint64 (n, ceil(L/32)), valid bool) — N poisons
    validity. Multi-word keys keep the dedup exact for ANY barcode length
    (a single uint64 silently dropped bases past position 31: numpy shifts
    >= 64 wrap/zero, so 40-mers differing only in their tail collided)."""
    n, L = codes_mat.shape
    valid = (codes_mat < 4).all(axis=1)
    vals = codes_mat.astype(np.uint64) & np.uint64(3)
    n_words = max(-(-L // 32), 1)
    words = np.zeros((n, n_words), dtype=np.uint64)
    for j in range(L):
        words[:, j // 32] |= vals[:, j] << np.uint64(2 * (j % 32))
    return words, valid


def find_candidate_guides(
    genome: Genome, barcode_length: int, pam: str, pam_direction: str = "downstream"
) -> list[str]:
    """All distinct PAM-adjacent spacers of the given length on either
    strand (reference: find_sequences_with_barcode_and_pam,
    design_guides.py:22-49; the reference dedups into a ``set`` so its order
    is arbitrary).

    Candidates come back in GENOME-FIRST-OCCURRENCE order (per contig:
    forward-strand sites by position, then reverse). This matters for
    performance, not just fidelity: the scan kernel's phase-1 indicator is
    keyed on (spacer-block, genome-subtile) cells, and position-ordered
    candidates put ~subtile-width runs of self-hits into the SAME cell —
    measured ~30x fewer phase-2 pairs on the 1 Mb design benchmark than the
    packed-key order np.unique returns."""
    L = barcode_length
    words_list: list[np.ndarray] = []
    codes_list: list[np.ndarray] = []
    ord_list: list[np.ndarray] = []
    base = 0
    for contig in genome.contigs:
        if contig.length < L:
            continue
        scan = build_scan_array(contig, L)
        windows = sliding_window_view(scan, L)[: contig.length]
        mask_f, mask_r = site_masks(contig, L, pam, pam_direction)
        mask_f = mask_f[: len(windows)]
        mask_r = mask_r[: len(windows)]
        for mask, rc in ((mask_f, False), (mask_r, True)):
            pos = np.nonzero(mask)[0]
            if not len(pos):
                base += contig.length
                continue
            sel = windows[pos]
            if rc:
                sel = sel[:, ::-1]
                sel = np.where(sel < 4, 3 - sel, sel)
            words, valid = _pack_windows(sel)
            words_list.append(words[valid])
            codes_list.append(np.ascontiguousarray(sel[valid]))
            ord_list.append(base + pos[valid])
            base += contig.length
    if not words_list:
        return []
    words = np.concatenate(words_list)
    codes_all = np.concatenate(codes_list)
    ords = np.concatenate(ord_list)
    n_words = words.shape[1]
    order = np.lexsort(
        (ords,) + tuple(words[:, w] for w in range(n_words - 1, -1, -1))
    )
    ws = words[order]
    first = np.ones(len(ws), dtype=bool)
    first[1:] = (ws[1:] != ws[:-1]).any(axis=1)
    sel_idx = order[first]  # first (smallest-ord) occurrence per key
    sel_idx = sel_idx[np.argsort(ords[sel_idx], kind="stable")]
    # decode from the stored window codes (exact for any L; valid windows
    # are N-free by construction)
    from ..core.encode import DECODE_ASCII

    ascii_mat = DECODE_ASCII[np.clip(codes_all[sel_idx], 0, 4)]
    Lw = ascii_mat.shape[1]
    flat = np.ascontiguousarray(ascii_mat).view(f"S{Lw}").ravel()
    return [b.decode("ascii") for b in flat]


@dataclass
class DesignOptions:
    """design_guides.py:329-403 flags with their defaults and the
    omit_ambiguous → omit_offtargets implication."""

    orientation: str = "forward"  # forward / reverse / both
    mismatches: int = 1
    pam_direction: str = "downstream"
    omit_intergenic: bool = True
    omit_offtargets: bool = False
    omit_ambiguous: bool = False
    keep_top: int = 10
    tile_size: int | None = None
    full_overlap: bool = False

    def resolve(self, barcode_length: int) -> "DesignOptions":
        """Resolved COPY (tile_size default, omit_ambiguous implication):
        mutating self carried stale tile_size/omit_offtargets into a later
        run_design call reusing the same options object (r5 review)."""
        import dataclasses

        return dataclasses.replace(
            self,
            tile_size=self.tile_size or barcode_length,
            omit_offtargets=self.omit_offtargets or self.omit_ambiguous,
        )


def apply_design_filters(
    targets: pd.DataFrame, barcode_length: int, opts: DesignOptions, log=None
) -> pd.DataFrame:
    """The selection cascade (design_guides.py:111-326)."""
    info = log.info if log else (lambda *_: None)
    targets = targets.copy()
    if "mismatches" not in targets.columns:
        targets["mismatches"] = 0
    # only mismatched rows carry lowercase bases in `target` — uppercasing
    # the whole 600k-row arrow column measured ~1 s at design scale
    mm_rows = (targets["mismatches"].fillna(0) > 0).to_numpy(bool)
    if mm_rows.any():
        targets.loc[mm_rows, "target"] = targets.loc[mm_rows, "target"].str.upper()
    if "count" in targets.columns:
        targets = targets.drop(columns=["count"])
    # spacer selections below (full-overlap / tiling / keep-top) run on one
    # factorization instead of string-set isin per filter
    sp_codes_all, _ = pd.factorize(targets["spacer"])
    targets["_spc"] = sp_codes_all

    # note strings have tiny cardinality (combinations of small counts), so
    # regex work runs once per UNIQUE note and maps back through codes —
    # str.extract over ~600k arrow rows measured ~1 s per call at design
    # scale, ×4 calls
    has_note = "note" in targets.columns
    if has_note:
        note_codes, note_uniq = pd.factorize(targets["note"])
        targets["_nc"] = note_codes
        uniq_s = pd.Series(note_uniq, dtype="object")

        def note_field(pattern: str, fill=None) -> np.ndarray:
            vals = uniq_s.str.extract(pattern, expand=False).to_numpy(dtype="float64")
            codes_now = targets["_nc"].to_numpy()
            out = np.where(
                codes_now >= 0, vals[np.clip(codes_now, 0, None)], np.nan
            )
            if fill is None:
                # match the direct column extract: .astype(int) raises when
                # any CURRENT row's note misses the pattern
                if np.isnan(out).any():
                    raise ValueError(
                        f"note rows without {pattern!r} cannot convert to int"
                    )
            else:
                out = np.where(np.isnan(out), fill, out)
            return out.astype(int)

    if opts.orientation == "forward":
        targets = targets.loc[targets["sp_dir"] == targets["tar_dir"]]
    elif opts.orientation == "reverse":
        targets = targets.loc[targets["sp_dir"] != targets["tar_dir"]]

    if opts.omit_offtargets:
        if not has_note:
            raise ValueError(
                "omit_offtargets requires a 'note' column (site/gene counts) "
                "on the targets frame; run the targets stage with notes enabled"
            )
        len_before = len(targets)
        targets.loc[:, "sites"] = note_field(r"(\d+) site")
        targets = targets[targets["sites"] == 1]
        info(f"Removed {len_before - len(targets):,} off-targeting guides")

    if opts.mismatches > 0:
        len_before = len(targets)
        targets = targets.loc[targets["mismatches"] == 0]
        info(f"Removed {len_before - len(targets):,} mismatched guides")

    if opts.omit_ambiguous:
        if not has_note:
            raise ValueError(
                "omit_ambiguous requires a 'note' column (site/gene counts) "
                "on the targets frame; run the targets stage with notes enabled"
            )
        targets["sites"] = note_field(r"(\d+) site", fill=0)
        targets["genes"] = note_field(r"(\d+) gene", fill=0)
        targets["intergenic"] = note_field(r"(\d+) intergenic", fill=0)
        len_before = len(targets)
        targets = targets[
            (targets["sites"] == 1) & (targets["genes"] == 1) & (targets["intergenic"] == 0)
        ]
        info(f"Removed {len_before - len(targets):,} ambiguous guides")

    if opts.omit_intergenic:
        if not has_note:
            raise ValueError(
                "omit_intergenic requires a 'note' column (site/gene counts) "
                "on the targets frame; run the targets stage with notes enabled"
            )
        len_before = len(targets)
        has_inter = uniq_s.str.contains("intergenic").fillna(False).to_numpy(bool)
        codes_now = targets["_nc"].to_numpy()
        row_inter = (codes_now >= 0) & has_inter[np.clip(codes_now, 0, None)]
        targets = targets[~row_inter]
        info(f"Removed {len_before - len(targets):,} intergenic guides")

    if opts.full_overlap:
        len_before = len(targets)
        codes = targets["_spc"].to_numpy()
        # float compare so NA overlaps (non-targeting rows) read as
        # no-match like the reference's numpy NaN semantics, instead of
        # raising on the nullable boolean mask
        ovl = targets["overlap"].to_numpy(dtype="float64", na_value=np.nan)
        keep_codes = np.unique(codes[ovl == barcode_length])
        targets = targets[np.isin(codes, keep_codes)]
        info(f"Removed {len_before - len(targets):,} partial-overlap guides")

    def lt_sorted(t):
        """(t sorted like sort_values(["locus_tag", "offset"]), per-row
        lexicographic locus codes, null code): one factorization serves the
        sort and the group boundaries — pandas groupby materialized ~4200
        sub-frames per pass (measured ~1.5 s at design scale); null
        locus_tag sorts last (na_position) and is flagged for the
        groupby-dropna semantics."""
        lt_codes, lt_uniq = pd.factorize(t["locus_tag"], sort=True)
        null_code = len(lt_uniq)
        lt_adj = np.where(lt_codes < 0, null_code, lt_codes).astype(np.int64)
        off = t["offset"].to_numpy(dtype="float64", na_value=np.nan)
        order = np.lexsort((off, lt_adj))
        return t.iloc[order], lt_adj[order], null_code

    if opts.tile_size and opts.tile_size > 0:
        targets, lt_adj, null_code = lt_sorted(targets)
        spc = targets["_spc"].to_numpy()
        off_all = targets["offset"].to_numpy(dtype="float64", na_value=np.nan)
        ovl_all = targets["overlap"].to_numpy(dtype="float64", na_value=np.nan)
        starts = np.nonzero(np.r_[True, lt_adj[1:] != lt_adj[:-1]])[0] if len(lt_adj) else np.zeros(0, np.int64)
        ends = np.r_[starts[1:], len(lt_adj)] if len(starts) else starts
        selected_codes = set()
        # greedy per-gene tiling (design_guides.py:231-280) over numpy
        # slices of the sorted arrays
        for a, b in zip(starts.tolist(), ends.tolist()):
            if lt_adj[a] == null_code:
                continue  # groupby("locus_tag") drops the null group
            offsets = off_all[a:b]
            sp_arr = spc[a:b]
            overlaps = ovl_all[a:b]
            if opts.full_overlap:
                full = np.nonzero(overlaps == barcode_length)[0]
                last_offset = offsets[full[0]] if len(full) else None
            else:
                # an all-NaN-offset group (unstranded feature,
                # targets.py:231-232): NaN sorts last, so offsets[0] is NaN
                # only when the whole group is — skip it like the empty
                # full_overlap case (the reference CRASHES here: its
                # offset==NaN mask selects nothing and .iloc[0] raises)
                last_offset = None if np.isnan(offsets[0]) else offsets[0]
            if last_offset is not None:
                selected_codes.add(sp_arr[offsets == last_offset][0])
            if last_offset is not None:
                for off, sp in zip(offsets, sp_arr):
                    if off >= last_offset + opts.tile_size:
                        selected_codes.add(sp)
                        last_offset = off
        targets = targets[
            np.isin(spc, np.fromiter(selected_codes, np.int64, len(selected_codes)))
        ]

    if opts.keep_top and opts.keep_top > 0:
        len_before = len(targets)
        if opts.full_overlap:
            targets = targets[
                targets["overlap"].to_numpy(dtype="float64", na_value=np.nan)
                >= barcode_length
            ]
        targets, lt_adj, null_code = lt_sorted(targets)
        if len(targets):
            # ≡ groupby("locus_tag").head(keep_top): already sorted by
            # (locus_tag, offset), so within-group rank < N IS the N
            # smallest offsets with the same positional tie-breaking
            starts = np.nonzero(np.r_[True, lt_adj[1:] != lt_adj[:-1]])[0]
            counts = np.diff(np.r_[starts, len(lt_adj)])
            rank = np.arange(len(lt_adj)) - np.repeat(starts, counts)
            spc = targets["_spc"].to_numpy()
            off_sorted = targets["offset"].to_numpy(
                dtype="float64", na_value=np.nan
            )
            # nsmallest(keep_top, 'offset') silently DROPS NaN-offset rows
            # (unstranded features) — positional rank alone would admit
            # them whenever a group holds fewer than keep_top real offsets
            head_mask = (
                (rank < opts.keep_top)
                & (lt_adj != null_code)
                & ~np.isnan(off_sorted)
            )
            top_codes = np.unique(spc[head_mask])
            targets = targets[np.isin(spc, top_codes)]
        info(f"Removed {len_before - len(targets):,} beyond-top-{opts.keep_top} guides")

    targets = targets.drop(
        columns=[c for c in ("_nc", "_spc") if c in targets.columns]
    )
    # integer coercion + final sort (design_guides.py:312-326 applies it to
    # every non-object column; under pandas 3 strings are `str` dtype, so
    # the equivalent guard is is_numeric_dtype)
    targets = targets.apply(
        lambda col: (
            pd.to_numeric(col, errors="coerce").fillna(0).astype(int)
            if pd.api.types.is_numeric_dtype(col)
            else col
        )
    )
    targets = targets.sort_values(
        ["chr", "tar_start", "tar_end", "locus_tag", "offset", "overlap"]
    )
    return targets


def write_sgrna_fasta(candidates, path: str) -> None:
    """create_sgRNA_fasta parity (design_guides.py:53-56): ``>seq\\nseq``
    records, one per candidate, in enumeration order."""
    with open(path, "wt") as fh:
        for seq in candidates:
            fh.write(f">{seq}\n{seq}\n")


def run_design(
    genome: Genome,
    pam: str,
    barcode_length: int,
    opts: DesignOptions | None = None,
    backend: str = "auto",
    log=None,
    sgrna_out: str | None = None,
) -> tuple[pd.DataFrame, TargetsResult, list[str]]:
    """Full design pipeline; returns (final table, targets stage result,
    candidate guides).

    sgrna_out persists the enumerated candidates as a ``>seq\\nseq`` FASTA
    BEFORE the scan stage — the reference's durable sgRNA.fasta intermediate
    (design_guides.py:53-56,82), so the library survives a failed scan."""
    opts = (opts or DesignOptions()).resolve(barcode_length)
    candidates = find_candidate_guides(genome, barcode_length, pam, opts.pam_direction)
    if log:
        log.info(f"Found {len(candidates):,} potential guides in the genome")
    if sgrna_out:
        write_sgrna_fasta(candidates, sgrna_out)
    # name = sequence, like create_sgRNA_fasta (design_guides.py:53-56);
    # candidates are already unique + normalized (find_candidate_guides)
    library = BarcodeLibrary.from_unique_list(candidates)
    tr = run_targets(
        library, genome, pam, opts.mismatches,
        pam_direction=opts.pam_direction, backend=backend,
    )
    final = apply_design_filters(tr.table, barcode_length, opts, log=log)
    return final, tr, candidates
