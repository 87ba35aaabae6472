"""Workload 3 — heuristic barcode counting in sequencing reads.

Equivalent of the reference's ``heuristicount.py``: (a) sample reads to vote
barcode orientation + fixed offset; (b) discover constant flanking sequences
by length-descending vote; (c) cross-check flank complementarity between
mates; (d) count exact flank-anchored barcode occurrences over all reads;
(e) collate documented vs undocumented (``seq*``) counts.

Phases (a)–(c) are data-dependent host control flow over a few thousand
reads and faithfully reproduce the reference's heuristics
(heuristicount.py:156-425, 644-697). Phase (d) — the hot loop the reference
runs on a fork pool of Python workers (heuristicount.py:720-722) — is
replaced by a vectorized engine: reads become a fixed-width byte matrix, the
window/flank checks become column compares, barcode cores are 2-bit packed
into uint64 keys and matched against the sorted library via searchsorted
(device or numpy), counts merged with bincount/segment-sum. A direct
per-read port is kept as the exactness oracle (count_chunk_reference).
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field

import numpy as np

from ..seqio.fasta import iter_read_chunks


def rev_comp(sequence: str) -> str:
    """heuristicount.py:29-30."""
    return sequence[::-1].translate(str.maketrans("ATCGN", "TAGCN"))


def safe_len(s) -> int:
    return 0 if s is None else len(s)


def validate_barcodes(barcodes) -> None:
    """heuristicount.py:75-97."""
    if isinstance(barcodes, list):
        sequences = set(barcodes)
    elif isinstance(barcodes, set):
        sequences = barcodes
    else:
        raise ValueError("Pass a list or set of barcodes to validate.")
    if len(sequences) < 10:
        raise ValueError(
            "The input contains fewer than 10 sequences. Please provide at least 10 short barcodes."
        )
    for seq in sequences:
        if len(seq) > 1000:
            raise ValueError(
                f'The sequence "{seq}" is longer than 1,000 bases. Provide a list or fasta file of short barcodes.'
            )


@dataclass
class SampleResult:
    new_reads_sampled: int
    bc_start1: int | None
    bc_start2: int | None
    sample1: set | None
    sample2: set | None
    observed_barcodes: set
    need_swap: bool
    num_chunks: int


_KEY_SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)


def _window_keys(reads: list[str], bc_len: int) -> np.ndarray:
    """(n, W) uint64 2-bit keys of every bc_len-window of every read; the
    sentinel where the window contains a non-ACGT byte or runs past the
    read end. W is keyed to the longest read in the batch."""
    if not reads:
        return np.zeros((0, 0), np.uint64)
    mat = _to_matrix(reads)
    lens = np.array([len(r) for r in reads], np.int64)
    codes = _CODE_LUT[mat]  # (n, m) uint8; >=4 = non-ACGT
    n, m = codes.shape
    W = m - bc_len + 1
    if W <= 0:
        return np.zeros((n, 0), np.uint64)
    vals = (codes & 3).astype(np.uint64)
    bad = codes >= 4
    cs = np.zeros((n, m + 1), np.int32)
    np.cumsum(bad, axis=1, out=cs[:, 1:])
    badw = (cs[:, bc_len:] - cs[:, :-bc_len]) > 0  # (n, W)
    keys = np.zeros((n, W), np.uint64)
    for j in range(bc_len):
        keys |= vals[:, j : j + W] << np.uint64(2 * j)
    oob = np.arange(W)[None, :] > (lens - bc_len)[:, None]
    keys[badw | oob] = _KEY_SENTINEL
    return keys


def _key_candidates(keys: np.ndarray, sorted_keys: np.ndarray) -> np.ndarray:
    """Bool mask of windows whose packed key appears in sorted_keys."""
    if keys.size == 0 or len(sorted_keys) == 0:
        return np.zeros(keys.shape, bool)
    idx = np.minimum(np.searchsorted(sorted_keys, keys), len(sorted_keys) - 1)
    return (sorted_keys[idx] == keys) & (keys != _KEY_SENTINEL)


def _csr_rows(mask: np.ndarray):
    """Row-grouped nonzero columns: (cols, indptr) with row i's candidate
    positions at cols[indptr[i]:indptr[i+1]], ascending."""
    r, c = np.nonzero(mask)
    ptr = np.searchsorted(r, np.arange(mask.shape[0] + 1))
    return c, ptr


def sample_reads(file1, file2, barcodes, is_paired, log=None) -> SampleResult:
    """Reference sample_data (heuristicount.py:156-379): vote orientation and
    offset from k-mer membership, with the diversity stopping rules.

    The per-read/per-position logic is the reference's, but the k-mer
    membership loop only visits *candidate* positions precomputed with a
    vectorized packed-key match per chunk. Candidates are a provable
    superset of every position where any of the reference's membership
    tests (barcodes / rev_barcodes / this-chunk novel_barcodes, all of
    which contain only library-matching strings) can succeed, because
    case-insensitive 2-bit packing is coarser than string equality — so
    replaying the original tests at candidate positions is exact. Falls
    back to the full per-position loop when barcodes don't pack (length
    > 32 or non-ACGT letters)."""
    info = log.info if log else (lambda *_: None)
    warn = log.warn if log else (lambda *_: None)
    satisfy_diversity = False
    rev_barcodes = {rev_comp(bc) for bc in barcodes}
    bc_len = len(next(iter(barcodes)))
    chunk_generator = iter_read_chunks(
        file1, file2 if is_paired else None, chunk_size=len(barcodes)
    )

    # packed-key candidate prefilter (see docstring); sentinel keys mean
    # some barcode doesn't 2-bit-pack -> use the unfiltered per-position loop
    use_prefilter = False
    if bc_len <= 32:  # > 32 doesn't fit a uint64 key at all
        all_keys = _pack_strings(sorted(barcodes) + sorted(rev_barcodes))
        use_prefilter = not (all_keys == _KEY_SENTINEL).any()
    cand_keys = np.sort(all_keys) if use_prefilter else None

    diversity_count1 = diversity_count2 = 0
    read1_orients: Counter = Counter()
    read2_orients: Counter = Counter()
    read1_offsets: Counter = Counter()
    read2_offsets: Counter = Counter()
    valid_reads1: set = set()
    valid_reads2: set = set()
    global_novel_reads: set = set()
    observed_barcodes: set = set()
    global_novel_barcodes: list = []
    num_chunks = 0
    read1 = read2 = None

    for read1_chunk, read2_chunk in chunk_generator:
        num_chunks += 1
        novel_read1_orients: list = []
        novel_read2_orients: list = []
        novel_read1_offsets: list = []
        novel_read2_offsets: list = []
        novel_barcodes: set = set()
        novel_reads: set = set()

        if use_prefilter:
            c1_cols, c1_ptr = _csr_rows(
                _key_candidates(_window_keys(read1_chunk, bc_len), cand_keys)
            )
            if is_paired:
                c2_cols, c2_ptr = _csr_rows(
                    _key_candidates(_window_keys(read2_chunk, bc_len), cand_keys)
                )

        for ridx, (read1, read2) in enumerate(
            zip(read1_chunk, read2_chunk if read2_chunk else [None] * len(read1_chunk))
        ):
            if read1 in novel_reads or (read2 and read2 in novel_reads):
                continue
            global_novel_reads.add(read1)
            if is_paired:
                global_novel_reads.add(read2)

            if use_prefilter:
                p1 = c1_cols[c1_ptr[ridx] : c1_ptr[ridx + 1]]
                if is_paired:
                    p2 = c2_cols[c2_ptr[ridx] : c2_ptr[ridx + 1]]
                    p2 = p2[p2 <= len(read1) - bc_len]  # the reference's
                    # position loop is bounded by read1's length
                    positions = np.union1d(p1, p2) if len(p2) else p1
                else:
                    positions = p1
            else:
                positions = range(len(read1) - bc_len + 1)

            for i in positions:
                i = int(i)
                kmer = read1[i : i + bc_len]
                if kmer in novel_barcodes:
                    continue
                if kmer in barcodes:
                    diversity_count1 += 1
                    novel_barcodes.add(kmer)
                    observed_barcodes.add(kmer)
                    novel_read1_orients.append("forward")
                    novel_read1_offsets.append(i)
                    valid_reads1.add(read1)
                    novel_reads.add(read1)
                if kmer in rev_barcodes:
                    diversity_count1 += 1
                    novel_barcodes.add(kmer)
                    observed_barcodes.add(kmer)
                    novel_read1_orients.append("reverse")
                    novel_read1_offsets.append(i)
                    valid_reads1.add(read1)
                    novel_reads.add(read1)

                if is_paired and i <= len(read2) - bc_len:
                    kmer2 = read2[i : i + bc_len]
                    if kmer2 in novel_barcodes:
                        continue
                    if kmer2 in barcodes:
                        diversity_count2 += 1
                        novel_barcodes.add(kmer2)
                        # the reference adds READ1's kmer here, not kmer2
                        # (heuristicount.py:260-261,269-270) — its quirk,
                        # preserved for stdout parity
                        observed_barcodes.add(kmer)
                        novel_read2_orients.append("forward")
                        novel_read2_offsets.append(i)
                        valid_reads2.add(read2)
                        novel_reads.add(read2)
                    if kmer2 in rev_barcodes:
                        diversity_count2 += 1
                        novel_barcodes.add(kmer2)
                        observed_barcodes.add(kmer)
                        novel_read2_orients.append("reverse")
                        novel_read2_offsets.append(i)
                        valid_reads2.add(read2)
                        novel_reads.add(read2)

        global_novel_barcodes.extend(novel_barcodes)
        read1_orients.update(novel_read1_orients)
        read2_orients.update(novel_read2_orients)
        read1_offsets.update(novel_read1_offsets)
        read2_offsets.update(novel_read2_offsets)
        read1_offsets_common = read1_offsets.most_common(2)
        read2_offsets_common = read2_offsets.most_common(2)

        if is_paired:
            if all(c >= 5 * len(barcodes) for c in (diversity_count1, diversity_count2)):
                info("Many barcodes seen enough in reads...")
                satisfy_diversity = True
            if len(global_novel_reads) >= 5 * len(barcodes) and global_novel_barcodes:
                info("Read depth diversity satisfied...")
                satisfy_diversity = True
            if len(global_novel_barcodes) >= 5 * len(barcodes):
                info("Barcode frequency diversity satisfied...")
                satisfy_diversity = True
            if satisfy_diversity:
                if (len(read1_offsets_common) == 1 and len(read2_offsets_common) == 1) or (
                    len(read1_offsets_common) > 1
                    and len(read2_offsets_common) > 1
                    and read1_offsets_common[0][1] >= 2 * read1_offsets_common[1][1]
                    and read2_offsets_common[0][1] >= 2 * read2_offsets_common[1][1]
                ):
                    info("Dominant offsets found...")
                    break
        else:
            if diversity_count1 >= 5 * len(barcodes):
                info("Many barcodes seen enough in reads...")
                satisfy_diversity = True
            if len(global_novel_reads) >= 5 * len(barcodes) and global_novel_barcodes:
                info("Read depth diversity satisfied...")
                satisfy_diversity = True
            if len(global_novel_barcodes) >= 5 * len(barcodes):
                info("Barcode frequency diversity satisfied...")
                satisfy_diversity = True
            if satisfy_diversity:
                if len(read1_offsets_common) == 1 or (
                    len(read1_offsets_common) > 1
                    and read1_offsets_common[0][1] >= 2 * read1_offsets_common[1][1]
                ):
                    info("Dominant offsets found...")
                    break

    if not satisfy_diversity:
        warn("Sequencing depth is probably insufficient! Continuing anyway...")

    read1_orient = read1_orients.most_common(1)[0][0] if read1_orients else None
    read1_offset = read1_offsets.most_common(1)[0][0] if read1_offsets else None
    read2_orient = read2_orients.most_common(1)[0][0] if read2_orients else None
    read2_offset = read2_offsets.most_common(1)[0][0] if read2_offsets else None

    if read1_orient == "forward" or read2_orient == "reverse":
        return SampleResult(
            len(global_novel_reads), read1_offset, read2_offset,
            valid_reads1, valid_reads2, observed_barcodes, False, num_chunks,
        )
    if read1_orient == "reverse" or read2_orient == "forward":
        return SampleResult(
            len(global_novel_reads), read2_offset, read1_offset,
            valid_reads2, valid_reads1, observed_barcodes, True, num_chunks,
        )
    raise ValueError(
        "Unable to determine orientation of reads. Please check the input files."
    )


def find_flanks(reads, start: int, bc_len: int, max_flank: int = 10):
    """Reference find_flanks (heuristicount.py:382-425)."""
    L_flanks: Counter = Counter()
    R_flanks: Counter = Counter()

    def update_flanks(side, seq, max_len):
        counts = L_flanks if side == "L_flank" else R_flanks
        for i in range(max_len, 0, -1):
            truncated = seq[-i:] if side == "L_flank" else seq[:i]
            counts[truncated] += 1

    for read in reads:
        L_flank = read[start - max_flank : start] if start - max_flank >= 0 else read[0:start]
        R_flank = read[start + bc_len : start + bc_len + max_flank]
        update_flanks("L_flank", L_flank, len(L_flank))
        update_flanks("R_flank", R_flank, len(R_flank))

    def extract_best_flank(counts: Counter):
        most_common_prev = None
        for fl_len in range(max_flank, 0, -1):
            potential = [seq for seq in counts if len(seq) == fl_len]
            if not potential:
                continue
            most_common = max(potential, key=lambda x: counts[x])
            if most_common_prev is None:
                most_common_prev = most_common
            elif counts[most_common] > 3 * counts[most_common_prev]:
                most_common_prev = most_common
        return most_common_prev

    return extract_best_flank(L_flanks), extract_best_flank(R_flanks)


def check_flank_complementarity(L_fwd, R_fwd, L_rev, R_rev):
    """Reference main() flank cross-check (heuristicount.py:644-688);
    returns list of error messages (empty = consistent)."""
    L_rev_rev = rev_comp(L_rev) if L_rev else None
    R_rev_rev = rev_comp(R_rev) if R_rev else None
    errors = set()
    if L_fwd and R_rev_rev:
        m = min(len(L_fwd), len(R_rev_rev))
        if L_fwd[-m:] != R_rev_rev[:m]:
            errors.add("Flank complementarity violation")
    if R_fwd and L_rev_rev:
        m = min(len(R_fwd), len(L_rev_rev))
        if R_fwd[:m] != L_rev_rev[:m]:
            errors.add("Flank complementarity violation")
    return sorted(errors)


@dataclass
class CountConfig:
    barcodes: set
    bc_len: int
    L_fwd: str | None = None
    R_fwd: str | None = None
    L_rev: str | None = None
    R_rev: str | None = None
    L_fwd_start: int | None = None
    L_rev_start: int | None = None
    need_swap: bool = False
    # derived
    bcs_with_flanks_fwd: set = field(default_factory=set)
    bcs_with_flanks_rev: set = field(default_factory=set)

    def __post_init__(self):
        def add_flank(bcs, L, R):
            L, R = (L or ""), (R or "")
            return {L + b + R for b in bcs}

        bcs_rev = {rev_comp(b) for b in self.barcodes}
        self.bcs_with_flanks_fwd = add_flank(self.barcodes, self.L_fwd, self.R_fwd)
        self.bcs_with_flanks_rev = add_flank(bcs_rev, self.L_rev, self.R_rev)


def count_chunk_reference(chunk, cfg: CountConfig) -> tuple[Counter, int]:
    """Direct port of process_chunk (heuristicount.py:428-562): the
    per-read oracle for the vectorized engine."""
    counts: Counter = Counter()
    if cfg.need_swap:
        reads2, reads1 = chunk
    else:
        reads1, reads2 = chunk

    L_fwd_len = safe_len(cfg.L_fwd)
    R_fwd_len = safe_len(cfg.R_fwd)
    L_rev_len = safe_len(cfg.L_rev)
    R_rev_len = safe_len(cfg.R_rev)
    bc_len = cfg.bc_len

    def validate_read(seq_with_flanks, L_flank, R_flank, rev=False):
        in_set = seq_with_flanks in (
            cfg.bcs_with_flanks_rev if rev else cfg.bcs_with_flanks_fwd
        )
        seq = seq_with_flanks[safe_len(L_flank) : safe_len(seq_with_flanks) - safe_len(R_flank)]
        has_flanks = seq_with_flanks.startswith(L_flank or "") and seq_with_flanks.endswith(
            R_flank or ""
        )
        return in_set, has_flanks, seq

    if reads1 and reads2:
        if len(reads1) != len(reads2):
            raise ValueError(
                "Length of reads1 and reads2 must be the same for paired-end data."
            )
        for rf, rr in zip(reads1, reads2):
            if "N" in rf or "N" in rr:
                continue
            swf = rf[cfg.L_fwd_start : cfg.L_fwd_start + L_fwd_len + bc_len + R_fwd_len]
            swr = rr[cfg.L_rev_start : cfg.L_rev_start + L_rev_len + bc_len + R_rev_len]
            in_f, has_f, seq1 = validate_read(swf, cfg.L_fwd, cfg.R_fwd)
            in_r, has_r, seq2 = validate_read(swr, cfg.L_rev, cfg.R_rev, rev=True)
            if seq1 != rev_comp(seq2):
                continue
            if in_f and in_r and has_f and has_r:
                counts[seq1] += 1
            elif has_f and has_r:
                counts[seq1 + "*"] += 1
    elif reads1:
        for record in reads1:
            if "N" in record:
                continue
            swf = record[cfg.L_fwd_start : cfg.L_fwd_start + L_fwd_len + bc_len + R_fwd_len]
            in_f, has_f, seq = validate_read(swf, cfg.L_fwd, cfg.R_fwd)
            if in_f and has_f:
                counts[seq] += 1
            elif has_f:
                counts[seq + "*"] += 1
    elif reads2:
        for record in reads2:
            if "N" in record:
                continue
            swr = record[cfg.L_rev_start : cfg.L_rev_start + L_rev_len + bc_len + R_rev_len]
            in_r, has_r, seq = validate_read(swr, cfg.L_rev, cfg.R_rev, rev=True)
            seq = rev_comp(seq)
            if in_r and has_r:
                counts[seq] += 1
            elif has_r:
                counts[seq + "*"] += 1
    return counts, (len(reads1) if reads1 else len(reads2))


# ----------------------- vectorized counting engine -----------------------

_CODE_LUT = np.full(256, 4, dtype=np.int8)
for _i, _b in enumerate(b"ACGT"):
    _CODE_LUT[_b] = _i


def _to_matrix(reads: list[str]) -> np.ndarray:
    """list of read strings → (n, maxlen) uint8 ascii matrix (0-padded)."""
    arr = np.array(reads, dtype="S")
    return arr.view(np.uint8).reshape(len(reads), -1) if len(reads) else np.zeros((0, 0), np.uint8)


def _window(mat: np.ndarray, start: int, width: int) -> np.ndarray:
    """Column slice with 0-padding past the read end (ascii 0 never matches
    any base or flank)."""
    n, m = mat.shape
    out = np.zeros((n, width), dtype=np.uint8)
    s = min(max(start, 0), m)
    e = min(start + width, m)
    if e > s:
        out[:, : e - s] = mat[:, s:e]
    return out


def _pack_codes(codes: np.ndarray) -> np.ndarray:
    """(n, bc_len<=32) base codes → (n,) uint64 keys (2 bits/base).

    Any non-ACGT base poisons the key to the sentinel ~0 (never equals a
    packed library barcode, which is pure ACGT)."""
    n, w = codes.shape
    assert w <= 32
    bad = (codes >= 4).any(axis=1)
    vals = codes.astype(np.uint64) & np.uint64(3)
    key = np.zeros(n, dtype=np.uint64)
    for j in range(w):
        key |= vals[:, j] << np.uint64(2 * j)
    key[bad] = np.uint64(0xFFFFFFFFFFFFFFFF)
    return key


def _pack_strings(seqs: list[str]) -> np.ndarray:
    if not seqs:
        return np.zeros(0, dtype=np.uint64)
    mat = _to_matrix(seqs)
    return _pack_codes(_CODE_LUT[mat])


class _CheckpointState:
    """Per-batch partial-count persistence for the vector engine."""

    def __init__(self, path: str, cfg: "CountConfig", inputs: tuple = ()):
        import hashlib

        self.path = path
        # `inputs`: (file paths..., chunk_size) — resuming against
        # DIFFERENT input files or a different chunk geometry with the
        # same library/flank config would silently skip the wrong chunks
        # of the new stream (r5 review; distill's make_fingerprint is the
        # model). Size+mtime pin the file contents.
        in_sig = []
        for item in inputs:
            if isinstance(item, str):
                import os

                try:
                    st = os.stat(item)
                    in_sig.append((os.path.abspath(item), st.st_size, st.st_mtime_ns))
                except OSError:
                    in_sig.append((item, -1, -1))
            else:
                in_sig.append(item)
        sig = "|".join(
            str(x)
            for x in (
                sorted(cfg.barcodes)[:50], len(cfg.barcodes), cfg.bc_len,
                cfg.L_fwd, cfg.R_fwd, cfg.L_rev, cfg.R_rev,
                cfg.L_fwd_start, cfg.L_rev_start, cfg.need_swap, in_sig,
            )
        )
        self.cfg_hash = hashlib.sha256(sig.encode()).hexdigest()[:16]

    def restore(self, vc: "VectorCounter") -> int:
        import json
        import os

        import numpy as _np

        if not os.path.exists(self.path):
            return 0
        try:
            with _np.load(self.path, allow_pickle=False) as z:
                meta = json.loads(str(z["meta"]))
                if meta["cfg_hash"] != self.cfg_hash:
                    return 0
                vc.doc_counts[:] = z["doc_counts"]
                vc.total_reads = int(meta["total_reads"])
                vc.undoc.update(
                    {k: int(v) for k, v in zip(meta["undoc_keys"], meta["undoc_vals"])}
                )
                if hasattr(vc, "owned_reads"):
                    # multi-host chunk-ownership bookkeeping: without this a
                    # resumed run under-reports the host's parse share and
                    # breaks the "disjoint shares sum to the total" contract
                    # that info['owned_reads'] advertises
                    vc.owned_reads = int(meta.get("owned_reads", 0))
                return int(meta["chunk_no"])
        except Exception:
            return 0

    def save(self, vc: "VectorCounter", chunk_no: int) -> None:
        import json
        import os

        import numpy as _np

        # retire in-flight device work first — doc_counts/undoc must cover
        # every chunk up to chunk_no or a resume loses the gap
        vc.drain()
        meta = {
            "cfg_hash": self.cfg_hash,
            "chunk_no": chunk_no,
            "total_reads": vc.total_reads,
            "undoc_keys": list(vc.undoc.keys()),
            "undoc_vals": [int(v) for v in vc.undoc.values()],
            "owned_reads": int(getattr(vc, "owned_reads", 0)),
        }
        tmp = self.path + ".tmp"
        _np.savez(tmp, doc_counts=vc.doc_counts, meta=json.dumps(meta))
        os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp, self.path)

    def finalize(self) -> None:
        import os

        if os.path.exists(self.path):
            os.remove(self.path)


class VectorCounter:
    """Chunk counter with the same observable semantics as
    count_chunk_reference, implemented as array ops.

    Requires bc_len <= 32 (covers the reference's real libraries, 20–32 nt);
    longer barcodes automatically fall back to the per-read path in
    run_count."""

    def __init__(self, cfg: CountConfig):
        self.cfg = cfg
        bcs = sorted(cfg.barcodes)
        self.bc_list = bcs
        self.bc_keys = _pack_strings(bcs)
        order = np.argsort(self.bc_keys)
        self.bc_keys_sorted = self.bc_keys[order]
        self.bc_order = order
        self.doc_counts = np.zeros(len(bcs), dtype=np.int64)
        self.undoc: Counter = Counter()
        self.total_reads = 0
        self._bc_index = None  # lazy {barcode: row} for the slow path

    def _flank_ok(self, win: np.ndarray, flank: str | None, side: str) -> np.ndarray:
        if not flank:
            return np.ones(win.shape[0], dtype=bool)
        fl = np.frombuffer(flank.encode(), dtype=np.uint8)
        if side == "L":
            return (win[:, : len(fl)] == fl[None, :]).all(axis=1)
        return (win[:, win.shape[1] - len(fl) :] == fl[None, :]).all(axis=1)

    def _process_side(self, mat, start, L_flank, R_flank, rev: bool):
        cfg = self.cfg
        W = safe_len(L_flank) + cfg.bc_len + safe_len(R_flank)
        win = _window(mat, start or 0, W)
        has_l = self._flank_ok(win, L_flank, "L")
        has_r = self._flank_ok(win, R_flank, "R")
        core = win[:, safe_len(L_flank) : safe_len(L_flank) + cfg.bc_len]
        return win, has_l & has_r, core

    def process_chunk(self, chunk) -> None:
        """String-list entry point (mirrors process_chunk in the reference);
        converts to byte matrices and delegates."""
        cfg = self.cfg
        if cfg.need_swap:
            reads2, reads1 = chunk
        else:
            reads1, reads2 = chunk
        m1 = _to_matrix(reads1) if reads1 else None
        m2 = _to_matrix(reads2) if reads2 else None
        self.process_matrices(m1, m2)

    def process_matrices(self, m1, m2) -> None:
        """Matrix entry point (rows already swapped if cfg.need_swap was
        applied by the caller of process_chunk; direct callers pass matrices
        in fwd/rev orientation)."""
        cfg = self.cfg
        n = m1.shape[0] if m1 is not None else (m2.shape[0] if m2 is not None else 0)
        self.total_reads += n
        if n == 0:
            return

        # reads whose scan window is TRUNCATED by the read end take the
        # reference per-read path: the fixed-width zero-padded window
        # cannot reproduce the reference's Python-slice semantics there
        # (endswith on the truncated slice counts undoc, truncated undoc
        # strings, truncated-core pair consistency — r5 review repros).
        # The rows are then BLANKED to all-N in a copy rather than removed:
        # every engine's whole-read N filter drops them without changing
        # row counts, which keeps the sharded engines' cross-host dispatch
        # geometry in lockstep.
        W_f = safe_len(cfg.L_fwd) + cfg.bc_len + safe_len(cfg.R_fwd)
        W_r = safe_len(cfg.L_rev) + cfg.bc_len + safe_len(cfg.R_rev)

        def _trunc(m, start, W):
            return (m != 0).sum(axis=1) < (start or 0) + W

        trunc = np.zeros(n, dtype=bool)
        if m1 is not None:
            trunc |= _trunc(m1, cfg.L_fwd_start, W_f)
        if m2 is not None:
            trunc |= _trunc(m2, cfg.L_rev_start, W_r)
        if trunc.any():
            self._slow_path_rows(m1, m2, np.nonzero(trunc)[0])
            if m1 is not None:
                m1 = m1.copy()
                m1[trunc] = ord("N")
            if m2 is not None:
                m2 = m2.copy()
                m2[trunc] = ord("N")

        if m1 is not None and m2 is not None:
            no_n = ~((m1 == ord("N")).any(axis=1) | (m2 == ord("N")).any(axis=1))
            _, has_f, core_f = self._process_side(m1, cfg.L_fwd_start, cfg.L_fwd, cfg.R_fwd, False)
            _, has_r, core_r = self._process_side(m2, cfg.L_rev_start, cfg.L_rev, cfg.R_rev, True)
            key1 = _pack_codes(_CODE_LUT[core_f])
            # seq1 == rev_comp(seq2): pack revcomp of read2 core
            rc = core_r[:, ::-1]
            rc_codes = _CODE_LUT[rc]
            rc_codes = np.where(rc_codes < 4, 3 - rc_codes, rc_codes)
            key2 = _pack_codes(rc_codes)
            consistent = key1 == key2
            # N-containing cores poison both keys to the same sentinel, but
            # those reads are already dropped by the no_n filter
            eligible = no_n & consistent & has_f & has_r
            self._tally(key1, core_f, eligible)
        else:
            mat, start, Lf, Rf, rev = (
                (m1, cfg.L_fwd_start, cfg.L_fwd, cfg.R_fwd, False)
                if m1 is not None
                else (m2, cfg.L_rev_start, cfg.L_rev, cfg.R_rev, True)
            )
            if not rev and self._try_native_single_end(mat, start, Lf, Rf):
                return
            no_n = ~(mat == ord("N")).any(axis=1)
            _, has, core = self._process_side(mat, start, Lf, Rf, rev)
            codes = _CODE_LUT[core]
            if rev:
                # reference reports rev_comp(core) (heuristicount.py:532-533)
                codes = codes[:, ::-1]
                codes = np.where(codes < 4, 3 - codes, codes)
                ascii_lut = np.frombuffer(b"ACGTN", dtype=np.uint8)
                core = ascii_lut[np.clip(codes, 0, 4)]
            key = _pack_codes(codes)
            self._tally(key, core, no_n & has)

    def _try_native_single_end(self, mat, start, Lf, Rf) -> bool:
        """Forward single-end counting via the C++ seqpack hot loop
        (native/seqpack.cpp sp_count_exact); returns False to fall back to
        the numpy path when the native library is unavailable."""
        from .. import native_bridge

        if not native_bridge.seqpack_available():
            return False
        lengths = (mat != 0).sum(axis=1).astype(np.int64)
        res = native_bridge.count_exact(
            mat, lengths, start or 0, Lf or "", Rf or "", self.cfg.bc_len,
            self.bc_keys_sorted,
        )
        if res is None:
            return False
        doc, undoc_rows = res
        np.add.at(self.doc_counts, self.bc_order, doc)
        if len(undoc_rows):
            W0 = len(Lf or "")
            cores = mat[undoc_rows, (start or 0) + W0 : (start or 0) + W0 + self.cfg.bc_len]
            uniq, counts = np.unique(cores, axis=0, return_counts=True)
            for row, cnt in zip(uniq, counts):
                seq = row.tobytes().decode("ascii", errors="replace").rstrip("\x00")
                self.undoc[seq + "*"] += int(cnt)
        return True

    def _slow_path_rows(self, m1, m2, rows) -> None:
        """Route the given rows through count_chunk_reference (the
        per-read oracle) and merge its counts — exact reference semantics
        for the truncated-window edge the vector path masks out."""

        def to_strings(m):
            if m is None:
                return None
            sel = np.ascontiguousarray(m[rows])
            flat = sel.view(f"S{m.shape[1]}").ravel()
            return [b.rstrip(b"\x00").decode("ascii", errors="replace") for b in flat]

        s1, s2 = to_strings(m1), to_strings(m2)
        # count_chunk_reference applies cfg.need_swap itself; matrices here
        # are already post-swap (m1 = fwd), so hand it the raw-file order
        chunk = (s2, s1) if self.cfg.need_swap else (s1, s2)
        counts, _ = count_chunk_reference(chunk, self.cfg)
        if self._bc_index is None:
            self._bc_index = {bc: i for i, bc in enumerate(self.bc_list)}
        for k, cnt in counts.items():
            if k.endswith("*"):
                self.undoc[k] += cnt
            else:
                i = self._bc_index.get(k)
                if i is not None:
                    self.doc_counts[i] += cnt

    def _tally(self, keys, cores, eligible) -> None:
        keys = keys[eligible]
        cores = cores[eligible]
        if len(keys) == 0 or len(self.bc_keys_sorted) == 0:
            return
        idx = np.searchsorted(self.bc_keys_sorted, keys)
        idx = np.clip(idx, 0, len(self.bc_keys_sorted) - 1)
        # sentinel keys (non-ACGT core: lowercase or padding) must never
        # match a documented barcode — a library entry that itself packs to
        # the sentinel (e.g. an N-containing barcode) would otherwise
        # "match" every such read (r5 review repro)
        matched = (self.bc_keys_sorted[idx] == keys) & (keys != _KEY_SENTINEL)
        if matched.any():
            np.add.at(self.doc_counts, self.bc_order[idx[matched]], 1)
        un = ~matched
        if un.any():
            uniq, counts = np.unique(cores[un], axis=0, return_counts=True)
            for row, cnt in zip(uniq, counts):
                seq = row.tobytes().decode("ascii", errors="replace").rstrip("\x00")
                self.undoc[seq + "*"] += int(cnt)

    def results(self) -> tuple[Counter, Counter]:
        doc = Counter()
        for bc, cnt in zip(self.bc_list, self.doc_counts):
            if cnt > 0:
                doc[bc] = int(cnt)
        return doc, Counter(self.undoc)

    def drain(self) -> None:
        """Flush pending async work into doc_counts/undoc. No-op here; the
        device/sharded engines override. MUST be called before reading
        counter state mid-stream (checkpoint save) — a snapshot taken while
        device futures are in flight would record an advanced chunk_no with
        stale counts, and a resume would silently drop those chunks."""

    def reset(self) -> None:
        """Zero all accumulated state (the discard-restored-checkpoint
        path of the multi-host resume agreement)."""
        self.doc_counts[:] = 0
        self.undoc.clear()
        self.total_reads = 0

    def abort(self) -> None:
        """Best-effort teardown after a mid-stream error (e.g. a paired-end
        length mismatch raised by the reader). No-op here — the synchronous
        engine holds no background state; the device/sharded engines
        override to stop their dispatch worker and release pinned buffers.
        Never raises and never issues new device traffic."""


def _codes_to_strings(codes: np.ndarray):
    lut = np.frombuffer(b"ACGTN", dtype=np.uint8)
    ascii_mat = lut[np.clip(codes, 0, 4)]
    for row in ascii_mat:
        yield row.tobytes().decode("ascii")


def _pack_cores_u32(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """2-bit-pack (n, bc_len<=32) int8 codes into (n, 2) uint32 words for
    the device ship (packing cuts bc_len bytes/read to 8). Returns (packed, has_n) — N
    (code 4) cannot be represented in 2 bits, so reads whose core contains
    one carry a has_n flag and are excluded from EXACT matching on device;
    the host's undocumented tally still sees their raw bytes."""
    n, L = codes.shape
    has_n = (codes >= 4).any(axis=1)
    vals = (codes & 3).astype(np.uint32) << (2 * (np.arange(L) % 16)).astype(np.uint32)[None, :]
    packed = np.zeros((n, 2), np.uint32)
    packed[:, 0] = np.bitwise_or.reduce(vals[:, :16], axis=1)
    if L > 16:
        packed[:, 1] = np.bitwise_or.reduce(vals[:, 16:], axis=1)
    return packed, has_n


def _unpacked_onehot(cc, bc_len: int, jnp):
    """(S, 2) uint32 packed cores → (S, 4*bc_len) bf16 one-hot, inside jit
    (the device-side inverse of _pack_cores_u32)."""
    j = jnp.arange(bc_len)
    word = cc[:, j // 16]  # (S, bc_len)
    codes_mat = (word >> (2 * (j % 16)).astype(jnp.uint32)[None, :]) & 3
    oh = (
        codes_mat[:, :, None] == jnp.arange(4, dtype=jnp.uint32)[None, None, :]
    ).reshape(cc.shape[0], 4 * bc_len)
    return oh.astype(jnp.bfloat16)


class DeviceCounter(VectorCounter):
    """Device-resident counting engine (SURVEY.md §7 step 8): the whole
    per-chunk hot loop — N filter, flank equality at the fixed offset,
    paired revcomp-consistency, and exact barcode matching — runs in ONE
    jitted program per chunk shape. Matching is a one-hot matmul
    (core rows x barcode columns; a score of bc_len means exact equality),
    reduced with argmax; cores ship 2-bit-packed (8 bytes/read + 1
    eligibility byte — N-in-core reads are device-ineligible and resolve
    on the host, see _pack_cores_u32) and only (match_idx, matched) per
    read cross back.

    Semantics are identical to VectorCounter / count_chunk_reference
    (cross-checked in tests). Worth it when reads stream to the device
    faster than host cores can slice them; which engine wins on the GPU is
    not measured yet (ROADMAP S6).

    d2h per chunk is ONE bit per read (the matched mask, packbits'd on
    device — undocumented-read resolution needs it); documented counts
    tally into a DEVICE-RESIDENT accumulator (scatter-add over the match
    indices, donated through every dispatch) that crosses back ONCE per
    drain, not per chunk.

    Incoming read chunks buffer host-side to ``_DISPATCH_ROWS`` rows per
    dispatched program (chunk batching: 4x fewer dispatches + bit fetches
    at the reader's 2^16 chunk size), and the final fetch happens at
    drain()/results() time."""

    _READ_SLICE = 8192  # rows per matmul slice (keeps the (rows, B) score
    # matrix ~300 MB at 10k barcodes)
    _DISPATCH_ROWS = 1 << 18  # reader chunks buffered per dispatched program
    _ACC_SPILL_ROWS = 1 << 30  # int32 count-accumulator overflow guard:
    # spill to the int64 host array after this many tallied rows

    # compiled matchers shared ACROSS counter instances: run_count builds a
    # fresh counter per call, and a fresh jax.jit object re-traces and
    # re-loads the executable every time. The program depends only on
    # geometry — barcodes ride in as an argument.
    _JIT_CACHE: dict = {}

    def __init__(self, cfg: CountConfig):
        super().__init__(cfg)
        import jax.numpy as jnp

        bcs = self.bc_list
        self.B = len(bcs)
        self.bc_len = cfg.bc_len
        if self.bc_len > 32:
            raise ValueError("device engine requires bc_len <= 32")
        codes = _CODE_LUT[_to_matrix(bcs)]
        if (codes >= 4).any():
            raise ValueError("device engine requires pure-ACGT barcodes")
        K4 = 4 * self.bc_len
        B_pad = -(-self.B // 128) * 128
        oh = np.zeros((K4, B_pad), np.float32)
        cols = np.arange(self.B)
        for j in range(self.bc_len):
            oh[4 * j + codes[:, j], cols] = 1.0
        self._bc_oh = jnp.asarray(oh, dtype=jnp.bfloat16)
        self._jnp = jnp
        self._match_jit = None
        self._pending = []
        self._acc = None  # device count accumulator since the last drain
        self._acc_rows = 0  # rows tallied into _acc (int32 overflow guard)
        self._buf: list = []  # [(cores, eligible)] awaiting one dispatch
        self._buf_rows = 0
        self._worker = None  # dispatch thread (started at first flush)
        self._worker_err = None

    def _match_fn(self):
        """The jitted matcher, built ONCE per geometry — defining it per
        chunk retraced the whole program every call, and defining it per
        COUNTER instance re-loaded the executable on every run_count call
        (r4)."""
        if getattr(self, "_match_jit", None) is not None:
            return self._match_jit
        key = (type(self).__name__, self.bc_len, self.B,
               int(self._bc_oh.shape[1]), self._READ_SLICE)
        cached = self._JIT_CACHE.get(key)
        if cached is not None:
            self._match_jit = cached
            return cached
        import functools

        import jax

        jnp = self._jnp
        S = self._READ_SLICE
        bc_len, B = self.bc_len, self.B

        B_pad = int(self._bc_oh.shape[1])

        # acc is DONATED: each dispatch chains the count accumulator
        # through without a host round trip; the host fetches it once per
        # drain
        @functools.partial(jax.jit, donate_argnums=(3,))
        def match(codes_d, elig_d, bc_oh, acc):
            def one_slice(args):
                cc, el = args
                oh = _unpacked_onehot(cc, bc_len, jnp)
                scores = jnp.dot(oh, bc_oh, preferred_element_type=jnp.float32)
                best = jnp.argmax(scores, axis=1)
                exact = jnp.max(scores, axis=1) >= bc_len - 0.5
                matched = exact & el & (best < B)
                return best.astype(jnp.int32), matched

            cs = codes_d.reshape(-1, S, 2)
            es = elig_d.reshape(-1, S)
            idx, m = jax.lax.map(one_slice, (cs, es))
            idx, m = idx.reshape(-1), m.reshape(-1)
            counts = acc.at[idx].add(m.astype(jnp.int32))
            return jnp.packbits(m), counts

        self._match_jit = match
        self._JIT_CACHE[key] = match
        while len(self._JIT_CACHE) > 16:
            self._JIT_CACHE.pop(next(iter(self._JIT_CACHE)))
        return match

    def _zero_acc(self):
        return self._jnp.zeros((int(self._bc_oh.shape[1]),), self._jnp.int32)

    def _device_match_async(
        self, core_codes: np.ndarray, eligible: np.ndarray, pad_min: int = 0
    ):
        """Dispatch one batch's matching; returns (n, matched-bits future)
        and threads the donated device count accumulator, so batches
        pipeline (all fetches happen at drain time). pad_min lifts the
        pad bucket (the sharded engine's lockstep geometry floor)."""
        jnp = self._jnp
        n = core_codes.shape[0]
        S = self._READ_SLICE
        # geometric row buckets (S, 2S, 4S, ...): a tail batch reuses the
        # full batch's executable instead of compiling its own shape
        n_pad = S
        while n_pad < max(n, pad_min):
            n_pad *= 2
        packed, has_n = _pack_cores_u32(core_codes)
        codes_p = np.zeros((n_pad, 2), np.uint32)
        codes_p[:n] = packed
        elig_p = np.zeros(n_pad, bool)  # pad rows (decode as poly-A) stay
        elig_p[:n] = eligible & ~has_n  # ineligible, so they never count
        if self._acc is None:
            self._acc = self._zero_acc()
        mbits, self._acc = self._match_fn()(
            jnp.asarray(codes_p), jnp.asarray(elig_p), self._bc_oh, self._acc
        )
        # int32 accumulator guard: one barcode absorbing > 2^31 matches
        # would wrap, so spill into the int64 host array every ~1G rows
        # (one extra fetch per billion reads — noise)
        self._acc_rows += n_pad
        if self._acc_rows >= self._ACC_SPILL_ROWS:
            self._fetch_acc()
        return n, mbits

    def _fetch_acc(self) -> None:
        if self._acc is not None:
            self.doc_counts += np.asarray(self._acc)[: self.B].astype(
                self.doc_counts.dtype
            )
            self._acc = None
        self._acc_rows = 0

    def _tally(self, keys, cores, eligible) -> None:
        """Same contract as VectorCounter._tally, but the key matching runs
        on the accelerator (keys are ignored; cores re-match exactly).
        Reader chunks buffer to _DISPATCH_ROWS per dispatched program;
        dispatches are queued and all fetches happen at drain()/results()
        time so upload/compute/host-IO of successive batches overlap."""
        if len(self.bc_list) == 0:
            return
        self._buf.append((cores, np.asarray(eligible, bool)))
        self._buf_rows += len(cores)
        if self._buf_rows >= self._DISPATCH_ROWS:
            self._flush_buf()

    def _flush_buf(self, pad_min: int = 0) -> None:
        """Hand the buffered rows to the dispatch worker thread.

        Dispatch runs OFF the reader thread so the h2d upload and dispatch
        (which release the GIL) overlap reading and windowing the next
        batches; whether this still pays on the GPU is open (ROADMAP D2).
        Order is preserved (one FIFO queue, one worker), which is also what
        keeps multi-host collective dispatch in lockstep."""
        if not self._buf:
            return
        if len(self._buf) == 1:
            cores, eligible = self._buf[0]
        else:
            cores = np.concatenate([c for c, _ in self._buf])
            eligible = np.concatenate([e for _, e in self._buf])
        self._buf = []
        self._buf_rows = 0
        self._ensure_worker()
        if self._worker_err is not None:
            # surface a dispatch failure into the reader loop NOW instead
            # of silently discarding every later batch until end-of-stream
            err, self._worker_err = self._worker_err, None
            self._shutdown_worker()
            raise err
        self._work_q.put((cores, eligible, pad_min))

    _MAX_PENDING = 8

    def _ensure_worker(self) -> None:
        if self._worker is not None:
            return
        import queue
        import threading

        self._work_q = queue.Queue(maxsize=2)  # backpressure: bounds RAM
        self._worker_err = None

        def loop():
            while True:
                item = self._work_q.get()
                try:
                    if item is None:
                        return
                    if self._worker_err is None:
                        cores, eligible, pad_min = item
                        codes = _CODE_LUT[cores]
                        fut = self._device_match_async(codes, eligible, pad_min)
                        self._pending.append((fut, cores, eligible))
                        # bounded pipelining: each entry retains its
                        # batch's cores byte matrix on the host; retiring
                        # the oldest keeps RAM flat while dispatches
                        # still overlap
                        while len(self._pending) > self._MAX_PENDING:
                            self._drain_entry(self._pending.pop(0))
                except BaseException as e:  # surfaced at flush or drain
                    self._worker_err = e
                finally:
                    # Queue.join()/task_done(): the unfinished-task count
                    # is maintained atomically by put(), so an interrupted
                    # put can never desync the quiesce accounting (the
                    # hand-rolled submitted/processed counters could)
                    self._work_q.task_done()

        self._worker = threading.Thread(
            target=loop, name="count-dispatch", daemon=True
        )
        self._worker.start()

    def _shutdown_worker(self) -> None:
        if self._worker is None:
            return
        self._work_q.put(None)
        self._worker.join()
        self._worker = None

    def abort(self) -> None:
        """Stop the dispatch worker and drop all buffered/pinned state
        WITHOUT waiting for queued batches to run (contrast _quiesce).
        Called by run_count's error path: without it an exception raised
        mid-stream by the reader leaks the daemon worker thread blocked on
        q.get() plus up to _MAX_PENDING pinned cores matrices. Queued items
        are skipped (the worker's _worker_err guard), so no further device
        traffic is issued. Never raises."""
        if self._worker is not None:
            import queue

            self._worker_err = RuntimeError("counter aborted")
            try:
                while True:  # drop queued batches so the sentinel is next
                    self._work_q.get_nowait()
                    self._work_q.task_done()
            except queue.Empty:
                pass
            try:
                self._work_q.put_nowait(None)
            except queue.Full:
                pass
            self._worker.join(timeout=60.0)
            if self._worker.is_alive():
                # wedged device call: the daemon thread still owns
                # _pending — leave its state alone
                return
            self._worker = None
            self._worker_err = None
        self._pending = []
        self._buf = []
        self._buf_rows = 0

    def _quiesce(self) -> None:
        """Wait until the dispatch worker has consumed every submitted
        batch, then STOP it (restarted lazily at the next flush — a
        long-lived worker would pin the counter and its device arrays in
        its closure forever); re-raise any error it hit. After this the
        instance state (_pending, _acc, undoc) is main-thread-safe."""
        if self._worker is None:
            return
        self._work_q.join()
        self._shutdown_worker()
        if self._worker_err is not None:
            err, self._worker_err = self._worker_err, None
            raise err

    def _drain_entry(self, entry) -> None:
        (n, mb_f), cores, eligible = entry
        matched = np.unpackbits(np.asarray(mb_f))[:n].astype(bool)
        un = eligible & ~matched
        if un.any():
            uniq, counts = np.unique(cores[un], axis=0, return_counts=True)
            for row, cnt in zip(uniq, counts):
                seq = row.tobytes().decode("ascii", errors="replace").rstrip("\x00")
                self.undoc[seq + "*"] += int(cnt)

    def drain(self) -> None:
        self._flush_buf()
        self._quiesce()
        for entry in self._pending:
            self._drain_entry(entry)
        self._pending = []
        # ONE count-vector fetch per drain; accumulation restarts so a
        # mid-stream drain (checkpoint save) composes additively
        self._fetch_acc()

    def results(self):
        self.drain()
        return super().results()

    def reset(self) -> None:
        self._quiesce()
        super().reset()
        self._acc = None
        self._acc_rows = 0
        self._buf = []
        self._buf_rows = 0
        self._pending = []

    def _try_native_single_end(self, mat, start, Lf, Rf) -> bool:
        return False  # keep the whole hot loop on the device path


def discover_config(barcodes, file1, file2, is_paired, log=None):
    """Phases (a)–(c): sample reads, vote orientation/offset, discover and
    cross-check flanks; returns ``(SampleResult, CountConfig)`` — the
    deterministic discovery stage run_count performs before counting
    (exposed so multi-host checkpoint tooling can rebuild the identical
    config without re-running the count)."""
    bc_len = len(next(iter(barcodes)))
    sample = sample_reads(file1, file2, barcodes, is_paired, log=log)

    if sample.sample1 is not None:
        L_fwd, R_fwd = find_flanks(sample.sample1, sample.bc_start1, bc_len)
        L_fwd_start = sample.bc_start1 - len(L_fwd) if L_fwd else 0
    else:
        L_fwd = R_fwd = None
        L_fwd_start = None
    if sample.sample2 is not None and sample.sample2:
        L_rev, R_rev = find_flanks(sample.sample2, sample.bc_start2, bc_len)
        L_rev_start = sample.bc_start2 - len(L_rev) if L_rev else 0
    else:
        L_rev = R_rev = None
        L_rev_start = None

    errors = check_flank_complementarity(L_fwd, R_fwd, L_rev, R_rev)
    if errors:
        raise ValueError("A critical error occurred: " + ", ".join(errors))

    cfg = CountConfig(
        barcodes=barcodes,
        bc_len=bc_len,
        L_fwd=L_fwd,
        R_fwd=R_fwd,
        L_rev=L_rev,
        R_rev=R_rev,
        L_fwd_start=L_fwd_start,
        L_rev_start=L_rev_start,
        need_swap=sample.need_swap,
    )
    return sample, cfg


def run_count(
    barcode_file_or_set,
    file1: str,
    file2: str | None = None,
    chunk_size: int = 2**16,
    log=None,
    engine: str = "auto",
    checkpoint_path: str | None = None,
    checkpoint_every: int = 16,
):
    """Full counting pipeline; returns (doc Counter, undoc Counter,
    total_reads, info dict).

    checkpoint_path enables crash-safe streaming (SURVEY.md §5: the
    reference recomputes everything in deleted temp dirs; here partial
    per-batch counts are persisted every ``checkpoint_every`` chunks and a
    rerun resumes from the last checkpoint when the discovered counting
    config matches)."""
    from ..seqio.fasta import read_barcode_fasta

    if isinstance(barcode_file_or_set, str):
        barcodes = read_barcode_fasta(barcode_file_or_set)
    else:
        barcodes = set(barcode_file_or_set)
    validate_barcodes(barcodes)
    lens = {len(b) for b in barcodes}
    if len(lens) != 1:
        raise ValueError("All barcodes must be the same length")
    bc_len = lens.pop()
    is_paired = bool(file2)

    sample, cfg = discover_config(barcodes, file1, file2, is_paired, log=log)

    if bc_len > 32 and engine not in ("auto", "reference"):
        # the array engines 2-bit-pack barcode cores into uint64 keys
        if log:
            log.warn(
                f"{engine} engine requires barcodes <= 32 nt "
                f"(got {bc_len}); using the per-read engine"
            )
        engine = "reference"
    if engine == "auto" and bc_len <= 32:
        import jax

        if jax.process_count() > 1:
            # multi-host SPMD run: the sharded engine divides both the
            # device matching AND (via chunk ownership below) the host
            # parse work across hosts; the other engines would replicate
            # the whole count on every host
            keys = _pack_strings(sorted(barcodes))
            if not (keys == _KEY_SENTINEL).any():
                engine = "sharded"
    use_vector = engine in ("vector", "device", "sharded") or (
        engine == "auto" and bc_len <= 32
    )
    if checkpoint_path and not use_vector:
        # checkpointing is wired into the array engines only; say so loudly
        # instead of silently recomputing from scratch on a crash
        if log:
            log.warn(
                "--checkpoint is not supported on the per-read reference "
                "engine (barcodes > 32 nt); counting will restart from "
                "scratch if interrupted"
            )
    doc: Counter = Counter()
    undoc: Counter = Counter()
    total_reads = 0
    if use_vector:
        if engine == "sharded":
            from ..parallel.sharded_count import ShardedCounter

            vc = ShardedCounter(cfg)
        else:
            vc = DeviceCounter(cfg) if engine == "device" else VectorCounter(cfg)
        if checkpoint_path:
            import jax

            if jax.process_count() > 1:
                # multi-host SPMD: every host runs this driver with the same
                # argv — per-host checkpoint files (undoc is host-local)
                # instead of N processes clobbering one path
                checkpoint_path = f"{checkpoint_path}.p{jax.process_index()}"
        ckpt = (
            _CheckpointState(
                checkpoint_path, cfg,
                inputs=tuple(f for f in (file1, file2) if f) + (chunk_size,),
            )
            if checkpoint_path
            else None
        )
        try:
            doc, undoc, total_reads = _stream_counts(
                vc, ckpt, engine, sample, file1, file2, chunk_size,
                checkpoint_every, log,
            )
        except BaseException:
            # mid-stream failure (reader errors like a paired-end length
            # mismatch, device faults, KeyboardInterrupt): stop the dispatch
            # worker thread and release its pinned buffers — without this a
            # long-lived API process leaks a daemon thread + ~MB-scale
            # batches per failed call (and the thread would keep the counter
            # alive forever)
            vc.abort()
            raise
    else:
        for chunk in iter_read_chunks(file1, file2 if is_paired else None, chunk_size):
            counts, nreads = count_chunk_reference(chunk, cfg)
            total_reads += nreads
            for bc, cnt in counts.items():
                (undoc if bc.endswith("*") else doc)[bc] += cnt

    info = {
        "sample": sample,
        "config": cfg,
        "bc_len": bc_len,
        "engine": (engine if engine in ("device", "sharded") else "vector")
        if use_vector
        else "reference",
    }
    if use_vector:
        # rows this host parsed itself (chunk-ownership proof: under
        # multi-host the per-host values are disjoint and sum to the total)
        info["owned_reads"] = getattr(vc, "owned_reads", None)
    return doc, undoc, total_reads, info


def _stream_counts(
    vc, ckpt, engine, sample, file1, file2, chunk_size,
    checkpoint_every, log,
):
    """The array-engine streaming loop of run_count: restore/agree the
    checkpoint, feed every chunk (owned or full-stream), finalize, and
    collate results. Split out so run_count's error path can tear the
    counter down (`vc.abort()`) no matter where in the stream a failure
    lands."""
    from ..seqio.fast_reader import iter_matrix_chunks

    skip_chunks = ckpt.restore(vc) if ckpt else 0
    use_owned = False
    if engine == "sharded":
        import jax

        use_owned = jax.process_count() > 1
    if use_owned and ckpt is not None:
        # cross-host resume agreement: a crash between hosts' saves can
        # leave per-host checkpoints at different chunk_no; resuming
        # from mismatched points would double-count on the later host
        # and desync the lockstep collectives. All hosts gather their
        # restored chunk_no; on ANY mismatch every state is discarded
        # and counting restarts from 0 — resuming from min() is NOT
        # possible because a later host's restored counts already
        # include the chunks past it and cannot be rewound. The
        # gathered vector is identical everywhere, so every host takes
        # the same branch.
        from ..parallel.multihost import agree_int

        _, all_equal = agree_int(skip_chunks)
        if not all_equal:
            if log:
                log.warn(
                    "Checkpoint resume points disagree across hosts "
                    f"(this host: chunk {skip_chunks}); discarding "
                    "checkpoints and recounting from the start"
                )
            vc.reset()
            skip_chunks = 0
    f_a, f_b = (file1, file2) if not sample.need_swap else (file2, file1)
    chunk_no = 0
    if use_owned:
        from ..seqio.fast_reader import iter_owned_matrix_chunks

        K, h = jax.process_count(), jax.process_index()
        swapped_single = f_a is None
        first, second = (f_b, None) if swapped_single else (f_a, f_b)
        for chunk_idx, nrec, r1, r2 in iter_owned_matrix_chunks(
            first, second, chunk_size, owner=h, num_owners=K,
            start_chunk=skip_chunks,
        ):
            chunk_no = chunk_idx + 1
            if chunk_no <= skip_chunks:
                continue
            m1 = r1[0] if r1 is not None else None
            m2 = r2[0] if r2 is not None else None
            if swapped_single:
                m1, m2 = None, m1
            vc.feed_owned(chunk_idx, nrec, m1, m2)
            if ckpt and chunk_no % checkpoint_every == 0:
                ckpt.save(vc, chunk_no)
    elif f_a is None:
        # swapped single-end: the lone file is the reverse-orientation one
        for r1, _ in iter_matrix_chunks(f_b, None, chunk_size):
            chunk_no += 1
            if chunk_no <= skip_chunks:
                continue
            vc.process_matrices(None, r1[0])
            if ckpt and chunk_no % checkpoint_every == 0:
                ckpt.save(vc, chunk_no)
    else:
        for r1, r2 in iter_matrix_chunks(f_a, f_b, chunk_size):
            chunk_no += 1
            if chunk_no <= skip_chunks:
                continue
            vc.process_matrices(r1[0], r2[0] if r2 else None)
            if ckpt and chunk_no % checkpoint_every == 0:
                ckpt.save(vc, chunk_no)
    doc, undoc = vc.results()
    # finalize (delete the checkpoint) only AFTER results() — its final
    # drain/device fetch is the operation most prone to failing, and
    # deleting first would lose all checkpointed progress if it raises
    # (r5 review)
    if ckpt:
        ckpt.finalize()
    if engine == "sharded":
        import jax

        if jax.process_count() > 1:
            # documented counts are already global (psum); the
            # undocumented tally is host-local to each host's own rows
            # — gather and merge so every host returns the identical
            # collated result (the reference's end-of-run Counter
            # merge, heuristicount.py:726-877, across DCN)
            import pickle

            from ..parallel.multihost import allgather_bytes

            merged: Counter = Counter()
            for blob in allgather_bytes(pickle.dumps(dict(undoc))):
                merged.update(pickle.loads(blob))
            undoc = merged
    return doc, undoc, vc.total_reads
