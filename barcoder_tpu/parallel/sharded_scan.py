"""Multi-device genome-axis sharded scan (shard_map over a 1-D or 2-D mesh),
running the flagship engine per device. On one card it is a 1-device mesh,
and it is what ``auto`` runs on every platform.

Sharding design (SURVEY.md §2/§5: the replacement for the reference's
100 kb-overhang + process-pool parallelism):

  - the genome position axis is split into contiguous per-device blocks of
    B starts; each device fetches the first ``halo`` codes of the *next*
    device's block with ``lax.ppermute`` (ring halo exchange) so windows
    crossing the block boundary score correctly — the circular wrap halo
    itself is materialized once on the host into the scan array
    (build_scan_array), so the ring is uniform;
  - on a 2-D ``(library, genome)`` mesh (make_mesh_2d) the spacer one-hot
    rows are sharded over the library axis too (libraries larger than one
    device's memory scan without replication);
  - phase 1 per device is the STRAND-FUSED folded-bias hit indicator
    (ops.pallas_scan.phase1_hits: the compiled kernel on the GPU, its
    plain-XLA reference on the CPU): one pass scores both strands, with
    the per-strand PAM site masks riding inside the product as spare G
    rows;
  - the nonzero (subtile, spacer-block) pairs are compacted ON DEVICE
    (_compact_pairs) — no dense indicator tensor ever leaves the device;
  - phase 2 runs DEVICE-RESIDENT on each device's own compacted pair list
    (the extract_spec formulation: gathered subtile G one-hots, einsum
    re-score, hierarchical hit compaction) — hits stay on device;
  - per-device packed hit lists merge with ``lax.all_gather``, so the host
    performs ONE fetch of an already-replicated array per scan.

Capacities (pairs per device, hits per device) are static per compile;
overflow is signaled in the packed header and the host retries with
doubled capacity buckets — the same fixed-capacity + retry protocol as the
single-device engine.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P_

from ..core.genome import Contig
from ..ops.pallas_scan import (
    BS,
    MASK_BIAS,
    _build_g_onehot,
    _cdiv,
    _compact_hits,
    _compact_pairs,
    _tiles_device_impl,
    onehot_rows,
    phase1_hits,
)
from ..ops.prep import build_scan_array, revcomp_matrix, site_masks, spacer_matrix
from ..ops.types import STRAND_F, STRAND_R, Hits
from ..utils.platform import device_platform, phase1_kernel_enabled
from .mesh import GENOME_AXIS, LIBRARY_AXIS, make_mesh
from .multihost import put_global

_HDR = 6  # packed header ints:
# [n_pairs, n_hits, reserved, n_rows, max_row_hits, reserved] — the host
# grows the matching static capacity (pair_cap / hit_cap / cap_rows / k)
# for whichever one overflowed and retries. Word 2 once carried a psum'd
# global hit total; no consumer ever read it, so the collective was
# dropped (r5 review) and the slot stays zero for layout stability.

_MM_BITS = 6  # mismatch bits in the packed hit word (mm <= L <= 63)

# per-scan wall-time breakdown of the last sharded site scan (read by
# bench.py's sharded_1dev cell and the capacity-memo test)
LAST_TIMINGS: dict = {}

# grown static capacities remembered across scans, keyed by workload
# identity. Without this every scan restarted from the signature defaults
# (pair_cap=256), and any workload that overflows them paid the capacity
# retry — a full second engine round (dispatch + fetch) — on EVERY scan,
# not just the first.
_CAPS_MEMO: dict = {}
_CAPS_MEMO_MAX = 256


def _caps_recall(key, *caps):
    ent = _CAPS_MEMO.get(key)
    if ent is None:
        return caps
    return tuple(max(c, m) for c, m in zip(caps, ent))


def _caps_store(key, *caps) -> None:
    _CAPS_MEMO[key] = caps
    while len(_CAPS_MEMO) > _CAPS_MEMO_MAX:
        _CAPS_MEMO.pop(next(iter(_CAPS_MEMO)))


def _decode_packed_hits(row, cap, n_sig):
    """(word0, word1) hit lists from one device's packed payload → (global
    col/pos, spacer-local, mm). Inverse of the device-side packing in
    shard_fn: word0 = global column/position, word1 = meta << _MM_BITS | mm
    (meta = spacer_local, or spacer_local << 1 | is_rev on the fused dense
    path — the caller splits it)."""
    w0 = row[_HDR : _HDR + cap][:n_sig]
    w1 = row[_HDR + cap : _HDR + 2 * cap][:n_sig]
    return w0, w1 >> _MM_BITS, w1 & ((1 << _MM_BITS) - 1)


def _mesh_dims(mesh) -> tuple[int, int]:
    """(n_library, n_genome) shard counts of ``mesh`` (1-D meshes have no
    library axis → n_library=1)."""
    shape = dict(mesh.shape)
    return shape.get(LIBRARY_AXIS, 1), shape[GENOME_AXIS]


def _kernel_on(mesh) -> bool:
    """Whether phase 1 runs the compiled kernel on ``mesh``'s platform."""
    return phase1_kernel_enabled(device_platform(mesh.devices.ravel()))


def _check_spacer_len(q_f: np.ndarray) -> None:
    """The packed hit word carries mismatch counts in _MM_BITS bits
    (mm <= L must fit); beyond it the meta field would silently corrupt
    spacer indices. Enforced on EVERY entry path — sharded_scan,
    sharded_scan_many and sharded_scan_contigs all construct runs."""
    if q_f.shape[0] and q_f.shape[1] > (1 << _MM_BITS) - 1:
        raise ValueError(
            f"sharded engine supports spacers up to {(1 << _MM_BITS) - 1} nt "
            f"(got {q_f.shape[1]})"
        )


def _want_sites(pam: str, site_mode: str) -> bool:
    """Engine choice for a PAM scan: site-compacted unless the PAM has no
    informative (non-N) base. An all-wildcard PAM ('N', 'NN') makes every
    window-valid position a site, so the site path would ship ~L_pad bytes
    per genome base (vs ~1 for the dense fused path) for zero FLOP savings
    (r5 review). site_mode='always' still forces it; 'never' forbids it."""
    if not pam or site_mode == "never":
        return False
    return site_mode == "always" or any(ch != "N" for ch in pam)


def _phase2_geom(P: int, sub_width: int) -> tuple[int, int]:
    """(SUB, P2) subtile geometry with P2 * SUB == P enforced up front: the
    packed-hit decode reconstructs global columns as tile*P + sub*P2 + lane,
    so a non-divisor sub_width would mis-map positions — and in practice
    fails deep inside tracing with an opaque reshape error instead of a
    usable message."""
    SUB = max(P // min(sub_width, P), 1)
    P2 = P // SUB
    if SUB * P2 != P:
        raise ValueError(
            f"sub_width={sub_width} yields SUB={SUB} which does not divide "
            f"P={P}; pick a sub_width such that P // sub_width divides P "
            f"(powers of two always work)"
        )
    return SUB, P2


@functools.lru_cache(maxsize=64)
def _sharded_engine(
    mesh,
    *,
    n_lib: int,
    n_gen: int,
    B: int,
    P: int,
    P2: int,
    halo: int,
    L: int,
    K: int,
    SUB: int,
    BS_M: int,
    n_sblocks_loc: int,
    half_blocks: int,
    fused: bool,
    fold: bool,
    thresh_mm: int,
    pair_cap: int,
    cap: int,
    cap_rows: int,
    k: int,
    use_pallas: bool,
    interpret: bool,
):
    """Build + jit the sharded scan program for one static geometry.

    Cached so repeat scans (and capacity-retry loops) reuse executables;
    every argument is part of the compile key."""
    n_tiles_loc = B // P
    n_tiles2_loc = B // P2
    n_sb_pad8 = _cdiv(n_sblocks_loc, 8) * 8
    R = 2 if fused else 1
    perm = [(d, (d - 1) % n_gen) for d in range(n_gen)]

    def indicator(thresh_v, q, tiles, bias_t):
        return phase1_hits(
            thresh_v, q, tiles, bias_t, L=L, K=K, P=P, SUB=SUB, BS_M=BS_M,
            use_kernel=use_pallas, interpret=interpret, fold_bias=fold,
        )

    def shard_fn(codes_b, ok_b, q, thresh_v):
        # codes/masks arrive as int8 (a quarter of the h2d bytes); widen
        # and derive the f32 bias on device
        codes_local = codes_b[0].astype(jnp.int32)  # (B,)
        ok_local = ok_b[0]  # (R, B) int8
        bias_local = jnp.where(ok_local > 0, 0.0, MASK_BIAS).astype(jnp.float32)
        # ring halo exchange: windows crossing the block boundary read the
        # next device's first ``halo`` codes
        recv = jax.lax.ppermute(codes_local[:halo], GENOME_AXIS, perm)
        local_ext = jnp.concatenate([codes_local, recv])  # (B + halo,)

        # ---- phase 1: strand-fused hit indicator + device pair compaction
        tiles = _tiles_device_impl(local_ext, n_starts=B, P=P, halo=halo)
        bias_t = bias_local.reshape(R, n_tiles_loc, P).transpose(1, 0, 2)
        ind = indicator(thresh_v, q, tiles, bias_t)
        pairs, _vals, n_pairs = _compact_pairs(ind, pair_cap)

        # ---- phase 2 (device-resident, extract_spec formulation) on this
        # device's own compacted pair list
        slots = pairs  # B_slots == pair_cap
        slot_ok = (
            jnp.arange(pair_cap, dtype=jnp.int32) < jnp.minimum(n_pairs, pair_cap)
        ) & (slots >= 0)
        safe = jnp.where(slot_ok, slots, 0)
        t_big = safe // (n_sb_pad8 * SUB)
        rem = safe % (n_sb_pad8 * SUB)
        s_idx = rem // SUB
        t_idx = t_big * SUB + rem % SUB  # subtile index on the P2 grid
        tiles2 = _tiles_device_impl(local_ext, n_starts=B, P=P2, halo=halo)
        ok_t = ok_local.reshape(R, n_tiles2_loc, P2)
        if fused:
            is_rev = s_idx >= half_blocks
            mask_sel = jnp.where(is_rev[:, None], ok_t[1][t_idx], ok_t[0][t_idx])
        else:
            mask_sel = ok_t[0][t_idx]
        valid2d = (mask_sel > 0) & slot_ok[:, None]
        idx, mm_vals, n_hits, n_rows, max_rh = _phase2_compact(
            q, s_idx, t_idx, valid2d,
            lambda t_c: _build_g_onehot(tiles2[t_c][:, 0, :], L=L, K=K, P=P2),
            BS_M=BS_M, K=K, P2=P2, L=L, thresh_mm=thresh_mm,
            pair_cap=pair_cap, cap=cap, cap_rows=cap_rows, k=k,
            n_sblocks_loc=n_sblocks_loc,
        )

        # hit-dependent payload (VERDICT r2 item 1): decode each hit ON
        # DEVICE to (global pos, spacer-local << 1 | strand) and ship
        # (pos, meta<<6|mm) pairs — the slots array never crosses a link
        dev = jax.lax.axis_index(GENOME_AXIS)
        slot_h = jnp.clip(idx // (BS_M * P2), 0, pair_cap - 1)
        rem_h = idx % (BS_M * P2)
        pair_h = slots[slot_h]
        t2_h = (pair_h // (n_sb_pad8 * SUB)) * SUB + pair_h % SUB
        s_blk_h = pair_h % (n_sb_pad8 * SUB) // SUB
        if fused:
            rev_h = (s_blk_h >= half_blocks).astype(jnp.int32)
            sp_local_h = (s_blk_h - rev_h * half_blocks) * BS_M + rem_h // P2
        else:
            rev_h = jnp.zeros_like(s_blk_h)  # host applies the fixed strand
            sp_local_h = s_blk_h * BS_M + rem_h // P2
        pos_h = dev * B + t2_h * P2 + rem_h % P2
        w1 = ((sp_local_h * 2 + rev_h) << _MM_BITS) | mm_vals

        # ---- collective: all_gather of hit lists. Header word 2 is a
        # reserved slot (it carried a psum'd global hit total no host
        # consumer ever read — retry decisions use the gathered per-device
        # headers, so the extra collective was pure dispatch cost)
        header = jnp.stack(
            [
                n_pairs.astype(jnp.int32),
                n_hits.astype(jnp.int32),
                jnp.int32(0),
                n_rows.astype(jnp.int32),
                max_rh.astype(jnp.int32),
                jnp.int32(0),
            ]
        )
        packed = jnp.concatenate([header, pos_h, w1])  # (_HDR + 2*cap,)
        g1 = jax.lax.all_gather(packed, GENOME_AXIS)  # (n_gen, LEN)
        if n_lib > 1:
            g2 = jax.lax.all_gather(g1, LIBRARY_AXIS)  # (n_lib, n_gen, LEN)
        else:
            g2 = g1[None]
        return g2

    lib_spec = P_(LIBRARY_AXIS) if n_lib > 1 else P_()
    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(
            P_(GENOME_AXIS),
            P_(GENOME_AXIS),
            lib_spec,
            P_(),
        ),
        out_specs=P_(),
        check_vma=False,
    )
    return jax.jit(fn)


def _pair_chunk(BS_M: int, P2: int) -> int:
    """Pairs per phase-2 chunk: bounds the (chunk, BS_M, P2) f32 score
    transient to ~1 GB of HBM (the sharded analog of the single-chip
    engine's extract_batch scaling, ops.pallas_scan.EXTRACT_BATCH)."""
    pc = (1 << 28) // max(BS_M * P2, 1)
    return max(256, 1 << max(pc.bit_length() - 1, 0))


def _phase2_compact(q, s_idx, t_for_g, valid2d, build_g, *, BS_M, K, P2, L,
                    thresh_mm, pair_cap, cap, cap_rows, k, n_sblocks_loc):
    """Phase-2 scoring + hierarchical compaction over one device's
    compacted pair list, shared by the dense and site engines. CHUNKED
    along the pair axis once pair_cap outgrows the ~1 GB transient budget:
    capacity-retry growth of pair_cap is unbounded (hit-dense design-scale
    scans legitimately reach 1e5+ pairs/device) and a monolithic
    (pair_cap, BS_M, P2) f32 score tensor would OOM HBM long before the
    counts stop fitting (r5 review). Per-chunk compaction keeps the full
    global (cap, cap_rows, k) capacities, so any per-chunk truncation
    forces the summed counts over capacity and the caller's _grow_caps
    retry fires exactly as in the monolithic case.

    ``build_g(t_chunk) -> (chunk, K, P2) bf16`` supplies the genome-side
    one-hot for a chunk of pair tile-indices; ``valid2d`` is the
    (pair_cap, P2) column-validity mask (slot + PAM/site bounds)."""
    q_rows = q.reshape(-1, BS_M, K)

    def score_and_compact(s_c, t_c, v_c):
        q_blocks = q_rows[jnp.clip(s_c, 0, n_sblocks_loc - 1)]
        scores = jnp.einsum(
            "nsk,nkp->nsp", q_blocks, build_g(t_c),
            preferred_element_type=jnp.float32,
        )
        mm = (L - scores).astype(jnp.int32)
        hit = (mm <= thresh_mm) & v_c[:, None, :]
        return _compact_hits(hit, mm, cap=cap, cap_rows=cap_rows, k=k)

    PC = _pair_chunk(BS_M, P2)
    if pair_cap <= PC or pair_cap % PC:
        # monolithic (the common case: default caps are far below PC);
        # non-divisible pair_cap only arises from non-power-of-two
        # user-supplied caps — the retry protocol always grows to powers
        # of two, so grown capacities chunk cleanly
        return score_and_compact(s_idx, t_for_g, valid2d)

    n_ch = pair_cap // PC
    idx_cs, mm_cs, nh_cs, nr_cs, mrh_cs = jax.lax.map(
        lambda args: score_and_compact(*args),
        (
            s_idx.reshape(n_ch, PC),
            t_for_g.reshape(n_ch, PC),
            valid2d.reshape(n_ch, PC, P2),
        ),
    )
    # per-chunk flat indices live in a (PC*BS_M, P2) row space; chunk c's
    # rows start at c*PC*BS_M, so its flat base is c*PC*BS_M*P2
    offs = (jnp.arange(n_ch, dtype=jnp.int32) * (PC * BS_M * P2))[:, None]
    all_idx = jnp.where(idx_cs >= 0, idx_cs + offs, -1).reshape(-1)
    all_mm = mm_cs.reshape(-1)
    (sel,) = jnp.nonzero(all_idx >= 0, size=cap, fill_value=-1)
    sel_safe = jnp.clip(sel, 0, all_idx.shape[0] - 1)
    idx = jnp.where(sel >= 0, all_idx[sel_safe], -1).astype(jnp.int32)
    mm_vals = jnp.where(sel >= 0, all_mm[sel_safe], 0).astype(jnp.int32)
    return (
        idx,
        mm_vals,
        nh_cs.sum().astype(jnp.int32),
        nr_cs.sum().astype(jnp.int32),
        mrh_cs.max().astype(jnp.int32),
    )


def _grow_caps(worsts, caps):
    """One step of the capacity-overflow protocol shared by the dense and
    site engines: compare the packed-header maxima (pairs, hits, rows,
    row-hits) against the current (pair_cap, hit_cap, cap_rows, k_top),
    return (ok, new_caps) — ok=True when everything fits (the row check
    clamps to min(cap_rows, pair_cap * BS_M), the device-side row bound);
    otherwise each overflowed capacity is sized from the exact reported
    count (next power of two of max(worst, 2*cap)): one retry, not a
    doubling walk. Keeping this in ONE place is load-bearing — the two
    engines' retry protocols must never diverge."""
    worst_pairs, worst_hits, worst_rows, worst_rh, bs_m = worsts
    pair_cap, hit_cap, cap_rows, k_top = caps
    ok = (
        worst_pairs <= pair_cap
        and worst_hits <= hit_cap
        and worst_rows <= min(cap_rows, pair_cap * bs_m)
        and worst_rh <= k_top
    )
    if not ok:
        if worst_pairs > pair_cap:
            pair_cap = 1 << (max(worst_pairs, 2 * pair_cap) - 1).bit_length()
        if worst_hits > hit_cap:
            hit_cap = 1 << (max(worst_hits, 2 * hit_cap) - 1).bit_length()
        if worst_rows > cap_rows:
            cap_rows = 1 << (max(worst_rows, 2 * cap_rows) - 1).bit_length()
        if worst_rh > k_top:
            k_top = 1 << (max(worst_rh, 2 * k_top) - 1).bit_length()
    return ok, (pair_cap, hit_cap, cap_rows, k_top)


def _entry_bytes(v) -> int:
    """Best-effort device/host byte estimate of one cache entry (jax or
    numpy arrays, possibly nested in tuples)."""
    if hasattr(v, "nbytes"):
        try:
            return int(v.nbytes)
        except Exception:  # pragma: no cover - exotic array type
            return 0
    if isinstance(v, (tuple, list)):
        return sum(_entry_bytes(x) for x in v)
    return 0


class _ShardDevCache(dict):
    """LRU of device-resident sharded inputs keyed by content digest +
    geometry — repeat scans of one genome/library over one mesh skip the
    host build and the h2d ship entirely. Hits refresh recency (a FIFO
    thrashed 100% on the 8-library serving set, r4 review), and eviction
    is bounded BOTH by entry count and by estimated bytes so a few
    design-scale libraries can't pin multiple GB of HBM."""

    MAX = 8
    MAX_BYTES = 1 << 30

    def __init__(self, max_entries: int = 8, max_bytes: int = 1 << 30):
        super().__init__()
        self.MAX = max_entries
        self.MAX_BYTES = max_bytes
        self._bytes: dict = {}
        # observability counters (VERDICT r4 item 4): the r4 thrash bug —
        # a FIFO evicting the whole working set every serving pass — was
        # invisible because nothing reported re-ships; tests and bench's
        # serving block pin these
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.bytes_built = 0  # bytes constructed+shipped on misses

    def stats(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "bytes_built": self.bytes_built,
            "entries": len(self),
            "bytes_resident": sum(self._bytes.values()),
        }

    def reset_stats(self) -> None:
        self.hits = self.misses = self.evictions = self.bytes_built = 0

    def get_or_put(self, key, build):
        v = super().get(key)
        if v is None:
            v = build()
            self[key] = v
            nb = _entry_bytes(v)
            self._bytes[key] = nb
            self.misses += 1
            self.bytes_built += nb
            while len(self) > self.MAX or (
                len(self) > 1 and sum(self._bytes.values()) > self.MAX_BYTES
            ):
                old = next(iter(self))
                del self[old]
                self._bytes.pop(old, None)
                self.evictions += 1
        else:
            # LRU touch: move to the recent end
            del self[key]
            self[key] = v
            self.hits += 1
        return v


_GENOME_SHARD_CACHE = _ShardDevCache()
# sized for a SERVING SET of libraries (8+ distinct q one-hots in rotation
# plus the small scalars), not just one
_Q_SHARD_CACHE = _ShardDevCache(max_entries=32)
# HOST-memory site tables (numpy, backed by the on-disk artifact store so a
# miss is a disk reload, not a recompute). Kept OUT of _GENOME_SHARD_CACHE:
# counting host bytes against the HBM budget made a chromosome-scale site
# table (~780 MB at 250 Mb/NGG) and its device codes array evict each other
# on every scan — permanent thrash of exactly the kind the cache exists to
# prevent (r5 review)
_SITE_HOST_CACHE = _ShardDevCache(max_entries=6, max_bytes=3 << 30)


def serving_cache_stats(reset: bool = False) -> dict:
    """Device-input cache observability for production serving: hit /
    miss / eviction / bytes counters of the genome-side and library-side
    caches. A warm serving pass over a working set that fits must show
    misses=0, bytes_built=0 — anything else means one-hots are being
    re-shipped every pass (the r4 thrash bug class). ``reset=True``
    zeroes the counters after reading (per-window monitoring)."""
    out = {
        "genome": _GENOME_SHARD_CACHE.stats(),
        "q": _Q_SHARD_CACHE.stats(),
        "site_host": _SITE_HOST_CACHE.stats(),
    }
    if reset:
        _GENOME_SHARD_CACHE.reset_stats()
        _Q_SHARD_CACHE.reset_stats()
        _SITE_HOST_CACHE.reset_stats()
    return out


def _host_onehot(q_codes: np.ndarray, K: int, L: int, fold: bool, bias_col: int):
    """(rows, K) f32 one-hot with the folded-bias constant-1 column."""
    oh = onehot_rows(q_codes, K)
    if fold:
        oh[:, 4 * L + bias_col] = 1.0
    return oh


@functools.lru_cache(maxsize=64)
def _sharded_site_engine(
    mesh,
    *,
    n_lib: int,
    n_gen: int,
    Bs: int,
    P: int,
    P2: int,
    L: int,
    L_pad: int,
    K: int,
    SUB: int,
    BS_M: int,
    n_sblocks_loc: int,
    thresh_mm: int,
    pair_cap: int,
    cap: int,
    cap_rows: int,
    k: int,
    use_pallas: bool,
    interpret: bool,
):
    """Site-compacted sharded engine: the SITE axis (not the genome axis)
    is sharded over the mesh — every PAM-valid window is an independent
    column of the site-code matrix (R-strand windows pre-revcomped at
    enumeration), so there is NO halo exchange at all: the collective
    surface is just the all_gathered hit lists.
    Forward spacer rows only (half the matmul rows of the dense fused
    path) and ~N/4^|pam-informative-bases| of its columns — the same
    contraction that makes site mode the fastest single-chip engine
    (ops.pallas_scan._SiteScanJob)."""
    n_tiles_loc = Bs // P
    n_t2_loc = Bs // P2
    n_sb_pad8 = _cdiv(n_sblocks_loc, 8) * 8

    def indicator(thresh_v, q, tiles):
        bias = jnp.zeros((n_tiles_loc, 1, P), jnp.float32)
        return phase1_hits(
            thresh_v, q, tiles, bias, L=L, K=K, P=P, SUB=SUB, BS_M=BS_M,
            use_kernel=use_pallas, interpret=interpret, fold_bias=False,
            matrix_rows=True,
        )

    def shard_fn(codes_lp_b, n_sites_v, q, thresh_v):
        codes_lp = codes_lp_b  # (L_pad, Bs) int8
        dev = jax.lax.axis_index(GENOME_AXIS)
        tiles = (
            codes_lp.astype(jnp.int32).reshape(L_pad, n_tiles_loc, P).transpose(1, 0, 2)
        )
        ind = indicator(thresh_v, q, tiles)
        pairs, _vals, n_pairs = _compact_pairs(ind, pair_cap)

        # phase 2 (extract_matrix formulation) on this device's pair list
        slots = pairs
        slot_ok = (
            jnp.arange(pair_cap, dtype=jnp.int32) < jnp.minimum(n_pairs, pair_cap)
        ) & (slots >= 0)
        safe = jnp.where(slot_ok, slots, 0)
        t_big = safe // (n_sb_pad8 * SUB)
        rem = safe % (n_sb_pad8 * SUB)
        s_idx = rem // SUB
        t_idx = t_big * SUB + rem % SUB
        t_safe = jnp.clip(t_idx, 0, n_t2_loc - 1)
        tiles2 = codes_lp.reshape(L_pad, n_t2_loc, P2).transpose(1, 0, 2)[:, :L, :]

        def build_g(t_c):
            g = tiles2[jnp.clip(t_c, 0, n_t2_loc - 1)]  # (chunk, L, P2) int8
            oh = (
                g[:, :, None, :]
                == jnp.arange(4, dtype=g.dtype)[None, None, :, None]
            ).reshape(g.shape[0], 4 * L, P2)
            g_oh = oh.astype(jnp.bfloat16)
            if 4 * L < K:
                g_oh = jnp.pad(g_oh, ((0, 0), (0, K - 4 * L), (0, 0)))
            return g_oh

        # column validity is GLOBAL: this device holds sites
        # [dev*Bs, dev*Bs + Bs); padding columns past n_sites never hit
        col_global = dev * Bs + t_safe[:, None] * P2 + jnp.arange(P2, dtype=jnp.int32)[None, :]
        col_ok = col_global < n_sites_v
        valid2d = col_ok & (slot_ok & (t_idx < n_t2_loc))[:, None]
        idx, mm_vals, n_hits, n_rows, max_rh = _phase2_compact(
            q, s_idx, t_idx, valid2d, build_g,
            BS_M=BS_M, K=K, P2=P2, L=L, thresh_mm=thresh_mm,
            pair_cap=pair_cap, cap=cap, cap_rows=cap_rows, k=k,
            n_sblocks_loc=n_sblocks_loc,
        )

        # hit-dependent payload: decode each hit ON DEVICE to its global
        # site column + spacer-local index and ship (col, spacer<<6|mm)
        # pairs — no slots array crosses a link and the host decode is a
        # plain unpack (VERDICT r2 item 1)
        slot_h = jnp.clip(idx // (BS_M * P2), 0, pair_cap - 1)
        rem_h = idx % (BS_M * P2)
        pair_h = slots[slot_h]
        t2_h = (pair_h // (n_sb_pad8 * SUB)) * SUB + pair_h % SUB
        spacer_h = (pair_h % (n_sb_pad8 * SUB) // SUB) * BS_M + rem_h // P2
        col_h = dev * Bs + t2_h * P2 + rem_h % P2
        w1 = spacer_h * (1 << _MM_BITS) + mm_vals

        # header word 2 reserved (see the dense engine's note: the psum'd
        # total had no consumer)
        header = jnp.stack(
            [
                n_pairs.astype(jnp.int32),
                n_hits.astype(jnp.int32),
                jnp.int32(0),
                n_rows.astype(jnp.int32),
                max_rh.astype(jnp.int32),
                jnp.int32(0),
            ]
        )
        packed = jnp.concatenate([header, col_h, w1])
        g1 = jax.lax.all_gather(packed, GENOME_AXIS)
        if n_lib > 1:
            g2 = jax.lax.all_gather(g1, LIBRARY_AXIS)
        else:
            g2 = g1[None]
        return g2

    lib_spec = P_(LIBRARY_AXIS) if n_lib > 1 else P_()
    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P_(None, GENOME_AXIS), P_(), lib_spec, P_()),
        out_specs=P_(),
        check_vma=False,
    )
    return jax.jit(fn)


def _site_table_host(contig: Contig, L: int, pam: str, pam_direction: str):
    """(positions, strands, codes) for one contig — shared with the
    single-chip engine through the same on-disk artifact key
    (ops.pallas_scan site path), cached in-process per genome."""
    from ..ops.pallas_scan import _content_digest
    from ..ops.prep import enumerate_sites
    from ..utils import artifacts

    digest = _content_digest(contig.codes)
    art_key = (
        f"{digest.hex()}-{contig.length}-{int(bool(contig.circular))}"
        f"-{L}-{pam}-{pam_direction}"
    )

    def build():
        art = artifacts.load("sites", art_key)
        if art is not None:
            return art["positions"], art["strands"], art["codes"]
        positions, strands, codes = enumerate_sites(contig, L, pam, pam_direction)
        artifacts.store(
            "sites", art_key, positions=positions, strands=strands, codes=codes
        )
        return positions, strands, codes

    return _SITE_HOST_CACHE.get_or_put(("site_host", art_key), build), digest


class _SiteScanRun:
    """One site-compacted sharded scan split into DISPATCH (device work
    queued, nothing fetched) and COLLECT (fetch + capacity-retry + decode)
    halves, so many libraries' scans pipeline their device work before any
    result crosses the link (sharded_scan_many)."""

    def __init__(
        self,
        q_f: np.ndarray,
        contig: Contig,
        max_mismatches: int,
        pam: str,
        pam_direction: str,
        mesh,
        P: int,
        sub_width: int,
        pair_cap: int,
        hit_cap: int,
        use_pallas: bool,
        interpret: bool,
    ):
        import time as _time

        self._t0 = _time.time()
        _check_spacer_len(q_f)
        n_lib, n_gen = _mesh_dims(mesh)
        S, L = q_f.shape
        K = max(_cdiv(4 * L, 128) * 128, 128)
        fold = 4 * L < K
        BS_M = 512 if S >= 2048 else (256 if S >= 512 else BS)
        (positions, strands, codes), genome_digest = _site_table_host(
            contig, L, pam, pam_direction
        )
        n_sites = len(positions)
        self.empty = n_sites == 0 or S == 0
        if self.empty:
            return
        SUB, P2 = _phase2_geom(P, sub_width)
        L_pad = _cdiv(L, 8) * 8
        Bs = _cdiv(n_sites, n_gen * P) * P
        total_s = n_gen * Bs
        mesh_key = (
            tuple(mesh.shape.items()),
            tuple(d.id for d in mesh.devices.ravel()),
        )
        base_key = (genome_digest, contig.id, contig.length,
                    bool(contig.circular), L, pam, pam_direction, n_gen, Bs,
                    mesh_key)

        sharding_cols = NamedSharding(mesh, P_(None, GENOME_AXIS))
        lib_spec = P_(LIBRARY_AXIS) if n_lib > 1 else P_()
        sharding_q = NamedSharding(mesh, lib_spec)

        def _build_codes_lp():
            codes_pad = np.full((total_s, L_pad), 4, dtype=np.int8)
            codes_pad[:n_sites, :L] = codes
            return np.ascontiguousarray(codes_pad.T)  # (L_pad, total_s)

        # all placements go through put_global: on a process-spanning mesh
        # each host ships only its addressable shards (no whole-array
        # device_put, which requires every mesh device to be local —
        # parallel.multihost)
        sharding_rep = NamedSharding(mesh, P_())
        codes_dev = _GENOME_SHARD_CACHE.get_or_put(
            ("site_codes", base_key),
            lambda: put_global(_build_codes_lp, sharding_cols),
        )
        n_sites_v = _Q_SHARD_CACHE.get_or_put(
            ("n_sites", base_key),
            lambda: put_global(np.int32(n_sites), sharding_rep),
        )
        thresh_v = _Q_SHARD_CACHE.get_or_put(
            ("thresh", L - max_mismatches, mesh_key),
            lambda: put_global(
                np.full((1,), L - max_mismatches, np.float32), sharding_rep
            ),
        )

        S_loc = _cdiv(S, n_lib * BS_M) * BS_M
        q_pad = np.full((n_lib * S_loc, L), 4, dtype=np.int8)
        q_pad[:S] = q_f
        n_sblocks_loc = S_loc // BS_M
        from ..ops.pallas_scan import _content_digest

        q_digest = _content_digest(np.ascontiguousarray(q_pad))
        q_dev = _Q_SHARD_CACHE.get_or_put(
            (q_digest, "site", K, n_lib, S_loc, mesh_key),
            lambda: put_global(
                _host_onehot(q_pad, K, L, fold, 0).astype(jnp.bfloat16),
                sharding_q,
            ),
        )

        cap_rows = max(hit_cap // 16, 2 * pair_cap)
        k_top = 4
        caps_key = ("site", base_key, q_digest, int(max_mismatches))
        pair_cap, hit_cap, cap_rows, k_top = _caps_recall(
            caps_key, pair_cap, hit_cap, cap_rows, k_top
        )
        # everything collect() needs to fetch/retry/decode
        self.mesh = mesh
        self.n_lib, self.n_gen = n_lib, n_gen
        self.S, self.L, self.K, self.SUB, self.P2, self.P = (
            S, L, K, SUB, P2, P
        )
        self.L_pad, self.Bs, self.BS_M = L_pad, Bs, BS_M
        self.n_sblocks_loc = n_sblocks_loc
        self.S_loc = S_loc
        self.max_mismatches = int(max_mismatches)
        self.positions, self.strands = positions, strands
        self.n_sites = n_sites
        self.codes_dev, self.n_sites_v, self.thresh_v, self.q_dev = (
            codes_dev, n_sites_v, thresh_v, q_dev
        )
        self.caps_key = caps_key
        self.pair_cap, self.hit_cap, self.cap_rows, self.k_top = (
            pair_cap, hit_cap, cap_rows, k_top
        )
        self.use_pallas, self.interpret = use_pallas, interpret
        self._t1 = _time.time()
        self._attempts = 0
        self._dispatch_s = 0.0  # engine build + enqueue time, all attempts
        self.fut = self._dispatch()

    def _dispatch(self):
        import time as _time

        self._attempts += 1
        _ta = _time.time()
        eng = _sharded_site_engine(
            self.mesh, n_lib=self.n_lib, n_gen=self.n_gen, Bs=self.Bs,
            P=self.P, P2=self.P2, L=self.L, L_pad=self.L_pad, K=self.K,
            SUB=self.SUB, BS_M=self.BS_M, n_sblocks_loc=self.n_sblocks_loc,
            thresh_mm=self.max_mismatches, pair_cap=self.pair_cap,
            cap=self.hit_cap,
            cap_rows=min(self.cap_rows, self.pair_cap * self.BS_M),
            k=self.k_top, use_pallas=self.use_pallas,
            interpret=self.interpret,
        )
        fut = eng(self.codes_dev, self.n_sites_v, self.q_dev, self.thresh_v)
        self._dispatch_s += _time.time() - _ta
        return fut

    def collect(self) -> Hits:
        import time as _time

        if self.empty:
            return Hits()
        while True:
            _ta = _time.time()
            packed = np.asarray(self.fut)
            _t3 = _time.time()
            LAST_TIMINGS.update(
                host_prep_s=self._t1 - self._t0,
                dispatch_s=self._dispatch_s,
                fetch_s=_t3 - _ta, attempts=self._attempts,
                payload_ints=int(packed.size),
            )
            ok, caps = _grow_caps(
                (int(packed[..., 0].max()), int(packed[..., 1].max()),
                 int(packed[..., 3].max()), int(packed[..., 4].max()),
                 self.BS_M),
                (self.pair_cap, self.hit_cap, self.cap_rows, self.k_top),
            )
            self.pair_cap, self.hit_cap, self.cap_rows, self.k_top = caps
            if ok:
                break
            self.fut = self._dispatch()
        _caps_store(
            self.caps_key, self.pair_cap, self.hit_cap, self.cap_rows,
            self.k_top,
        )
        out = []
        for li in range(packed.shape[0]):
            for di in range(self.n_gen):
                row = packed[li, di]
                n_sig = int(row[1])
                if n_sig == 0:
                    continue
                col, spacer_l, mm_vals = _decode_packed_hits(
                    row, self.hit_cap, n_sig
                )
                spacer = li * self.S_loc + spacer_l
                # device already masked col >= n_sites; spacer padding rows
                # (code 4 -> zero one-hot) can't hit, but keep the guard
                keep = (spacer < self.S) & (col < self.n_sites)
                if not keep.any():
                    continue
                col = col[keep]
                out.append(
                    Hits(
                        spacer_idx=spacer[keep].astype(np.int64),
                        pos=self.positions[col].astype(np.int64),
                        strand=self.strands[col].astype(np.int8),
                        mismatches=mm_vals[keep].astype(np.int32),
                    )
                )
        res = Hits.concat(out).sorted()
        LAST_TIMINGS["decode_s"] = _time.time() - _t3
        return res


def _sharded_site_scan(
    q_f: np.ndarray,
    contig: Contig,
    max_mismatches: int,
    pam: str,
    pam_direction: str,
    mesh,
    P: int,
    sub_width: int,
    pair_cap: int,
    hit_cap: int,
    use_pallas: bool,
    interpret: bool,
) -> Hits:
    """Site-compacted multi-device scan (see _sharded_site_engine)."""
    return _SiteScanRun(
        q_f, contig, max_mismatches, pam, pam_direction, mesh, P, sub_width,
        pair_cap, hit_cap, use_pallas, interpret,
    ).collect()


def sharded_scan(
    spacers,
    contig: Contig,
    max_mismatches: int,
    pam: str = "",
    pam_direction: str = "downstream",
    mesh=None,
    P: int = 2048,
    sub_width: int = 512,
    pair_cap: int = 256,
    hit_cap: int = 1 << 12,
    use_pallas: bool | None = None,
    interpret: bool = False,
    site_mode: str = "auto",
) -> Hits:
    """Full multi-device scan on the flagship engine: sharded strand-fused
    phase 1, device-side pair compaction, device-resident phase 2,
    all_gathered hit lists, one host fetch. Same contract as
    ops.scan.scan_contig.

    pair_cap/hit_cap are PER-DEVICE static capacities (phase 2 is a fixed
    (pair_cap, BS_M, P2) einsum, so modest defaults + overflow retry beat
    sizing for the worst case upfront)."""
    if mesh is None:
        mesh = make_mesh()
    n_lib, n_gen = _mesh_dims(mesh)
    if use_pallas is None:
        use_pallas = _kernel_on(mesh)
    q_f = spacer_matrix(list(spacers)) if not isinstance(spacers, np.ndarray) else spacers
    _check_spacer_len(q_f)
    if q_f.shape[0] and _want_sites(pam, site_mode):
        # PAM scans run site-compacted (~N/4^|informative-bases| of the
        # dense columns, forward rows only, no halo ring) — the same engine
        # choice that wins single-chip; "never" forces the dense fused path
        return _sharded_site_scan(
            q_f, contig, max_mismatches, pam, pam_direction, mesh, P,
            sub_width, pair_cap, hit_cap, use_pallas, interpret,
        )
    S, L = q_f.shape
    K = max(_cdiv(4 * L, 128) * 128, 128)
    halo = K // 4
    fused = 4 * L + 2 <= K
    fold = 4 * L < K
    BS_M = 512 if S >= 2048 else (256 if S >= 512 else BS)
    n = contig.length
    # len(build_scan_array(contig, L)) without building it — repeat scans
    # must not pay ANY genome-proportional host work (it all lives behind
    # the content-keyed device caches below)
    scan_len = n + (L - 1) if (contig.circular and L > 1) else n
    n_starts = min(n, scan_len - L + 1) if scan_len >= L else 0
    if n_starts <= 0 or S == 0:
        return Hits()
    SUB, P2 = _phase2_geom(P, sub_width)
    if P2 < halo:
        raise ValueError(f"subtile width {P2} must cover the halo {halo}")

    # genome-axis blocks. B is sized so total >= n_starts + halo: every code
    # any VALID window reads (scan_len = n_starts + L - 1 <= n_starts + halo)
    # is materialized inside the blocks themselves, and the ring ppermute is
    # only load-bearing for cross-block reads of real in-block codes. The
    # last device's received halo is device 0's block start — wrong codes
    # for a linear tail or a non-exact circular wrap — but with this sizing
    # only masked starts (>= n_starts) can reach it. (Sizing from n_starts
    # alone silently dropped tail/wrap hits whenever total - n_starts < L-1;
    # pinned by test_parallel.py boundary-band tests.)
    B = _cdiv(n_starts + halo, n_gen * P) * P
    total = n_gen * B

    def _build_codes_blocks():
        scan = build_scan_array(contig, L)  # int8; widened on device
        codes_padded = np.full(total, 4, dtype=np.int8)
        usable = min(len(scan), total)
        codes_padded[:usable] = scan[:usable]
        return codes_padded.reshape(n_gen, B)

    def _blocked(mask):
        ok = np.zeros(total, dtype=np.int8)
        ok[:n_starts] = mask[:n_starts]
        return ok

    # library-axis spacer layout: shard i holds fwd rows [i*S_loc,(i+1)*S_loc)
    # (and, fused, their reverse rows stacked below — so each shard's q is a
    # self-contained fwd++rev block and in_spec P_(library) hands it over)
    S_loc = _cdiv(S, n_lib * BS_M) * BS_M
    q_pad = np.full((n_lib * S_loc, L), 4, dtype=np.int8)
    q_pad[:S] = q_f
    n_sblocks_loc = ((2 if fused else 1) * S_loc) // BS_M
    half_blocks = S_loc // BS_M

    sharding_g = NamedSharding(mesh, P_(GENOME_AXIS))
    lib_spec = P_(LIBRARY_AXIS) if n_lib > 1 else P_()
    sharding_q = NamedSharding(mesh, lib_spec)
    from ..ops.pallas_scan import _content_digest

    mesh_key = (tuple(mesh.shape.items()), tuple(d.id for d in mesh.devices.ravel()))
    genome_digest = _content_digest(contig.codes)
    base_key = (genome_digest, contig.id, n, bool(contig.circular),
                L, pam, pam_direction, n_gen, B, mesh_key)
    # codes blocks are PAM-independent (only the 'ok' masks depend on the
    # PAM) — keying them on base_key forced a redundant rebuild + h2d
    # re-ship of identical data when one genome was scanned under two PAMs
    codes_dev = _GENOME_SHARD_CACHE.get_or_put(
        ("codes", genome_digest, contig.id, n, bool(contig.circular), L,
         n_gen, B, mesh_key),
        lambda: put_global(_build_codes_blocks, sharding_g),
    )
    thresh_v = _Q_SHARD_CACHE.get_or_put(
        ("thresh", L - max_mismatches, mesh_key),
        lambda: put_global(
            np.full((1,), L - max_mismatches, np.float32),
            NamedSharding(mesh, P_()),
        ),
    )

    cap_rows = max(hit_cap // 16, 2 * pair_cap)
    k_top = 4

    q_digest = _content_digest(np.ascontiguousarray(q_pad))
    caps_key = ("dense", base_key, q_digest, int(max_mismatches))
    pair_cap, hit_cap, cap_rows, k_top = _caps_recall(
        caps_key, pair_cap, hit_cap, cap_rows, k_top
    )

    def run(strand_jobs):
        """strand_jobs: list of (q one-hot BUILDER, ok-array BUILDER,
        strand meta) → list of per-job packed arrays, retried together on
        capacity overflow. All host builds + h2d ships live behind the
        content-keyed device caches, so a repeat scan's host cost is one
        digest of the spacer-codes matrix."""
        nonlocal pair_cap, hit_cap, cap_rows, k_top
        put = [
            (
                _Q_SHARD_CACHE.get_or_put(
                    (q_digest, K, fused, fold, n_lib, S_loc, mesh_key, ji),
                    lambda build_q=build_q: put_global(
                        build_q().astype(jnp.bfloat16), sharding_q
                    ),
                ),
                _GENOME_SHARD_CACHE.get_or_put(
                    ("ok", base_key, ji),
                    lambda build_ok=build_ok: put_global(
                        np.ascontiguousarray(
                            build_ok().reshape(-1, n_gen, B).transpose(1, 0, 2)
                        ),
                        sharding_g,
                    ),
                ),
            )
            for ji, (build_q, build_ok, _meta) in enumerate(strand_jobs)
        ]
        while True:
            eng = _sharded_engine(
                mesh, n_lib=n_lib, n_gen=n_gen, B=B, P=P, P2=P2,
                halo=halo, L=L, K=K, SUB=SUB, BS_M=BS_M,
                n_sblocks_loc=n_sblocks_loc, half_blocks=half_blocks,
                fused=fused, fold=fold, thresh_mm=int(max_mismatches),
                pair_cap=pair_cap, cap=hit_cap,
                cap_rows=min(cap_rows, pair_cap * BS_M), k=k_top,
                use_pallas=use_pallas, interpret=interpret,
            )
            outs = [eng(codes_dev, ok_d, q_d, thresh_v) for q_d, ok_d in put]
            packed = [np.asarray(o) for o in outs]  # ONE fetch per job
            ok, caps = _grow_caps(
                (max(int(p[..., 0].max()) for p in packed),
                 max(int(p[..., 1].max()) for p in packed),
                 max(int(p[..., 3].max()) for p in packed),
                 max(int(p[..., 4].max()) for p in packed),
                 BS_M),
                (pair_cap, hit_cap, cap_rows, k_top),
            )
            pair_cap, hit_cap, cap_rows, k_top = caps
            if ok:
                _caps_store(caps_key, pair_cap, hit_cap, cap_rows, k_top)
                return packed

    def _masks():
        return site_masks(contig, L, pam, pam_direction)

    if fused:
        def build_q_fused():
            q_host = np.empty((n_lib * 2 * S_loc, K), dtype=np.float32)
            q_f_oh = _host_onehot(q_pad, K, L, fold, 0)
            q_r_oh = _host_onehot(revcomp_matrix(q_pad), K, L, fold, 1)
            for i in range(n_lib):
                q_host[i * 2 * S_loc : i * 2 * S_loc + S_loc] = q_f_oh[
                    i * S_loc : (i + 1) * S_loc
                ]
                q_host[i * 2 * S_loc + S_loc : (i + 1) * 2 * S_loc] = q_r_oh[
                    i * S_loc : (i + 1) * S_loc
                ]
            return q_host

        def build_ok_fused():
            mask_f, mask_r = _masks()
            return np.stack([_blocked(mask_f), _blocked(mask_r)])

        jobs = [(build_q_fused, build_ok_fused, None)]
        strands_of = [None]
    else:
        jobs = [
            (
                lambda: _host_onehot(q_pad, K, L, fold, 0),
                lambda: _blocked(_masks()[0])[None],
                STRAND_F,
            ),
            (
                lambda: _host_onehot(revcomp_matrix(q_pad), K, L, fold, 0),
                lambda: _blocked(_masks()[1])[None],
                STRAND_R,
            ),
        ]
        strands_of = [STRAND_F, STRAND_R]

    packed_all = run(jobs)

    out = []
    for packed, fixed_strand in zip(packed_all, strands_of):
        for li in range(packed.shape[0]):
            for di in range(n_gen):
                row = packed[li, di]
                n_sig = int(row[1])
                if n_sig == 0:
                    continue
                pos, meta, mm_vals = _decode_packed_hits(row, hit_cap, n_sig)
                sp_local = meta >> 1
                if fused:
                    rev = (meta & 1).astype(bool)
                    strand = np.where(rev, STRAND_R, STRAND_F).astype(np.int8)
                else:
                    strand = np.full(len(pos), fixed_strand, np.int8)
                spacer = li * S_loc + sp_local
                keep = (sp_local < S_loc) & (spacer < S) & (pos < n_starts)
                if not keep.any():
                    continue
                out.append(
                    Hits(
                        spacer_idx=spacer[keep].astype(np.int64),
                        pos=pos[keep].astype(np.int64),
                        strand=strand[keep],
                        mismatches=mm_vals[keep].astype(np.int32),
                    )
                )
    return Hits.concat(out).sorted()


def _windowed_collect(makers, max_pending: int) -> list:
    """Run dispatch/collect jobs with at most ``max_pending`` in flight:
    the oldest job is drained BEFORE the next is constructed (construction
    dispatches), so in-flight device work never exceeds the window.
    Results in input order. Shared by sharded_scan_many (libraries) and
    sharded_scan_contigs (contigs)."""
    results: list = [None] * len(makers)
    pending: list = []
    for i, make in enumerate(makers):
        if len(pending) >= max_pending:
            j, run = pending.pop(0)
            results[j] = run.collect()
        pending.append((i, make()))
    for j, run in pending:
        results[j] = run.collect()
    return results


def sharded_scan_many(
    libraries,
    contig: Contig,
    max_mismatches: int,
    pam: str,
    pam_direction: str = "downstream",
    mesh=None,
    P: int = 2048,
    sub_width: int = 512,
    pair_cap: int = 256,
    hit_cap: int = 1 << 12,
    use_pallas: bool | None = None,
    interpret: bool = False,
    max_pending: int = 4,
) -> list[Hits]:
    """Batched serving: scan MANY libraries against one contig with each
    library's fused program dispatched before any result is fetched —
    device execution of library i overlaps the link round trip of library
    i-1 (the serving analog of the counting engine's dispatch pipelining).
    PAM site-compacted scans only (the serving shape); requires a PAM.

    max_pending bounds in-flight scans: each pins its q one-hot on device
    (~S_pad x 128 bf16). Returns hits in input order."""
    if not pam:
        raise ValueError("sharded_scan_many serves PAM site-compacted scans")
    if mesh is None:
        mesh = make_mesh()
    if use_pallas is None:
        use_pallas = _kernel_on(mesh)
    libraries = list(libraries)  # allow a generator of libraries

    def make(spacers):
        q_f = (
            spacer_matrix(list(spacers))
            if not isinstance(spacers, np.ndarray)
            else spacers
        )
        return _SiteScanRun(
            q_f, contig, max_mismatches, pam, pam_direction, mesh, P,
            sub_width, pair_cap, hit_cap, use_pallas, interpret,
        )

    return _windowed_collect(
        [functools.partial(make, sp) for sp in libraries], max_pending
    )


def sharded_scan_contigs(
    spacers,
    contigs,
    max_mismatches: int,
    pam: str = "",
    pam_direction: str = "downstream",
    mesh=None,
    P: int = 2048,
    sub_width: int = 512,
    pair_cap: int = 256,
    hit_cap: int = 1 << 12,
    use_pallas: bool | None = None,
    interpret: bool = False,
    site_mode: str = "auto",
    max_pending: int = 4,
) -> list[Hits]:
    """Multi-contig sharded scan with every contig's fused program
    dispatched before any result is fetched — a multi-replicon genome
    (e.g. the 5-contig Zymomonas set) overlaps its per-contig link round
    trips instead of paying them serially (the multi-contig analog of
    sharded_scan_many; PAM site path only — dense/no-PAM contigs fall
    back to sequential sharded_scan). Results in INPUT ORDER, robust to
    duplicate contig ids."""
    if mesh is None:
        mesh = make_mesh()
    if use_pallas is None:
        use_pallas = _kernel_on(mesh)
    q_f = (
        spacer_matrix(list(spacers))
        if not isinstance(spacers, np.ndarray)
        else spacers
    )
    if not (q_f.shape[0] and _want_sites(pam, site_mode)):
        return [
            sharded_scan(
                q_f, c, max_mismatches, pam, pam_direction, mesh=mesh, P=P,
                sub_width=sub_width, pair_cap=pair_cap, hit_cap=hit_cap,
                use_pallas=use_pallas, interpret=interpret,
                site_mode=site_mode,
            )
            for c in contigs
        ]
    def make(c):
        return _SiteScanRun(
            q_f, c, max_mismatches, pam, pam_direction, mesh, P, sub_width,
            pair_cap, hit_cap, use_pallas, interpret,
        )

    return _windowed_collect(
        [functools.partial(make, c) for c in contigs], max_pending
    )
