"""Data-parallel barcode counting over a device mesh (shard_map + psum).

The reference's counting phase merges per-process ``Counter``s from a fork
pool (heuristicount.py:720-737). The equivalent here shards the
read-batch axis over a 1-D mesh: each device exact-matches its rows against
the replicated barcode one-hot table with a matmul (the same formulation as
``pipeline.heuristic_count.DeviceCounter``), builds a per-barcode local
count vector, and the vectors merge on-device with ``lax.psum`` — the
collective Counter merge. The matched mask comes back sharded because
undocumented-barcode handling (heuristicount.py:517-518) needs the raw
sequences and stays on the host.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P_

from ..pipeline.heuristic_count import (
    CountConfig,
    DeviceCounter,
    _pack_cores_u32,
    _unpacked_onehot,
)
from .multihost import fetch_local_rows, put_global, put_process_local

READS_AXIS = "reads"


def make_read_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the read-batch (data-parallel) axis."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.array(devices), (READS_AXIS,))


class ShardedCounter(DeviceCounter):
    """DeviceCounter with the match matmul sharded over a read-batch mesh
    axis and documented counts merged on-device with ``psum``.

    Chunk semantics (flank windows, paired revcomp consistency, N filter,
    undocumented ``seq*`` counting) are inherited unchanged — only the
    exact-match + tally stage is distributed. Like the single-device
    engine, d2h is one packbits'd matched bit per read (sharded) plus the
    psum-merged count vector (replicated).

    On a process-spanning mesh (parallel.multihost) every host feeds the
    IDENTICAL chunk stream (plain SPMD: same argv, same files on each
    host) and process_matrices slices each chunk into equal-width per-host
    row windows internally — so no external driver can double-count, and
    the collective shapes stay in lockstep by construction. The psum
    leaves every host holding the identical GLOBAL documented-count
    vector (the reference's end-of-run Counter merge,
    heuristicount.py:734-737, happens on-device instead) and the same
    global total_reads; the undocumented tally stays host-local to each
    process's own row window (union over hosts = the single-process
    tally)."""

    def __init__(self, cfg: CountConfig, mesh: Mesh | None = None):
        super().__init__(cfg)
        self._mesh = mesh if mesh is not None else make_read_mesh()
        self._n_dev = int(self._mesh.devices.size)
        self._n_local_dev = sum(
            1 for d in self._mesh.devices.ravel()
            if d.process_index == jax.process_index()
        )
        self._owned_mode = False  # chunk-ownership feed (feed_owned)
        self._owned_rows = None  # per-owner rows buffered since last flush
        self.owned_reads = 0  # rows this host parsed+processed itself
        if jax.process_count() > 1:
            # replicate the barcode table onto this process's mesh devices
            # (a bare jnp array is single-device and can't feed a
            # process-spanning shard_map)
            self._bc_oh = put_global(
                np.asarray(self._bc_oh), NamedSharding(self._mesh, P_())
            )

    def process_matrices(self, m1, m2) -> None:
        k = jax.process_count()
        if k > 1:
            n = m1.shape[0] if m1 is not None else (
                m2.shape[0] if m2 is not None else 0
            )
            per = -(-n // k)  # equal-width windows keep every process's
            # dispatch geometry identical (lockstep collectives)
            lo = jax.process_index() * per

            def cut(m):
                if m is None:
                    return None
                sl = m[lo : lo + per]
                if len(sl) < per:
                    # all-N pad rows: the no-N filter makes them ineligible
                    # everywhere, so they can neither count nor reach undoc
                    pad = np.full((per - len(sl), m.shape[1]), ord("N"), m.dtype)
                    sl = np.concatenate([sl, pad])
                return sl

            m1, m2 = cut(m1), cut(m2)
            # super() adds this host's `per` rows; top up so every host
            # reports the GLOBAL read total
            self.total_reads += n - per
        super().process_matrices(m1, m2)

    # ----- chunk-ownership feed (multi-host input sharding) -----
    #
    # process_matrices above replicates parsing: every host parses the full
    # stream and keeps 1/K of the rows. The owned feed divides the input
    # instead — chunk i belongs to host i mod K, each host parses ONLY its
    # own chunks (seqio.fast_reader.iter_owned_matrix_chunks skips the
    # rest at newline-scan speed), and lockstep is preserved because every
    # host still *scans* every chunk and therefore derives the identical
    # dispatch schedule from the shared (chunk_idx, n_records) stream.
    # The multi-host generalization of the reference fork pool dividing
    # chunks across workers (heuristicount.py:720-722).

    def feed_owned(self, chunk_idx: int, n_records: int, m1, m2) -> None:
        """Feed one chunk of the shared stream, in chunk order, from every
        host. ``m1``/``m2`` are non-None only on the owning host
        (``chunk_idx % K == process_index``); other hosts pass the record
        count alone. Rows buffer per-host and flush in lockstep once the
        busiest host's buffer reaches ``_DISPATCH_ROWS`` (a shared
        decision: all hosts see the same per-chunk record counts)."""
        K = jax.process_count()
        if not self._owned_mode:
            self._owned_mode = True
            self._owned_rows = np.zeros(K, np.int64)
        owner = chunk_idx % K
        self._owned_rows[owner] += n_records
        if m1 is not None or m2 is not None:
            self.owned_reads += n_records
            # VectorCounter windowing (flank checks, revcomp consistency)
            # on this host's own rows; _tally buffers without flushing
            from ..pipeline.heuristic_count import VectorCounter

            VectorCounter.process_matrices(self, m1, m2)
        else:
            self.total_reads += n_records
        if int(self._owned_rows.max()) >= self._DISPATCH_ROWS:
            self.flush_owned()

    def flush_owned(self) -> None:
        """Dispatch every host's buffered owned rows as ONE lockstep
        program: all hosts pad to the bucket of the busiest host's row
        count (derived from the shared scan, so identical everywhere) —
        a host with no owned rows in this window dispatches an
        all-ineligible batch to keep the collective schedule aligned."""
        if not self._owned_mode or int(self._owned_rows.max()) == 0:
            return
        if not self._buf:
            # zero-row batch so _flush_buf still dispatches
            self._buf.append(
                (np.zeros((0, self.bc_len), np.uint8), np.zeros(0, bool))
            )
        # pad floor rides WITH the batch through the dispatch queue — an
        # instance attribute would race the worker thread. _owned_rows
        # resets even on a failed flush: stale counts would poison the
        # NEXT flush's pad bucket and desync cross-host geometry
        try:
            self._flush_buf(pad_min=int(self._owned_rows.max()))
        finally:
            self._owned_rows[:] = 0

    def drain(self) -> None:
        if self._owned_mode:
            self.flush_owned()  # all hosts drain at the same stream point
        super().drain()

    def reset(self) -> None:
        """Also rewind the chunk-ownership bookkeeping (the discard-
        checkpoints path of the multi-host resume agreement restarts the
        stream from chunk 0)."""
        super().reset()
        self.owned_reads = 0
        if self._owned_rows is not None:
            self._owned_rows[:] = 0

    def _match_fn(self):
        if getattr(self, "_match_jit", None) is not None:
            return self._match_jit
        key = ("sharded", self.bc_len, self.B, int(self._bc_oh.shape[1]),
               self._READ_SLICE, self._mesh)
        cached = self._JIT_CACHE.get(key)
        if cached is not None:
            self._match_jit = cached
            return cached
        S = self._READ_SLICE
        bc_len, B = self.bc_len, self.B

        def shard_fn(codes_b, elig_b, bc_oh, acc):
            cs = codes_b.reshape(-1, S, 2)
            es = elig_b.reshape(-1, S)

            def one_slice(args):
                cc, el = args
                oh = _unpacked_onehot(cc, bc_len, jnp)
                scores = jnp.dot(oh, bc_oh, preferred_element_type=jnp.float32)
                best = jnp.argmax(scores, axis=1)
                exact = jnp.max(scores, axis=1) >= bc_len - 0.5
                matched = exact & el & (best < B)
                return best.astype(jnp.int32), matched

            idx, m = jax.lax.map(one_slice, (cs, es))
            idx, m = idx.reshape(-1), m.reshape(-1)
            local = jnp.zeros(acc.shape, jnp.int32).at[idx].add(m.astype(jnp.int32))
            # the on-device Counter merge: psum into the (replicated,
            # donated) global accumulator — every host's drain fetch sees
            # identical GLOBAL counts
            counts = acc + jax.lax.psum(local, READS_AXIS)
            return jnp.packbits(m), counts

        fn = jax.shard_map(
            shard_fn,
            mesh=self._mesh,
            in_specs=(P_(READS_AXIS), P_(READS_AXIS), P_(), P_()),
            out_specs=(P_(READS_AXIS), P_()),
            check_vma=False,
        )
        self._match_jit = jax.jit(fn, donate_argnums=(3,))
        self._JIT_CACHE[key] = self._match_jit
        while len(self._JIT_CACHE) > 16:
            self._JIT_CACHE.pop(next(iter(self._JIT_CACHE)))
        return self._match_jit

    def _zero_acc(self):
        return put_global(
            np.zeros((int(self._bc_oh.shape[1]),), np.int32),
            NamedSharding(self._mesh, P_()),
        )

    def _tally(self, keys, cores, eligible) -> None:
        if self._owned_mode:
            # owned mode: buffer only — flush decisions are made in
            # feed_owned/flush_owned from shared knowledge, never from
            # this host's local row count (which may differ at the tail)
            if len(self.bc_list) == 0:
                return
            self._buf.append((cores, np.asarray(eligible, bool)))
            self._buf_rows += len(cores)
            return
        super()._tally(keys, cores, eligible)

    def _device_match_async(
        self, core_codes: np.ndarray, eligible: np.ndarray, pad_min: int = 0
    ):
        n = core_codes.shape[0]
        # this process pads to ITS addressable quantum; the global row count
        # is the sum over processes (put_process_local, process order)
        quantum = self._n_local_dev * self._READ_SLICE
        # geometric quantum buckets: a tail batch reuses the full batch's
        # executable (see DeviceCounter._device_match_async); pad_min
        # (owned mode) lifts every host to the busiest host's bucket so
        # the collective geometry stays identical
        n_pad = quantum
        while n_pad < max(n, pad_min):
            n_pad *= 2
        packed, has_n = _pack_cores_u32(core_codes)
        codes_p = np.zeros((n_pad, 2), np.uint32)  # 2-bit packed cores
        codes_p[:n] = packed
        elig_p = np.zeros(n_pad, bool)  # pad/N rows device-ineligible
        elig_p[:n] = eligible & ~has_n
        sharding = NamedSharding(self._mesh, P_(READS_AXIS))
        codes_d = put_process_local(codes_p, sharding)
        elig_d = put_process_local(elig_p, sharding)
        if self._acc is None:
            self._acc = self._zero_acc()
        mbits, self._acc = self._match_fn()(
            codes_d, elig_d, self._bc_oh, self._acc
        )
        # int32 accumulator guard, mirroring DeviceCounter: the psum'd acc
        # absorbs n_pad rows PER PROCESS per dispatch; spill to the int64
        # host array before any barcode can reach 2^31. Lockstep-safe —
        # every host dispatches identical n_pad, so all hosts spill at
        # the same dispatch (the fetch itself is host-local, no collective)
        self._acc_rows += n_pad * jax.process_count()
        if self._acc_rows >= self._ACC_SPILL_ROWS:
            self._fetch_acc()
        # (n, matched-bits) + threaded accumulator: the DeviceCounter
        # drain contract
        return n, mbits

    def _drain_entry(self, entry) -> None:
        if jax.process_count() == 1:
            return super()._drain_entry(entry)
        # multi-host: the matched bits are row-sharded across processes —
        # this host unpacks only its addressable rows, which are exactly
        # its own reads (put_process_local row order); the count
        # accumulator is replicated and fetched once in drain()
        (n, mb_f), cores, eligible = entry
        matched = np.unpackbits(fetch_local_rows(mb_f))[:n].astype(bool)
        un = eligible & ~matched
        if un.any():
            uniq, counts = np.unique(cores[un], axis=0, return_counts=True)
            for row, cnt in zip(uniq, counts):
                seq = row.tobytes().decode("ascii", errors="replace").rstrip("\x00")
                self.undoc[seq + "*"] += int(cnt)
