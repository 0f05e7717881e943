"""TpuEngine: chunked, jitted genotyping over device tensors.

The device twin of ``svtyper_tpu.oracle.OracleEngine`` (reference
``classic.py::sv_genotype`` inner loop, SURVEY.md §3.1): the host
prepares padded chunk tensors (``evidence.extract``), one jitted XLA
program runs classification + GL (``evidence.device`` + ``ops.gl``),
and results come back as arrays that reconstruct per-sample
``GenotypeResult``s. Compilation is cached per padded shape bucket.

Float dtype: float64 when JAX x64 is enabled (CPU parity runs — the
golden tests), float32 otherwise (device throughput runs).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from svtyper_tpu.breakpoints import Breakpoint
from svtyper_tpu.evidence.device import classify_compact
from svtyper_tpu.evidence.extract import (
    COMPACT_KEYS,
    VARS_BOOL,
    compact_chunk,
    prepare_chunk,
    prepare_compact_chunk,
)
from svtyper_tpu.models.bayes import GT_STRINGS, GenotypeResult
from svtyper_tpu.ops.gl import genotype_batch, log_choose_table
from svtyper_tpu.stats.library import Sample

MAX_N_TABLE = 1 << 17  # log-choose table span; QR+QA beyond this clamps

def _repad_compact(c, r_pad: int, f_pad: int, n_var: int):
    """Grow compact matrices to common shard geometry. Padding rows:
    var = n_var (trash segment) and zero flags, so they contribute
    nothing regardless of the other fields."""
    def grow(m, pad, fill=0):
        if m.shape[1] == pad:
            return m
        out = np.full((m.shape[0], pad), fill, dtype=m.dtype)
        out[:, : m.shape[1]] = m
        return out

    out = dict(c)
    out["cr_u16"] = grow(c["cr_u16"], r_pad, n_var)
    out["cr_u8"] = grow(c["cr_u8"], r_pad)
    out["cp_u16"] = grow(c["cp_u16"], f_pad, n_var)
    out["cp_i32"] = grow(c["cp_i32"], f_pad)
    out["cp_u8"] = grow(c["cp_u8"], f_pad)
    return out


def pack_wire(packed, multi: bool = False):
    """Concatenate the compact matrices (extract.COMPACT_KEYS order)
    into one contiguous uint8 wire buffer (+ static geometry for the
    device-side unpack). With ``multi``, matrices carry a leading
    device axis and the wire is [D, nbytes] so shard_map splits it
    along 'data'."""
    mats = [np.ascontiguousarray(packed[k]) for k in COMPACT_KEYS]
    if multi:
        d = mats[0].shape[0]
        geom = tuple((m.dtype.str, m.shape[1:]) for m in mats)
        wire = np.concatenate(
            [m.reshape(d, -1).view(np.uint8) for m in mats], axis=1
        )
    else:
        geom = tuple((m.dtype.str, m.shape) for m in mats)
        wire = np.concatenate([m.reshape(-1).view(np.uint8) for m in mats])
    return wire, geom

# packed output layouts (one int32 matrix + one float matrix per chunk)
INT_FIELDS = (
    "null", "gt_idx", "gq", "qr", "qa", "dp", "ro", "ao",
    "rs", "as_", "asc", "rp", "ap", "ab_valid",
)
_I = {k: i for i, k in enumerate(INT_FIELDS)}
# float columns: gl0 gl1 gl2 sq ab c0..c4


class TpuEngine:
    def __init__(
        self,
        samples: List[Sample],
        min_aligned: int = 20,
        split_weight: float = 1.0,
        disc_weight: float = 1.0,
        max_reads: Optional[int] = None,
        max_ci_dist: float = 1e10,
        chunk_size: int = 1024,
        devices: Optional[list] = None,
        prep_workers: Optional[int] = None,
        force_shard: bool = False,
    ) -> None:
        self.samples = samples
        self.min_aligned = min_aligned
        self.split_weight = split_weight
        self.disc_weight = disc_weight
        self.max_reads = max_reads
        self.max_ci_dist = max_ci_dist
        # multi-device: shard each chunk's variants across the local
        # devices via shard_map (SURVEY.md §2.1); a single device keeps
        # the plain jit path. local_devices, not devices: under
        # jax.distributed each process drives only its own devices
        # (variant sharding across hosts is parallel/multihost)
        if devices is None:
            devices = jax.local_devices()
        self.devices = list(devices)
        self.n_dev = len(self.devices)
        # force_shard runs the shard_map program even on ONE device, so
        # the multi-device composition is testable with a single card
        self.sharded = self.n_dev > 1 or force_shard
        if self.sharded:
            chunk_size = -(-chunk_size // self.n_dev) * self.n_dev
            self.mesh = Mesh(np.asarray(self.devices), axis_names=("data",))
            # per-chunk arrays split along the mesh; tables replicate
            self._split = NamedSharding(self.mesh, P("data"))
            self._replicated = NamedSharding(self.mesh, P())
        else:
            self._split = self._replicated = self.devices[0]
        self.chunk_size = chunk_size
        self._use_f64 = jax.config.jax_enable_x64
        self.dtype = jnp.float64 if self._use_f64 else jnp.float32
        self._lcf = jax.device_put(
            log_choose_table(MAX_N_TABLE, use_f64=self._use_f64),
            self._replicated,
        )
        self._dens_cache: Dict[int, jax.Array] = {}
        self._step = self._build_step()
        self._hw_reads = 0
        self._hw_pairs = 0
        self._sample_pool = None  # lazy; multi-sample prep fan-out
        # -w evidence export: when set, called as sink(sample_idx, ev)
        # once per (chunk, sample) from the prep thread(s); ev is the
        # native chunk_evidence() tuple, or None when this chunk's prep
        # used a non-native path (caller falls back to a re-fetch)
        self.evidence_sink = None
        self._prep_workers = prep_workers  # None = env/auto
        # per-stage wall-time observability (SURVEY.md §5)
        self.stats = {
            "prep_s": 0.0,   # host: fetch + layout (prep thread)
            "send_s": 0.0,   # host→device transfer + dispatch enqueue
            "sync_s": 0.0,   # device execution exposed at the sync point
            "reads": 0,
            "pairs": 0,
            "chunks": 0,
            "variants": 0,
        }

    def _build_step(self):
        sw, dw = self.split_weight, self.disc_weight
        dtype = self.dtype

        def unwire(wire, geom):
            """One uint8 wire buffer → the seven packed matrices.
            ``geom`` is static (per shape bucket), so the slices and
            bitcasts are free at trace time and fuse into consumers;
            the host ships a single contiguous transfer per chunk."""
            parts = []
            off = 0
            for dt_str, shape in geom:
                dt = np.dtype(dt_str)
                nb = int(np.prod(shape)) * dt.itemsize
                seg = wire[off : off + nb]
                off += nb
                if dt.itemsize == 1:
                    arr = seg.reshape(shape)
                    if dt != np.uint8:
                        arr = jax.lax.bitcast_convert_type(arr, dt)
                else:
                    arr = jax.lax.bitcast_convert_type(
                        seg.reshape(shape + (dt.itemsize,)), dt
                    )
                parts.append(arr)
            return parts

        def step_wire(wire, dens, lcf, n_var, geom):
            return step(*unwire(wire, geom), dens, lcf, n_var)

        _ib = {name: i for i, name in enumerate(VARS_BOOL)}

        def step(cr16, cr8, cp16, cp32, cp8, v32, v8, dens, lcf, n_var):
            variants = {
                "is_dup": v8[_ib["is_dup"]].astype(bool),
                "force_null": v8[_ib["force_null"]].astype(bool),
            }
            counts = classify_compact(
                cr16, cr8, cp16, cp32, cp8, v32, v8, dens, n_var,
                dtype=dtype,
            )
            out = genotype_batch(
                counts,
                variants["is_dup"],
                variants["force_null"],
                lcf,
                split_weight=sw,
                disc_weight=dw,
            )
            # pack EVERYTHING into one [N, 24] float matrix: a single
            # device→host transfer per chunk. Integer fields are exact in
            # f32 up to 2^24 — far above any per-variant read count.
            ints = jnp.stack(
                [out[k].astype(dtype) for k in INT_FIELDS], axis=1
            )
            flts = jnp.concatenate(
                [
                    out["gl"],
                    out["sq"][:, None],
                    out["ab"][:, None],
                    out["counts"],
                ],
                axis=1,
            )
            return jnp.concatenate([ints, flts], axis=1)

        if self.sharded:
            n_shard = self.chunk_size // self.n_dev
            dspec = P("data")

            def sharded(wire, dens, lcf, geom):
                def local(w, d, l):
                    # shard_map blocks keep the leading device axis
                    return step_wire(w[0], d[0], l, n_shard, geom)[None]

                return jax.shard_map(
                    local,
                    mesh=self.mesh,
                    in_specs=(dspec, dspec, P()),
                    out_specs=dspec,
                )(wire, dens, lcf)

            return jax.jit(sharded, static_argnames=("geom",))
        return jax.jit(step_wire, static_argnames=("n_var", "geom"))

    def _dens_for(self, sample_idx: int) -> jax.Array:
        """The sample's insert-size density table on the device: one
        copy on the plain engine's device, or one per mesh device
        stacked along 'data' for the sharded step."""
        d = self._dens_cache.get(sample_idx)
        if d is None:
            m = self.samples[sample_idx].dens_matrix()
            # bucket the insert-size axis so dens shape doesn't drive
            # recompiles across samples
            w = 1024
            while w < m.shape[1]:
                w *= 2
            padded = np.zeros((max(m.shape[0], 1), w), dtype=self.dtype)
            if m.size:
                padded[: m.shape[0], : m.shape[1]] = m
            if self.sharded:
                padded = np.broadcast_to(
                    padded[None], (self.n_dev,) + padded.shape
                )
            d = jax.device_put(padded, self._split)
            self._dens_cache[sample_idx] = d
        return d

    def _put_wire(self, wire: np.ndarray) -> jax.Array:
        """Host→device copy of one chunk's wire buffer, already split
        along the mesh when sharded: each device receives only its own
        [1, nbytes] row, so the step needs no scatter between devices."""
        return jax.device_put(wire, self._split)

    def _prepare(self, bps: List[Optional[Breakpoint]]):
        """Host-only stage: fetch + layout for one chunk → per-sample
        ChunkInputs. Runs on a single prep thread (the native chunk
        arena is one-in-flight per BAM handle); the C++ decode inside
        releases the GIL and fans out over its own threads. The numpy
        predicate pass (``compact_chunk``) deliberately does NOT happen
        here — it runs in ``_send`` on the main thread, overlapping the
        GIL-free native fetch of the next chunk (prep was the pipeline
        ceiling; see BASELINE.md round-3 progression)."""
        t0 = time.time()
        n_real = len(bps)
        # constant chunk geometry: pad short chunks with absent variants
        # and reuse high-water read/pair buckets so recompiles stop once
        # the largest shapes have been seen
        if len(bps) < self.chunk_size:
            bps = list(bps) + [None] * (self.chunk_size - len(bps))
        # one stateless prep body per sample — plain or sharded — so
        # multi-sample runs fan out over the thread pool in BOTH device
        # modes (r3 only overlapped the single-device path; a 2-sample
        # multi-chip run prepped serially — VERDICT r3 Weak #5). Every
        # Sample owns its own BAM handle (separate native arena + block
        # cache) and the C++ decode drops the GIL, so per-sample
        # fetches overlap on multi-core hosts.
        prep_one = (
            self._prepare_sharded if self.sharded else self._prepare_sample
        )
        if len(self.samples) > 1:
            outs = list(
                self._get_sample_pool().map(
                    lambda t: prep_one(t[1], bps, t[0]),
                    enumerate(self.samples),
                )
            )
        else:
            outs = [prep_one(self.samples[0], bps, 0)]
        payloads = []
        for entry, n_ev, n_pair, r_w, p_w in outs:
            self._hw_reads = max(self._hw_reads, r_w)
            self._hw_pairs = max(self._hw_pairs, p_w)
            self.stats["reads"] += n_ev
            self.stats["pairs"] += n_pair
            payloads.append(entry)
        self.stats["prep_s"] += time.time() - t0
        self.stats["chunks"] += 1
        self.stats["variants"] += n_real
        return payloads

    def _prepare_sample(self, sample: Sample, bps, si: int = 0):
        """Stateless single-sample prep body → ``(payload_entry, n_ev,
        n_pair, r_width, p_width)``; the caller owns high-water /stats
        updates (keeps this safe to run concurrently per sample)."""
        res = prepare_compact_chunk(
            sample,
            bps,
            min_aligned=self.min_aligned,
            max_reads=self.max_reads,
            max_ci_dist=self.max_ci_dist,
            pad_reads=self._hw_reads,
            pad_pairs=self._hw_pairs,
        )
        if res is not None:
            compact, n_var, n_ev, n_pair = res
            if self.evidence_sink is not None:
                # pull the arena's kept-row records BEFORE the next
                # fetch on this handle overwrites them
                self.evidence_sink(si, sample.bam.chunk_evidence())
            return (
                (("compact", compact), n_var), n_ev, n_pair,
                compact["cr_u16"].shape[1], compact["cp_u16"].shape[1],
            )
        if self.evidence_sink is not None:
            self.evidence_sink(si, None)  # non-native prep: re-fetch
        chunk = prepare_chunk(
            sample,
            bps,
            min_aligned=self.min_aligned,
            max_reads=self.max_reads,
            max_ci_dist=self.max_ci_dist,
            pad_reads=self._hw_reads,
            pad_pairs=self._hw_pairs,
        )
        n_ev = int(np.count_nonzero(chunk.reads["var"] < chunk.n_var))
        n_pair = int(np.count_nonzero(chunk.pairs["var"] < chunk.n_var))
        return (
            (chunk, chunk.n_var), n_ev, n_pair,
            len(chunk.reads["var"]), len(chunk.pairs["var"]),
        )

    def _get_sample_pool(self):
        """Lazy multi-sample prep pool (SURVEY.md §3.1: the reference's
        classic.py gathers samples serially)."""
        from concurrent.futures import ThreadPoolExecutor

        if self._sample_pool is None:
            import os

            # auto-size against the decode fan-out: each concurrent
            # prep launches its sample's native decode threads, so the
            # two knobs must share the host, not each assume they own it
            dec = max(
                (getattr(s.bam, "_threads", 1) for s in self.samples),
                default=1,
            )
            workers = (
                self._prep_workers
                or int(os.environ.get("SVT_PREP_WORKERS", "0"))
                or max(
                    1,
                    min(
                        len(self.samples),
                        (os.cpu_count() or 2) // max(dec, 1),
                    ),
                )
            )
            self._sample_pool = ThreadPoolExecutor(max_workers=workers)
            # the pool must not outlive the engine: a long-lived process
            # constructing many engines would otherwise accumulate idle
            # worker threads (close() is the explicit path; the finalizer
            # covers engines that are simply dropped)
            import weakref

            self._pool_finalizer = weakref.finalize(
                self, self._sample_pool.shutdown, wait=False
            )
        return self._sample_pool

    def _prepare_sharded(self, sample: Sample, bps, si: int = 0):
        """Multi-chip prep: split the chunk's variants into ``n_dev``
        contiguous shards with identical pad geometry and stack them
        into rectangular [D, ...] arrays. Stateless like
        ``_prepare_sample`` (same return shape) so multi-sample runs
        can fan it out over the prep pool; the caller owns high-water
        and stats updates."""
        n_shard = self.chunk_size // self.n_dev
        shards = []
        ev_total = pair_total = 0
        ev_rows = [] if self.evidence_sink is not None else None
        widths = []
        for d in range(self.n_dev):
            shard_bps = bps[d * n_shard : (d + 1) * n_shard]
            res = prepare_compact_chunk(
                sample,
                shard_bps,
                min_aligned=self.min_aligned,
                max_reads=self.max_reads,
                max_ci_dist=self.max_ci_dist,
                pad_reads=self._hw_reads,
                pad_pairs=self._hw_pairs,
            )
            if res is not None:
                compact, n_var, n_ev, n_pair = res
                if ev_rows is not None:
                    ev_rows.append(sample.bam.chunk_evidence())
                shards.append((compact, n_var))
                widths.append(
                    (compact["cr_u16"].shape[1], compact["cp_u16"].shape[1])
                )
                ev_total += n_ev
                pair_total += n_pair
                continue
            chunk = prepare_chunk(
                sample,
                shard_bps,
                min_aligned=self.min_aligned,
                max_reads=self.max_reads,
                max_ci_dist=self.max_ci_dist,
                pad_reads=self._hw_reads,
                pad_pairs=self._hw_pairs,
            )
            if ev_rows is not None:
                ev_rows = None  # non-native shard: whole chunk re-fetches
            shards.append(chunk)
            widths.append(
                (len(chunk.reads["var"]), len(chunk.pairs["var"]))
            )
            ev_total += int(
                np.count_nonzero(chunk.reads["var"] < chunk.n_var)
            )
            pair_total += int(
                np.count_nonzero(chunk.pairs["var"] < chunk.n_var)
            )
        r_pad = max(w[0] for w in widths)
        f_pad = max(w[1] for w in widths)
        if self.evidence_sink is not None:
            if ev_rows is not None and all(e is not None for e in ev_rows):
                self.evidence_sink(
                    si,
                    tuple(
                        np.concatenate([e[k] for e in ev_rows])
                        for k in range(5)
                    ),
                )
            else:
                self.evidence_sink(si, None)
        # compact + stack happens in _send (same overlap rationale as
        # the single-device path)
        return (
            (((shards, r_pad, f_pad), None)),
            ev_total, pair_total, r_pad, f_pad,
        )

    def _step_args(self, si: int, payload, n_var):
        """One sample's prepared chunk → the step's (args, static
        kwargs). The seven packed matrices ship as ONE contiguous uint8
        wire buffer (a single transfer; the jitted step slices and
        bitcasts them back at trace time for free)."""
        if self.sharded:
            shards, r_pad, f_pad = payload
            compacts = [
                _repad_compact(
                    c[0] if isinstance(c, tuple)
                    else compact_chunk(c, self.min_aligned),
                    r_pad, f_pad,
                    c[1] if isinstance(c, tuple) else c.n_var,
                )
                for c in shards
            ]
            packed = {
                k: np.stack([p[k] for p in compacts]) for k in COMPACT_KEYS
            }
        elif isinstance(payload, tuple) and payload[0] == "compact":
            packed = payload[1]
        else:
            packed = compact_chunk(payload, self.min_aligned)
        wire, geom = pack_wire(packed, multi=self.sharded)
        args = (self._put_wire(wire), self._dens_for(si), self._lcf)
        if self.sharded:
            return args, {"geom": geom}
        return args, {"n_var": n_var, "geom": geom}

    def _send(self, payloads):
        """Device stage: host→device transfer + async step dispatch
        (no sync). Runs on the main thread — the device execution
        itself is asynchronous, so chunk k computes while chunk k+1
        preps and chunk k-1 collects."""
        t0 = time.time()
        arrs = []
        for si, (payload, n_var) in enumerate(payloads):
            args, kwargs = self._step_args(si, payload, n_var)
            arrs.append(self._step(*args, **kwargs))
        self.stats["send_s"] += time.time() - t0
        return arrs

    def compile_step(self, bps: List[Optional[Breakpoint]]):
        """The compiled device program for one chunk of ``bps`` (first
        sample's shapes), for inspection: ``memory_analysis()``,
        ``as_text()``. Preps the chunk on the host; runs nothing."""
        payload, n_var = self._prepare(bps)[0]
        args, kwargs = self._step_args(0, payload, n_var)
        return self._step.lower(*args, **kwargs).compile()

    def _dispatch(self, bps: List[Optional[Breakpoint]]):
        """Prep + send for one chunk (the synchronous entry point)."""
        return self._send(self._prepare(bps))

    def _collect(
        self, n_bps: int, arrs, raw: bool = False
    ) -> List[List[GenotypeResult]]:
        t0 = time.time()
        per_sample = [np.asarray(a) for a in arrs]  # sync point
        if self.sharded:
            # [D, n_shard, 24] → [chunk_size, 24] (shards are contiguous
            # variant slices, so a plain reshape restores input order)
            per_sample = [
                a.reshape(-1, a.shape[-1]) for a in per_sample
            ]
        self.stats["sync_s"] += time.time() - t0
        if raw:
            # vectorized-emission path (cli fast_emit): hand back the
            # packed [chunk, 24] matrices — one per sample — without
            # exploding them into per-variant Python objects
            return n_bps, per_sample
        return [
            [_to_result(ps, vi) for ps in per_sample]
            for vi in range(n_bps)
        ]

    def close(self) -> None:
        """Release host-side resources (the multi-sample prep pool).
        Idempotent; the engine remains usable for single-sample work
        afterwards (the pool is rebuilt lazily if needed)."""
        if self._sample_pool is not None:
            self._sample_pool.shutdown(wait=False)
            self._sample_pool = None

    def __enter__(self) -> "TpuEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def genotype_chunk(
        self, bps: List[Optional[Breakpoint]]
    ) -> List[List[GenotypeResult]]:
        """→ results[variant][sample], matching OracleEngine layout."""
        return self._collect(len(bps), self._dispatch(bps))

    def genotype_stream(self, bps_iter, raw: bool = False):
        """Streaming form of :meth:`genotype_all`: consume an ITERABLE
        of breakpoints lazily and yield one chunk's worth of
        ``results[variant][sample]`` lists at a time, keeping host RSS
        flat over arbitrarily long variant streams (SURVEY.md §5 scale
        axis = variant count). Same three-stage pipeline: a prep thread
        runs fetch+layout for chunk k+1 while the main thread
        transfers/dispatches chunk k (async on device) and a collector
        thread syncs + unpacks chunk k-1; in-flight device chunks are
        bounded, so device buffers stay O(1).

        ``raw=True`` yields ``(n_real, [per-sample [chunk, 24] array])``
        per chunk instead of GenotypeResult lists — the CLI's
        vectorized formatter consumes these directly (see
        ``svtyper_tpu.fast_emit``; VERDICT r4 item 1)."""
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor
        from itertools import islice

        it = iter(bps_iter)
        with ThreadPoolExecutor(max_workers=1) as prep_pool, \
                ThreadPoolExecutor(max_workers=1) as collect_pool:
            preps: deque = deque()
            collects: deque = deque()
            done = False

            def pump():
                nonlocal done
                while not done and len(preps) < 2:
                    chunk = list(islice(it, self.chunk_size))
                    if not chunk:
                        done = True
                        return
                    preps.append(
                        (len(chunk), prep_pool.submit(self._prepare, chunk))
                    )

            pump()
            while preps:
                n_real, f = preps.popleft()
                payloads = f.result()
                pump()
                arrs = self._send(payloads)
                collects.append(
                    collect_pool.submit(self._collect, n_real, arrs, raw)
                )
                while len(collects) >= 3:
                    yield collects.popleft().result()
            while collects:
                yield collects.popleft().result()

    def genotype_all(
        self, bps: List[Optional[Breakpoint]]
    ) -> List[List[GenotypeResult]]:
        """Pipelined genotyping of a full list (see
        :meth:`genotype_stream`); accumulates every chunk's results —
        use the stream form for million-variant runs."""
        results: List[List[GenotypeResult]] = []
        for chunk_results in self.genotype_stream(bps):
            results.extend(chunk_results)
        return results


_NI = len(INT_FIELDS)
ROW_WIDTH = _NI + 10  # int fields + (gl0 gl1 gl2 sq ab c0..c4)


def result_to_row(r: Optional[GenotypeResult]) -> np.ndarray:
    """Inverse of ``_to_result``: fixed-width float64 row for the
    cross-host gather (parallel/multihost). None encodes as null."""
    row = np.zeros(ROW_WIDTH, dtype=np.float64)
    if r is None:
        row[_I["null"]] = 1.0
        return row
    row[_I["qr"]], row[_I["qa"]] = r.qr, r.qa
    if r.counts is not None:
        row[_NI + 5 : _NI + 10] = r.counts
    if r.null:
        row[_I["null"]] = 1.0
        return row
    row[_I["gt_idx"]] = r.gt_idx
    row[_I["gq"]] = r.gq
    row[_NI + 0 : _NI + 3] = r.gl
    row[_NI + 3] = r.sq
    if r.ab is not None:
        row[_I["ab_valid"]] = 1.0
        row[_NI + 4] = r.ab
    return row


def row_to_result(row: np.ndarray) -> GenotypeResult:
    """Decode one fixed-width row (see ``result_to_row``)."""
    return _to_result(row[None], 0)


def _to_result(packed: np.ndarray, i: int) -> GenotypeResult:
    row = packed[i]
    row_f = row[_NI:]
    r = GenotypeResult()
    r.counts = tuple(float(x) for x in row_f[5:10])
    r.qr = int(row[_I["qr"]])
    r.qa = int(row[_I["qa"]])
    if row[_I["null"]]:
        return r
    r.null = False
    r.gt_idx = int(row[_I["gt_idx"]])
    r.gt_string = GT_STRINGS[r.gt_idx]
    r.gl = [float(row_f[0]), float(row_f[1]), float(row_f[2])]
    r.gq = int(row[_I["gq"]])
    r.sq = float(row_f[3])
    r.ab = float(row_f[4]) if row[_I["ab_valid"]] else None
    return r
