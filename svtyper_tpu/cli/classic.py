"""The ``svtyper`` command line (parity of ``classic.py::main/sv_genotype``,
SURVEY.md §2.2–2.3).

Flag surface per SPEC.md/SURVEY §2.3; the engine is chunked-batched on
device instead of the reference's serial per-variant loop, but the output
contract (§2.4) is unchanged.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time
from typing import IO, List, Optional

from svtyper_tpu.bamio.bam import open_bam
from svtyper_tpu.breakpoints import BndRegistry
from svtyper_tpu.output import add_format_headers, apply_variant
from svtyper_tpu.stats import Sample
from svtyper_tpu.vcfio.model import Variant, Vcf
from svtyper_tpu.vcfio.reader import read_vcf_lines
from svtyper_tpu.version import __version__


def open_vcf_input(path):
    """-i input opener shared by both CLIs: .vcf.gz inputs (LUMPY
    outputs are often bgzip-compressed in pipelines) go through
    gzip.open, which handles plain gzip AND bgzip members; the
    streaming re-read path rewinds either like any seekable file."""
    if path.endswith(".gz"):
        import gzip

        return gzip.open(path, "rt")
    return open(path)


def get_args(argv=None):
    p = argparse.ArgumentParser(
        prog="svtyper",
        description="Compute genotype of structural variants based on breakpoint depth",
    )
    p.add_argument("--version", action="version",
                   version="%%(prog)s %s" % __version__)
    p.add_argument("-i", "--input_vcf", default=None,
                   help="VCF input (default: stdin)")
    p.add_argument("-o", "--output_vcf", default=None,
                   help="output VCF to write (default: stdout)")
    p.add_argument("-B", "--bam", required=True,
                   help="BAM file(s), comma-separated if genotyping multiple samples")
    p.add_argument("-T", "--ref_fasta", default=None,
                   help="reference FASTA (optional: CRAM genotyping "
                        "decodes CIGAR from read features without it; "
                        "providing it restores full SEQ/QUAL in -w "
                        "output from CRAM)")
    p.add_argument("-l", "--lib_info", default=None,
                   help="create/read JSON file of library information")
    p.add_argument("-m", "--min_aligned", type=int, default=20,
                   help="minimum number of aligned bases to consider read as evidence [20]")
    p.add_argument("-n", dest="num_samp", type=int, default=1000000,
                   help="number of reads to sample from BAM file for building insert size distribution [1000000]")
    p.add_argument("-q", "--sum_quals", action="store_true",
                   help="add genotyping quality to existing QUAL (default: overwrite QUAL field)")
    p.add_argument("--split_weight", type=float, default=1.0,
                   help="weight for split reads [1]")
    p.add_argument("--disc_weight", type=float, default=1.0,
                   help="weight for discordant paired-end reads [1]")
    p.add_argument("--max_reads", type=int, default=None,
                   help="maximum number of reads to assess at any variant (reduces processing time in high-depth regions) [unlimited]")
    p.add_argument("--max_ci_dist", type=float, default=1e10,
                   help="maximum size of a confidence interval before 0/0 genotype [1e10]")
    p.add_argument("-w", "--write_alignment", default=None,
                   help="write relevant reads to BAM file (CRAM inputs "
                        "emit full SEQ/QUAL when -T provides the "
                        "reference FASTA; seq-less '*' records "
                        "otherwise)")
    p.add_argument("--debug", action="store_true", help="debugging verbosity")
    p.add_argument("--verbose", action="store_true", help="progress logging")
    # framework extensions (not in the reference)
    p.add_argument("--engine", choices=("tpu", "oracle"), default="tpu",
                   help="genotyping engine: batched device pipeline or the float64 per-read oracle [tpu]")
    p.add_argument("--batch_size", type=int, default=1024,
                   help="variants per device chunk [1024]")
    p.add_argument("--cores", type=int, default=None,
                   help="host-side prep threads (default: auto)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a jax.profiler trace of the run to DIR")
    p.add_argument("--checkpoint_dir", default=None, metavar="DIR",
                   help="spill each genotyped chunk to DIR and resume a killed "
                        "run at chunk granularity (same input + batch_size)")
    p.add_argument("--num_shards", type=int, default=1,
                   help="split the variant set into N contiguous shards "
                        "(multi-host data parallelism; each shard emits only "
                        "its slice, concatenate shard outputs in order)")
    p.add_argument("--shard_index", type=int, default=0,
                   help="which shard this process genotypes [0]")
    return p.parse_args(argv)


def sv_genotype(
    bam_string: str,
    vcf_in: IO[str],
    vcf_out: IO[str],
    min_aligned: int = 20,
    split_weight: float = 1.0,
    disc_weight: float = 1.0,
    num_samp: int = 1_000_000,
    lib_info_path: Optional[str] = None,
    debug: bool = False,
    alignment_outpath: Optional[str] = None,
    ref_fasta: Optional[str] = None,
    sum_quals: bool = False,
    max_reads: Optional[int] = None,
    max_ci_dist: float = 1e10,
    engine_kind: str = "tpu",
    batch_size: int = 1024,
    verbose: bool = False,
    checkpoint_dir: Optional[str] = None,
    num_shards: int = 1,
    shard_index: int = 0,
    cores: Optional[int] = None,
) -> None:
    """Library entry point (parity of ``classic.py::sv_genotype``)."""
    t0 = time.time()
    # multi-host bootstrap (SURVEY.md §5 comm backend): env-driven
    # jax.distributed — one process per host, host i genotypes the
    # contiguous slice shard_slices(n, P)[i], fixed-width result rows
    # are allgathered over DCN, host 0 formats + writes the single VCF.
    # Must run before any other jax use in this process.
    from svtyper_tpu.parallel.multihost import (
        allgather_rows,
        initialize_from_env,
        shard_slices,
    )

    dist_coord = os.environ.get("SVT_DIST_COORD")
    dist_nprocs = os.environ.get("SVT_DIST_NPROCS")
    if dist_coord and dist_nprocs:
        proc_id, n_procs = initialize_from_env(
            dist_coord, int(dist_nprocs),
            int(os.environ.get("SVT_DIST_PROCID", "0")),
        )
        if num_shards != 1:
            raise ValueError(
                "--num_shards is manual sharding; incompatible with "
                "SVT_DIST_* automatic multihost mode"
            )
    else:
        proc_id, n_procs = 0, 1
    bam_paths = [b for b in bam_string.split(",") if b]
    # --cores drives the native decoder's per-fetch thread fan-out (the
    # role of the reference sso's fork pool: host-side parallelism)
    bams = [open_bam(p, threads=cores, ref_fasta=ref_fasta)
            for p in bam_paths]

    # Samples: JSON cache if it exists, else head-scan (then save cache)
    samples: List[Sample] = []
    if lib_info_path and os.path.exists(lib_info_path):
        info = Sample.load_lib_info(lib_info_path)
        for bam in bams:
            samples.append(Sample.from_lib_info(bam, info))
    else:
        for bam in bams:
            samples.append(Sample.from_bam(bam, num_samp=num_samp))
        if lib_info_path:
            Sample.save_lib_info(samples, lib_info_path)
    if verbose:
        sys.stderr.write(
            "svtyper-tpu %s: %d sample(s) ready in %.1fs\n"
            % (__version__, len(samples), time.time() - t0)
        )

    if engine_kind == "oracle":
        from svtyper_tpu.oracle import OracleEngine

        engine = OracleEngine(
            samples, min_aligned=min_aligned, split_weight=split_weight,
            disc_weight=disc_weight, max_reads=max_reads,
            max_ci_dist=max_ci_dist,
        )

        def run_chunk(bps):
            return [engine.genotype_variant(bp) if bp is not None
                    else [None] * len(samples) for bp in bps]
    else:
        # persistent XLA compile cache: without it every CLI run
        # compiles each shape bucket anew
        from svtyper_tpu.utils.compile_cache import enable_compile_cache

        enable_compile_cache()
        from svtyper_tpu.gt import TpuEngine

        engine = TpuEngine(
            samples, min_aligned=min_aligned, split_weight=split_weight,
            disc_weight=disc_weight, max_reads=max_reads,
            max_ci_dist=max_ci_dist, chunk_size=batch_size,
            prep_workers=cores,
        )
        if engine.chunk_size != batch_size:
            # multi-device engines round the chunk size up to a device
            # multiple; aligning the CLI's chunking to it keeps plan
            # chunks 1:1 with engine chunks, so the vectorized emission
            # and the -w engine-export arena stay engaged on sharded
            # runs (the effective value is what the checkpoint manifest
            # records — a resume under a different device count would
            # otherwise replay mismatched chunk boundaries)
            sys.stderr.write(
                "note: batch size %d rounded to %d (device multiple)\n"
                % (batch_size, engine.chunk_size)
            )
            batch_size = engine.chunk_size

        def run_chunk(bps):
            return engine.genotype_chunk(bps)

    # the body start for get_body() re-streams must be the stream's
    # CURRENT position, not byte 0 — a library caller may hand us a
    # handle positioned past a prefix (review, r5)
    try:
        _body_origin = vcf_in.tell()
    except (OSError, ValueError, AttributeError):
        _body_origin = None
    header_lines, body = read_vcf_lines(vcf_in)
    vcf = Vcf()
    vcf.add_header(header_lines)
    add_format_headers(vcf)
    sample_names = [s.name for s in samples]
    for name in sample_names:
        vcf.add_sample(name)

    # Streaming pre-scan (SURVEY.md §5 scale axis; VERDICT r4 item 4):
    # ONE pass over the body computes the record count, the checkpoint
    # manifest's content hash, and the BND-only line subset the mate
    # registry needs (it must see mates that appear after the current
    # record). Seekable inputs are then RE-STREAMED lazily per
    # consumer instead of materialized, so CLI host RSS stays flat
    # over million-variant VCFs; a pipe (stdin) still buffers.
    import hashlib
    import itertools

    vcf_sha = hashlib.sha256()
    for line in header_lines:
        vcf_sha.update(line.encode())
        vcf_sha.update(b"\n")
    vcf_sha.update(b"--\n")
    bnd_lines: List[str] = []
    n_records = 0

    def _prescan(lines):
        # ONE loop shared by both branches: the hash scheme must stay
        # byte-identical to checkpoint.build_manifest or manifests stop
        # matching across code paths (review, r5)
        nonlocal n_records
        for line in lines:
            n_records += 1
            vcf_sha.update(line.encode())
            vcf_sha.update(b"\n")
            if "SVTYPE=BND" in line:
                bnd_lines.append(line)

    try:
        seekable = _body_origin is not None and vcf_in.seekable()
    except Exception:
        seekable = False
    if seekable:
        _prescan(body)

        def get_body():
            vcf_in.seek(_body_origin)
            return read_vcf_lines(vcf_in)[1]
    else:
        _buf = list(body)
        _prescan(_buf)

        def get_body():
            return iter(_buf)

    # the registry only reads BND records; feeding it the filtered
    # subset preserves relative input order (its primary-anchor
    # tie-break), so resolution is identical to a full-body scan
    registry = BndRegistry()
    registry.scan(bnd_lines)

    # checkpoint manifest guard: replay is keyed by chunk index, so the
    # directory must be bound to THIS input + flag tuple — a mismatch
    # (different VCF/BAM/flags) refuses instead of silently emitting
    # stale genotypes (cli/checkpoint.py)
    from svtyper_tpu.cli.checkpoint import CrashInjector

    crash = CrashInjector()
    if checkpoint_dir:
        import json

        from svtyper_tpu.cli.checkpoint import (
            build_manifest_hashed,
            ensure_manifest,
        )

        lib_sha = hashlib.sha256(
            json.dumps(
                [s.to_json_obj() for s in samples], sort_keys=True
            ).encode()
        ).hexdigest()
        ensure_manifest(
            checkpoint_dir,
            build_manifest_hashed(
                bam_paths, vcf_sha.hexdigest(), n_records,
                flags={
                    "min_aligned": min_aligned,
                    "split_weight": split_weight,
                    "disc_weight": disc_weight,
                    "sum_quals": sum_quals,
                    "max_reads": max_reads,
                    "max_ci_dist": max_ci_dist,
                    "batch_size": batch_size,
                    "num_shards": num_shards,
                    "shard_index": shard_index,
                    "n_procs": n_procs,
                    # engines are byte-identical on the f64 parity
                    # config but may differ at format-rounding
                    # boundaries in f32 — never mix their chunks
                    "engine": engine_kind,
                    "lib_stats_sha256": lib_sha,
                },
            ),
        )

    if n_procs > 1:
        # phase 1 (every process): genotype this host's contiguous
        # variant slice; ship fixed-width rows through the collective
        import numpy as np

        from svtyper_tpu.gt.engine import (
            ROW_WIDTH,
            result_to_row,
            row_to_result,
        )
        from svtyper_tpu.cli.checkpoint import (
            load_rows,
            rows_part_path,
            save_rows,
        )

        slices = shard_slices(n_records, n_procs)
        lo, hi = slices[proc_id]
        rounds_per_host = [
            -(-(s1 - s0) // batch_size) if s1 > s0 else 0
            for (s0, s1) in slices
        ]
        max_rounds = max(rounds_per_host) if rounds_per_host else 0
        body_p1 = itertools.islice(get_body(), lo, hi)

        def slice_plans():
            # per-chunk row spill (pre-gather): a restarted shard
            # replays completed chunks from disk and recomputes only
            # the remainder, so the allgathered row stream stays
            # synchronized across hosts (SURVEY.md §5 checkpoint row)
            for c0 in range(lo, hi, batch_size):
                k = min(c0 + batch_size, hi) - c0
                part = (
                    rows_part_path(checkpoint_dir, proc_id, c0)
                    if checkpoint_dir else None
                )
                cached = load_rows(part) if part else None
                if cached is not None:
                    for _ in itertools.islice(body_p1, k):
                        pass  # advance the stream past the cached chunk
                    yield None, cached, part
                    continue
                chunk_vars = [
                    Variant(line, vcf)
                    for line in itertools.islice(body_p1, k)
                ]
                # registry.resolve gives BOTH mates of a BND pair the
                # same anchor breakpoint, so hosts compute identical
                # rows even when a pair straddles a shard boundary
                yield [registry.resolve(v) for v in chunk_vars], None, part

        def encode_rows(res):
            arr = np.zeros(
                (len(res), len(sample_names), ROW_WIDTH), dtype=np.float64
            )
            for j, row in enumerate(res):
                for s, r in enumerate(row):
                    arr[j, s] = result_to_row(r)
            return arr

        # Bounded gather (VERDICT r4 item 4): ONE collective per chunk
        # round instead of a single whole-slice allgather — no host
        # ever holds more than one round of foreign rows in memory.
        # Host 0 spills each gathered round to disk and streams it back
        # in phase 2; hosts that run out of chunks keep participating
        # with empty arrays so the collective count matches everywhere.
        import tempfile

        gather_dir = (
            tempfile.mkdtemp(prefix="svt_gather_") if proc_id == 0 else None
        )
        _round = [0]
        empty_rows = np.zeros(
            (0, len(sample_names), ROW_WIDTH), np.float64
        )

        def gather_round(arr):
            shards_r = allgather_rows(arr)
            if proc_id == 0:
                for h, rows_h in enumerate(shards_r):
                    np.save(
                        os.path.join(
                            gather_dir,
                            "g_h%03d_r%06d.npy" % (h, _round[0]),
                        ),
                        rows_h,
                    )
            _round[0] += 1

        if engine_kind == "tpu":
            # pipelined drive (same rationale as the single-host stream
            # below): feed every to-compute chunk through
            # genotype_stream and encode rows as they surface
            plans_feed, plans_fmt = itertools.tee(slice_plans())

            def feed():
                for bps_chunk, cached, _p in plans_feed:
                    if cached is None:
                        yield from bps_chunk

            flat = (
                row
                for cr in engine.genotype_stream(feed())
                for row in cr
            )
            for bps_chunk, cached, part in plans_fmt:
                if cached is None:
                    res = [next(flat) for _ in range(len(bps_chunk))]
                    cached = encode_rows(res)
                    if part:
                        save_rows(part, cached)
                gather_round(cached)
                crash.chunk_done()
        else:
            for bps_chunk, cached, part in slice_plans():
                if cached is None:
                    cached = encode_rows(run_chunk(bps_chunk))
                    if part:
                        save_rows(part, cached)
                gather_round(cached)
                crash.chunk_done()
        for _ in range(_round[0], max_rounds):
            gather_round(empty_rows)
        if verbose:
            sys.stderr.write(
                "host %d/%d: genotyped slice [%d:%d) in %d gather "
                "rounds\n" % (proc_id, n_procs, lo, hi, _round[0])
            )
        if proc_id != 0:
            return  # host 0 owns formatting + the single ordered write

        # phase 2 (host 0 only): replay the ordinary formatting pipeline
        # (BND mate sharing, QUAL aggregation, FORMAT emission) over the
        # full record stream with genotyping replaced by a bounded
        # streaming read of the gathered rows. Host-major file order ==
        # global input order (slices are contiguous and ordered), which
        # is exactly what merge_ordered asserted for the in-memory path.
        class _RowReader:
            def __init__(self, paths):
                self._paths = iter(paths)
                self._cur = None
                self._off = 0

            def take(self, k):
                parts = []
                need = k
                while need > 0:
                    if self._cur is None or self._off >= len(self._cur):
                        self._cur = np.load(next(self._paths))
                        self._off = 0
                        continue
                    t = min(need, len(self._cur) - self._off)
                    parts.append(self._cur[self._off : self._off + t])
                    self._off += t
                    need -= t
                if not parts:
                    return empty_rows
                return (
                    parts[0] if len(parts) == 1
                    else np.concatenate(parts, axis=0)
                )

        _reader = _RowReader(
            [
                os.path.join(gather_dir, "g_h%03d_r%06d.npy" % (h, r))
                for h in range(n_procs)
                for r in range(max_rounds)
            ]
        )

        def run_chunk(bps_chunk, _rd=_reader):
            rows = _rd.take(len(bps_chunk))
            return [
                [
                    row_to_result(rows[j, s])
                    for s in range(len(sample_names))
                ]
                for j in range(len(bps_chunk))
            ]

        # flush()'s checkpoint replay skips run_chunk for a finished
        # chunk; the row cursor must still advance past that chunk's
        # rows or every later variant reads an earlier variant's row
        # (review finding, r4 — silent wrong-output class)
        run_chunk.skip_rows = lambda n, _rd=_reader: _rd.take(n)

    if shard_index == 0:
        # shards >0 emit body-only so that `cat shard0 shard1 ...` is
        # byte-identical to the single-process output
        vcf_out.write(vcf.get_header())

    writer_bams = None
    evidence_streamed = False
    if alignment_outpath:
        from svtyper_tpu.cli.write_alignment import EvidenceWriter

        writer_bams = EvidenceWriter(alignment_outpath, samples)
        # engine-export fast path: the native chunk fetch records every
        # kept row's location during genotyping prep, so -w costs no
        # second decode pass (falls back to the batched re-fetch when
        # any sample lacks native support — CRAM, pure-Python — or in
        # multihost mode); batch_size was aligned to the engine's
        # device-rounded chunk size at construction, keeping the
        # writer's per-chunk flag FIFO 1:1 with the CLI's chunk plans
        fallback_why = None
        if engine_kind != "tpu":
            fallback_why = "oracle engine has no decode arena"
        elif n_procs != 1:
            fallback_why = "multihost run (per-host arenas not merged)"
        # (batch_size was aligned to engine.chunk_size at engine
        # construction, so chunk-rounding can no longer disengage -w)
        if fallback_why is None:
            toggles = [
                getattr(s.bam, "set_evidence_export", lambda v: False)
                for s in samples
            ]
            enabled = [t(True) for t in toggles]
            if all(enabled):
                engine.evidence_sink = writer_bams.push_native
                evidence_streamed = True
            else:
                # mixed support (e.g. BAM + CRAM): roll back so no
                # handle records rows nobody will export
                for t, on in zip(toggles, enabled):
                    if on:
                        t(False)
                fallback_why = (
                    "input(s) without native evidence export (CRAM or "
                    "pure-Python decode)"
                )
        if fallback_why is not None:
            # the arena path costs no second decode; the re-fetch path
            # re-reads every evidence window — never degrade silently
            # (VERDICT r4 Weak #5)
            sys.stderr.write(
                "note: -w using the batched re-fetch path (%s); "
                "expect roughly one extra read pass over the evidence "
                "windows\n" % fallback_why
            )

    n_done = 0
    chunk_idx = 0
    t_gt = time.time()
    t_first_chunk = [None]  # wall time when the first chunk emitted
    pending: List[Variant] = []
    # BND mate pairing (SPEC.md §2, §8.8): each breakend event is
    # genotyped ONCE — at the first-arriving record's slot, with the
    # registry's shared anchor breakpoint — and the result row is
    # copied to the mate when it appears (records stay in input order;
    # unpaired breakends are genotyped independently)
    bnd_results: dict = {}
    bnd_computed: set = set()

    def part_path():
        """Per-chunk checkpoint part file; advances the chunk counter.
        SINGLE SOURCE for part naming + counter + replay side effects —
        the serial flush() drive and the streaming plan/emit drive both
        go through here (a diverged copy caused the r4 phase-2 cursor
        bug)."""
        nonlocal chunk_idx
        if not checkpoint_dir:
            return None
        path = os.path.join(
            checkpoint_dir, "part_%06d.vcfpart" % chunk_idx
        )
        chunk_idx += 1
        return path

    def replay_part(path, vars_):
        """Emit a finished chunk's spilled lines; advance every piece
        of per-chunk state a computed chunk would have advanced —
        including the -w evidence collection, which a replayed chunk
        must re-fetch (the engine never sees its reads)."""
        nonlocal n_done
        with open(path) as fh:
            for line in fh:
                vcf_out.write(line)
        if writer_bams is not None:
            # plain resolve (no bnd_computed mutation): mates share the
            # anchor breakpoint and close() dedups by voffset
            writer_bams.add_batch([registry.resolve(v) for v in vars_])
        # phase-2 multihost replay: the gathered-row cursor must
        # advance past the replayed chunk's rows
        skip = getattr(run_chunk, "skip_rows", None)
        if skip is not None:
            skip(len(vars_))
        n_done += len(vars_)
        crash.chunk_done()

    def plan_chunk(vars_):
        """bps + run_bps for one chunk (run order = feed order): the
        second record of an already-computed breakend event gets
        ``run_bps[i] = None`` — its row is copied from the mate at
        emission."""
        bps = [registry.resolve(v) for v in vars_]
        for v, bp in zip(vars_, bps):
            if bp is None:
                sys.stderr.write(
                    "Warning: skipping variant %s, SVTYPE %s not supported\n"
                    % (v.var_id, v.get_info("SVTYPE"))
                )
        run_bps = list(bps)
        for i, (v, bp) in enumerate(zip(vars_, bps)):
            if bp is not None and bp.svtype == "BND":
                mate_id = v.get_info("MATEID")
                if mate_id and mate_id in bnd_computed:
                    run_bps[i] = None
                else:
                    bnd_computed.add(v.var_id)
        return bps, run_bps

    def emit_tail(vars_, bps, out_lines, part):
        """Shared per-chunk epilogue (-w collection, output write, part
        spill, progress) for the object and vectorized formatters."""
        nonlocal n_done
        if writer_bams is not None:
            if evidence_streamed:
                wide = [
                    bp for bp in bps
                    if bp is not None and bp.ci_width() > max_ci_dist
                ]
                writer_bams.finish_chunk(bps, wide)
            else:
                # one batched fetch per chunk (rides the block cache
                # the genotyping pass just warmed) — not per variant
                writer_bams.add_batch(bps)
        vcf_out.writelines(out_lines)
        if part is not None:
            tmp = part + ".tmp"
            with open(tmp, "w") as fh:
                fh.writelines(out_lines)
            os.replace(tmp, part)
        n_done += len(vars_)
        if t_first_chunk[0] is None:
            # one-time device program load/compile dominates the first
            # chunk on a fresh process; recording its boundary lets the
            # bench report steady-state CLI throughput honestly
            t_first_chunk[0] = time.time()
        crash.chunk_done()
        if verbose:
            dt = time.time() - t_gt
            sys.stderr.write(
                "genotyped %d variants (%.1f variants/s)\n"
                % (n_done, n_done / dt if dt > 0 else 0.0)
            )

    def emit_chunk(vars_, bps, rows, part):
        """Format + write one genotyped chunk (BND mate sharing, QUAL
        aggregation, -w collection, part spill, progress)."""
        out_lines: List[str] = []
        for v, bp, res_row in zip(vars_, bps, rows):
            if bp is None:
                out_lines.append(v.get_var_string() + "\n")
                continue
            if bp.svtype == "BND":
                mate_id = v.get_info("MATEID")
                if mate_id and mate_id in bnd_results:
                    res_row = bnd_results.pop(mate_id)
                    bnd_computed.discard(mate_id)
                elif mate_id and registry.mate_known(v.var_id):
                    bnd_results[v.var_id] = res_row
            apply_variant(v, sample_names, res_row, sum_quals=sum_quals)
            if debug:
                for name, res in zip(sample_names, res_row):
                    sys.stderr.write(
                        "%s %s counts=%s QR=%s QA=%s GT=%s\n"
                        % (v.var_id, name, res.counts, res.qr, res.qa,
                           res.gt_string)
                    )
            out_lines.append(v.get_var_string() + "\n")
        emit_tail(vars_, bps, out_lines, part)

    def flush():
        if not pending:
            return
        # chunk checkpoint/resume (SURVEY.md §5): a completed chunk's
        # formatted lines are spilled to a part file; a rerun with the
        # same input and batch_size replays them without re-genotyping
        part = part_path()
        if part is not None and os.path.exists(part):
            replay_part(part, pending)
            pending.clear()
            return
        bps, run_bps = plan_chunk(pending)
        rows = run_chunk(run_bps)
        emit_chunk(pending, bps, rows, part)
        pending.clear()

    # contiguous variant sharding for multi-host runs (SURVEY.md §2.1):
    # this process emits only records in [shard, in input order; shard
    # outputs concatenate to the single-host output byte-for-byte
    from svtyper_tpu.parallel.multihost import shard_slices

    # emission re-streams the body from the start (the multihost phase 1
    # consumed its own stream; seekable inputs re-open for free)
    body_emit = get_body()
    if num_shards > 1:
        # the BND registry was built from the FULL body above, so a
        # breakend pair straddling a shard boundary still resolves to
        # the same anchor breakpoint on both shards
        lo, hi = shard_slices(n_records, num_shards)[shard_index]
        body_emit = itertools.islice(body_emit, lo, hi)

    if engine_kind == "tpu" and n_procs == 1:
        # streaming drive: chunk PLANS feed the engine's pipelined
        # genotype_stream (prep thread / async dispatch / collect
        # thread), while this loop formats chunks in input order as
        # their rows surface. The old per-chunk genotype_chunk drive
        # serialized prep→transfer→sync per chunk, exposing the full
        # device round-trip latency on every chunk.
        import itertools

        def chunk_plans():
            pend: List[Variant] = []

            def mk(vars_):
                part = part_path()
                if part is not None and os.path.exists(part):
                    return (vars_, None, None, part, True)
                bps, run_bps = plan_chunk(vars_)
                return (vars_, bps, run_bps, part, False)

            for line in body_emit:
                pend.append(Variant(line, vcf))
                if len(pend) >= batch_size:
                    yield mk(pend)
                    pend = []
            if pend:
                yield mk(pend)

        # two views of one plan stream: the feed side is consumed by
        # genotype_stream's pump (same thread, during next()), the
        # format side below — tee buffers only the in-flight chunks
        plans_feed, plans_fmt = itertools.tee(chunk_plans())

        def bp_feed():
            for _v, _b, run_bps, _p, replay in plans_feed:
                if not replay:
                    yield from run_bps

        # vectorized emission (fast_emit): chunk-at-a-time numpy
        # formatting of the packed result matrices, byte-identical to
        # the object path. Needs 1:1 plan↔engine chunk alignment (the
        # sharded engine rounds chunk_size up) and the default FORMAT
        # declaration order; --debug needs the per-variant objects.
        from svtyper_tpu.cli.fast_emit import (
            eligible as _fast_ok,
            format_chunk_lines,
        )

        use_fast = (
            not debug
            and engine.chunk_size == batch_size
            and _fast_ok(vcf, sample_names)
        )
        if use_fast:
            raw_stream = engine.genotype_stream(bp_feed(), raw=True)
        else:
            flat = (
                row
                for chunk_rows in engine.genotype_stream(bp_feed())
                for row in chunk_rows
            )
        for vars_, bps, run_bps, part, replay in plans_fmt:
            if replay:
                replay_part(part, vars_)
                continue
            if use_fast:
                n_r, per_sample = next(raw_stream)
                # plan chunks and engine chunks must stay 1:1 (guarded
                # by the chunk_size == batch_size gate above)
                assert n_r == len(vars_), (n_r, len(vars_))
                out_lines = format_chunk_lines(
                    vars_, bps, per_sample, sample_names, sum_quals,
                    bnd_results, bnd_computed, registry,
                )
                emit_tail(vars_, bps, out_lines, part)
            else:
                rows = [next(flat) for _ in range(len(vars_))]
                emit_chunk(vars_, bps, rows, part)
    else:
        for line in body_emit:
            pending.append(Variant(line, vcf))
            if len(pending) >= batch_size:
                flush()
        flush()
    if writer_bams is not None:
        writer_bams.close()
    if n_procs > 1 and proc_id == 0:
        shutil.rmtree(gather_dir, ignore_errors=True)
    if hasattr(engine, "close"):
        engine.close()  # release the multi-sample prep pool promptly
    if verbose and hasattr(engine, "stats"):
        st = engine.stats
        dt = time.time() - t_gt
        sys.stderr.write(
            "summary: %d variants in %.2fs (%.1f variants/s) | "
            "%d reads, %d pairs, %d chunks | prep %.2fs, send %.2fs, "
            "device-sync %.2fs\n"
            % (st["variants"], dt, st["variants"] / dt if dt > 0 else 0.0,
               st["reads"], st["pairs"], st["chunks"],
               st["prep_s"], st["send_s"], st["sync_s"])
        )
    stats_path = os.environ.get("SVT_CLI_STATS")
    if stats_path:
        # machine-readable run stats for bench.py's CLI-level row
        # (VERDICT r4 item 1): genotype_wall_s covers parse → last
        # write, total_wall_s adds sample bootstrap; n_done counts
        # emitted records (replayed checkpoint chunks included)
        import json as _json

        payload = {
            "n_variants": n_done,
            "genotype_wall_s": time.time() - t_gt,
            "total_wall_s": time.time() - t0,
            "first_chunk_s": (
                (t_first_chunk[0] - t_gt) if t_first_chunk[0] else None
            ),
        }
        if hasattr(engine, "stats"):
            payload.update(
                {k: engine.stats[k]
                 for k in ("prep_s", "send_s", "sync_s", "reads", "pairs",
                           "chunks")}
            )
        from svtyper_tpu.bamio.native import perf_counters

        payload["native_perf"] = perf_counters()
        with open(stats_path, "w") as fh:
            _json.dump(payload, fh)


def main(argv=None) -> int:
    args = get_args(argv)
    vcf_in = open_vcf_input(args.input_vcf) if args.input_vcf \
        else sys.stdin
    vcf_out = open(args.output_vcf, "w") if args.output_vcf else sys.stdout
    profile_ctx = None
    if args.profile:
        import jax.profiler

        profile_ctx = jax.profiler.trace(args.profile)
        profile_ctx.__enter__()
    try:
        sv_genotype(
            args.bam,
            vcf_in,
            vcf_out,
            min_aligned=args.min_aligned,
            split_weight=args.split_weight,
            disc_weight=args.disc_weight,
            num_samp=args.num_samp,
            lib_info_path=args.lib_info,
            debug=args.debug,
            alignment_outpath=args.write_alignment,
            ref_fasta=args.ref_fasta,
            sum_quals=args.sum_quals,
            max_reads=args.max_reads,
            max_ci_dist=args.max_ci_dist,
            engine_kind=args.engine,
            batch_size=args.batch_size,
            verbose=args.verbose or args.debug,
            checkpoint_dir=args.checkpoint_dir,
            num_shards=args.num_shards,
            shard_index=args.shard_index,
            cores=args.cores,
        )
    finally:
        if profile_ctx is not None:
            profile_ctx.__exit__(None, None, None)
        if args.input_vcf:
            vcf_in.close()
        if args.output_vcf:
            vcf_out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
