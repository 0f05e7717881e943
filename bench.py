"""Benchmark: end-to-end genotyping throughput (variants/s).

Baseline: the reference publishes no throughput numbers (BASELINE.md),
so the denominator is the float64 per-read oracle — the same
per-fragment algorithm the reference implements in pure Python
(SURVEY.md §6: baseline defined by measurement).

Prints ONE JSON line:
  {"metric": "variants_per_s", "value": N, "unit": "variants/s",
   "vs_baseline": N}

Two engine numbers, both over DISTINCT variants (default 9600):
  * `cold_vps` — one pass over never-before-seen variants right after
    a compile-only warmup on a held-out prefix: BGZF blocks uncached,
    so this includes the full first-touch decode cost.
  * `value`/`vs_baseline` (headline) — a second full pass with the
    native block cache warm: the steady-state engine throughput.

Further rows: `bnd_*` (LUMPY-style interchromosomal mate pairs through
the BndRegistry), `multisample_*` (2 samples, independent truths),
`cli_*` (the SHIPPED command, called in this process on a 96k tiling:
whole genotype phase, and steady state past the first chunk, which
carries compilation or the compile-cache load), and the inflate
roofline block (achieved CPU bandwidth vs the retain-pattern bound).
An accuracy gate exits 3 (JSON still printed, `accuracy_degraded`
set) below the concordance floors.

Everything runs in one process: a second JAX process on the same card
would fail for want of device memory.

Env knobs: SVT_BENCH_VARIANTS (default = SVT_BENCH_MIN_MEASURED, 9600),
SVT_BENCH_DEPTH (30), SVT_BENCH_ORACLE_N (48), SVT_BENCH_CACHE
(fixture dir), SVT_BENCH_BND_EVENTS (1500), SVT_BENCH_MS_VARIANTS
(2400), SVT_BENCH_CLI_VARIANTS (96000), SVT_BENCH_CONC_FLOOR (0.97),
SVT_BENCH_BND_CONC_FLOOR (0.93).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

MIN_MEASURED = int(os.environ.get("SVT_BENCH_MIN_MEASURED", "9600"))
N_VARIANTS = int(os.environ.get("SVT_BENCH_VARIANTS", str(MIN_MEASURED)))
DEPTH = float(os.environ.get("SVT_BENCH_DEPTH", "30"))
ORACLE_N = int(os.environ.get("SVT_BENCH_ORACLE_N", "48"))
CACHE = os.environ.get(
    "SVT_BENCH_CACHE", os.path.join(tempfile.gettempdir(), "svtyper_tpu_bench")
)


def build_fixture(n_variants=None, depth=None, cache=None):
    """DEL/DEL/DEL/DUP/INV events spaced 20 kb apart at ``depth``×
    (``SimConfig`` defaults otherwise), seed 42 → (bam, vcf); the truth
    genotypes go to ``vcf + ".truth.json"``. Cached in ``cache``."""
    from svtyper_tpu.simulate import Event, SimConfig, events_to_vcf, simulate_events

    n_variants = N_VARIANTS if n_variants is None else n_variants
    depth = DEPTH if depth is None else depth
    cache = CACHE if cache is None else cache
    os.makedirs(cache, exist_ok=True)
    tag = "v3_n%d_d%g" % (n_variants, depth)
    bam = os.path.join(cache, "bench_%s.bam" % tag)
    vcf = os.path.join(cache, "bench_%s.vcf" % tag)

    def gen_events():
        rng = np.random.default_rng(42)
        types = ["DEL", "DEL", "DEL", "DUP", "INV"]  # DEL-heavy, LUMPY-like
        gts = ["0/0", "0/1", "0/1", "1/1"]
        spacing = 20_000
        n_chrom = max(1, (n_variants * spacing) // 40_000_000 + 1)
        per_chrom = (n_variants + n_chrom - 1) // n_chrom
        refs = [("chr%d" % (c + 1), per_chrom * spacing + 100_000)
                for c in range(n_chrom)]
        events = []
        for i in range(n_variants):
            c = i // per_chrom
            j = i % per_chrom
            pos = 30_000 + j * spacing
            svlen = int(rng.integers(300, 6000))
            events.append(
                Event(
                    types[i % len(types)], refs[c][0], pos, pos + svlen,
                    gts[int(rng.integers(0, len(gts)))],
                    var_id="v%d" % i,
                )
            )
        return refs, events

    if os.path.exists(bam) and os.path.exists(bam + ".bai") and os.path.exists(vcf):
        if not os.path.exists(vcf + ".truth.json"):
            # deterministic regeneration backfills older cached fixtures
            _, events = gen_events()
            with open(vcf + ".truth.json", "w") as fh:
                json.dump({e.var_id: e.gt for e in events}, fh)
        return bam, vcf
    refs, events = gen_events()
    cfg = SimConfig(depth=depth)
    t0 = time.time()
    simulate_events(bam, refs, events, cfg, seed=42, extra_background=5000)
    with open(vcf, "w") as fh:
        fh.write(events_to_vcf(events, refs))
    with open(vcf + ".truth.json", "w") as fh:
        json.dump({e.var_id: e.gt for e in events}, fh)
    sys.stderr.write("fixture built in %.1fs (%s)\n" % (time.time() - t0, bam))
    return bam, vcf


def tile_vcf(src: str, dst: str, n: int, prefix: str) -> None:
    """Tile a fixture VCF's body to n records with unique ids (same
    loci) — shared by the bench CLI row and scripts/soak_1m.py --cli
    so the two stay in sync (review, r5)."""
    with open(src) as fh:
        lines = fh.read().splitlines()
    header = [l for l in lines if l.startswith("#")]
    body = [l for l in lines if not l.startswith("#")]
    with open(dst + ".tmp", "w") as out:
        out.write("\n".join(header) + "\n")
        i = 0
        while i < n:
            for l in body:
                if i >= n:
                    break
                c = l.split("\t", 3)
                out.write("%s\t%s\t%s%d\t%s\n" % (c[0], c[1], prefix, i, c[3]))
                i += 1
    os.replace(dst + ".tmp", dst)


def run_cli_in_process(argv, stats_path):
    """Run ``svtyper`` (``cli.classic.main``) in this process with
    ``SVT_CLI_STATS`` pointed at ``stats_path`` → the stats dict the
    CLI wrote. Raises if the CLI fails."""
    from svtyper_tpu.cli import classic

    if os.path.exists(stats_path):
        os.unlink(stats_path)
    old = os.environ.get("SVT_CLI_STATS")
    os.environ["SVT_CLI_STATS"] = stats_path
    try:
        rc = classic.main(argv)
    finally:
        if old is None:
            del os.environ["SVT_CLI_STATS"]
        else:
            os.environ["SVT_CLI_STATS"] = old
    if rc != 0:
        raise RuntimeError("svtyper %s exited %d" % (" ".join(argv), rc))
    with open(stats_path) as fh:
        return json.load(fh)


def build_bnd_fixture(n_events=None, cache=None):
    """Breakend fixture (VERDICT r4 item 3): interchromosomal BND mate
    PAIRS mixed with DELs, emitted in the LUMPY two-record MATEID form
    so the bench exercises the BndRegistry anchor/copy machinery and
    cross-chromosome fetch. → (bam, vcf, truth by record id)."""
    from svtyper_tpu.simulate import Event, SimConfig, events_to_vcf, simulate_events

    if n_events is None:
        n_events = int(os.environ.get("SVT_BENCH_BND_EVENTS", "1500"))
    cache = CACHE if cache is None else cache
    os.makedirs(cache, exist_ok=True)
    tag = "bnd_n%d_d%g" % (n_events, DEPTH)
    bam = os.path.join(cache, "bench_%s.bam" % tag)
    vcf = os.path.join(cache, "bench_%s.vcf" % tag)
    rng = np.random.default_rng(77)
    gts = ["0/0", "0/1", "0/1", "1/1"]
    spacing = 20_000
    half = (n_events + 1) // 2
    span = half * spacing + 100_000
    refs = [("chr1", span), ("chr2", span)]
    events = []
    for i in range(n_events):
        c = i % 2
        pos = 30_000 + (i // 2) * spacing
        gt = gts[int(rng.integers(0, len(gts)))]
        if i % 3 == 0:  # every third event: interchromosomal breakend
            mate_pos = 30_000 + int(rng.integers(0, half)) * spacing + 9_000
            events.append(Event("BND", refs[c][0], pos, mate_pos, gt,
                                chrom2=refs[1 - c][0], var_id="b%d" % i))
        else:
            svlen = int(rng.integers(300, 6000))
            events.append(Event("DEL", refs[c][0], pos, pos + svlen, gt,
                                var_id="b%d" % i))
    if not (os.path.exists(bam) and os.path.exists(bam + ".bai")
            and os.path.exists(vcf)):
        simulate_events(bam, refs, events, SimConfig(depth=DEPTH), seed=77,
                        extra_background=2000)
        with open(vcf, "w") as fh:
            fh.write(events_to_vcf(events, refs, bnd_mates=True))
    truth = {}
    for e in events:
        if e.svtype == "BND":
            truth[e.var_id + "_1"] = e.gt
            truth[e.var_id + "_2"] = e.gt
        else:
            truth[e.var_id] = e.gt
    return bam, vcf, truth


def build_ms_fixture():
    """Two-sample fixture (VERDICT r4 item 3): the same variant set
    against two BAMs with independently drawn genotypes, so chunks
    carry mixed per-sample nulls and the multi-sample prep pool has
    real overlap to show."""
    from svtyper_tpu.simulate import Event, SimConfig, events_to_vcf, simulate_events

    os.makedirs(CACHE, exist_ok=True)
    n = int(os.environ.get("SVT_BENCH_MS_VARIANTS", "2400"))
    tag = "ms_n%d_d%g" % (n, DEPTH)
    bams = [os.path.join(CACHE, "bench_%s_%s.bam" % (tag, s))
            for s in ("A", "B")]
    vcf = os.path.join(CACHE, "bench_%s.vcf" % tag)
    rng = np.random.default_rng(99)
    gts = ["0/0", "0/1", "0/1", "1/1"]
    types = ["DEL", "DEL", "DEL", "DUP", "INV"]
    spacing = 20_000
    refs = [("chr1", n * spacing + 100_000)]
    base = []
    per_sample_gts = [[], []]
    for i in range(n):
        pos = 30_000 + i * spacing
        svlen = int(rng.integers(300, 6000))
        base.append((types[i % len(types)], pos, pos + svlen, "m%d" % i))
        for s in range(2):
            per_sample_gts[s].append(gts[int(rng.integers(0, len(gts)))])
    truth = [
        {vid: per_sample_gts[s][i] for i, (_t, _p, _e, vid) in enumerate(base)}
        for s in range(2)
    ]
    for s, bam in enumerate(bams):
        if os.path.exists(bam) and os.path.exists(bam + ".bai"):
            continue
        events = [
            Event(t, refs[0][0], p, e, per_sample_gts[s][i], var_id=vid)
            for i, (t, p, e, vid) in enumerate(base)
        ]
        simulate_events(
            bam, refs, events,
            SimConfig(depth=DEPTH, sample_name="SAMPLE_%s" % "AB"[s]),
            seed=100 + s, extra_background=2000,
        )
    if not os.path.exists(vcf):
        events = [Event(t, refs[0][0], p, e, "0/0", var_id=vid)
                  for (t, p, e, vid) in base]
        with open(vcf, "w") as fh:
            fh.write(events_to_vcf(events, refs, sample="SAMPLE_A"))
    return bams, vcf, truth


def main():
    build_fixture()
    build_bnd_fixture()
    build_ms_fixture()
    _measure()


def _measure():
    from svtyper_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    bam_path, vcf_path = build_fixture()

    from svtyper_tpu.bamio.bam import BamFile
    from svtyper_tpu.breakpoints import resolve_breakpoint
    from svtyper_tpu.gt import TpuEngine
    from svtyper_tpu.oracle import OracleEngine
    from svtyper_tpu.stats import Sample
    from svtyper_tpu.vcfio.model import Variant, Vcf
    from svtyper_tpu.vcfio.reader import read_vcf_lines

    sample = Sample.from_bam(BamFile(bam_path), num_samp=200_000)

    # rooflines FIRST, while the process's heap is young: a retain
    # sweep run late reuses pages the earlier phases freed (no kernel
    # fault/zero cost) and overestimates the bound. Bounded block
    # counts keep the resident bump small (~260 MB, freed).
    roofline = roofline_ret = None
    _nat0 = getattr(sample.bam, "_get_native", lambda: None)()
    if _nat0 is not None:
        def _best(**kw):
            runs = [_nat0.inflate_roofline(**kw) for _ in range(2)]
            runs = [r for r in runs if r]
            return max(runs, key=lambda r: r["bytes_per_s"]) \
                if runs else None

        roofline_ret = _best(max_blocks=4000, retain=True)
        roofline = _best(max_blocks=8000)

    vcf = Vcf()
    with open(vcf_path) as fh:
        header, body = read_vcf_lines(fh)
        vcf.add_header(header)
        variants = [Variant(line, vcf) for line in body]
    bps = [resolve_breakpoint(v) for v in variants]
    sys.stderr.write("%d variants, sample ready\n" % len(bps))

    # --- baseline: float64 per-read oracle, PINNED denominator — the
    # median of 5 timed runs over a fixed prefix (the oracle is
    # host-load sensitive; single runs swing widely)
    oracle = OracleEngine([sample])
    for bp in bps[:8]:
        oracle.genotype_variant(bp)  # warm page cache + fine index
    oracle_runs = []
    for _ in range(5):
        t0 = time.time()
        for bp in bps[:ORACLE_N]:
            oracle.genotype_variant(bp)
        oracle_runs.append(ORACLE_N / (time.time() - t0))
    oracle_vps = float(np.median(oracle_runs))
    sys.stderr.write(
        "oracle: %.2f variants/s (median of %s)\n"
        % (oracle_vps, ["%.1f" % r for r in oracle_runs])
    )

    # --- device engine. Warmup compiles on a held-out PREFIX chunk only;
    # the cold pass then covers the remaining DISTINCT variants —
    # blocks never decoded, caches cold (VERDICT r3 item 3). Shape
    # buckets are 1.5×-stepped, so the uniform fixture settles on chunk
    # 0's bucket; if a later chunk did grow it, the one-time compile
    # lands in the persistent cache and vanishes from repeat runs.
    chunk = int(os.environ.get("SVT_BENCH_CHUNK", "1024"))
    engine = TpuEngine([sample], chunk_size=chunk)
    warm_n = min(chunk, len(bps))
    engine.genotype_chunk(bps[:warm_n])
    for k in engine.stats:
        engine.stats[k] = 0

    # GT concordance vs the simulator's truth on the warmup chunk's
    # results + a full warm pass below (accuracy guard: a perf change
    # that silently breaks calls should show here, not just in CI)
    truth = {}
    tpath = vcf_path + ".truth.json"
    if os.path.exists(tpath):
        with open(tpath) as fh:
            truth = json.load(fh)

    cold_bps = bps[warm_n:]
    if not cold_bps:
        sys.stderr.write(
            "WARNING: SVT_BENCH_VARIANTS <= chunk size — the warmup "
            "consumed every variant, cold metrics not measurable\n"
        )
    from svtyper_tpu.bamio.native import perf_counters

    perf_counters()  # drain: isolate the cold pass's inflate work
    t0 = time.time()
    results = engine.genotype_all(cold_bps)
    dt_cold = time.time() - t0
    cold_perf = perf_counters()
    cold_vps = len(cold_bps) / dt_cold if cold_bps else 0.0
    n_called = sum(1 for row in results if not row[0].null)
    st = dict(engine.stats)
    sys.stderr.write(
        "device engine COLD: %.2f variants/s (%d distinct variants in %.1fs;"
        " prep %.2fs, send %.2fs, sync %.2fs; %d/%d called)\n"
        % (cold_vps, len(cold_bps), dt_cold, st["prep_s"], st["send_s"],
           st["sync_s"], n_called, len(cold_bps))
    )

    # --- warm companion: one more pass over the full stream, all BGZF
    # blocks in the shared native cache and every bucket settled
    for k in engine.stats:
        engine.stats[k] = 0
    t0 = time.time()
    warm_results = engine.genotype_all(bps)
    dt_warm = time.time() - t0
    warm_vps = len(bps) / dt_warm
    stw = engine.stats
    sys.stderr.write(
        "device engine WARM: %.2f variants/s (%d variants in %.1fs;"
        " prep %.2fs, send %.2fs, sync %.2fs)\n"
        % (warm_vps, len(bps), dt_warm, stw["prep_s"], stw["send_s"],
           stw["sync_s"])
    )

    concordant = evaluated = 0
    if truth:
        for v, row in zip(variants, warm_results):
            want = truth.get(v.var_id)
            if want is None:
                continue
            evaluated += 1
            got = row[0].gt_string if not row[0].null else "./."
            concordant += got == want
        sys.stderr.write(
            "GT concordance vs simulated truth: %d/%d (%.4f)\n"
            % (concordant, evaluated, concordant / max(evaluated, 1))
        )

    # --- inflate roofline (VERDICT r4 item 2): two single-thread bare
    # rooflines over the fixture's own BGZF blocks — "hot" (one reused
    # output buffer: the absolute peak, unattainable while RETAINING
    # blocks) and "retain" (every block stays live, the block cache's
    # true allocation pattern: the kernel first-touch page tax is
    # inherent). Achieved is measured in CPU time (thread clock), so
    # scheduler contention on a shared host doesn't masquerade as code
    # cost. frac ≈ 1 vs the retain roofline proves the cold
    # decode path inflates at the host's speed of light.
    # (rooflines were measured at process start — see above)
    cold_inflate_bps = (
        cold_perf["inflate_bytes"] / cold_perf["inflate_s"]
        if cold_perf["inflate_s"] > 0 else 0.0
    )
    cold_inflate_cpu_bps = (
        cold_perf["inflate_bytes"] / cold_perf["inflate_cpu_s"]
        if cold_perf.get("inflate_cpu_s") else 0.0
    )
    roofline_bps = roofline["bytes_per_s"] if roofline else 0.0
    roofline_ret_bps = roofline_ret["bytes_per_s"] if roofline_ret else 0.0
    sys.stderr.write(
        "inflate: cold pass %.0f MB, %.2fs wall / %.2fs cpu in inflate "
        "calls (%.2f GB/s cpu); rooflines hot %.2f / retain %.2f GB/s; "
        "frac-vs-retain %.2f; %d cache hits\n"
        % (cold_perf["inflate_bytes"] / 1e6, cold_perf["inflate_s"],
           cold_perf.get("inflate_cpu_s", 0.0),
           cold_inflate_cpu_bps / 1e9, roofline_bps / 1e9,
           roofline_ret_bps / 1e9,
           cold_inflate_cpu_bps / roofline_ret_bps
           if roofline_ret_bps else 0.0,
           cold_perf["cache_hits"])
    )

    # --- BND mate-pair row (VERDICT r4 item 3): LUMPY-style breakend
    # pairs + DELs through the BndRegistry resolve path
    from svtyper_tpu.breakpoints import BndRegistry

    bnd_bam, bnd_vcf, bnd_truth = build_bnd_fixture()
    bnd_sample = Sample.from_bam(BamFile(bnd_bam), num_samp=200_000)
    bnd_engine = TpuEngine([bnd_sample], chunk_size=chunk)
    with open(bnd_vcf) as fh:
        h2, body2 = read_vcf_lines(fh)
        body2 = list(body2)
    vcf2 = Vcf()
    vcf2.add_header(h2)
    registry = BndRegistry()
    registry.scan(body2)
    bnd_vars = [Variant(line, vcf2) for line in body2]
    bnd_bps = [registry.resolve(v) for v in bnd_vars]
    # genotype each breakend EVENT once (anchor), copy to the mate —
    # mirror of the CLI's plan_chunk/emit mate sharing
    seen_events = set()
    run_bps = []
    for v, bp in zip(bnd_vars, bnd_bps):
        mate = v.get_info("MATEID")
        if bp is not None and bp.svtype == "BND" and mate in seen_events:
            run_bps.append(None)
        else:
            seen_events.add(v.var_id)
            run_bps.append(bp)
    bnd_engine.genotype_all(run_bps)  # warmup: compile + block cache
    dt_bnd = None
    for _ in range(2):  # best of 2: host-weather stability
        for k in bnd_engine.stats:
            bnd_engine.stats[k] = 0
        t0 = time.time()
        bnd_rows = bnd_engine.genotype_all(run_bps)
        dt = time.time() - t0
        if dt_bnd is None or dt < dt_bnd:
            dt_bnd = dt
    bnd_vps = len(bnd_bps) / dt_bnd
    bnd_engine.close()
    # mate copy + concordance
    by_id = {v.var_id: r for v, r in zip(bnd_vars, bnd_rows)}
    bnd_ok = bnd_n = 0
    for v, bp, rb, row in zip(bnd_vars, bnd_bps, run_bps, bnd_rows):
        if bp is None:
            continue
        if rb is None:  # mate record: anchor row lives at the mate id
            row = by_id[v.get_info("MATEID")]
        want = bnd_truth.get(v.var_id)
        if want is None:
            continue
        bnd_n += 1
        got = row[0].gt_string if not row[0].null else "./."
        bnd_ok += got == want
    bnd_conc = bnd_ok / max(bnd_n, 1)
    st_b = bnd_engine.stats
    sys.stderr.write(
        "BND fixture: %.0f variants/s (%d records incl. %d mate pairs "
        "in %.1fs; prep %.2fs send %.2fs sync %.2fs), concordance "
        "%d/%d (%.4f)\n"
        % (bnd_vps, len(bnd_bps),
           sum(1 for r in run_bps if r is None), dt_bnd,
           st_b["prep_s"], st_b["send_s"], st_b["sync_s"],
           bnd_ok, bnd_n, bnd_conc)
    )

    # --- two-sample row (VERDICT r4 item 3): per-sample prep fans out
    # over the pool; per-sample truth draws are independent
    ms_bams, ms_vcf, ms_truth = build_ms_fixture()
    ms_samples = [
        Sample.from_bam(BamFile(p), num_samp=200_000) for p in ms_bams
    ]
    ms_engine = TpuEngine(ms_samples, chunk_size=chunk)
    with open(ms_vcf) as fh:
        h3, body3 = read_vcf_lines(fh)
        body3 = list(body3)
    vcf3 = Vcf()
    vcf3.add_header(h3)
    ms_vars = [Variant(line, vcf3) for line in body3]
    ms_bps = [resolve_breakpoint(v) for v in ms_vars]
    ms_engine.genotype_all(ms_bps)  # warmup: compile + block cache
    dt_ms = None
    for _ in range(2):  # best of 2: host-weather stability
        for k in ms_engine.stats:
            ms_engine.stats[k] = 0
        t0 = time.time()
        ms_rows = ms_engine.genotype_all(ms_bps)
        dt = time.time() - t0
        if dt_ms is None or dt < dt_ms:
            dt_ms = dt
    ms_vps = len(ms_bps) / dt_ms
    ms_engine.close()
    ms_ok = ms_n = 0
    for v, row in zip(ms_vars, ms_rows):
        for s in range(2):
            want = ms_truth[s].get(v.var_id)
            if want is None:
                continue
            ms_n += 1
            got = row[s].gt_string if not row[s].null else "./."
            ms_ok += got == want
    ms_conc = ms_ok / max(ms_n, 1)
    st_m = ms_engine.stats
    sys.stderr.write(
        "2-sample fixture: %.0f variants/s (%d variants x 2 samples in "
        "%.1fs; prep %.2fs send %.2fs sync %.2fs), concordance %d/%d "
        "(%.4f)\n"
        % (ms_vps, len(ms_bps), dt_ms, st_m["prep_s"], st_m["send_s"],
           st_m["sync_s"], ms_ok, ms_n, ms_conc)
    )

    # --- CLI-level row (VERDICT r4 item 1): the SHIPPED command, on a
    # 10x tiling of the fixture (distinct ids, same loci) so the
    # per-process one-time costs — the first chunk's compile or
    # compile-cache load, first-touch BGZF inflate — amortize the way
    # they do in a cohort run. Two numbers: cli_vps over the whole
    # genotype phase (first chunk included) and cli_steady_vps past the
    # first chunk (the boundary the CLI records itself). The CLI runs in
    # this process: a second process could not open the card.
    cli_n = int(os.environ.get("SVT_BENCH_CLI_VARIANTS", "96000"))
    cli_vcf = os.path.join(CACHE, "cli_tiled_%d.vcf" % cli_n)
    if not os.path.exists(cli_vcf):
        tile_vcf(vcf_path, cli_vcf, cli_n, "cli")
    lib_json = os.path.join(CACHE, "bench_libinfo.json")
    stats_path = os.path.join(CACHE, "cli_stats.json")
    cli_out = os.path.join(CACHE, "cli_out.vcf")

    def _steady(st):
        fc = st.get("first_chunk_s")
        if fc and st["genotype_wall_s"] > fc:
            return (st["n_variants"] - chunk) / (
                st["genotype_wall_s"] - fc
            )
        return None

    cli_stats = run_cli_in_process(
        ["-i", cli_vcf, "-B", bam_path, "-o", cli_out, "-l", lib_json,
         "--batch_size", str(chunk)],
        stats_path,
    )
    cli_vps = cli_stats["n_variants"] / cli_stats["genotype_wall_s"]
    fc = cli_stats.get("first_chunk_s")
    cli_steady_vps = _steady(cli_stats)
    sys.stderr.write(
        "CLI end-to-end: %.0f variants/s genotype phase, %.0f "
        "steady-state past the first chunk (%d variants in %.2fs; "
        "first chunk %.2fs; total wall %.2fs; prep %.2fs send "
        "%.2fs sync %.2fs)\n"
        % (cli_vps, cli_steady_vps or 0.0, cli_stats["n_variants"],
           cli_stats["genotype_wall_s"], fc or 0.0,
           cli_stats["total_wall_s"], cli_stats["prep_s"],
           cli_stats["send_s"], cli_stats["sync_s"])
    )

    # --- accuracy gate (VERDICT r4 item 7): a perf change that breaks
    # calls must fail the bench, not shave a stderr line. Floors sit
    # under the documented DUP-zygosity ambiguity band (0.984 main,
    # 0.97 BND fixture where breakend junctions are noisier).
    floor_main = float(os.environ.get("SVT_BENCH_CONC_FLOOR", "0.97"))
    floor_bnd = float(os.environ.get("SVT_BENCH_BND_CONC_FLOOR", "0.93"))
    main_conc = concordant / evaluated if evaluated else None
    degraded = []
    if main_conc is not None and main_conc < floor_main:
        degraded.append("main %.4f < %.2f" % (main_conc, floor_main))
    if bnd_n and bnd_conc < floor_bnd:
        degraded.append("bnd %.4f < %.2f" % (bnd_conc, floor_bnd))
    if ms_n and ms_conc < floor_main:
        degraded.append("multisample %.4f < %.2f" % (ms_conc, floor_main))
    if degraded:
        sys.stderr.write(
            "ACCURACY GATE FAILED: %s\n" % "; ".join(degraded)
        )

    print(
        json.dumps(
            {
                "metric": "variants_per_s",
                "value": round(warm_vps, 2),
                "unit": "variants/s",
                "vs_baseline": round(warm_vps / oracle_vps, 2),
                "oracle_vps": round(oracle_vps, 2),
                "cold_vps": round(cold_vps, 2) if cold_bps else None,
                "cold_vs_baseline": (
                    round(cold_vps / oracle_vps, 2) if cold_bps else None
                ),
                "n_measured": len(bps),
                "n_cold": len(cold_bps),
                "chunk_size": chunk,
                "warm_prep_s": round(stw["prep_s"], 3),
                "warm_sync_s": round(stw["sync_s"], 3),
                "gt_concordance": (
                    round(concordant / evaluated, 4) if evaluated else None
                ),
                "cold_prep_s": round(st["prep_s"], 3),
                "cold_send_s": round(st["send_s"], 3),
                "cold_sync_s": round(st["sync_s"], 3),
                # inflate roofline proof (r5): achieved CPU-time
                # bandwidth vs the retain-pattern roofline (the fair
                # bound for a growing block cache); the hot-buffer
                # peak is reported for context
                "cold_inflate_bytes": cold_perf["inflate_bytes"],
                "cold_inflate_s": round(cold_perf["inflate_s"], 3),
                "cold_inflate_cpu_s": round(
                    cold_perf.get("inflate_cpu_s", 0.0), 3
                ),
                "inflate_bytes_per_s": round(cold_inflate_cpu_bps, 0),
                "inflate_roofline_bytes_per_s": round(
                    roofline_ret_bps, 0
                ),
                "inflate_roofline_hot_bytes_per_s": round(
                    roofline_bps, 0
                ),
                "inflate_roofline_frac": (
                    round(cold_inflate_cpu_bps / roofline_ret_bps, 3)
                    if roofline_ret_bps else None
                ),
                "cold_cache_hits": cold_perf["cache_hits"],
                # BND + multi-sample rows (r5)
                "bnd_vps": round(bnd_vps, 2),
                "bnd_vs_baseline": round(bnd_vps / oracle_vps, 2),
                "bnd_concordance": round(bnd_conc, 4),
                "bnd_n_records": len(bnd_bps),
                "multisample_vps": round(ms_vps, 2),
                "multisample_vs_baseline": round(ms_vps / oracle_vps, 2),
                "multisample_concordance": round(ms_conc, 4),
                # CLI end-to-end row (r5)
                "cli_vps": round(cli_vps, 2),
                "cli_vs_baseline": round(cli_vps / oracle_vps, 2),
                "cli_steady_vps": (
                    round(cli_steady_vps, 2) if cli_steady_vps else None
                ),
                "cli_steady_vs_baseline": (
                    round(cli_steady_vps / oracle_vps, 2)
                    if cli_steady_vps else None
                ),
                "cli_n_variants": cli_stats["n_variants"],
                "cli_first_chunk_s": round(fc, 2) if fc else None,
                "cli_total_wall_s": round(cli_stats["total_wall_s"], 2),
                # accuracy gate (r5): degraded is the machine-readable
                # failure flag; the nonzero exit makes it unmissable
                "accuracy_degraded": degraded or None,
            }
        )
    )
    if degraded:
        raise SystemExit(3)


if __name__ == "__main__":
    main()
