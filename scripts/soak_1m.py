"""Million-variant soak (VERDICT r3 item 8): drive the engine's
streaming path over 1M breakpoints and assert host RSS stays flat
across chunks (results are yielded, never accumulated).

The variant stream tiles the bench fixture's loci (fresh Breakpoint
objects per variant, so object lifetime is exercised; BGZF blocks go
warm after the first pass — this soaks memory behavior and sustained
throughput, not cold I/O, which bench.py's cold pass covers).

Usage: python scripts/soak_1m.py [n_variants]   (default 1_000_000)
       python scripts/soak_1m.py --cli [n_variants]
Writes a summary line; exits non-zero if RSS drifts.

``--cli`` (VERDICT r4 item 4) soaks the SHIPPED command instead of the
library stream: it tiles the bench fixture's VCF to n records on disk,
runs ``python -m svtyper_tpu.cli.classic`` as a subprocess on JAX's
default backend (this parent process never imports JAX, so the child
alone holds the card), samples the child's RSS throughout, and asserts
the same flat-RSS property on the whole CLI process — parse, registry
pre-scan, genotyping, formatting, write.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CLI_MODE = "--cli" in sys.argv[1:]
_pos = [a for a in sys.argv[1:] if not a.startswith("-")]
N = int(_pos[0]) if _pos else 1_000_000


def rss_mb() -> float:
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return 0.0


def main_cli() -> int:
    """Soak the CLI binary end to end (VERDICT r4 item 4)."""
    import json
    import subprocess

    os.environ.setdefault("SVT_BENCH_VARIANTS", "9600")
    import bench

    bam_path, vcf_path = bench.build_fixture()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cache = os.path.dirname(vcf_path)
    big_vcf = os.path.join(cache, "soak_cli_%d.vcf" % N)
    if not os.path.exists(big_vcf):
        # tile the fixture body to N records with unique ids (loci
        # repeat: the soak targets CLI memory behavior and sustained
        # throughput; cold I/O is bench.py's cold pass)
        t0 = time.time()
        bench.tile_vcf(vcf_path, big_vcf, N, "soak")
        sys.stderr.write("soak VCF built in %.0fs (%s)\n"
                         % (time.time() - t0, big_vcf))

    stats_path = os.path.join(cache, "soak_cli_stats.json")
    if os.path.exists(stats_path):
        os.unlink(stats_path)
    env = dict(os.environ, PYTHONPATH=repo, SVT_CLI_STATS=stats_path)
    proc = subprocess.Popen(
        [sys.executable, "-m", "svtyper_tpu.cli.classic",
         "-i", big_vcf, "-B", bam_path, "-o", os.devnull, "--verbose"],
        env=env, stderr=subprocess.DEVNULL,
    )

    def child_rss_mb() -> float:
        try:
            with open("/proc/%d/status" % proc.pid) as fh:
                for line in fh:
                    if line.startswith("VmRSS:"):
                        return int(line.split()[1]) / 1024.0
        except OSError:
            pass
        return 0.0

    samples = []
    t0 = time.time()
    while proc.poll() is None:
        time.sleep(2.0)
        r = child_rss_mb()
        if r:
            samples.append(r)
            if len(samples) % 10 == 0:
                sys.stderr.write("cli soak: %.0fs RSS %.0f MB\n"
                                 % (time.time() - t0, r))
    if proc.returncode != 0:
        sys.stderr.write("FAIL: CLI exited rc=%d\n" % proc.returncode)
        return 1
    with open(stats_path) as fh:
        st = json.load(fh)
    import numpy as np

    vals = np.asarray(samples, dtype=np.float64)
    # skip the startup third (imports, sample bootstrap, compile)
    vals = vals[len(vals) // 3:]
    if len(vals) < 4:
        head = tail = float(vals[-1]) if len(vals) else 0.0
        drift = 0.0
    else:
        q = max(1, len(vals) // 4)
        head, tail = float(np.median(vals[:q])), float(np.median(vals[-q:]))
        drift = (tail - head) / head if head else 0.0
    print(
        '{"cli_soak_variants": %d, "variants_per_s": %.1f, '
        '"genotype_wall_s": %.1f, "rss_head_mb": %.0f, '
        '"rss_tail_mb": %.0f, "rss_drift": %.3f}'
        % (st["n_variants"], st["n_variants"] / st["genotype_wall_s"],
           st["genotype_wall_s"], head, tail, drift)
    )
    if drift > 0.10:
        sys.stderr.write("FAIL: CLI RSS drifted %.1f%% across the soak\n"
                         % (100 * drift))
        return 1
    return 0


def main() -> int:
    os.environ.setdefault("SVT_BENCH_VARIANTS", "9600")
    import bench  # reuse the cached bench fixture

    bam_path, vcf_path = bench.build_fixture()

    from svtyper_tpu.bamio.bam import BamFile
    from svtyper_tpu.breakpoints import Breakpoint, resolve_breakpoint
    from svtyper_tpu.gt import TpuEngine
    from svtyper_tpu.stats import Sample
    from svtyper_tpu.vcfio.model import Variant, Vcf
    from svtyper_tpu.vcfio.reader import read_vcf_lines

    sample = Sample.from_bam(BamFile(bam_path), num_samp=200_000)
    vcf = Vcf()
    with open(vcf_path) as fh:
        header, body = read_vcf_lines(fh)
        body = list(body)
    vcf.add_header(header)
    base = [resolve_breakpoint(Variant(l, vcf)) for l in body]

    def stream():
        i = 0
        while i < N:
            for bp in base:
                if i >= N:
                    return
                # fresh object per variant: the soak must exercise
                # allocation/lifetime, not re-yield one shared instance
                yield Breakpoint(
                    bp.svtype, bp.chrom_a, bp.pos_a, bp.ci_a, bp.chrom_b,
                    bp.pos_b, bp.ci_b, bp.o1_rev, bp.o2_rev, bp.var_length,
                )
                i += 1

    engine = TpuEngine([sample], chunk_size=1024)
    engine.genotype_chunk(base[:1024])  # compile warmup

    t0 = time.time()
    n_done = 0
    n_called = 0
    rss_track = []
    for chunk_results in engine.genotype_stream(stream()):
        n_done += len(chunk_results)
        n_called += sum(1 for row in chunk_results if not row[0].null)
        if (n_done // 1024) % 25 == 0:
            rss_track.append((n_done, rss_mb()))
            sys.stderr.write(
                "%8d variants  %.0f v/s  RSS %.0f MB\n"
                % (n_done, n_done / (time.time() - t0), rss_track[-1][1])
            )
    dt = time.time() - t0
    assert n_done == N, (n_done, N)

    # flat-RSS check: compare the median of the last quarter against
    # the first quarter (skip the first sample: warmup allocations)
    import numpy as np

    vals = np.asarray([r for _, r in rss_track[1:]], dtype=np.float64)
    if len(vals) < 4:  # short smoke runs: not enough samples to judge
        head = tail = float(vals[-1]) if len(vals) else rss_mb()
        drift = 0.0
    else:
        q = max(1, len(vals) // 4)
        head, tail = np.median(vals[:q]), np.median(vals[-q:])
        drift = (tail - head) / head if head else 0.0
    print(
        '{"soak_variants": %d, "variants_per_s": %.1f, "called": %d, '
        '"rss_head_mb": %.0f, "rss_tail_mb": %.0f, "rss_drift": %.3f}'
        % (N, N / dt, n_called, head, tail, drift)
    )
    if drift > 0.10:
        sys.stderr.write("FAIL: RSS drifted %.1f%% across the soak\n"
                         % (100 * drift))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main_cli() if CLI_MODE else main())
