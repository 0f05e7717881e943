"""Virtual-mesh scaling curve (VERDICT r1 task 9).

Runs the integrated multi-chip engine (TpuEngine + shard_map) over
1/2/4/8 virtual CPU devices on the bench fixture and reports variants/s
per mesh size. The curve validates the sharding math and pad-geometry
discipline (byte-identical outputs, rectangular [D, ...] stacks), not
wall-clock speedup — all virtual devices share the same cores.

Usage: python scripts/scaling_curve.py [n_variants]
"""
from __future__ import annotations

import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
xla = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla:
    os.environ["XLA_FLAGS"] = (
        xla + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))



def main():
    import jax

    jax.config.update("jax_platforms", "cpu")

    from svtyper_tpu.bamio.bam import BamFile
    from svtyper_tpu.breakpoints import resolve_breakpoint
    from svtyper_tpu.gt import TpuEngine
    from svtyper_tpu.stats import Sample
    from svtyper_tpu.vcfio.model import Variant, Vcf
    from svtyper_tpu.vcfio.reader import read_vcf_lines

    import bench

    bam, vcf_path = bench.build_fixture(n_variants=1600)
    sample = Sample.from_bam(BamFile(bam), num_samp=200_000)
    vcf = Vcf()
    with open(vcf_path) as fh:
        header, body = read_vcf_lines(fh)
        vcf.add_header(header)
        variants = [Variant(line, vcf) for line in body]
    bps = [resolve_breakpoint(v) for v in variants]
    n = int(sys.argv[1]) if len(sys.argv) > 1 else len(bps)
    bps = bps[:n]

    rows = []
    base_fmt = None
    for n_dev in (1, 2, 4, 8):
        engine = TpuEngine(
            [sample], chunk_size=1024, devices=jax.devices()[:n_dev]
        )
        engine.genotype_all(bps)  # compile + settle buckets
        t0 = time.time()
        res = engine.genotype_all(bps)
        dt = time.time() - t0
        fmt = [
            (r[0].gt_string, None if r[0].gl is None else
             tuple(round(g, 6) for g in r[0].gl))
            for r in res
        ]
        if base_fmt is None:
            base_fmt = fmt
        identical = fmt == base_fmt
        vps = len(bps) / dt
        rows.append({"devices": n_dev, "variants_per_s": round(vps, 1),
                     "identical_to_1dev": identical})
        sys.stderr.write(
            "devices=%d: %.0f var/s (%.2fs) identical=%s\n"
            % (n_dev, vps, dt, identical)
        )
        assert identical, "multi-device output diverged from single-device"
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
