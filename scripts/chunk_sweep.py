"""Engine chunk-size sweep with the prep/send/sync split, on the bench's
1,600-variant fixture and JAX's default backend.

Usage: python scripts/chunk_sweep.py [chunks...]   (default 1024 2048 4096)
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    import bench
    from svtyper_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    bam, vcf_path = bench.build_fixture(n_variants=1600)

    from svtyper_tpu.bamio.bam import BamFile
    from svtyper_tpu.breakpoints import resolve_breakpoint
    from svtyper_tpu.gt import TpuEngine
    from svtyper_tpu.stats import Sample
    from svtyper_tpu.vcfio.model import Variant, Vcf
    from svtyper_tpu.vcfio.reader import read_vcf_lines

    sample = Sample.from_bam(BamFile(bam), num_samp=200_000)
    vcf = Vcf()
    with open(vcf_path) as fh:
        header, body = read_vcf_lines(fh)
        vcf.add_header(header)
        variants = [Variant(line, vcf) for line in body]
    bps = [resolve_breakpoint(v) for v in variants]
    sys.stderr.write("%d variants on %s\n" % (len(bps), jax.devices()))

    sizes = [int(a) for a in sys.argv[1:]] or [1024, 2048, 4096]
    for cs in sizes:
        engine = TpuEngine([sample], chunk_size=cs)
        t0 = time.time()
        engine.genotype_chunk(bps[: min(cs, len(bps))])  # compile
        sys.stderr.write("chunk=%d compile+first: %.2fs\n"
                         % (cs, time.time() - t0))
        for rep in range(3):
            for k in engine.stats:
                engine.stats[k] = 0
            t0 = time.time()
            engine.genotype_all(bps)
            dt = time.time() - t0
            st = engine.stats
            sys.stderr.write(
                "chunk=%d rep%d: %.0f var/s (%.2fs; prep %.2fs sync %.2fs"
                " chunks %d)\n"
                % (cs, rep, len(bps) / dt, dt, st["prep_s"], st["sync_s"],
                   st["chunks"])
            )


if __name__ == "__main__":
    main()
