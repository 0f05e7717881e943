"""Profile host-side prep (fetch + layout) on the bench fixture.

Usage: JAX_PLATFORMS=cpu python scripts/profile_prep.py [n_variants]
"""
from __future__ import annotations

import cProfile
import io
import os
import pstats
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np



def main():
    from svtyper_tpu.bamio.bam import BamFile
    from svtyper_tpu.breakpoints import resolve_breakpoint
    from svtyper_tpu.evidence.extract import prepare_chunk, pack_chunk
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
    chunk_size = 1024

    # warm
    prepare_chunk(sample, bps[:chunk_size])

    t0 = time.time()
    for lo in range(0, len(bps), chunk_size):
        c = bps[lo : lo + chunk_size]
        if len(c) < chunk_size:
            c = c + [None] * (chunk_size - len(c))
        ch = prepare_chunk(sample, c)
    dt = time.time() - t0
    print("prep: %.3fs for %d variants = %.0f var/s" % (dt, n, n / dt))

    pr = cProfile.Profile()
    pr.enable()
    for _rep in range(3):
        for lo in range(0, len(bps), chunk_size):
            c = bps[lo : lo + chunk_size]
            if len(c) < chunk_size:
                c = c + [None] * (chunk_size - len(c))
            prepare_chunk(sample, c)
    pr.disable()
    s = io.StringIO()
    ps = pstats.Stats(pr, stream=s).sort_stats("cumulative")
    ps.print_stats(25)
    print(s.getvalue())


if __name__ == "__main__":
    main()
