"""svtyper-tpu — a JAX structural-variant genotyping framework.

A from-scratch re-design of the capabilities of ``hall-lab/svtyper``
(Chiang et al., Nat Methods 2015) for accelerators under XLA:

- ``bamio``     BAM/BGZF/BAI decoding to columnar numpy batches (C++ core
                with a pure-Python fallback) — replaces pysam/htslib.
- ``vcfio``     VCF object model + byte-exact writer (parity surface of
                ``svtyper/parsers.py::Vcf/Variant/Genotype``).
- ``stats``     per-library insert-size models + ``-l`` JSON cache
                (parity surface of ``parsers.py::Sample/Library``).
- ``evidence``  vectorized fragment/split/clip feature extraction into
                dense per-variant tensors (replaces the per-read Python
                loop of ``classic.py::sv_genotype``).
- ``models``    the Bayesian genotype model (``classic.py::bayes_gt``).
- ``ops``       JAX/Pallas kernels (log-binomial GL, segment reductions).
- ``gt``        the batched device genotyping engine.
- ``parallel``  device-mesh sharding + multi-host orchestration.
- ``cli``       drop-in ``svtyper`` / ``svtyper-sso`` command lines.
- ``oracle``    pure-Python float64 reference implementation (the parity
                baseline; see SPEC.md).
"""

from svtyper_tpu.version import __version__  # noqa: F401

# Lazy top-level conveniences (PEP 562): the common library surface
# without paying the jax import at package-import time.
_LAZY = {
    "TpuEngine": ("svtyper_tpu.gt", "TpuEngine"),
    "OracleEngine": ("svtyper_tpu.oracle", "OracleEngine"),
    "sv_genotype": ("svtyper_tpu.cli.classic", "sv_genotype"),
    "open_bam": ("svtyper_tpu.bamio.bam", "open_bam"),
    "Sample": ("svtyper_tpu.stats", "Sample"),
    "Vcf": ("svtyper_tpu.vcfio.model", "Vcf"),
    "Variant": ("svtyper_tpu.vcfio.model", "Variant"),
    "resolve_breakpoint": ("svtyper_tpu.breakpoints", "resolve_breakpoint"),
    "BndRegistry": ("svtyper_tpu.breakpoints", "BndRegistry"),
}


def __getattr__(name):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            "module %r has no attribute %r" % (__name__, name)
        ) from None
    import importlib

    return getattr(importlib.import_module(mod_name), attr)


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
