"""Vectorized evidence extraction (reference L3, SURVEY.md §1).

Replaces the per-read Python loop of ``classic.py::sv_genotype``
(SURVEY.md §3.1 "INNER HOT LOOP") with a two-stage design:

- ``extract`` (host): BAM fetch → columnar batches → flat, padded,
  fixed-shape chunk tensors (reads / fragment-pairs / variants).
- ``device``: all predicates and weighted evidence sums as one
  fused XLA program (segment-sums by variant), feeding the GL kernel.
"""

from svtyper_tpu.evidence.extract import ChunkInputs, prepare_chunk  # noqa: F401
