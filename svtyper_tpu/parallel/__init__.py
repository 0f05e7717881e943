"""Device-mesh and multi-host scaling.

The reference's only parallelism is a fork pool over variant batches
(``singlesample.py``, SURVEY.md §2.1). Genotyping is embarrassingly
parallel over variants, so the scaling axis is data parallelism:
variants (with their reads/pairs) are sharded over a
``jax.sharding.Mesh`` 'data' axis via ``shard_map`` — each device runs
the full fused classify+GL program on its shard with no collectives on
the hot path — and across hosts via ``jax.distributed`` with contiguous
variant slices merged in order by host 0 (SURVEY.md §2.1). TP/PP/SP/EP
have no counterpart here by construction (SURVEY.md §5: N/A is ground
truth).
"""

from svtyper_tpu.parallel.mesh import (  # noqa: F401
    make_mesh,
    make_sharded_step,
    stack_shards,
)
from svtyper_tpu.parallel.multihost import (  # noqa: F401
    merge_ordered,
    shard_slices,
)
