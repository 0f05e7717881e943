"""Single-host multi-chip sharding: shard_map over a 'data' mesh axis.

Each device receives one padded (reads, pairs, variants) block —
prepared with identical pad sizes by ``stack_shards`` — and runs the
fused evidence+GL program locally. There is no cross-device traffic on
the hot path (per-variant work is independent); only the output gather
crosses the interconnect, handled by XLA when the caller reads the
sharded result.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from svtyper_tpu.evidence.device import classify
from svtyper_tpu.evidence.extract import ChunkInputs
from svtyper_tpu.ops.gl import genotype_batch


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A 1-D 'data' mesh over ``devices`` (default: the default
    backend's devices), cut to the first ``n_devices``. Too few devices
    is an error: a mesh meant for the accelerator never falls back to
    another backend. A virtual-device rehearsal passes
    ``devices=jax.devices("cpu")`` explicitly."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                "need %d devices, have %d" % (n_devices, len(devices))
            )
        devices = devices[:n_devices]
    return Mesh(np.array(devices), axis_names=("data",))


def make_sharded_step(
    mesh: Mesh,
    n_var: int,
    min_aligned: int = 20,
    split_weight: float = 1.0,
    disc_weight: float = 1.0,
    dtype=jnp.float32,
):
    """jit-compiled step over [D, ...] stacked shard blocks.

    Returns ``fn(reads, pairs, variants, dens, lcf) -> outputs`` where
    every array carries a leading device axis sharded over 'data'.
    """

    def local_step(reads, pairs, variants, dens, lcf):
        # shard_map passes blocks with the leading device axis intact
        reads = {k: v[0] for k, v in reads.items()}
        pairs = {k: v[0] for k, v in pairs.items()}
        variants = {k: v[0] for k, v in variants.items()}
        counts = classify(
            reads, pairs, variants, dens[0], n_var, min_aligned,
            dtype=dtype, rows_sorted=True,
        )
        out = genotype_batch(
            counts,
            variants["is_dup"],
            variants["force_null"],
            lcf,
            split_weight=split_weight,
            disc_weight=disc_weight,
        )
        return {k: v[None] for k, v in out.items()}

    dspec = P("data")
    rspec = P()  # replicated (lcf table)
    fn = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(dspec, dspec, dspec, dspec, rspec),
        out_specs=dspec,
    )
    return jax.jit(fn)


def stack_shards(chunks: Sequence[ChunkInputs]) -> Dict[str, Dict[str, np.ndarray]]:
    """Stack per-device ChunkInputs (equal pad sizes required) into
    [D, ...] arrays."""
    def stack(dicts: List[Dict[str, np.ndarray]]):
        return {k: np.stack([d[k] for d in dicts]) for k in dicts[0]}

    return {
        "reads": stack([c.reads for c in chunks]),
        "pairs": stack([c.pairs for c in chunks]),
        "variants": stack([c.variants for c in chunks]),
    }
