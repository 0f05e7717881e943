"""Mesh sharding: 8-virtual-device shard_map ≡ single-device results."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from svtyper_tpu.evidence.device import classify
from svtyper_tpu.ops.gl import genotype_batch, log_choose_table
from svtyper_tpu.parallel import (
    make_mesh,
    make_sharded_step,
    merge_ordered,
    shard_slices,
    stack_shards,
)
from svtyper_tpu.parallel.synth import make_synthetic_chunk


def test_shard_slices():
    assert shard_slices(10, 4) == [(0, 3), (3, 6), (6, 8), (8, 10)]
    assert shard_slices(8, 8) == [(i, i + 1) for i in range(8)]
    assert shard_slices(3, 8)[-1] == (3, 3)


def test_merge_ordered():
    sl = shard_slices(10, 3)
    rows = [np.arange(lo, hi) for lo, hi in sl]
    merged = merge_ordered(rows, sl)
    assert merged.tolist() == list(range(10))
    with pytest.raises(AssertionError):
        merge_ordered([rows[1], rows[0], rows[2]], sl)


def test_sharded_step_matches_local():
    n_dev = 8
    mesh = make_mesh(n_dev)
    n_var = 8
    shards, dens = [], None
    for i in range(n_dev):
        chunk, dens = make_synthetic_chunk(n_var=n_var, frags_per_var=2 + i % 3)
        shards.append(chunk)
    stacked = stack_shards(shards)
    dtype = jnp.float64
    step = make_sharded_step(mesh, n_var, dtype=dtype)
    lcf = jnp.asarray(log_choose_table(1 << 12, use_f64=True))
    dens_stack = jnp.asarray(np.stack([dens] * n_dev), dtype=dtype)
    out = jax.device_get(
        step(stacked["reads"], stacked["pairs"], stacked["variants"],
             dens_stack, lcf)
    )
    assert out["gt_idx"].shape == (n_dev, n_var)

    # per-shard local recomputation must agree exactly
    for d, chunk in enumerate(shards):
        counts = classify(
            {k: jnp.asarray(v) for k, v in chunk.reads.items()},
            {k: jnp.asarray(v) for k, v in chunk.pairs.items()},
            {k: jnp.asarray(v) for k, v in chunk.variants.items()},
            jnp.asarray(dens, dtype=dtype),
            n_var, 20, dtype=dtype,
        )
        local = jax.device_get(
            genotype_batch(
                counts,
                jnp.asarray(chunk.variants["is_dup"]),
                jnp.asarray(chunk.variants["force_null"]),
                lcf,
            )
        )
        np.testing.assert_array_equal(out["gt_idx"][d], local["gt_idx"])
        # different XLA programs may fuse/reassociate differently; the
        # formatted-output surface (%.0f GLs) is what parity guards
        np.testing.assert_allclose(out["gl"][d], local["gl"], rtol=1e-12)


def test_graft_entry_single_and_multi():
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.device_get(jax.jit(fn)(*args))
    assert out["gt_idx"].shape[0] == 64
    assert not out["null"].any()
    g.dryrun_multichip(8)
    g.dryrun_multichip(4)


def test_engine_multidevice_byte_identical(tmp_path):
    """TpuEngine on the 8-device mesh ≡ single-device engine, end to end
    through the CLI formatting layer (VERDICT task: multi-chip in the
    production engine, not a demo step)."""
    import io

    from svtyper_tpu.bamio.bam import BamFile
    from svtyper_tpu.breakpoints import resolve_breakpoint
    from svtyper_tpu.gt import TpuEngine
    from svtyper_tpu.output import add_format_headers, apply_variant
    from svtyper_tpu.simulate import (
        Event, SimConfig, events_to_vcf, simulate_events,
    )
    from svtyper_tpu.stats import Sample
    from svtyper_tpu.vcfio.model import Variant, Vcf
    from svtyper_tpu.vcfio.reader import read_vcf_lines

    refs = [("chr1", 4_000_000)]
    events = [
        Event("DEL", "chr1", 300_000 + i * 250_000,
              300_000 + i * 250_000 + 1500 + 97 * i,
              ["0/0", "0/1", "1/1"][i % 3], var_id="v%d" % i)
        for i in range(13)  # not a multiple of 8: exercises padding
    ]
    bam_path = str(tmp_path / "md.bam")
    simulate_events(bam_path, refs, events, SimConfig(depth=30), seed=9,
                    extra_background=1000)
    sample = Sample.from_bam(BamFile(bam_path), num_samp=50_000)
    vcf = Vcf()
    header, body = read_vcf_lines(io.StringIO(events_to_vcf(events, refs)))
    vcf.add_header(header)
    add_format_headers(vcf)
    vcf.add_sample(sample.name)
    variants = [Variant(line, vcf) for line in body]
    bps = [resolve_breakpoint(v) for v in variants]

    assert len(jax.devices()) == 8  # conftest virtual mesh
    multi = TpuEngine([sample], chunk_size=8)   # 13 vars → 2 chunks
    single = TpuEngine([sample], chunk_size=8,
                       devices=jax.devices()[:1])
    assert multi.n_dev == 8 and single.n_dev == 1
    rows_m = multi.genotype_all(bps)
    rows_s = single.genotype_all(bps)

    def render(rows):
        out = []
        for v, row in zip(variants, rows):
            apply_variant(v, [sample.name], row)
            out.append(v.get_var_string())
        return "\n".join(out)

    assert render(rows_m) == render(rows_s)
    called = sum(1 for r in rows_m if not r[0].null)
    assert called == len(bps)


@pytest.mark.parametrize(
    "n_devices,n_given", [(16, None), (4, 2)],
    ids=["default-backend", "explicit-devices"],
)
def test_make_mesh_raises_when_too_few_devices(n_devices, n_given):
    """A mesh asked of too few devices is an error — never a quiet
    fallback onto another backend's devices."""
    devices = None if n_given is None else jax.devices()[:n_given]
    with pytest.raises(ValueError, match="need %d devices" % n_devices):
        make_mesh(n_devices, devices=devices)
    assert make_mesh(2, devices=jax.devices()[:2]).devices.shape == (2,)


class _DensOnly:
    """Stands in for a Sample where only the density table is read."""

    name = "stub"

    def dens_matrix(self):
        return np.arange(12, dtype=np.float64).reshape(2, 6) / 100.0


def test_sharded_engine_places_wire_and_tables_on_the_mesh():
    """Each device receives only its own row of the chunk's wire (no
    scatter from device 0 inside the step), the per-device density
    tables split the same way, and the log-choose table replicates."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from svtyper_tpu.gt import TpuEngine

    engine = TpuEngine([_DensOnly()], chunk_size=16)
    assert engine.sharded and engine.n_dev == 8
    split = NamedSharding(engine.mesh, P("data"))
    wire = np.arange(8 * 40, dtype=np.uint8).reshape(8, 40)
    arr = engine._put_wire(wire)
    assert arr.sharding.is_equivalent_to(split, arr.ndim)
    shards = sorted(arr.addressable_shards, key=lambda s: s.index[0].start)
    assert [s.device for s in shards] == engine.devices
    for d, shard in enumerate(shards):
        np.testing.assert_array_equal(np.asarray(shard.data), wire[d:d + 1])
    dens = engine._dens_for(0)
    assert dens.shape[0] == 8 and dens.sharding.is_equivalent_to(split, 3)
    np.testing.assert_array_equal(
        np.asarray(dens)[:, :2, :6],
        np.broadcast_to(_DensOnly().dens_matrix(), (8, 2, 6)),
    )
    assert engine._lcf.sharding.is_fully_replicated
    assert set(engine._lcf.sharding.device_set) == set(engine.devices)


def test_engine_multidevice_f32_byte_identical(tmp_path):
    """The shipped f32 configuration (x64 off): the sharded engine on
    the 8-device mesh gives the single-device engine's rows, byte for
    byte through the CLI formatting layer."""
    import io

    from svtyper_tpu.bamio.bam import BamFile
    from svtyper_tpu.breakpoints import resolve_breakpoint
    from svtyper_tpu.gt import TpuEngine
    from svtyper_tpu.output import add_format_headers, apply_variant
    from svtyper_tpu.simulate import (
        Event, SimConfig, events_to_vcf, simulate_events,
    )
    from svtyper_tpu.stats import Sample
    from svtyper_tpu.vcfio.model import Variant
    from svtyper_tpu.vcfio.reader import read_vcf_lines

    refs = [("chr1", 4_000_000)]
    events = [
        Event(["DEL", "DUP", "INV"][i % 3], "chr1", 300_000 + i * 250_000,
              300_000 + i * 250_000 + 1200 + 83 * i,
              ["0/1", "1/1", "0/0"][i % 3], var_id="f%d" % i)
        for i in range(11)  # not a multiple of 8: exercises padding
    ]
    bam_path = str(tmp_path / "f32.bam")
    simulate_events(bam_path, refs, events, SimConfig(depth=30), seed=21,
                    extra_background=1000)
    sample = Sample.from_bam(BamFile(bam_path), num_samp=50_000)
    text = events_to_vcf(events, refs)
    header, body = read_vcf_lines(io.StringIO(text))
    body = list(body)
    bps = [resolve_breakpoint(Variant(line, _vcf(header, sample.name)))
           for line in body]

    def render(rows):
        vcf = _vcf(header, sample.name)
        add_format_headers(vcf)
        out = []
        for line, row in zip(body, rows):
            v = Variant(line, vcf)
            apply_variant(v, [sample.name], row)
            out.append(v.get_var_string())
        return "\n".join(out)

    jax.config.update("jax_enable_x64", False)
    try:
        multi = TpuEngine([sample], chunk_size=8)
        single = TpuEngine([sample], chunk_size=8, devices=jax.devices()[:1])
        assert multi.dtype == jnp.float32 and multi.n_dev == 8
        rows_m = multi.genotype_all(bps)
        rows_s = single.genotype_all(bps)
    finally:
        jax.config.update("jax_enable_x64", True)
    assert render(rows_m) == render(rows_s)
    assert sum(1 for r in rows_m if not r[0].null) == len(bps)


def _vcf(header, sample_name):
    from svtyper_tpu.vcfio.model import Vcf

    vcf = Vcf()
    vcf.add_header(header)
    vcf.add_sample(sample_name)
    return vcf
