"""What only a GPU can check: the engine's programs as compiled for the
card. Skipped elsewhere; on a GPU host run ``python -m pytest -m gpu
tests/`` (``chip_smoke.py`` covers the same ground at full size)."""

import io

import jax
import pytest

from svtyper_tpu.bamio.bam import BamFile
from svtyper_tpu.breakpoints import resolve_breakpoint
from svtyper_tpu.gt import TpuEngine
from svtyper_tpu.output import add_format_headers, apply_variant
from svtyper_tpu.simulate import Event, SimConfig, events_to_vcf, simulate_events
from svtyper_tpu.stats import Sample
from svtyper_tpu.vcfio.model import Variant, Vcf
from svtyper_tpu.vcfio.reader import read_vcf_lines

pytestmark = pytest.mark.gpu

REFS = [("chr1", 5_000_000)]


@pytest.mark.parametrize("force_shard", [False, True], ids=["plain", "shard_map"])
def test_engine_on_card_repeats_and_matches_plain(tmp_path, force_shard):
    """Two passes of one engine print the same rows, and the shard_map
    program on one card prints the plain program's rows."""
    events = [
        Event(["DEL", "DUP", "INV"][i % 3], "chr1", 200_000 + i * 230_000,
              200_000 + i * 230_000 + 900 + 67 * i,
              ["0/1", "1/1", "0/0"][i % 3], var_id="g%d" % i)
        for i in range(20)
    ]
    bam = str(tmp_path / "g.bam")
    simulate_events(bam, REFS, events, SimConfig(depth=30), seed=13,
                    extra_background=1000)
    sample = Sample.from_bam(BamFile(bam), num_samp=50_000)
    header, body = read_vcf_lines(io.StringIO(events_to_vcf(events, REFS)))
    body = list(body)

    def vcf():
        v = Vcf()
        v.add_header(header)
        add_format_headers(v)
        v.add_sample(sample.name)
        return v

    bps = [resolve_breakpoint(Variant(line, vcf())) for line in body]

    def render(rows):
        out = []
        for line, row in zip(body, rows):
            v = Variant(line, vcf())
            apply_variant(v, [sample.name], row)
            out.append(v.get_var_string())
        return out

    card = jax.devices()[:1]
    with TpuEngine([sample], devices=card, force_shard=force_shard) as eng:
        first = render(eng.genotype_all(bps))
        assert render(eng.genotype_all(bps)) == first
    with TpuEngine([sample], devices=card) as plain:
        assert render(plain.genotype_all(bps)) == first
    assert sum(1 for line in first if "\t./." not in line) >= 15
