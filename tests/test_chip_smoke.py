"""``chip_smoke.py``'s comparison helpers, run on CPU-made VCFs, and its
refusal to run anywhere but on a GPU."""

import json

import pytest

import chip_smoke

HEADER = [
    "##fileformat=VCFv4.2",
    "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1",
]
FMT = "GT:GQ:SQ:GL:DP:RO:AO:QR:QA:RS:AS:ASC:RP:AP:AB"


def _write(path, samples, quals=None):
    lines = list(HEADER)
    for i, sample in enumerate(samples):
        qual = quals[i] if quals else "10.5"
        lines.append("\t".join([
            "chr1", str(1000 * (i + 1)), "v%d" % i, "N", "<DEL>", qual,
            ".", "SVTYPE=DEL;END=%d" % (1000 * (i + 1) + 500), FMT, sample,
        ]))
    path.write_text("\n".join(lines) + "\n")
    return str(path)


ROW_A = "0/1:45:10.50:-10,-2,-30:30:20:10:20:10:5:3:2:15:5:0.33"
ROW_B = "1/1:45:10.51:-10,-2,-30:30:20:10:20:10:5:3:2:15:5:0.33"


def test_format_key_diffs_counts_per_key(tmp_path):
    a = _write(tmp_path / "a.vcf", [ROW_A, ROW_A, ROW_A], ["9", "9", "9"])
    b = _write(tmp_path / "b.vcf", [ROW_A, ROW_B, ROW_B], ["9", "9", "8"])
    assert chip_smoke.format_key_diffs(a, b) == {"GT": 2, "SQ": 2, "QUAL": 1}
    assert chip_smoke.format_key_diffs(a, a) == {}


def test_format_key_diffs_refuses_other_records(tmp_path):
    a = _write(tmp_path / "a.vcf", [ROW_A, ROW_A])
    b = _write(tmp_path / "b.vcf", [ROW_A])
    with pytest.raises(AssertionError, match="records"):
        chip_smoke.format_key_diffs(a, b)


def test_concordance_against_truth(tmp_path):
    null = "./.:.:.:.:.:.:.:0:0:.:.:.:.:.:."
    path = _write(tmp_path / "c.vcf", [ROW_A, ROW_B, null, ROW_A])
    truth = {"v0": "0/1", "v1": "0/1", "v2": "0/0"}  # v3 has no truth
    assert chip_smoke.concordance(path, truth) == (1, 3)


def test_same_bytes(tmp_path, capsys):
    a = _write(tmp_path / "a.vcf", [ROW_A])
    b = _write(tmp_path / "b.vcf", [ROW_B])
    chip_smoke.same_bytes(a, a, "self")
    assert "self: byte-identical" in capsys.readouterr().out
    with pytest.raises(AssertionError, match="outputs differ"):
        chip_smoke.same_bytes(a, b, "a vs b")


def test_entry_refuses_a_non_gpu_backend(monkeypatch, capsys):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr()
    assert "not a GPU" in out.err
    for line in out.out.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)  # no result line is printed
    import os

    assert os.environ["CUDA_VISIBLE_DEVICES"] == "0"  # one card by default
