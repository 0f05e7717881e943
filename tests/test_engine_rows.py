"""The engine's packed result row: field layout and the row codec that
multi-host runs ship between processes."""

import pytest

from svtyper_tpu.gt.engine import (
    INT_FIELDS,
    ROW_WIDTH,
    result_to_row,
    row_to_result,
)
from svtyper_tpu.models.bayes import genotype_from_counts


def test_int_field_layout_matches_engine():
    assert INT_FIELDS == (
        "null", "gt_idx", "gq", "qr", "qa", "dp", "ro", "ao",
        "rs", "as_", "asc", "rp", "ap", "ab_valid",
    )
    assert ROW_WIDTH == len(INT_FIELDS) + 10


@pytest.mark.parametrize(
    "counts,is_dup",
    [
        ((12.0, 3.5, 1.0, 20.2, 4.9), False),
        ((0.0, 6.0, 2.0, 0.0, 11.0), True),
        ((0.0, 0.0, 0.0, 0.0, 0.0), False),  # no evidence: null call
    ],
    ids=["het-del", "dup", "null"],
)
def test_row_codec_round_trips_a_result(counts, is_dup):
    res = genotype_from_counts(*counts, is_dup=is_dup)
    back = row_to_result(result_to_row(res))
    for field in ("null", "gt_idx", "gt_string", "gl", "gq", "sq", "qr",
                  "qa", "counts", "ab"):
        assert getattr(back, field) == getattr(res, field), field
