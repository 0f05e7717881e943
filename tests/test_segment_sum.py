"""``evidence.device.sorted_segment_sum``: the engine's reproducible
segment-sum must give the sequential scatter's sums bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from svtyper_tpu.evidence.device import _UNROLL, sorted_segment_sum


def _case(n_rows, num_segments, width, seed, dtype):
    rng = np.random.default_rng(seed)
    # ids past num_segments stand for the engine's padding rows
    seg = np.sort(rng.integers(0, num_segments + 2, n_rows)).astype(np.int32)
    data = (1.0 - 10.0 ** (-rng.integers(0, 60, (n_rows, width)) / 10.0))
    data[rng.random((n_rows, width)) < 0.2] *= -0.5
    return jnp.asarray(data.astype(dtype)), jnp.asarray(seg)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize(
    "n_rows,num_segments",
    [(0, 4), (5, 16), (300, 8), (3000, 1024)],
    ids=["empty", "sparse", "long-segments", "chunk-sized"],
)
def test_matches_sequential_scatter_bitwise(n_rows, num_segments, dtype):
    data, seg = _case(n_rows, num_segments, 3, n_rows, dtype)
    got = jax.jit(sorted_segment_sum, static_argnums=2)(data, seg, num_segments)
    want = jax.ops.segment_sum(data, seg, num_segments=num_segments + 2)
    assert got.shape == (num_segments, 3) and got.dtype == data.dtype
    np.testing.assert_array_equal(np.asarray(got),
                                  np.asarray(want)[:num_segments])


def test_segments_longer_than_one_loop_step():
    n = 5 * _UNROLL + 3  # one segment spanning several steps, then a tail
    seg = jnp.asarray([0] * n + [2, 2], dtype=jnp.int32)
    data = jnp.arange(1.0, n + 3.0)[:, None]
    out = np.asarray(sorted_segment_sum(data, seg, 3))
    assert out[:, 0].tolist() == [n * (n + 1) / 2, 0.0, (n + 1) + (n + 2)]
