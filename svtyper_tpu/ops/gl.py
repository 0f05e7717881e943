"""Batched genotype-likelihood stage (SPEC.md §5) in JAX.

Vectorized twin of ``svtyper_tpu.models.bayes.genotype_from_counts``:
[N,5] evidence counts → QR/QA (trunc toward zero) → log10 GLs via a
cumulative log10-factorial table → GT/GQ/SQ/AB and the truncated FORMAT
count fields. The table reproduces the reference's iterative
``log_choose`` to <1e-12 in float64 (SURVEY.md §8.2; the golden tests
compare *formatted* output).
"""

from __future__ import annotations

import functools
import math
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from svtyper_tpu.models.bayes import ALT_PROBS, ALT_PROBS_DUP

MAX_GQ = 200.0
# smallest float64 subnormal is 10**-323.6; below that the oracle's naive
# sum(10**gl) is exactly 0 and it emits a null genotype
LOG10_TINY = -323.6
LN10 = math.log(10.0)

# log10 p / log10 (1-p) per genotype, rows (non-dup, dup), rounded once
# in float64. The float32 branch builds its per-genotype scores from
# THESE constants (see genotype_batch).
LOG_P_TABLE = np.asarray(
    [[math.log10(p) for p in ALT_PROBS],
     [math.log10(p) for p in ALT_PROBS_DUP]]
)
LOG_Q_TABLE = np.asarray(
    [[math.log10(1.0 - p) for p in ALT_PROBS],
     [math.log10(1.0 - p) for p in ALT_PROBS_DUP]]
)


@functools.lru_cache(maxsize=4)
def log_choose_table(max_n: int, use_f64: bool = True) -> np.ndarray:
    """lcf[i] = sum_{d=1..i} log10(d), so
    log10 C(n,k) = lcf[n] - lcf[k] - lcf[n-k]."""
    dt = np.float64 if use_f64 else np.float32
    v = np.zeros(max_n + 1, dtype=dt)
    v[1:] = np.cumsum(np.log10(np.arange(1, max_n + 1, dtype=np.float64)))
    return v.astype(dt)


def _trunc(x):
    return jnp.trunc(x)


def genotype_batch(
    counts: jnp.ndarray,  # [N,5] ref_seq, alt_seq, alt_clip, ref_span, alt_span
    is_dup: jnp.ndarray,  # [N] bool
    force_null: jnp.ndarray,  # [N] bool
    lcf: jnp.ndarray,  # [MAXN+1] log10-factorial table
    split_weight: float = 1.0,
    disc_weight: float = 1.0,
) -> Dict[str, jnp.ndarray]:
    dtype = counts.dtype
    ref_seq = counts[:, 0]
    alt_seq = counts[:, 1]
    alt_clip = counts[:, 2]
    ref_span = counts[:, 3]
    alt_span = counts[:, 4]
    alt_splitters = alt_seq + alt_clip
    total = ref_seq + alt_seq + alt_clip + ref_span + alt_span

    qr = _trunc(split_weight * ref_seq) + _trunc(disc_weight * ref_span)
    qa = _trunc(split_weight * alt_splitters) + _trunc(disc_weight * alt_span)
    n = qr + qa
    k = qa

    maxn = lcf.shape[0] - 1
    ni = jnp.clip(n, 0, maxn).astype(jnp.int32)
    ki = jnp.clip(k, 0, maxn).astype(jnp.int32)
    nki = jnp.clip(n - k, 0, maxn).astype(jnp.int32)
    # symmetrized k for the validity test only (matches the reference's
    # degenerate-input behavior: log_choose → 0 when the loop is empty)
    k2 = jnp.where(2 * k > n, n - k, k)
    lc_valid = (k2 > 0) & (k >= 0) & (n >= k)
    lc = jnp.where(lc_valid, lcf[ni] - lcf[ki] - lcf[nki], 0.0).astype(dtype)

    if dtype == jnp.float64:
        # parity path: the oracle (models/bayes.py) computes GL with the
        # log-choose term folded in and derives GT/GQ/SQ from those
        # floats — mirror its exact op order so formatted output is
        # byte-identical (tests/test_engine_parity.py).
        p_alt = jnp.where(
            is_dup[:, None],
            jnp.asarray([1e-2, 0.2, 1.0 / 3.0], dtype=dtype),
            jnp.asarray([1e-3, 0.5, 0.9], dtype=dtype),
        )  # [N,3]
        log_p = jnp.log10(p_alt)
        log_q = jnp.log10(1.0 - p_alt)
        gl = lc[:, None] + k[:, None] * log_p + (n - k)[:, None] * log_q
        s = gl  # [N,3] — the scores GT/GQ/SQ derive from
    else:
        # float32 throughput path: lc is CONSTANT across the three
        # genotypes, so GT/GQ/SQ are computed from lc-free scores built
        # from f64-rounded constants: an f32 rounding of lc cannot move
        # GT or GQ, and GL keeps lc only for its printed value.
        lp = jnp.where(
            is_dup[:, None],
            jnp.asarray(LOG_P_TABLE[1], dtype=dtype),
            jnp.asarray(LOG_P_TABLE[0], dtype=dtype),
        )
        lq = jnp.where(
            is_dup[:, None],
            jnp.asarray(LOG_Q_TABLE[1], dtype=dtype),
            jnp.asarray(LOG_Q_TABLE[0], dtype=dtype),
        )
        s = k[:, None] * lp + (n - k)[:, None] * lq  # [N,3]
        gl = lc[:, None] + s

    best = jnp.argmax(s, axis=1)  # first max → lowest index on ties
    gl_best = jnp.take_along_axis(s, best[:, None], axis=1)[:, 0]
    masked = jnp.where(
        jax.nn.one_hot(best, 3, dtype=jnp.bool_), -jnp.inf, s
    )
    second = jnp.argmax(masked, axis=1)
    gl_second = jnp.take_along_axis(s, second[:, None], axis=1)[:, 0]

    # stable log10(sum 10**gl); lc cancels in s[:,0]-log_gt_sum, so the
    # f32 branch's lc-free scores give the same SQ
    m = jnp.max(s, axis=1)
    if dtype == jnp.float64:
        sum_shift = jnp.sum(jnp.power(10.0, s - m[:, None]), axis=1)
    else:
        sum_shift = jnp.sum(jnp.exp((s - m[:, None]) * LN10), axis=1)
    log_gt_sum = m + jnp.log10(sum_shift)
    # underflow is a property of the true max GL (incl. lc)
    m_gl = m if dtype == jnp.float64 else m + lc
    underflow = m_gl < LOG10_TINY

    sq = jnp.abs(-10.0 * (s[:, 0] - log_gt_sum))
    gq = _trunc(jnp.minimum(-10.0 * (gl_second - gl_best), MAX_GQ))

    null = force_null | (total <= 0) | underflow
    denom = ref_seq + ref_span + alt_splitters + alt_span
    ab = jnp.where(denom > 0, (alt_splitters + alt_span) / jnp.where(denom > 0, denom, 1.0), 0.0)

    return {
        "null": null,
        "gt_idx": jnp.where(null, -1, best).astype(jnp.int32),
        "gl": gl,
        "gq": gq.astype(jnp.int32),
        "sq": sq,
        "qr": qr.astype(jnp.int32),
        "qa": qa.astype(jnp.int32),
        # DP truncates the sum in the reference's own addition order
        "dp": _trunc(
            ref_seq + ref_span + alt_seq + alt_clip + alt_span
        ).astype(jnp.int32),
        "ro": _trunc(ref_seq + ref_span).astype(jnp.int32),
        "ao": _trunc(alt_splitters + alt_span).astype(jnp.int32),
        "rs": _trunc(ref_seq).astype(jnp.int32),
        "as_": _trunc(alt_seq).astype(jnp.int32),
        "asc": _trunc(alt_clip).astype(jnp.int32),
        "rp": _trunc(ref_span).astype(jnp.int32),
        "ap": _trunc(alt_span).astype(jnp.int32),
        "ab": ab,
        "ab_valid": denom > 0,
        "counts": counts,
    }
