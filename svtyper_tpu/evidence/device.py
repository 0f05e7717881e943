"""Device evidence classification — SPEC.md §4 as fused vector ops.

Every predicate of the reference's per-fragment Python loop
(``parsers.py::SamFragment/SplitRead``, SURVEY.md §2.2) becomes an
elementwise mask over flat read/pair tensors; the five evidence
accumulators become weighted segment-sums by variant. Runs under one
``jit`` together with the GL kernel (``svtyper_tpu.ops``) so XLA fuses
the whole numeric path; float dtype is f64 under x64 (oracle parity)
and f32 otherwise.
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp

SPLIT_SLOP = 7  # SPEC.md §8
PRIOR_CONC, PRIOR_DISC = 0.95, 0.05


def prob_mapq(mapq, dtype):
    return 1.0 - jnp.power(jnp.asarray(10.0, dtype), -mapq.astype(dtype) / 10.0)


_UNROLL = 8  # rows per segment added in one loop step


def sorted_segment_sum(data, seg, num_segments: int):
    """Sum the rows of ``data`` [N, C] by ascending segment id ``seg`` [N]
    into [num_segments, C]; rows with ``seg >= num_segments`` are dropped.

    Each segment adds its rows in row order, as a sequential scatter
    does: the same sums as ``jax.ops.segment_sum`` on the CPU, and the
    same bits on every run. A GPU scatter-add accumulates in whatever
    order its atomics land, so its last bit changes from run to run —
    and the printed FORMAT counts are truncations of these sums. The
    loop takes one step per ``_UNROLL`` rows of the longest segment;
    each step gathers one row per segment."""
    n, width = data.shape
    ids = jnp.arange(num_segments, dtype=seg.dtype)
    start = jnp.searchsorted(seg, ids, side="left").astype(jnp.int32)
    length = (
        jnp.searchsorted(seg, ids, side="right").astype(jnp.int32) - start
    )
    acc0 = jnp.zeros((num_segments, width), data.dtype)
    if n == 0:
        return acc0

    def step(carry):
        k, acc = carry
        for j in range(_UNROLL):
            take = (k + j < length)[:, None]
            row = data[jnp.minimum(start + k + j, n - 1)]
            acc = acc + jnp.where(take, row, 0.0)
        return k + _UNROLL, acc

    max_len = jnp.max(length)
    # the first step runs outside the loop, so that under shard_map the
    # loop's carry already varies over the mesh like the data it sums
    _, acc = jax.lax.while_loop(
        lambda carry: carry[0] < max_len, step, step((jnp.int32(0), acc0))
    )
    return acc


def classify_compact(
    cr_u16, cr_u8, cp_u16, cp_i32, cp_u8, v32, v8,
    dens: jnp.ndarray,
    n_var: int,
    dtype=jnp.float32,
) -> jnp.ndarray:
    """Counts from the compact wire format (extract.compact_chunk).

    The host precomputed the integer window/strand/straddle predicates
    as flag bits; this kernel applies every float op — prob_mapq
    weighting, the §4.3 insert-density re-partition, and the
    variant segment-sums — producing counts identical to ``classify``
    over the full columns (tests/test_compact.py). Rows are grouped by
    ascending variant (engine layout; padding rows carry var = n_var),
    so the reproducible ``sorted_segment_sum`` applies.
    """
    from svtyper_tpu.evidence.extract import (
        LIB_INVALID,
        P_ALT,
        P_ALTREC,
        R_CLIPHIT,
        R_COVHIT,
        R_LHIT,
        R_PRIMFIRST,
        R_RHIT,
        VARS_BOOL,
        VARS_I32,
    )

    iv = {name: i for i, name in enumerate(VARS_I32)}
    ib = {name: i for i, name in enumerate(VARS_BOOL)}

    # ---- reads (§4.1 coverage, §4.2 splits/clips)
    rv = cr_u16[0].astype(jnp.int32)
    mapq, sa_mapq, rf = cr_u8[0], cr_u8[1], cr_u8[2]
    pm = prob_mapq(mapq, dtype)
    spm = prob_mapq(sa_mapq, dtype)
    prim_first = (rf & R_PRIMFIRST) != 0
    l_pm = jnp.where(prim_first, pm, spm)
    r_pm = jnp.where(prim_first, spm, pm)
    lhit = ((rf & R_LHIT) != 0).astype(dtype)
    rhit = ((rf & R_RHIT) != 0).astype(dtype)
    ref_seq_c = jnp.where((rf & R_COVHIT) != 0, pm, 0.0)
    alt_seq_c = (l_pm * lhit + r_pm * rhit) * 0.5
    alt_clip_c = jnp.where((rf & R_CLIPHIT) != 0, pm, 0.0)
    counts_read = jnp.stack([ref_seq_c, alt_seq_c, alt_clip_c], axis=1)
    per_var_read = sorted_segment_sum(counts_read, rv, n_var)

    # ---- pairs (§4.3)
    pv = cp_u16[0].astype(jnp.int32)
    a_mapq, b_mapq, lu8, pf = cp_u8[0], cp_u8[1], cp_u8[2], cp_u8[3]
    p_pair = prob_mapq(a_mapq, dtype) * prob_mapq(b_mapq, dtype)
    alt = (pf & P_ALT) != 0
    alt_rec = (pf & P_ALTREC) != 0
    refw = (pf >> 2).astype(dtype)
    ref_span_c = refw * p_pair * 0.5

    def pgather(row):
        pad = jnp.zeros((1,), dtype=row.dtype)
        return jnp.concatenate([row, pad])[pv]

    vlen = pgather(v32[iv["vlen"]])
    is_del = pgather(v8[ib["is_del"]]).astype(bool)

    W = dens.shape[1]
    ospan = cp_i32[0]
    lib = jnp.where(lu8 == LIB_INVALID, -1, lu8.astype(jnp.int32))
    lib_safe = jnp.clip(lib, 0, dens.shape[0] - 1)

    def dens_at(x):
        ok = (x >= 0) & (x < W) & (lib >= 0)
        return jnp.where(ok, dens[lib_safe, jnp.clip(x, 0, W - 1)], 0.0)

    d_conc = dens_at(ospan)
    d_disc = dens_at(ospan - vlen)
    denom = PRIOR_CONC * d_conc + PRIOR_DISC * d_disc
    p_conc = jnp.where(
        denom > 0, PRIOR_CONC * d_conc / jnp.where(denom > 0, denom, 1.0), 0.0
    )
    del_move = jnp.where(
        is_del & alt & (denom > 0), (1.0 - p_conc) * p_pair, 0.0
    )
    alt_span_c = (
        del_move
        + jnp.where(alt & ~is_del, p_pair, 0.0)
        + jnp.where(alt_rec, p_pair, 0.0)
    )
    ref_span_c = ref_span_c - del_move
    counts_pair = jnp.stack([ref_span_c, alt_span_c], axis=1)
    per_var_pair = sorted_segment_sum(counts_pair, pv, n_var)
    # [n_var, 5]: ref_seq, alt_seq, alt_clip, ref_span, alt_span
    return jnp.concatenate([per_var_read, per_var_pair], axis=1).astype(dtype)


def _edge_in_window(pos, end, tid, bp_tid, bp_pos, ci0, ci1, o_rev):
    """SPEC.md §4.2: '+' edge = end-1, '-' edge = pos, within CI ± slop."""
    edge = jnp.where(o_rev, pos, end - 1)
    return (
        (tid == bp_tid)
        & (edge >= bp_pos + ci0 - SPLIT_SLOP)
        & (edge <= bp_pos + ci1 + SPLIT_SLOP)
    )


def _straddle(
    a_pos, a_end, a_rev, a_aln, a_tid,
    b_pos, b_end, b_rev, b_aln, b_tid,
    tid1, p1, ci10, ci11, tid2, p2, ci20, ci21,
    o1, o2, min_aligned,
):
    """SPEC.md §4.3 pair-straddle predicate, elementwise over pairs."""
    ok = (
        (a_rev == o1) & (b_rev == o2)
        & (a_tid == tid1) & (b_tid == tid2)
        & (a_aln >= min_aligned) & (b_aln >= min_aligned)
    )
    # bracket test (SPEC.md §4.3): forward read starts at-or-left,
    # reverse read ends at-or-right of its breakpoint
    a_side = jnp.where(o1, a_end - 1 >= p1 + ci10, a_pos <= p1 + ci11)
    b_side = jnp.where(o2, b_end - 1 >= p2 + ci20, b_pos <= p2 + ci21)
    return ok & a_side & b_side


def classify(
    reads: Dict[str, jnp.ndarray],
    pairs: Dict[str, jnp.ndarray],
    variants: Dict[str, jnp.ndarray],
    dens: jnp.ndarray,  # [n_libs, max_insert+1]
    n_var: int,
    min_aligned: int,
    dtype=jnp.float32,
    rows_sorted: bool = False,
) -> jnp.ndarray:
    """→ counts [n_var, 5]: ref_seq, alt_seq, alt_clip, ref_span, alt_span."""
    nseg = n_var + 1  # trailing trash segment for padding rows

    def vgather(name):
        col = variants[name]
        pad = jnp.zeros((1,), dtype=col.dtype)
        return jnp.concatenate([col, pad])

    rv = reads["var"]
    v = {name: vgather(name)[rv] for name in (
        "tid_a", "pos_a", "cia0", "cia1", "tid_b", "pos_b", "cib0", "cib1",
        "o1", "o2",
    )}
    pm = prob_mapq(reads["mapq"], dtype)

    # ---- §4.1 reference-sequencing reads
    ref_seq_c = jnp.where(reads["cov_a"] | reads["cov_b"], pm, 0.0)

    # ---- §4.2 SA splits
    same_strand_req = v["o1"] != v["o2"]
    pieces_same = reads["is_rev"] == reads["sa_rev"]
    sa_ok = reads["has_sa"] & (pieces_same == same_strand_req)
    prim_first = reads["lead"] <= reads["sa_lead"]

    def pick(prim, sa):
        return jnp.where(prim_first, prim, sa), jnp.where(prim_first, sa, prim)

    L_pos, R_pos = pick(reads["pos"], reads["sa_pos"])
    L_end, R_end = pick(reads["end"], reads["sa_end"])
    L_tid, R_tid = pick(reads["tid"], reads["sa_tid"])
    L_pm, R_pm = pick(pm, prob_mapq(reads["sa_mapq"], dtype))

    def win(pp, pe, pt, side):
        if side == "a":
            return _edge_in_window(
                pp, pe, pt, v["tid_a"], v["pos_a"], v["cia0"], v["cia1"], v["o1"]
            )
        return _edge_in_window(
            pp, pe, pt, v["tid_b"], v["pos_b"], v["cib0"], v["cib1"], v["o2"]
        )

    a1L, a1R = win(L_pos, L_end, L_tid, "a"), win(R_pos, R_end, R_tid, "b")
    a2L, a2R = win(L_pos, L_end, L_tid, "b"), win(R_pos, R_end, R_tid, "a")
    use1 = (a1L.astype(jnp.int32) + a1R) >= (a2L.astype(jnp.int32) + a2R)
    lr0 = jnp.where(use1, a1L, a2L)
    lr1 = jnp.where(use1, a1R, a2R)
    p_alt = (L_pm * lr0 + R_pm * lr1) * 0.5
    alt_seq_c = jnp.where(sa_ok, p_alt, 0.0)

    # ---- §4.2 soft-clip pseudo-splits
    has_clip = reads["has_lsoft"] | reads["has_rsoft"]

    def clip_sup(side):
        o = v["o1"] if side == "a" else v["o2"]
        fwd_ok = (~o) & reads["has_rsoft"] & win(
            reads["pos"], reads["end"], reads["tid"], side
        )
        rev_ok = o & reads["has_lsoft"] & win(
            reads["pos"], reads["end"], reads["tid"], side
        )
        return fwd_ok | rev_ok

    clip_hit = (~reads["has_sa"]) & has_clip & (clip_sup("a") | clip_sup("b"))
    alt_clip_c = jnp.where(clip_hit, pm, 0.0)

    counts_read = jnp.stack([ref_seq_c, alt_seq_c, alt_clip_c], axis=1)
    # the engine's chunks group rows by ascending variant (padding rows
    # carry var == n_var at the tail): rows_sorted=True then unlocks the
    # sorted segment-sum lowering. Synthetic/direct callers may pass
    # arbitrary row order with the default False.
    per_var_read = jax.ops.segment_sum(
        counts_read, rv, num_segments=nseg, indices_are_sorted=rows_sorted
    )

    # ---- §4.3 read pairs (self-contained rows: both mates' fields
    # were materialized on host — no gathers into the reads table)
    pv = pairs["var"]
    pvf = {name: vgather(name)[pv] for name in (
        "tid_a", "pos_a", "cia0", "cia1", "tid_b", "pos_b", "cib0", "cib1",
        "o1", "o2", "is_del", "is_inv", "vlen",
    )}

    A = dict(pos=pairs["a_pos"], end=pairs["a_end"], rev=pairs["a_rev"],
             aln=pairs["a_aln"], tid=pairs["a_tid"],
             pm=prob_mapq(pairs["a_mapq"], dtype), lib=pairs["a_lib"])
    B = dict(pos=pairs["b_pos"], end=pairs["b_end"], rev=pairs["b_rev"],
             aln=pairs["b_aln"], tid=pairs["b_tid"],
             pm=prob_mapq(pairs["b_mapq"], dtype))
    p_pair = A["pm"] * B["pm"]
    F, T = jnp.zeros_like(pvf["o1"]), jnp.ones_like(pvf["o1"])

    def strad(t1, p1, c10, c11, t2, p2, c20, c21, o1, o2):
        return _straddle(
            A["pos"], A["end"], A["rev"], A["aln"], A["tid"],
            B["pos"], B["end"], B["rev"], B["aln"], B["tid"],
            t1, p1, c10, c11, t2, p2, c20, c21, o1, o2, min_aligned,
        )

    at = (pvf["tid_a"], pvf["pos_a"], pvf["cia0"], pvf["cia1"])
    bt = (pvf["tid_b"], pvf["pos_b"], pvf["cib0"], pvf["cib1"])
    ref_a = strad(*at, *at, F, T)
    ref_b = strad(*bt, *bt, F, T)
    ref_gate = (ref_a | ref_b) & (~(ref_a & ref_b) | pvf["is_del"])
    ref_span_c = jnp.where(
        ref_gate,
        (ref_a.astype(dtype) + ref_b.astype(dtype)) * p_pair * 0.5,
        0.0,
    )
    alt = strad(*at, *bt, pvf["o1"], pvf["o2"])
    alt_rec = pvf["is_inv"] & strad(*at, *bt, ~pvf["o1"], ~pvf["o2"])

    # DEL concordance re-partition (§4.3): dens lookups per pair
    W = dens.shape[1]
    ospan = B["end"] - A["pos"]
    lib_safe = jnp.clip(A["lib"], 0, dens.shape[0] - 1)

    def dens_at(x):
        ok = (x >= 0) & (x < W) & (A["lib"] >= 0)
        return jnp.where(ok, dens[lib_safe, jnp.clip(x, 0, W - 1)], 0.0)

    d_conc = dens_at(ospan)
    d_disc = dens_at(ospan - pvf["vlen"])
    denom = PRIOR_CONC * d_conc + PRIOR_DISC * d_disc
    p_conc = jnp.where(denom > 0, PRIOR_CONC * d_conc / jnp.where(denom > 0, denom, 1.0), 0.0)
    del_move = jnp.where(
        pvf["is_del"] & alt & (denom > 0), (1.0 - p_conc) * p_pair, 0.0
    )
    alt_span_c = (
        del_move
        + jnp.where(alt & ~pvf["is_del"], p_pair, 0.0)
        + jnp.where(alt_rec, p_pair, 0.0)
    )
    ref_span_c = ref_span_c - del_move

    counts_pair = jnp.stack([ref_span_c, alt_span_c], axis=1)
    per_var_pair = jax.ops.segment_sum(
        counts_pair, pv, num_segments=nseg, indices_are_sorted=rows_sorted
    )

    # [n_var, 5]: ref_seq, alt_seq, alt_clip, ref_span, alt_span
    out = jnp.concatenate(
        [
            per_var_read[:n_var, 0:1],
            per_var_read[:n_var, 1:2],
            per_var_read[:n_var, 2:3],
            per_var_pair[:n_var, 0:1],
            per_var_pair[:n_var, 1:2],
        ],
        axis=1,
    ).astype(dtype)
    return out
