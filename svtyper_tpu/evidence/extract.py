"""Host-side chunk preparation: reads → flat padded device tensors.

The host's job ends at data layout: decode, filter, deduplicate, group
fragments, precompute ragged-only features (aligned-coverage tests), and
pad to bucketed static shapes so XLA compiles once per bucket. All float
math happens on device (SPEC.md §§3–5).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from svtyper_tpu.bamio.columns import FMUNMAP, FPAIRED
from svtyper_tpu.bamio.native import FetchFilter
from svtyper_tpu.breakpoints import Breakpoint, fetch_windows
from svtyper_tpu.oracle.engine import Z_FLANK
from svtyper_tpu.stats.library import Sample

# device-tensor dtypes are minimized to cut the host→device transfer:
# mapq fits u8; pair aln/lib are i16 (aln only feeds >= min_aligned)
READ_FIELDS = [
    ("var", np.int32),
    ("is_rev", np.bool_),
    ("tid", np.int32),
    ("pos", np.int32),
    ("end", np.int32),
    ("mapq", np.uint8),
    ("has_lsoft", np.bool_),
    ("has_rsoft", np.bool_),
    ("lead", np.int32),
    ("cov_a", np.bool_),
    ("cov_b", np.bool_),
    ("has_sa", np.bool_),
    ("sa_tid", np.int32),
    ("sa_pos", np.int32),
    ("sa_end", np.int32),
    ("sa_rev", np.bool_),
    ("sa_mapq", np.uint8),
    ("sa_lead", np.int32),
]
PAIR_FIELDS = [
    ("var", np.int32),
    ("a_pos", np.int32),
    ("a_end", np.int32),
    ("b_pos", np.int32),
    ("b_end", np.int32),
    ("a_tid", np.int32),
    ("b_tid", np.int32),
    ("a_aln", np.int16),
    ("b_aln", np.int16),
    ("a_lib", np.int16),
    ("a_rev", np.bool_),
    ("b_rev", np.bool_),
    ("a_mapq", np.uint8),
    ("b_mapq", np.uint8),
]

VAR_FIELDS = [
    ("tid_a", np.int32),
    ("pos_a", np.int32),
    ("cia0", np.int32),
    ("cia1", np.int32),
    ("tid_b", np.int32),
    ("pos_b", np.int32),
    ("cib0", np.int32),
    ("cib1", np.int32),
    ("o1", np.bool_),
    ("o2", np.bool_),
    ("is_del", np.bool_),
    ("is_dup", np.bool_),
    ("is_inv", np.bool_),
    ("vlen", np.int32),
    ("force_null", np.bool_),
]

# dtype-grouped packing: each group ships to the device as ONE
# [n_fields, N] matrix (few, dense host→device transfers). Two tables:
#   * reads — ONLY evidence-candidate rows (coverage hit, SA split, or
#     soft clip; typically ~20% of fetched reads), for the per-read
#     predicates of SPEC.md §4.1–4.2.
#   * pairs — self-contained two-sided rows for §4.3 (both mates'
#     fields materialized on host), so the device does no gathers into
#     the reads table and non-candidate reads never leave the host.
READS_I32 = ("var", "tid", "pos", "end", "lead", "sa_tid", "sa_pos",
             "sa_end", "sa_lead")
READS_U8 = ("is_rev", "mapq", "has_lsoft", "has_rsoft", "cov_a", "cov_b",
            "has_sa", "sa_rev", "sa_mapq")
READS_BOOL = frozenset(
    ("is_rev", "has_lsoft", "has_rsoft", "cov_a", "cov_b", "has_sa",
     "sa_rev")
)
VARS_I32 = ("tid_a", "pos_a", "cia0", "cia1", "tid_b", "pos_b", "cib0",
            "cib1", "vlen")
VARS_BOOL = ("o1", "o2", "is_del", "is_dup", "is_inv", "force_null")
PAIRS_I32 = ("var", "a_pos", "a_end", "b_pos", "b_end", "a_tid", "b_tid")
PAIRS_I16 = ("a_aln", "b_aln", "a_lib")
PAIRS_U8 = ("a_rev", "b_rev", "a_mapq", "b_mapq")
PAIRS_BOOL = frozenset(("a_rev", "b_rev"))


class ChunkInputs:
    """Flat arrays for one (sample × variant-chunk) device invocation.

    ``reads``/``pairs``/``variants`` are dicts of equal-length numpy
    arrays. Padding rows carry ``var == n_var`` (a trash segment dropped
    after the segment-sum). When built by ``prepare_chunk`` the dict
    entries are row views into the dtype-grouped ``packed`` matrices
    (keys r_i32/r_i16/r_u8/p_i32/v_i32/v_u8) that the engine ships as
    six device transfers.
    """

    def __init__(
        self,
        reads: Dict[str, np.ndarray],
        pairs: Dict[str, np.ndarray],
        variants: Dict[str, np.ndarray],
        n_var: int,
        packed: Optional[Dict[str, np.ndarray]] = None,
    ) -> None:
        self.reads = reads
        self.pairs = pairs
        self.variants = variants
        self.n_var = n_var
        self.packed = packed


def pack_chunk(chunk: "ChunkInputs") -> Dict[str, np.ndarray]:
    """Dtype-grouped matrices from a dict-form chunk (synthetic inputs);
    ``prepare_chunk`` builds them in place without this extra copy."""
    r, p, v = chunk.reads, chunk.pairs, chunk.variants
    return {
        "r_i32": np.stack([np.asarray(r[k], np.int32) for k in READS_I32]),
        "r_u8": np.stack([np.asarray(r[k], np.uint8) for k in READS_U8]),
        "p_i32": np.stack([np.asarray(p[k], np.int32) for k in PAIRS_I32]),
        "p_i16": np.stack([np.asarray(p[k], np.int16) for k in PAIRS_I16]),
        "p_u8": np.stack([np.asarray(p[k], np.uint8) for k in PAIRS_U8]),
        "v_i32": np.stack([np.asarray(v[k], np.int32) for k in VARS_I32]),
        "v_u8": np.stack([np.asarray(v[k], np.uint8) for k in VARS_BOOL]),
    }


# ---- compact wire format (engine hot path) --------------------------
#
# The integer/bool evidence predicates (SPEC.md §4.1–4.3 window, strand
# and straddle tests) are pure comparisons over data that is already
# cache-resident on the host — precomputing them here shrinks the
# host→device wire from 45 B/read + 38 B/pair to 5 B/read + 10 B/pair,
# while every float op (prob_mapq weighting, the §4.3 insert-density
# re-partition, segment sums, GL) stays on device
# (evidence/device.py::classify_compact). The full-column device path
# (device.py::classify) remains the semantic reference; tests assert
# the two produce identical counts.

_SPLIT_SLOP = 7  # must equal device.SPLIT_SLOP (tests enforce)

# cr_u8 rows: mapq, sa_mapq, flags; cp_u8 rows: a_mapq, b_mapq, lib, flags
R_COVHIT, R_CLIPHIT, R_LHIT, R_RHIT, R_PRIMFIRST = 1, 2, 4, 8, 16
P_ALT, P_ALTREC = 1, 2  # bits 2-3: pre-gated ref straddle weight (0/1/2)
LIB_INVALID = 255

COMPACT_KEYS = ("cr_u16", "cr_u8", "cp_u16", "cp_i32", "cp_u8",
                "v_i32", "v_u8")


def _np_edge_in_window(pos, end, tid, bp_tid, bp_pos, ci0, ci1, o_rev):
    edge = np.where(o_rev, pos, end - 1)
    return (
        (tid == bp_tid)
        & (edge >= bp_pos + ci0 - _SPLIT_SLOP)
        & (edge <= bp_pos + ci1 + _SPLIT_SLOP)
    )


def _np_straddle(a_pos, a_end, a_rev, a_aln, a_tid,
                 b_pos, b_end, b_rev, b_aln, b_tid,
                 tid1, p1, ci10, ci11, tid2, p2, ci20, ci21,
                 o1, o2, min_aligned):
    ok = (
        (a_rev == o1) & (b_rev == o2)
        & (a_tid == tid1) & (b_tid == tid2)
        & (a_aln >= min_aligned) & (b_aln >= min_aligned)
    )
    a_side = np.where(o1, a_end - 1 >= p1 + ci10, a_pos <= p1 + ci11)
    b_side = np.where(o2, b_end - 1 >= p2 + ci20, b_pos <= p2 + ci21)
    return ok & a_side & b_side


def compact_chunk(
    chunk: "ChunkInputs", min_aligned: int = 20
) -> Dict[str, np.ndarray]:
    """ChunkInputs → compact wire matrices (numpy twin of the predicate
    half of ``device.py::classify``; bit-identical flags by
    construction — both are integer compares)."""
    r, p, v = chunk.reads, chunk.pairs, chunk.variants
    n_var = chunk.n_var
    if n_var > 0xFFFE:
        raise ValueError("compact wire: chunk_size must be <= 65534")

    def vg(name):
        col = np.asarray(v[name])
        return np.concatenate([col, np.zeros(1, col.dtype)])

    rv = np.asarray(r["var"])
    V = {name: vg(name)[rv] for name in (
        "tid_a", "pos_a", "cia0", "cia1", "tid_b", "pos_b", "cib0",
        "cib1", "o1", "o2",
    )}

    covhit = r["cov_a"] | r["cov_b"]
    same_strand_req = V["o1"] != V["o2"]
    pieces_same = r["is_rev"] == r["sa_rev"]
    sa_ok = r["has_sa"] & (pieces_same == same_strand_req)
    prim_first = r["lead"] <= r["sa_lead"]

    def pick(prim, sa):
        return (np.where(prim_first, prim, sa),
                np.where(prim_first, sa, prim))

    L_pos, R_pos = pick(r["pos"], r["sa_pos"])
    L_end, R_end = pick(r["end"], r["sa_end"])
    L_tid, R_tid = pick(r["tid"], r["sa_tid"])

    def win(pp, pe, pt, side):
        if side == "a":
            return _np_edge_in_window(
                pp, pe, pt, V["tid_a"], V["pos_a"], V["cia0"], V["cia1"],
                V["o1"],
            )
        return _np_edge_in_window(
            pp, pe, pt, V["tid_b"], V["pos_b"], V["cib0"], V["cib1"],
            V["o2"],
        )

    a1L, a1R = win(L_pos, L_end, L_tid, "a"), win(R_pos, R_end, R_tid, "b")
    a2L, a2R = win(L_pos, L_end, L_tid, "b"), win(R_pos, R_end, R_tid, "a")
    use1 = (a1L.astype(np.int32) + a1R) >= (a2L.astype(np.int32) + a2R)
    lhit = sa_ok & np.where(use1, a1L, a2L)
    rhit = sa_ok & np.where(use1, a1R, a2R)

    def clip_sup(side):
        o = V["o1"] if side == "a" else V["o2"]
        hit = win(r["pos"], r["end"], r["tid"], side)
        return ((~o) & r["has_rsoft"] & hit) | (o & r["has_lsoft"] & hit)

    clip_hit = (
        (~r["has_sa"]) & (r["has_lsoft"] | r["has_rsoft"])
        & (clip_sup("a") | clip_sup("b"))
    )
    rflags = (
        covhit.astype(np.uint8) * R_COVHIT
        + clip_hit.astype(np.uint8) * R_CLIPHIT
        + lhit.astype(np.uint8) * R_LHIT
        + rhit.astype(np.uint8) * R_RHIT
        + prim_first.astype(np.uint8) * R_PRIMFIRST
    )

    pv = np.asarray(p["var"])
    PV = {name: vg(name)[pv] for name in (
        "tid_a", "pos_a", "cia0", "cia1", "tid_b", "pos_b", "cib0",
        "cib1", "o1", "o2", "is_del", "is_inv",
    )}
    A = (p["a_pos"], p["a_end"], p["a_rev"], p["a_aln"], p["a_tid"])
    B = (p["b_pos"], p["b_end"], p["b_rev"], p["b_aln"], p["b_tid"])
    at = (PV["tid_a"], PV["pos_a"], PV["cia0"], PV["cia1"])
    bt = (PV["tid_b"], PV["pos_b"], PV["cib0"], PV["cib1"])
    F = np.zeros_like(PV["o1"])
    T = np.ones_like(PV["o1"])

    def strad(t1, p1, c10, c11, t2, p2, c20, c21, o1, o2):
        return _np_straddle(*A, *B, t1, p1, c10, c11, t2, p2, c20, c21,
                            o1, o2, min_aligned)

    ref_a = strad(*at, *at, F, T)
    ref_b = strad(*bt, *bt, F, T)
    ref_gate = (ref_a | ref_b) & (~(ref_a & ref_b) | PV["is_del"])
    refw = np.where(ref_gate, ref_a.astype(np.uint8) + ref_b, 0)
    alt = strad(*at, *bt, PV["o1"], PV["o2"])
    alt_rec = PV["is_inv"] & strad(*at, *bt, ~PV["o1"], ~PV["o2"])
    pflags = (
        alt.astype(np.int32) * P_ALT
        + alt_rec.astype(np.int32) * P_ALTREC
        + refw.astype(np.int32) * 4
    ).astype(np.uint8)
    # i32 wrap matches the full device path's int32 subtract exactly
    ospan = np.subtract(p["b_end"], p["a_pos"], dtype=np.int32)
    lib = np.asarray(p["a_lib"])
    if lib.size and int(lib.max(initial=0)) >= LIB_INVALID:
        raise ValueError("compact wire supports < 255 libraries")
    lu8 = np.where(lib < 0, LIB_INVALID, lib).astype(np.uint8)

    packed = chunk.packed or pack_chunk(chunk)
    return {
        "cr_u16": rv.astype(np.uint16)[None],
        "cr_u8": np.stack([
            np.asarray(r["mapq"], np.uint8),
            np.asarray(r["sa_mapq"], np.uint8),
            rflags,
        ]),
        "cp_u16": pv.astype(np.uint16)[None],
        "cp_i32": ospan[None],
        "cp_u8": np.stack([
            np.asarray(p["a_mapq"], np.uint8),
            np.asarray(p["b_mapq"], np.uint8),
            lu8,
            pflags,
        ]),
        "v_i32": packed["v_i32"],
        "v_u8": packed["v_u8"],
    }


def _bucket(n: int, floor: int = 256) -> int:
    """Smallest 2^k or 1.5·2^k ≥ n: at most 25% padding waste (vs 50%
    for pure powers of two) at twice the compile-cache entries."""
    b = floor
    while b < n:
        if b + b // 2 >= n:
            return b + b // 2
        b *= 2
    return b


def _chunk_preamble(
    sample: Sample,
    bps: List[Optional[Breakpoint]],
    min_aligned: int,
    max_ci_dist: float,
    z: float,
):
    """Shared prologue of prepare_chunk / prepare_compact_chunk:
    typed variant columns, fetch windows, and the in-decode filter."""
    n_var = len(bps)
    name_to_tid = sample.bam.header.name_to_tid
    flank = sample.get_fetch_flank(z)

    # one tuple per breakpoint → single int64 matrix → typed columns
    # (15 per-field list appends per variant was a measurable host cost)
    g = name_to_tid.get
    null_row = (0,) * (len(VAR_FIELDS) - 1) + (1,)
    rows = np.asarray(
        [
            (
                g(bp.chrom_a, -1), bp.pos_a, bp.ci_a[0], bp.ci_a[1],
                g(bp.chrom_b, -1), bp.pos_b, bp.ci_b[0], bp.ci_b[1],
                bp.o1_rev, bp.o2_rev, bp.is_del, bp.is_dup, bp.is_inv,
                bp.var_length or 0, bp.ci_width() > max_ci_dist,
            )
            if bp is not None
            else null_row
            for bp in bps
        ],
        dtype=np.int64,
    ).reshape(n_var, len(VAR_FIELDS))
    variants = {
        name: rows[:, i].astype(dt)
        for i, (name, dt) in enumerate(VAR_FIELDS)
    }

    regions: List[Tuple[str, int, int]] = []
    reg_var: List[int] = []
    any_multi_window = False
    for vi in np.flatnonzero(~variants["force_null"]).tolist():
        wins = fetch_windows(bps[vi], flank)
        for win in wins:
            regions.append(win)
            reg_var.append(vi)
        if len(wins) > 1:
            any_multi_window = True

    # one batched fetch for every window of the chunk, with flag/RG
    # filtering and the §4.1 coverage predicate computed inside the
    # decode loop (bamcore FetchFilter)
    reg_var_arr = np.asarray(reg_var, dtype=np.int64)
    rg_keep, rg_to_lib = sample.fetch_filter_tables()
    filt = FetchFilter(
        drop_flags=0x100 | 0x200 | 0x400 | 0x800,
        rg_keep=rg_keep,
        rg_to_lib=rg_to_lib,
        cov_tid_a=variants["tid_a"][reg_var_arr].astype(np.int64),
        cov_pos_a=variants["pos_a"][reg_var_arr].astype(np.int64),
        cov_tid_b=variants["tid_b"][reg_var_arr].astype(np.int64),
        cov_pos_b=variants["pos_b"][reg_var_arr].astype(np.int64),
        min_aligned=min_aligned,
        want_blocks=False,
    )
    return variants, regions, reg_var, reg_var_arr, any_multi_window, filt


def _pack_variant_tables(variants: Dict[str, np.ndarray], n_var: int):
    """Rebind the variant dict entries to rows of contiguous packed
    matrices (v_i32 [9, n_var], v_u8 [6, n_var])."""
    v32 = np.empty((len(VARS_I32), n_var), dtype=np.int32)
    vu8 = np.empty((len(VARS_BOOL), n_var), dtype=np.uint8)
    for i, name in enumerate(VARS_I32):
        v32[i] = variants[name]
        variants[name] = v32[i]
    for i, name in enumerate(VARS_BOOL):
        vu8[i] = variants[name]
        variants[name] = vu8[i].view(np.bool_)
    return v32, vu8


def prepare_compact_chunk(
    sample: Sample,
    bps: List[Optional[Breakpoint]],
    min_aligned: int = 20,
    max_reads: Optional[int] = None,
    max_ci_dist: float = 1e10,
    z: float = Z_FLANK,
    pad_reads: Optional[int] = None,
    pad_pairs: Optional[int] = None,
):
    """One native call → compact wire matrices (extract.COMPACT_KEYS).

    The decode threads evaluate the §4.1–4.3 predicates at row emission
    (bamcore.cpp::chunk_worker compact mode — the C++ twin of
    ``compact_chunk``; bit-identical flags, tests/test_compact.py), so
    the host never materializes the full read/pair tables. Returns
    ``(compact, n_var, n_ev, n_pair)`` or None when the native core is
    unavailable (callers fall back to prepare_chunk + compact_chunk).
    """
    if os.environ.get("SVT_NO_FETCHCHUNK") == "1":
        return None
    # probe native availability BEFORE the preamble (both checks are
    # cached): on the pure-Python fallback path the caller re-runs the
    # identical preamble inside prepare_chunk, so building it here
    # first would double the host prep work
    native = getattr(sample.bam, "_get_native", lambda: None)()
    if native is None or not hasattr(native._lib, "svt_chunk_export_compact"):
        return None
    n_var = len(bps)
    if n_var > 0xFFFE:
        raise ValueError("compact wire: chunk_size must be <= 65534")
    variants, regions, reg_var, reg_var_arr, _multi, filt = _chunk_preamble(
        sample, bps, min_aligned, max_ci_dist, z
    )
    v32, vu8 = _pack_variant_tables(variants, n_var)
    res = sample.bam.fetch_chunk(
        regions, reg_var_arr, n_var, filt, max_reads=max_reads,
        vpred=(v32, vu8),
    )
    if res is None:
        return None
    n_ev, n_pair, var_over, _var_rows, export = res
    r_pad = max(pad_reads or 0, _bucket(max(n_ev, 1)))
    f_pad = max(pad_pairs or 0, _bucket(max(n_pair, 1), floor=64))
    cr_u16 = np.full((1, r_pad), n_var, dtype=np.uint16)
    cr_u8 = np.zeros((3, r_pad), dtype=np.uint8)
    # numpy-twin padding: compact_chunk computes prim_first on zero rows
    # (lead 0 <= sa_lead 0), so padding rflags carry R_PRIMFIRST
    cr_u8[2] = R_PRIMFIRST
    cp_u16 = np.full((1, f_pad), n_var, dtype=np.uint16)
    cp_i32 = np.zeros((1, f_pad), dtype=np.int32)
    cp_u8 = np.zeros((4, f_pad), dtype=np.uint8)
    export(cr_u16, cr_u8, cp_u16, cp_i32[0], cp_u8)
    vu8[5] |= var_over  # force_null row (VARS_BOOL order)
    compact = {
        "cr_u16": cr_u16,
        "cr_u8": cr_u8,
        "cp_u16": cp_u16,
        "cp_i32": cp_i32,
        "cp_u8": cp_u8,
        "v_i32": v32,
        "v_u8": vu8,
    }
    return compact, n_var, n_ev, n_pair


def prepare_chunk(
    sample: Sample,
    bps: List[Optional[Breakpoint]],
    min_aligned: int = 20,
    max_reads: Optional[int] = None,
    max_ci_dist: float = 1e10,
    z: float = Z_FLANK,
    pad_reads: Optional[int] = None,
    pad_pairs: Optional[int] = None,
) -> ChunkInputs:
    """Gather + lay out one chunk of breakpoints for one sample.

    ``bps`` entries may be None (unsupported records occupying a slot for
    output alignment); they become force_null variants with no reads.
    """
    n_var = len(bps)
    variants, regions, reg_var, reg_var_arr, any_multi_window, filt = (
        _chunk_preamble(sample, bps, min_aligned, max_ci_dist, z)
    )
    # ---- fast path: decode + dedup + pairing + candidate selection all
    # inside the C++ core, exported straight into the padded device
    # matrices (bamcore.cpp::svt_fetch_chunk). SVT_NO_FETCHCHUNK=1 forces
    # the numpy layout below, which stays as the semantic reference
    # (tests assert the two paths produce identical chunks).
    if os.environ.get("SVT_NO_FETCHCHUNK") != "1":
        res = sample.bam.fetch_chunk(
            regions, reg_var_arr, n_var, filt, max_reads=max_reads
        )
        if res is not None:
            n_ev, n_pair, var_over, _var_rows, export = res
            r_pad = max(pad_reads or 0, _bucket(max(n_ev, 1)))
            f_pad = max(pad_pairs or 0, _bucket(max(n_pair, 1), floor=64))
            m32 = np.zeros((len(READS_I32), r_pad), dtype=np.int32)
            mu8 = np.zeros((len(READS_U8), r_pad), dtype=np.uint8)
            p32 = np.zeros((len(PAIRS_I32), f_pad), dtype=np.int32)
            p16 = np.zeros((len(PAIRS_I16), f_pad), dtype=np.int16)
            pu8 = np.zeros((len(PAIRS_U8), f_pad), dtype=np.uint8)
            export(m32, mu8, p32, p16, pu8)
            m32[0, n_ev:] = n_var  # var padding → trash segment
            p32[0, n_pair:] = n_var
            p32[5, n_pair:] = -1  # padding tids match no variant
            p32[6, n_pair:] = -1
            variants["force_null"] = (
                variants["force_null"] | var_over.view(np.bool_)
            )
            reads = {}
            for i, name in enumerate(READS_I32):
                reads[name] = m32[i]
            for i, name in enumerate(READS_U8):
                reads[name] = (
                    mu8[i].view(np.bool_) if name in READS_BOOL else mu8[i]
                )
            pairs = {}
            for i, name in enumerate(PAIRS_I32):
                pairs[name] = p32[i]
            for i, name in enumerate(PAIRS_I16):
                pairs[name] = p16[i]
            for i, name in enumerate(PAIRS_U8):
                pairs[name] = (
                    pu8[i].view(np.bool_) if name in PAIRS_BOOL else pu8[i]
                )
            v32 = np.empty((len(VARS_I32), n_var), dtype=np.int32)
            vu8 = np.empty((len(VARS_BOOL), n_var), dtype=np.uint8)
            for i, name in enumerate(VARS_I32):
                v32[i] = variants[name]
                variants[name] = v32[i]
            for i, name in enumerate(VARS_BOOL):
                vu8[i] = variants[name]
                variants[name] = vu8[i].view(np.bool_)
            packed = {
                "r_i32": m32, "r_u8": mu8,
                "p_i32": p32, "p_i16": p16, "p_u8": pu8,
                "v_i32": v32, "v_u8": vu8,
            }
            return ChunkInputs(reads, pairs, variants, n_var, packed)

    # transient: rows are repacked into padded device buffers below, so
    # the batch may alias the decoder's reusable buffers (one copy saved)
    big, rid = sample.bam.fetch_many(regions, filt=filt, transient=True)
    var_of = (
        np.asarray(reg_var, dtype=np.int32)[rid]
        if big.n
        else np.zeros(0, dtype=np.int32)
    )
    # ---- row selection (dedup + read cap) as ONE index gather, applied
    # while filling the padded device buffers — no intermediate
    # ReadBatch.take() copies of all 25 columns
    sel = None  # None = keep every row
    if big.n:
        # dedup (var, voffset) keeping first occurrence in row order —
        # only reachable when a variant has two disjoint windows AND a
        # single alignment spans both (long D/N cigars); single-window
        # variants can't produce duplicates
        if any_multi_window:
            order = np.lexsort((np.arange(big.n), big.voffset, var_of))
            vo_s = big.voffset[order]
            va_s = var_of[order]
            dup = np.concatenate(
                ([False], (vo_s[1:] == vo_s[:-1]) & (va_s[1:] == va_s[:-1]))
            )
            if dup.any():
                sel = np.sort(order[~dup])
                var_of = var_of[sel]
        # per-variant read cap → null genotype (SPEC.md §3)
        if max_reads is not None and len(var_of):
            per_var = np.bincount(var_of, minlength=n_var)
            over = per_var > max_reads
            if over.any():
                variants["force_null"] = variants["force_null"] | over[:n_var]
                keep2 = ~over[var_of]
                var_of = var_of[keep2]
                sel = (
                    np.flatnonzero(keep2)
                    if sel is None
                    else sel[keep2]
                )
    # ---- selected-row columns (dedup/cap selection applied once each)
    def s(col):
        return col if sel is None else col[sel]

    tid_s, pos_s, end_s = s(big.tid), s(big.pos), s(big.ref_end)
    rev_s, mapq_s = s(big.is_reverse), s(big.mapq)
    lsoft_s = s(big.left_soft) > 0
    rsoft_s = s(big.right_soft) > 0
    cov_a_s, cov_b_s, has_sa_s = s(big.cov_a), s(big.cov_b), s(big.has_sa)

    # ---- reads table: evidence-candidate rows only (§4.1–4.2); other
    # reads can contribute pair evidence only and never leave the host
    ev = cov_a_s | cov_b_s | has_sa_s | lsoft_s | rsoft_s
    iev = np.flatnonzero(ev)
    n_ev = len(iev)
    r_pad = max(pad_reads or 0, _bucket(max(n_ev, 1)))
    m32 = np.zeros((len(READS_I32), r_pad), dtype=np.int32)
    m32[0] = n_var  # var padding → trash segment
    mu8 = np.zeros((len(READS_U8), r_pad), dtype=np.uint8)
    m32[0, :n_ev] = var_of[iev]
    m32[1, :n_ev] = tid_s[iev]
    m32[2, :n_ev] = pos_s[iev]
    m32[3, :n_ev] = end_s[iev]
    m32[4, :n_ev] = s(big.lead_clip_q)[iev]
    m32[5, :n_ev] = s(big.sa_tid)[iev]
    m32[6, :n_ev] = s(big.sa_pos)[iev]
    m32[7, :n_ev] = s(big.sa_end)[iev]
    m32[8, :n_ev] = s(big.sa_lead_clip_q)[iev]
    mu8[0, :n_ev] = rev_s[iev]
    mu8[1, :n_ev] = mapq_s[iev]
    mu8[2, :n_ev] = lsoft_s[iev]
    mu8[3, :n_ev] = rsoft_s[iev]
    mu8[4, :n_ev] = cov_a_s[iev]
    mu8[5, :n_ev] = cov_b_s[iev]
    mu8[6, :n_ev] = has_sa_s[iev]
    mu8[7, :n_ev] = s(big.sa_is_reverse)[iev]
    mu8[8, :n_ev] = s(big.sa_mapq)[iev]
    reads: Dict[str, np.ndarray] = {}
    for i, name in enumerate(READS_I32):
        reads[name] = m32[i]
    for i, name in enumerate(READS_U8):
        reads[name] = (
            mu8[i].view(np.bool_) if name in READS_BOOL else mu8[i]
        )

    # ---- fragment pair table (host: integer sort + boundaries) over the
    # SELECTED rows; both mates' fields materialized (§4.3 runs without
    # device gathers)
    flag = s(big.flag)
    qh = s(big.qname_hash)
    eligible = ((flag & FPAIRED) != 0) & ((flag & FMUNMAP) == 0)
    el = np.flatnonzero(eligible)
    if len(el):
        order = el[
            np.lexsort(
                (
                    np.arange(len(el)),  # stable within equal keys
                    pos_s[el],
                    tid_s[el],
                    qh[el],
                    var_of[el],
                )
            )
        ]
        key_var = var_of[order]
        key_q = qh[order]
        new = np.concatenate(
            ([True], (key_var[1:] != key_var[:-1]) | (key_q[1:] != key_q[:-1]))
        )
        gstart = np.flatnonzero(new)
        gcount = np.diff(np.concatenate((gstart, [len(order)])))
        two = gcount == 2
        p_a = order[gstart[two]]
        p_b = order[gstart[two] + 1]
        # mate-identity check: a 64-bit qname-hash collision could pair
        # two unrelated fragments; requiring each mate's MRNM/MPOS to
        # point at the other recovers the reference's exact-qname
        # grouping (a mismatched "pair" is dropped like a >2 group)
        mtid_s, mpos_s = s(big.mate_tid), s(big.mate_pos)
        okm = (
            (mtid_s[p_a] == tid_s[p_b]) & (mpos_s[p_a] == pos_s[p_b])
            & (mtid_s[p_b] == tid_s[p_a]) & (mpos_s[p_b] == pos_s[p_a])
        )
        if not okm.all():
            p_a, p_b = p_a[okm], p_b[okm]
        p_var = var_of[p_a]
    else:
        p_a = p_b = np.zeros(0, dtype=np.int64)
        p_var = np.zeros(0, dtype=np.int32)

    n_pair = len(p_a)
    f_pad = max(pad_pairs or 0, _bucket(max(n_pair, 1), floor=64))
    p32 = np.zeros((len(PAIRS_I32), f_pad), dtype=np.int32)
    p32[0] = n_var
    p32[5] = -1  # padding tids match no variant
    p32[6] = -1
    p32[0, :n_pair] = p_var
    p32[1, :n_pair] = pos_s[p_a]
    p32[2, :n_pair] = end_s[p_a]
    p32[3, :n_pair] = pos_s[p_b]
    p32[4, :n_pair] = end_s[p_b]
    p32[5, :n_pair] = tid_s[p_a]
    p32[6, :n_pair] = tid_s[p_b]
    p16 = np.zeros((len(PAIRS_I16), f_pad), dtype=np.int16)
    aln_s = np.minimum(s(big.ref_aln_len), 0x7FFF)
    lib_s = np.minimum(s(big.lib_id), 0x7FFF)
    p16[0, :n_pair] = aln_s[p_a]
    p16[1, :n_pair] = aln_s[p_b]
    p16[2, :n_pair] = lib_s[p_a]
    pu8 = np.zeros((len(PAIRS_U8), f_pad), dtype=np.uint8)
    pu8[0, :n_pair] = rev_s[p_a]
    pu8[1, :n_pair] = rev_s[p_b]
    pu8[2, :n_pair] = mapq_s[p_a]
    pu8[3, :n_pair] = mapq_s[p_b]
    pairs: Dict[str, np.ndarray] = {}
    for i, name in enumerate(PAIRS_I32):
        pairs[name] = p32[i]
    for i, name in enumerate(PAIRS_I16):
        pairs[name] = p16[i]
    for i, name in enumerate(PAIRS_U8):
        pairs[name] = (
            pu8[i].view(np.bool_) if name in PAIRS_BOOL else pu8[i]
        )

    # ---- packed variant matrices (rebind dict entries to views)
    v32 = np.empty((len(VARS_I32), n_var), dtype=np.int32)
    vu8 = np.empty((len(VARS_BOOL), n_var), dtype=np.uint8)
    for i, name in enumerate(VARS_I32):
        v32[i] = variants[name]
        variants[name] = v32[i]
    for i, name in enumerate(VARS_BOOL):
        vu8[i] = variants[name]
        variants[name] = vu8[i].view(np.bool_)

    packed = {
        "r_i32": m32, "r_u8": mu8,
        "p_i32": p32, "p_i16": p16, "p_u8": pu8,
        "v_i32": v32, "v_u8": vu8,
    }
    return ChunkInputs(reads, pairs, variants, n_var, packed)


READ_FIELDS_D = {name: dt for name, dt in READ_FIELDS}
