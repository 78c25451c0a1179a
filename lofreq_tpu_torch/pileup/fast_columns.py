"""Fused C column builder (csrc/columns.c) for the SNV calling path.

Produces a ColumnBatch plus the precomputed err-prob CSR in one native
sweep, replacing compile_columns + snv_errprobs_for_batch when indels are
not being called (the default `call` configuration).
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import defaults as D
from .engine import ColumnBatch, PileupConf
from .native_ingest import get_lib


class _ColConf(ctypes.Structure):
    _fields_ = [
        ("min_plp_bq", ctypes.c_int32),
        ("min_bq", ctypes.c_int32), ("min_alt_bq", ctypes.c_int32),
        ("def_alt_bq", ctypes.c_int32),
        ("min_jq", ctypes.c_int32), ("min_alt_jq", ctypes.c_int32),
        ("def_alt_jq", ctypes.c_int32),
        ("use_baq", ctypes.c_int32), ("use_mq", ctypes.c_int32),
        ("use_sq", ctypes.c_int32),
        ("min_plp_idq", ctypes.c_int32),
        ("max_depth", ctypes.c_int32),
        ("baq_bias", ctypes.c_int32),
        ("screen_flat", ctypes.c_int32),
        ("skip_emit_counts", ctypes.c_int32),
        ("mq0_errprob", ctypes.c_double),
    ]


def supports_fused(vconf) -> bool:
    """The fused path covers all non-median def_alt_bq modes; in indel
    mode the per-event pools are attached sparsely (event columns only,
    _attach_indels) on top of the native column sweep."""
    return vconf.def_alt_bq != -1


def colconf_struct(pconf: PileupConf, vconf) -> _ColConf:
    return _ColConf(
        min_plp_bq=pconf.min_plp_bq,
        min_bq=vconf.min_bq, min_alt_bq=vconf.min_alt_bq,
        def_alt_bq=vconf.def_alt_bq,
        min_jq=vconf.min_jq, min_alt_jq=vconf.min_alt_jq,
        def_alt_jq=vconf.def_alt_jq,
        use_baq=1 if (vconf.use_baq
                      and not getattr(vconf, "baq_screen_null", False))
        else 0,
        use_mq=1 if vconf.use_mq else 0,
        use_sq=1 if vconf.use_sq else 0,
        min_plp_idq=pconf.min_plp_idq,
        max_depth=pconf.max_depth if pconf.max_depth
        and pconf.max_depth < (1 << 30) else 0,
        baq_bias=getattr(vconf, "baq_screen_bias", 0),
        # screening engines (host no-BAQ or device-BAQ): the prob CSR
        # feeds only permutation-invariant lower bounds (prescreen /
        # screen) — candidates re-derive exact probs from raw bytes
        # (confirm_snv_candidates) — so the fused sweep may emit
        # order-free values and skip the per-column nt4 regroup.
        # Mode 2 emits u8 log-quantized codes straight from the sweep
        # (1 B/row: kills the biggest write stream AND the separate
        # quantize pass); mode 1 keeps f32 for the Poisson-approx conf
        # (its mu needs real prob sums, caller._host_candidate_mask).
        screen_flat=(
            (2 if getattr(vconf, "approx_threshold_n", -1) <= 0 else 1)
            if (getattr(vconf, "baq_screen_null", False)
                or getattr(vconf, "baq_screen_bias", 0) > 0)
            else 0),
        # screening SNV-only mode: fw/rv, raw alt counts and the
        # consensus accumulation feed only indel emission and the
        # exact-confirm rebuild (which recomputes them exactly) — skip
        # their per-row scatter RMWs, the sweep's hottest traffic
        skip_emit_counts=1 if (
            (getattr(vconf, "baq_screen_null", False)
             or getattr(vconf, "baq_screen_bias", 0) > 0)
            and (vconf.no_indels or not pconf.collect_indels)) else 0,
        mq0_errprob=D.MQ0_ERRPROB,
    )


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def build_snv_batch(rows, flags_raw, win_beg, win_end, ref: bytes,
                    target: str, pconf: PileupConf, vconf,
                    pool=None) -> ColumnBatch:
    """Run the fused builder; returns a ColumnBatch with `.ep` attached
    (the errprob dict consumed by call_snvs_batch) or None if empty.
    pool: optional SlabPool generation source for the output arrays (the
    call pipeline rotates two generations; see SlabPool contract)."""
    from .native_ingest import SlabPool

    lib = get_lib()
    n = len(rows.pos)
    if n == 0:
        return None
    win_len = int(win_end - win_beg)
    cf = colconf_struct(pconf, vconf)
    W = win_len
    gen = pool.next_gen() if pool is not None else None
    tk = SlabPool.take
    out = dict(
        positions=tk(gen, "positions", W, np.int64),
        coverage=tk(gen, "coverage", W, np.int64),
        num_bases=tk(gen, "num_bases", W, np.int64),
        heads=tk(gen, "heads", W, np.int64),
        tails=tk(gen, "tails", W, np.int64),
        ref_nt4=tk(gen, "ref_nt4", W, np.uint8),
        cons_nt4=tk(gen, "cons_nt4", W, np.uint8),
        fw=tk(gen, "fw", W * 5, np.int64), rv=tk(gen, "rv", W * 5, np.int64),
        alt_cnt=tk(gen, "alt_cnt", W * 5, np.int64),
        alt_raw=tk(gen, "alt_raw", W * 5, np.int64),
        col_start=tk(gen, "col_start", W + 1, np.int64),
        probs=tk(gen, "probs", n, np.float64),
        num_ins=tk(gen, "num_ins", W, np.int64),
        num_dels=tk(gen, "num_dels", W, np.int64),
        num_non=tk(gen, "num_non", W, np.int64),
        num_ign=tk(gen, "num_ign", W, np.int64),
        ins_ne=tk(gen, "ins_ne", W, np.int64),
        del_ne=tk(gen, "del_ne", W, np.int64),
        ins_ev=tk(gen, "ins_ev", W, np.int64),
        del_ev=tk(gen, "del_ev", W, np.int64),
    )
    pos = np.ascontiguousarray(rows.pos, dtype=np.int64)
    nt4 = np.ascontiguousarray(rows.nt4, dtype=np.uint8)
    bq = np.ascontiguousarray(rows.bq, dtype=np.int16)
    baq = np.ascontiguousarray(rows.baq, dtype=np.int16)
    mq = np.ascontiguousarray(rows.mq, dtype=np.int16)
    sq = np.ascontiguousarray(rows.sq, dtype=np.int32)
    indel = np.ascontiguousarray(rows.indel, dtype=np.int32)
    iq = np.ascontiguousarray(rows.iq, dtype=np.int16)
    dq = np.ascontiguousarray(rows.dq, dtype=np.int16)
    flags_raw = np.ascontiguousarray(flags_raw, dtype=np.uint8)

    u8 = ctypes.POINTER(ctypes.c_uint8)
    i16 = ctypes.POINTER(ctypes.c_int16)
    i32 = ctypes.POINTER(ctypes.c_int32)
    f64 = ctypes.POINTER(ctypes.c_double)
    lib.lfq_build_columns.restype = ctypes.c_int64
    C = lib.lfq_build_columns(
        _i64p(pos), nt4.ctypes.data_as(u8), bq.ctypes.data_as(i16),
        baq.ctypes.data_as(i16), mq.ctypes.data_as(i16),
        sq.ctypes.data_as(i32), flags_raw.ctypes.data_as(u8),
        indel.ctypes.data_as(i32), iq.ctypes.data_as(i16),
        dq.ctypes.data_as(i16),
        ctypes.c_int64(n), ctypes.c_int64(win_beg), ctypes.c_int64(win_end),
        ref, ctypes.c_int64(len(ref)), ctypes.byref(cf),
        _i64p(out["positions"]), _i64p(out["coverage"]),
        _i64p(out["num_bases"]), _i64p(out["heads"]), _i64p(out["tails"]),
        out["ref_nt4"].ctypes.data_as(u8),
        out["cons_nt4"].ctypes.data_as(u8),
        _i64p(out["fw"]), _i64p(out["rv"]),
        _i64p(out["alt_cnt"]), _i64p(out["alt_raw"]),
        _i64p(out["col_start"]), out["probs"].ctypes.data_as(f64),
        _i64p(out["num_ins"]), _i64p(out["num_dels"]), _i64p(out["num_non"]),
        _i64p(out["num_ign"]), _i64p(out["ins_ne"]), _i64p(out["del_ne"]),
        _i64p(out["ins_ev"]), _i64p(out["del_ev"]),
    )
    if C <= 0:
        return None
    C = int(C)

    # consensus-indel gate: ev-sum > ne-sum is a conservative trigger (the
    # sum over all events bounds the max single event); re-check flagged
    # columns exactly using the sparse event rows.  In indel mode the
    # attach below recomputes cons_indel exactly from the event maps, so
    # the approximate recheck is skipped.
    cons_indel = [None] * C
    flag_ins = out["ins_ev"][:C] > out["ins_ne"][:C]
    flag_del = out["del_ev"][:C] > out["del_ne"][:C]
    flagged = np.nonzero(flag_ins | flag_del)[0] \
        if not pconf.collect_indels else np.zeros(0, np.int64)
    if len(flagged):
        flag_pos = set(out["positions"][flagged].tolist())
        ev_rows = np.nonzero((rows.indel != 0)
                             & np.isin(rows.pos, list(flag_pos)))[0]
        per_col_ins: dict = {}
        per_col_del: dict = {}
        for r in ev_rows:
            p = int(rows.pos[r])
            if rows.indel[r] > 0:
                seq = rows.events[rows.event_id[r]][0] \
                    if rows.event_id[r] >= 0 else ""
                per_col_ins.setdefault(p, {}).setdefault(seq, 0)
                per_col_ins[p][seq] += int(rows.iq[r])
            else:
                l = -int(rows.indel[r])
                seq = ref[p + 1 : p + 1 + l].decode()
                per_col_del.setdefault(p, {}).setdefault(seq, 0)
                per_col_del[p][seq] += int(rows.dq[r])
        pos_to_ci = {int(out["positions"][ci]): ci for ci in flagged}
        for p, ci in pos_to_ci.items():
            ins_max = max(per_col_ins.get(p, {"": 0}).values())
            del_max = max(per_col_del.get(p, {"": 0}).values())
            if ins_max > out["ins_ne"][ci]:
                key = max(per_col_ins[p], key=per_col_ins[p].get)
                cons_indel[ci] = ("+", key)
            elif del_max > out["del_ne"][ci]:
                key = max(per_col_del[p], key=per_col_del[p].get)
                cons_indel[ci] = ("-", key)

    batch = _batch_from_out(out, C, cons_indel, target)
    if pconf.collect_indels:
        _attach_indels(batch, rows, pconf, ref)
    return batch


def _batch_from_out(out, C, cons_indel, target) -> ColumnBatch:
    """ColumnBatch + ep bundle from the native column output arrays
    (shared by the row-path builder and the fused ingest->columns path)."""
    z = np.zeros(0, dtype=np.int64)
    batch = ColumnBatch(
        target=target,
        positions=out["positions"][:C],
        ref_nt4=out["ref_nt4"][:C],
        coverage_plp=out["coverage"][:C],
        num_bases=out["num_bases"][:C],
        num_heads=out["heads"][:C],
        num_tails=out["tails"][:C],
        fw_counts=out["fw"][: C * 5].reshape(C, 5),
        rv_counts=out["rv"][: C * 5].reshape(C, 5),
        cons_nt4=out["cons_nt4"][:C],
        cons_indel=cons_indel,
        hrun=np.ones(C, dtype=np.int64),
        col_start=np.zeros(C + 1, dtype=np.int64),
        b_nt4=z.astype(np.uint8), b_bq=z.astype(np.int16),
        b_baq=z.astype(np.int16), b_mq=z.astype(np.int16),
        b_sq=z.astype(np.int32),
        num_ins=out["num_ins"][:C],
        num_dels=out["num_dels"][:C],
        num_non_indels=out["num_non"][:C],
        num_ign_indels=out["num_ign"][:C],
        ins_events=[None] * C, del_events=[None] * C,
        ins_neq_start=np.zeros(C + 1, np.int64), ins_neq_q=z,
        ins_neq_mq=z, ins_neq_sq=z,
        ins_neq_sq_start=np.zeros(C + 1, np.int64),
        del_neq_start=np.zeros(C + 1, np.int64), del_neq_q=z,
        del_neq_mq=z, del_neq_sq=z,
        del_neq_sq_start=np.zeros(C + 1, np.int64),
        non_ins_fw_rv=np.zeros((C, 2), np.int64),
        non_del_fw_rv=np.zeros((C, 2), np.int64),
        has_indel_aqs=np.zeros(C, bool),
    )
    alt_nt = np.array(
        [[b for b in range(4) if b != r] if r < 4 else [0, 1, 2]
         for r in range(5)], dtype=np.int64
    )[batch.ref_nt4]
    rowsC = np.arange(C)[:, None]
    col_start = out["col_start"][: C + 1]
    depths = np.diff(col_start)
    batch.ep = dict(
        flat_probs=out["probs"][: col_start[-1]],
        starts=col_start,
        depths=depths,
        alt_nt=alt_nt,
        alt_counts=out["alt_cnt"][: C * 5].reshape(C, 5)[rowsC, alt_nt],
        alt_raw_counts=out["alt_raw"][: C * 5].reshape(C, 5)[rowsC, alt_nt],
    )
    return batch


def build_snv_batch_fused(rdr, ref: bytes, target: str, tid: int, beg, end,
                          pconf: PileupConf, vconf, raw=None, ign_pos=None,
                          device_baq=None, pool=None, keep_raw=False,
                          skip_consindel_gate=False):
    """Fused ingest->columns (csrc/ingest.c:lfq_ingest_columns): raw
    records straight to a ColumnBatch with no row materialization.
    Returns (batch_or_None, ok); ok=False means a consensus-indel recheck
    needs per-event rows — the caller falls back to the two-pass row path
    for this window (rare: indel-dominant columns).

    skip_consindel_gate: indel-mode callers attach exact per-event data
    (incl. the exact consensus-indel decision) to every event column
    afterwards (_attach_indels), which supersedes the conservative ev>ne
    gate — the fused batch is returned regardless."""
    from .native_ingest import ingest_columns

    cf = colconf_struct(pconf, vconf)
    out, C, raw = ingest_columns(rdr, pconf, cf, ref, tid, beg, end,
                                 raw=raw, ign_pos=ign_pos,
                                 device_baq=device_baq, pool=pool)
    if out is None:
        return None, True
    if not skip_consindel_gate:
        flag = (out["ins_ev"][:C] > out["ins_ne"][:C]) | \
               (out["del_ev"][:C] > out["del_ne"][:C])
        if flag.any():
            return None, False
    batch = _batch_from_out(out, C, [None] * C, target)
    if keep_raw:
        batch.raw = raw
    return batch, True


def _attach_indels(batch, rows, pconf: PileupConf, ref: bytes):
    """Sparse per-event indel attach for the fused path: the native sweep
    already produced the scalar counters (num_ins/num_dels/num_non/num_ign)
    for every column; the event maps, non-event CSR qual pools, fw/rv
    splits, exact consensus-indel decisions and hrun are only needed at
    columns that actually carry an indel event (plp.c:1017-1272), typically
    a tiny fraction — so this stays O(event rows), not O(all rows)."""
    from .engine import _collect_indels, hrun_at_positions

    ev_cols = np.nonzero((batch.num_ins > 0) | (batch.num_dels > 0))[0]
    if not len(ev_cols):
        return
    ev_pos = batch.positions[ev_cols]
    idx = np.nonzero(np.isin(rows.pos, ev_pos))[0]
    # stable sort by position: within a column, pileup read order is
    # preserved (same order the native counting sort visits rows)
    idx = idx[np.argsort(rows.pos[idx], kind="stable")]
    ci = ev_cols[np.searchsorted(ev_pos, rows.pos[idx])]
    md = pconf.max_depth
    if md and md < (1 << 30):
        # bam_mplp_set_maxcnt semantics: first max_depth rows per column
        rank = np.arange(len(ci)) - np.searchsorted(ci, ci)
        keep = rank < md
        idx, ci = idx[keep], ci[keep]
    f = {k: getattr(rows, k)[idx] for k in (
        "iq", "dq", "indel", "is_del", "strand", "mq", "sq", "iaq", "daq",
        "has_ai", "has_ad", "event_id")}
    _collect_indels(batch, rows, f, ci, pconf, ref, counts_done=True)
    batch.hrun[ev_cols] = hrun_at_positions(ref, ev_pos)
