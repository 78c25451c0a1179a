"""SNV + indel calling over column batches, screened on PyTorch.

Counterpart of lofreq_tpu/call/caller.py.  Only the functions that name
the device screen are forked here; each keeps the reference's body and
takes its screen from lofreq_tpu_torch.ops.screen.  Every other function
(err-prob building, packing, the exact DP, emission, the exact confirm of
screened candidates) is the reference's own.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, fields

import numpy as np
import torch

from lofreq_tpu import defaults as D
from lofreq_tpu import native
from lofreq_tpu.call import caller as _ref
from lofreq_tpu.call.caller import (  # noqa: F401  (re-exported)
    PACK_MAX_COLS,
    SCREEN_PIPE,
    _TOPK_MAX,
    CallStats,
    LazyCandidates,
    _depth_chunks,
    _emit_snvs,
    _host_candidate_mask,
    _indel_errprob_groups,
    _indel_errprobs,
    _report_var,
    confirm_snv_candidates,
    pack_probs,
    snv_errprobs_for_batch,
)
from lofreq_tpu.core import phred as PH
from lofreq_tpu.core import stagetimer
from lofreq_tpu.core.poissbin import (
    _exp_longdouble,
    probvec_tailsum_batch,
    pruned_prob_dist_batch,
)
from lofreq_tpu.pileup.engine import NT4, ColumnBatch

from ..ops.screen import (
    device_screen_default,
    host_screen_tail,
    host_screen_tail_codes,
    prescreen_codes,
    screen_codes_for,
    screen_dispatch,
    screen_dispatch_codes,
    screen_fetch,
)


@dataclass
class VarcallConf(_ref.VarcallConf):
    """The reference's varcall conf, with the screen and the device BAQ
    on a torch device.

    device: where the sub-screen and the device-BAQ runner run; None =
    "cuda" when a card is present, else "cpu" (the plain PyTorch
    versions).  Only tests set it, to run the plain versions on a host
    that has a card.  device_baq_on is the reference's own: on only with
    an explicit use_device_baq (--device-baq) and a configuration the
    BAQ-screening engines cover; otherwise the host no-BAQ screening
    engine runs."""

    device: str | None = None

    @classmethod
    def from_reference(cls, conf: _ref.VarcallConf, **kw) -> "VarcallConf":
        """The port's conf with every field of a reference conf."""
        vals = {f.name: getattr(conf, f.name)
                for f in fields(_ref.VarcallConf)}
        vals.update(kw)
        return cls(**vals)

    def device_screen_on(self) -> bool:
        if self.use_device_screen is None:
            return device_screen_default()
        return self.use_device_screen

    def screen_device(self) -> torch.device:
        if self.device is not None:
            return torch.device(self.device)
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def call_snvs_batch(batch: ColumnBatch, conf: VarcallConf, stats: CallStats,
                    out_vars: list, screen_ctx: list = None):
    """call_snvs over a ColumnBatch (lofreq_call.c:735-879); the
    reference's body (lofreq_tpu/call/caller.py:call_snvs_batch).

    screen_ctx: when given (screening engine), run the screening pass
    only: candidate columns are appended to screen_ctx as (position, bonf)
    for exact confirmation (confirm_snv_candidates)."""
    C = len(batch.positions)
    if C == 0:
        return
    # column gates (call_vars + call_snvs entry)
    cons_is_indel = np.array([ci is not None for ci in batch.cons_indel])
    gate = (
        (batch.ref_nt4 != 4)
        & (batch.num_bases >= conf.min_cov)
        & ~cons_is_indel
        & ~(batch.num_bases * 2 < batch.coverage_plp)
    )

    ep = getattr(batch, "ep", None)
    if ep is None:
        if screen_ctx is not None:
            raise RuntimeError(
                "BAQ screening requires the fused column path "
                "(its ep carries the screening merge)")
        ep = snv_errprobs_for_batch(batch, conf)
    if screen_ctx is None and ep["flat_probs"].dtype != np.float64:
        raise RuntimeError(
            "screening-mode err probs (order-free f32/u8, screen_flat) "
            "cannot feed the exact DP — pass screen_ctx or rebuild the "
            "batch with the screening flags off")
    got_alt = ep["alt_counts"].sum(axis=1) > 0
    test = gate & got_alt
    n_test = int(test.sum())
    if n_test == 0:
        return

    # dynamic Bonferroni: the running factor at each tested column is
    # NUM_NONCONS_BASES * (# tested columns so far incl. this one)
    # (lofreq_call.c:794-800)
    order_idx = np.nonzero(test)[0]
    if conf.bonf_dynamic:
        start = 0 if conf.bonf_subst == 1 else conf.bonf_subst
        running_bonf = start + D.NUM_NONCONS_BASES * np.arange(
            1, n_test + 1, dtype=np.int64
        )
        conf.bonf_subst = int(running_bonf[-1])
    else:
        running_bonf = np.full(n_test, conf.bonf_subst, dtype=np.int64)
    stats.num_snv_tests += D.NUM_NONCONS_BASES * n_test

    d_tested = ep["depths"][order_idx]
    if screen_ctx is not None:
        # code-native front-end first (C top-S codes, integer prescreen,
        # survivors-only sub-screen); the prob-pack loop below only runs
        # when the native codes kernel is unavailable
        if (ep["flat_probs"].dtype in (np.float32, np.uint8)
                and conf.approx_threshold_n <= 0
                and _screen_codes_flow(batch, ep, order_idx, running_bonf,
                                       conf, screen_ctx)):
            return
        if ep["flat_probs"].dtype == np.uint8:
            raise RuntimeError(
                "u8 code CSR (screen_flat==2) requires the native "
                "screen-codes kernel — it produced the CSR, so this is "
                "unreachable unless the lib was unloaded mid-process")
        # software-pipelined: up to SCREEN_PIPE chunks' screens are in
        # flight before chunk N's mask is fetched
        q = deque()  # (sel, cols, host_mask, sub_handle) FIFO
        for sel in _depth_chunks(d_tested) + [None]:
            if sel is not None:
                cols = order_idx[sel]
                bonf_f = running_bonf[sel].astype(np.float64)
                with stagetimer.stage("pack_sort"):
                    probs = pack_probs(ep["flat_probs"], ep["starts"],
                                       ep["depths"], cols, sort=False)
                with stagetimer.stage("prescreen"):
                    host_mask = _host_candidate_mask(
                        probs, ep["depths"][cols], ep["alt_counts"][cols],
                        bonf_f, conf)
                with stagetimer.stage("screen"):
                    sub = _screen_dispatch_sub(
                        probs, ep["depths"][cols], ep["alt_counts"][cols],
                        bonf_f, conf, host_mask)
                q.append((sel, cols, host_mask, sub))
            while q and (len(q) > SCREEN_PIPE or sel is None):
                psel, pcols, pmask, psub = q.popleft()
                with stagetimer.stage("screen"):
                    cand = _screen_apply(pmask, psub)
                for j in np.nonzero(cand)[0]:
                    screen_ctx.append((int(batch.positions[pcols[j]]),
                                       int(running_bonf[psel[j]])))
        return

    pvalues = np.full((n_test, 3), PH.LDBL_MAX, dtype=np.longdouble)
    # pack UNSORTED and sort only the rows that reach the exact DP (the
    # screen and the Poisson approximation are permutation invariant);
    # up to SCREEN_PIPE chunks' screens are in flight while chunk N runs
    # its exact host DP
    q = deque()  # (sel, cols, probs, host_mask, sub_handle) FIFO
    for sel in _depth_chunks(d_tested) + [None]:
        if sel is not None:
            cols = order_idx[sel]
            bonf_f = running_bonf[sel].astype(np.float64)
            with stagetimer.stage("pack_sort"):
                probs = pack_probs(ep["flat_probs"], ep["starts"],
                                   ep["depths"], cols, sort=False)
            with stagetimer.stage("prescreen"):
                host_mask = _host_candidate_mask(
                    probs, ep["depths"][cols], ep["alt_counts"][cols],
                    bonf_f, conf)
            with stagetimer.stage("screen"):
                sub = _screen_dispatch_sub(
                    probs, ep["depths"][cols], ep["alt_counts"][cols],
                    bonf_f, conf, host_mask)
            q.append((sel, cols, probs, host_mask, sub))
        while q and (len(q) > SCREEN_PIPE or sel is None):
            psel, pcols, pprobs, pmask, psub = q.popleft()
            with stagetimer.stage("screen"):
                run_mask = _screen_apply(pmask, psub)
            pvalues[psel] = _snpcaller_with_screen(
                pprobs, ep["depths"][pcols], ep["alt_counts"][pcols],
                running_bonf[psel].astype(np.float64), conf,
                presorted=False, precomputed_mask=run_mask,
            )

    _emit_snvs(out_vars, batch, ep, order_idx, pvalues, running_bonf, conf)


def _screen_codes_flow(batch, ep, order_idx, running_bonf, conf,
                       screen_ctx) -> bool:
    """Code-native screening for the whole batch: C-side top-S u8 codes,
    integer-cumsum top-k prescreen, survivors-only sub-screen on the
    device (host clipped-K DP when the device screen is off), candidates
    appended as a LazyCandidates.  Returns False when the native kernel is
    unavailable (the caller falls back to the prob-pack loop).

    Not used when conf.approx_threshold_n > 0: the Poisson approximation
    needs the FULL prob sum, which the top-S subset understates."""
    with stagetimer.stage("pack_sort"):
        codes = screen_codes_for(ep["flat_probs"], ep["starts"], order_idx)
    if codes is None:
        return False
    ks_t = ep["alt_counts"][order_idx].max(axis=1)
    with stagetimer.stage("prescreen"):
        keep = prescreen_codes(codes, ks_t, running_bonf, conf.sig,
                               topk_max=_TOPK_MAX)
    surv = np.nonzero(keep)[0]
    if not len(surv):
        return True
    # the sub-screen runs inside a lazy resolver on the pipeline's confirm
    # executor, overlapping later windows' sweeps.  Survivor positions are
    # COPIED now: batch.positions is slab-pooled and its generation can be
    # recycled before the resolver runs.
    positions = np.asarray(batch.positions)[order_idx[surv]].copy()
    dev_on = conf.device_screen_on()
    device = conf.screen_device()

    def _resolve():
        cands = []
        for lo in range(0, len(surv), PACK_MAX_COLS):
            ch = surv[lo:lo + PACK_MAX_COLS]
            bonf_f = running_bonf[ch].astype(np.float64)
            with stagetimer.stage("screen"):
                if dev_on:
                    cand = screen_fetch(screen_dispatch_codes(
                        codes[ch], ks_t[ch], bonf_f, conf.sig, device))
                else:
                    cand = host_screen_tail_codes(codes[ch], ks_t[ch],
                                                  bonf_f, conf.sig)
            for j in np.nonzero(cand)[0]:
                t = int(ch[j])
                cands.append((int(positions[lo + int(j)]),
                              int(running_bonf[t])))
        return cands

    screen_ctx.append(LazyCandidates(_resolve))
    return True


def _screen_dispatch_sub(probs, depths, alt_counts, bonf,
                         conf: VarcallConf, host_mask):
    """Issue the sub-screen for the host-mask survivors only: on the
    device when the screen is on (asynchronous until _screen_apply), else
    the host f64 clipped-K tail DP.

    Returns ('dev', sidx, handle) | ('host', sidx, keep) | None."""
    sidx = np.nonzero(host_mask)[0]
    if not len(sidx):
        return None
    ks = alt_counts.max(axis=1)
    if conf.device_screen_on():
        h = screen_dispatch(probs[sidx], depths[sidx], ks[sidx],
                            bonf[sidx], conf.sig, conf.screen_device())
        return ("dev", sidx, h)
    keep = host_screen_tail(probs[sidx], depths[sidx], ks[sidx],
                            bonf[sidx], conf.sig)
    return ("host", sidx, keep)


def _screen_apply(host_mask, sub):
    """Combine a host candidate mask with a sub-screen's verdicts
    (None = no survivors: host mask rules)."""
    if sub is None:
        return host_mask
    kind, sidx, h = sub
    keep = screen_fetch(h) if kind == "dev" else h
    mask = host_mask.copy()
    mask[sidx[~keep]] = False
    return mask


def _snpcaller_with_screen(probs, depths, alt_counts, bonf, conf: VarcallConf,
                           presorted=True, precomputed_mask=None):
    """snpcaller over packed columns, candidate-filtered first; the
    reference's body (lofreq_tpu/call/caller.py:_snpcaller_with_screen).

    presorted=False: rows are packed unsorted; the reference's
    eps-comparator qsort is applied only to the candidate rows that
    reach the exact DP.  precomputed_mask: the pipelined caller already
    combined host mask + device sub-screen for this chunk."""
    B = probs.shape[0]
    pvalues = np.full((B, 3), PH.LDBL_MAX, dtype=np.longdouble)
    ks = alt_counts.max(axis=1)
    if precomputed_mask is not None:
        run_mask = precomputed_mask
    else:
        with stagetimer.stage("prescreen"):
            run_mask = _host_candidate_mask(probs, depths, alt_counts,
                                            bonf, conf)
        with stagetimer.stage("screen"):
            run_mask = _screen_apply(
                run_mask, _screen_dispatch_sub(probs, depths, alt_counts,
                                               bonf, conf, run_mask))
    idx = np.nonzero(run_mask)[0]
    if len(idx) == 0:
        return pvalues
    sub = probs[idx]
    if not presorted:
        with stagetimer.stage("pack_sort"):
            native.sort_errprobs_batch(sub, depths[idx])
    with stagetimer.stage("exact_dp"):
        state, _ = pruned_prob_dist_batch(sub, depths[idx], ks[idx],
                                          bonf[idx], conf.sig)
    sub_ks = ks[idx]
    tail = state[np.arange(len(idx)), sub_ks]
    pv_max = _exp_longdouble(tail)
    sig_ok = pv_max * bonf[idx] < conf.sig
    for i in range(3):
        counts = alt_counts[idx, i]
        todo = sig_ok & (counts != 0)
        if not np.any(todo):
            continue
        sel = np.nonzero(todo)[0]
        ts = probvec_tailsum_batch(state[sel], counts[sel], sub_ks[sel])
        pvalues[idx[sel], i] = _exp_longdouble(ts)
    return pvalues


def call_indels_batch(batch: ColumnBatch, conf: VarcallConf, stats: CallStats,
                      out_vars: list):
    """call_indels over a batch (lofreq_call.c:618-726)."""
    with stagetimer.stage("indels"):
        _call_indels_batch(batch, conf, stats, out_vars)


def _call_indels_batch(batch: ColumnBatch, conf: VarcallConf,
                       stats: CallStats, out_vars: list):
    """The reference's body (lofreq_tpu/call/caller.py:_call_indels_batch):
    pass 1 walks columns/events in reference order building each event's
    sorted err-prob vector and its dynamic Bonferroni factor; pass 2 runs
    one screened batch DP over all events, then emits in the same order."""
    C = len(batch.positions)
    pend_probs: list = []   # per-event sorted err-prob vectors
    pend_meta: list = []    # (c, key, is_ins, ev, bonf)
    for c in range(C):
        if batch.ref_nt4[c] == 4:
            continue
        if (batch.num_non_indels[c] + batch.num_ins[c] + batch.num_dels[c]
                < conf.min_cov):
            continue
        ins_events = batch.ins_events[c] or {}
        del_events = batch.del_events[c] or {}
        ign_nt = set()
        # multiallelic low-AF 1-bp poly-AT suppression (lofreq_call.c:643-681)
        if batch.num_ins[c] and batch.ins_neq_len(c) and batch.num_dels[c] \
                and batch.del_neq_len(c):
            max_af = np.float32(0.05)
            denom = np.float32(batch.coverage_plp[c] - batch.num_tails[c])
            ins1 = {k: e.count for k, e in ins_events.items()
                    if len(k) == 1 and k in "AT"}
            del1 = {k: e.count for k, e in del_events.items()
                    if len(k) == 1 and k in "AT"}
            for nt in ("A", "T"):
                if ins1.get(nt) and del1.get(nt):
                    ins_af = np.float32(ins1[nt]) / denom
                    del_af = np.float32(del1[nt]) / denom
                    if ins_af < max_af and del_af < max_af:
                        ign_nt.add(nt)

        for events, is_ins in ((ins_events, True), (del_events, False)):
            count_gate = batch.num_ins[c] if is_ins else batch.num_dels[c]
            if not count_gate:
                continue
            neq = batch.ins_neq_at(c) if is_ins else batch.del_neq_at(c)
            groups = _indel_errprob_groups(neq, events, conf)
            for key, ev in events.items():
                if len(key) == 1 and key in ign_nt:
                    continue
                probs = _indel_errprobs(neq, events, key, conf, is_ins,
                                        groups=groups)
                if conf.bonf_dynamic:
                    conf.bonf_indel += 1
                stats.num_indel_tests += 1
                pend_probs.append(probs)
                pend_meta.append((c, key, is_ins, ev, conf.bonf_indel))

    E = len(pend_meta)
    if E == 0:
        return
    # pass 2: one screened batch DP over all pending events, chunked to
    # bound the packed-matrix footprint
    pvals = np.empty(E, dtype=np.longdouble)
    all_depths = np.array([len(p) for p in pend_probs], dtype=np.int64)
    for sel in _depth_chunks(all_depths):
        depths = all_depths[sel]
        Dmax = max(int(depths.max()), 1)
        probs = np.full((len(sel), Dmax), 2.0, dtype=np.float64)
        for j, k in enumerate(sel):
            probs[j, : all_depths[k]] = pend_probs[k]
        alt_counts = np.zeros((len(sel), 3), dtype=np.int64)
        alt_counts[:, 0] = [pend_meta[k][3].count for k in sel]
        bonfs = np.array([float(pend_meta[k][4]) for k in sel])
        pvals[sel] = _snpcaller_with_screen(
            probs, depths, alt_counts, bonfs, conf)[:, 0]

    for (c, key, is_ins, ev, bonf), pv in zip(pend_meta, pvals):
        with np.errstate(over="ignore"):
            is_sig = pv * np.longdouble(bonf) < conf.sig
        if is_sig:
            if not batch.has_indel_aqs[c]:
                stats.indel_calls_wo_idaq += 1
            refbase = NT4[batch.ref_nt4[c]]
            if is_ins:
                ref_s, alt_s = refbase, refbase + key
                dp4 = (int(batch.non_ins_fw_rv[c, 0]),
                       int(batch.non_ins_fw_rv[c, 1]),
                       ev.fw_rv[0], ev.fw_rv[1])
            else:
                ref_s, alt_s = refbase + key, refbase
                dp4 = (int(batch.non_del_fw_rv[c, 0]),
                       int(batch.non_del_fw_rv[c, 1]),
                       ev.fw_rv[0], ev.fw_rv[1])
            af = np.float32(ev.count) / np.float32(
                batch.coverage_plp[c] - batch.num_tails[c])
            _report_var(
                out_vars, batch.target, batch.positions[c],
                ref_s, alt_s, af, PH.prob_to_phred(pv), 1, 0, dp4,
                int(batch.coverage_plp[c] - batch.num_tails[c]),
                int(batch.hrun[c]), 0,
            )


def call_vars_batch(batch: ColumnBatch, conf: VarcallConf,
                    stats: CallStats, screen_ctx: list = None) -> list:
    """call_vars over a batch: indels first, then SNVs (lofreq_call.c:887)."""
    out: list = []
    if batch is None:
        return out
    if not conf.no_indels:
        call_indels_batch(batch, conf, stats, out)
    if not conf.only_indels:
        call_snvs_batch(batch, conf, stats, out, screen_ctx=screen_ctx)
    # indels then SNVs at one position, both already position-sorted: a
    # stable sort by position keeps the reference's per-column order
    out.sort(key=lambda v: v.pos)
    return out
