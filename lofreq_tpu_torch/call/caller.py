"""SNV + indel calling over column batches.

Batched re-derivation of the reference's per-column flow
(call_vars/call_snvs/call_indels, lofreq_call.c:618-935) with the exact
same filters, quality merging, dynamic-Bonferroni accounting and VCF record
contents.  The heavy Poisson-binomial work can be pre-screened on a torch
device (ops.screen: kernel K1 on a CUDA card, its plain PyTorch version on
the CPU) before the exact native DP confirms candidates.

The port's fork of lofreq_tpu/call/caller.py: the statistics and the
records are the reference's.  VarcallConf is the port's own, with a torch
device and no engine logic (call/engines.py decides the engines once per
run), and the sub-screen's device is passed down as `screen` from
call_vars_batch to the functions that issue it.  call_snvs_batch's two
passes share one chunk loop (_screened_chunks).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, fields

import numpy as np
import torch

from .. import defaults as D
from ..core import phred as PH
from ..core import stagetimer
from ..core.fisher import strand_bias_qual
from ..core.poissbin import pruned_prob_dist_batch, probvec_tailsum_batch, _exp_longdouble
from ..core.quals import merge_srcq_mapq_baq_and_bq
from ..io.vcf import Var, sprintf_info
from ..ops import engine_device
from ..pileup.engine import NT4, ColumnBatch
from ..ops.screen import (
    host_screen_tail,
    host_screen_tail_codes,
    prescreen_codes,
    screen_codes_for,
    screen_dispatch,
    screen_dispatch_codes,
    screen_fetch,
)


@dataclass
class VarcallConf:
    """varcall_conf_t equivalent (snpcaller.h:38-63): the reference's
    fields, and the torch device of the device engines.

    device: where the device screen and the device-BAQ runner run.
    "cuda" (the default) launches the hand-written kernels and raises
    when there is no card; "cpu" runs their plain PyTorch versions and is
    meant for tests.  Which engines a run uses is call/engines.py's
    resolve_engines, from use_device_screen and use_device_baq; run_call
    never writes its choice back into the conf."""

    min_bq: int = D.DEFAULT_MIN_BQ
    min_alt_bq: int = D.DEFAULT_MIN_ALT_BQ
    def_alt_bq: int = D.DEFAULT_DEF_ALT_BQ
    min_jq: int = D.DEFAULT_MIN_JQ
    min_alt_jq: int = D.DEFAULT_MIN_ALT_JQ
    def_alt_jq: int = D.DEFAULT_DEF_ALT_JQ
    min_cov: int = D.DEFAULT_MIN_COV
    max_depth: int = D.DEFAULT_MAX_PLP_DEPTH
    bonf_dynamic: bool = True
    bonf_subst: int = 1
    bonf_indel: int = 1
    sig: float = D.DEFAULT_SIG
    use_baq: bool = True
    use_mq: bool = True
    use_sq: bool = False
    use_idaq: bool = True
    only_indels: bool = False
    no_indels: bool = True
    approx_threshold_n: int = -1
    # implementation switches (not in the reference).  None = auto: the
    # device screen is ON whenever a CUDA card is present, the exact host
    # DP only confirms candidates
    use_device_screen: bool | None = None
    # device BAQ: the read-rescoring HMM runs on device in f32 as a
    # *screening* signal; candidate columns are re-scored with the exact C
    # BAQ before emission, so the VCF is identical to the all-exact path
    use_device_baq: bool | None = None
    # the sweep's screening BAQ (the reference's fields): the phred
    # deflation of the device BAQ, and the no-BAQ merge, whose err probs
    # are per-base lower bounds (BAQ is a min against bq).  Set only on
    # the copies resolve_engines makes for the sweep
    baq_screen_bias: int = 0
    baq_screen_null: bool = False
    device: str = "cuda"

    def __post_init__(self):
        # the reference stores sig as a C float (snpcaller.h:53), so every
        # downstream pv*bonf < sig comparison and the auto-filter threshold
        # derivation (lofreq_call.c:1524-1537) see the float32-rounded value
        self.sig = float(np.float32(self.sig))

    @classmethod
    def from_reference(cls, conf, **kw) -> "VarcallConf":
        """The port's conf with every field of `conf`, a dataclass with
        the reference's fields (lofreq_tpu's VarcallConf); `kw` overrides."""
        vals = {f.name: getattr(conf, f.name) for f in fields(conf)}
        vals.update(kw)
        return cls(**vals)

    def screen_device(self) -> torch.device:
        """The device engines' torch device; raises for "cuda" on a host
        without a card."""
        return engine_device(self.device)


@dataclass
class CallStats:
    num_snv_tests: int = 0
    num_indel_tests: int = 0
    indel_calls_wo_idaq: int = 0


def _report_var(out_vars, target, pos, ref, alt, af, qual, is_indel,
                is_consvar, dp4, dp, hrun, num_alt_bases):
    """report_var equivalent (lofreq_call.c:92-137)."""
    sb_qual = strand_bias_qual(*dp4)
    v = Var(chrom=target, pos=int(pos), ref=ref, alt=alt)
    if qual > -1:
        v.qual = int(qual)
    v.info = sprintf_info(dp, af, sb_qual, dp4, is_indel, hrun,
                          is_consvar, num_alt_bases)
    out_vars.append(v)


def grouped_int_median(vals, group, n_groups: int) -> np.ndarray:
    """Per-group int median matching int_median (utils.c:436-462): even n
    averages the two middle elements with C double->int truncation; empty
    groups get -1.  Vectorized: lexsort by (group, val), then index the
    middle element(s) of each group's sorted slice."""
    order = np.lexsort((vals, group))
    vs = vals[order]
    cnt = np.bincount(group, minlength=n_groups)
    starts = np.zeros(n_groups, dtype=np.int64)
    starts[1:] = np.cumsum(cnt)[:-1]
    med = np.full(n_groups, -1, dtype=np.int64)
    nz = cnt > 0
    if len(vs):
        mid = starts + cnt // 2
        cap = len(vs) - 1
        hi_v = vs[np.minimum(mid, cap)]
        lo_v = np.where(cnt % 2 == 0, vs[np.clip(mid - 1, 0, cap)], hi_v)
        med[nz] = ((hi_v + lo_v)[nz] / 2.0).astype(np.int64)
    return med


# ---------------------------------------------------------------------------
# SNVs
# ---------------------------------------------------------------------------

def snv_errprobs_for_batch(batch: ColumnBatch, conf: VarcallConf):
    """Vectorized plp_to_errprobs (snpcaller.c:345-498) over all columns.

    Returns a dict with per-column packed err-prob matrix (sorted ascending),
    depths, per-alt counts (filtered + raw) and alt base identities.
    """
    C = len(batch.positions)
    nt4 = batch.b_nt4.astype(np.int64)
    bq = batch.b_bq.astype(np.int64)
    baq = batch.b_baq.astype(np.int64)
    mq = batch.b_mq.astype(np.int64)
    sq = batch.b_sq.astype(np.int64)
    col_of = np.repeat(np.arange(C), np.diff(batch.col_start))

    ref_nt4_row = batch.ref_nt4[col_of].astype(np.int64)
    not_n = nt4 != 4
    is_alt = not_n & (nt4 != ref_nt4_row)

    # raw alt counts (before bq filtering)
    alt_raw = np.zeros((C, 5), dtype=np.int64)
    np.add.at(alt_raw, (col_of[is_alt], nt4[is_alt]), 1)

    keep = not_n & (bq >= conf.min_bq) & (~is_alt | (bq >= conf.min_alt_bq))

    bq_eff = bq.copy()
    if conf.def_alt_bq == -1:
        # median BQ of ref bases per column (snpcaller.c:363-378)
        ref_rows = not_n & (nt4 == ref_nt4_row)
        med = grouped_int_median(bq[ref_rows], col_of[ref_rows], C)
        bq_eff = np.where(is_alt, med[col_of], bq_eff)
    elif conf.def_alt_bq > 0:
        bq_eff = np.where(is_alt, conf.def_alt_bq, bq_eff)

    baq_eff = baq if conf.use_baq else np.full_like(baq, -1)
    mq_eff = mq.copy() if conf.use_mq else np.full_like(mq, -1)
    if conf.use_mq:
        mq_eff = np.where(mq_eff == 255, -1, mq_eff)
    sq_eff = sq if conf.use_sq else np.full_like(sq, -1)

    merged = merge_srcq_mapq_baq_and_bq(sq_eff, mq_eff, baq_eff, bq_eff)
    if conf.min_jq > 0 or conf.min_alt_jq > 0:
        # joint-quality filters are phred-threshold comparisons; skip the
        # (longdouble) phred conversion entirely at the 0 defaults
        merged_qual = PH.prob_to_phred_safe_vec(merged)
        keep &= merged_qual >= conf.min_jq
        keep &= ~is_alt | (merged_qual >= conf.min_alt_jq)
    if conf.def_alt_jq > 0:
        merged = np.where(is_alt & keep,
                          PH.phred_to_prob(conf.def_alt_jq), merged)

    alt_counts5 = np.zeros((C, 5), dtype=np.int64)
    ka = keep & is_alt
    np.add.at(alt_counts5, (col_of[ka], nt4[ka]), 1)

    depths = np.bincount(col_of[keep], minlength=C)
    # keep err probs flat (CSR), nt4-grouped within each column in the
    # reference's emission order (plp_to_errprobs iterates A,C,G,T groups,
    # snpcaller.c:383-400); read order is preserved within a group.  The
    # value sort happens exactly once downstream with the reference's
    # eps-comparator qsort (pack_probs) — or not at all (uniq).
    order = np.argsort((col_of * 5 + nt4)[keep], kind="stable")
    kept_vals = merged[keep][order]
    starts = np.zeros(C + 1, dtype=np.int64)
    starts[1:] = np.cumsum(depths)

    # per-column alt bases in ACGT order excluding ref (3 of them)
    alt_nt = np.array(
        [[b for b in range(4) if b != r] if r < 4 else [0, 1, 2]
         for r in range(5)], dtype=np.int64
    )[batch.ref_nt4]  # [C, 3]
    rows = np.arange(C)[:, None]
    return dict(
        flat_probs=kept_vals,
        starts=starts,
        depths=depths,
        alt_nt=alt_nt,
        alt_counts=alt_counts5[rows, alt_nt],
        alt_raw_counts=alt_raw[rows, alt_nt],
    )


def pack_probs(flat_probs, starts, depths, cols, sort=True):
    """Pack the selected columns' err probs into [len(cols), Dmax], each row
    sorted with the reference's eps-comparator qsort (lofreq_call.c:784 +
    utils.c dbl_cmp); the 2.0 pad beyond depths[b] is left untouched.

    sort=False skips the qsort: the device screen is permutation
    invariant, so the screened path packs unsorted and sorts only the
    candidate rows that reach the exact DP (_snpcaller_with_screen).

    flat_probs may be float32 (screening mode, where the sweep emits
    order-free f32 — icolconf_t screen_flat); the pack then stays f32
    end to end, since those probs only feed the permutation-invariant
    prescreen/screen lower bounds, never the exact DP."""
    from .. import native

    f32 = flat_probs.dtype == np.float32
    assert not (f32 and sort), "f32 probs never reach the exact-DP sort"
    d = depths[cols]
    Dmax = int(d.max()) if len(cols) else 0
    probs = np.empty((len(cols), max(Dmax, 1)),
                     dtype=np.float32 if f32 else np.float64)
    if len(cols):
        # native threaded gather (+ per-row reference qsort when sort=True)
        if f32:
            native.pack_probs_batch_f32(flat_probs, starts, depths, cols,
                                        probs)
        else:
            native.pack_probs_batch(flat_probs, starts, depths, cols,
                                    probs, sort)
    else:
        probs.fill(2.0)
    return probs


PACK_BUDGET_BYTES = 256 << 20
PACK_MAX_COLS = 4096

#: sub-screens in flight in _screened_chunks.  A K1 launch on CUDA is
#: asynchronous until its mask is fetched, so the kernel and its copies
#: run under the host's pack and prescreen of the next chunks.  Output
#: is order-independent (per-chunk masks and p-values scatter through
#: index arrays), so the depth only moves latency.
SCREEN_PIPE = 3


def _depth_chunks(depths, max_cols: int = PACK_MAX_COLS,
                  budget: int = PACK_BUDGET_BYTES) -> list:
    """Depth-bucketed packing order: index arrays (into `depths`) whose
    packed [rows, Dmax] f64 matrices each stay under `budget` bytes.

    Sorting by depth before chunking keeps similar depths together, so
    one 10^5-10^6-deep column (reference max-depth default is 1e6,
    defaults.h:60) no longer inflates every row of its chunk to Dmax —
    without it a single deep column in a 4096-column chunk allocates
    4096 x depth x 8 bytes.  The pack order is free: each column's
    p-value and dynamic-Bonferroni factor are precomputed per column,
    and results are scattered back through the returned indices."""
    n = len(depths)
    if n == 0:
        return []
    perm = np.argsort(depths, kind="stable")
    d = np.asarray(depths)[perm]
    chunks = []
    i = 0
    while i < n:
        j = i + 1
        while (j < n and j - i < max_cols
               and (j - i + 1) * max(int(d[j]), 1) * 8 <= budget):
            j += 1
        chunks.append(perm[i:j])
        i = j
    return chunks


def call_snvs_batch(batch: ColumnBatch, conf: VarcallConf, stats: CallStats,
                    out_vars: list, screen_ctx: list = None, screen=None):
    """call_snvs over a ColumnBatch (lofreq_call.c:735-879).

    screen: the sub-screen's torch device (call/engines.py), None for the
    host f64 DP.  screen_ctx: when given, run the screening pass only —
    test counting and the dynamic-Bonferroni sequence advance exactly as in
    the exact pass (both are BAQ-independent), but instead of emitting,
    candidate columns are appended to screen_ctx as (position, bonf) for
    exact confirmation (confirm_snv_candidates)."""
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
                "device-BAQ screening requires the fused column path "
                "(its ep carries the deflated screening merge)")
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
    # (lofreq_call.c:794-800; the 1->3 first-column special case makes the
    # sequence exactly 3, 6, 9, ...)
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

    if screen_ctx is not None:
        # screening pass: the sweep merged its probs without the BAQ or
        # with the deflated device BAQ, per-base lower bounds of the exact
        # err probs, so every screened tail is a lower bound and discards
        # are safe.  Candidates are recorded (position, running bonf) and
        # re-scored exactly later; nothing is emitted here.  The code
        # front end (csrc/screen_pack.c) turns the sweep's CSR into top-S
        # u8 codes in C, prescreens by an integer cumsum and ships only
        # the survivors; codes decode to <= the true probs.
        if (ep["flat_probs"].dtype in (np.float32, np.uint8)
                and conf.approx_threshold_n <= 0
                and _screen_codes_flow(batch, ep, order_idx, running_bonf,
                                       conf, screen_ctx, screen)):
            return
        if ep["flat_probs"].dtype == np.uint8:
            raise RuntimeError(
                "u8 code CSR (screen_flat==2) requires the native "
                "screen-codes kernel — it produced the CSR, so this is "
                "unreachable unless the lib was unloaded mid-process")
        for sel, cols, _probs, mask in _screened_chunks(
                ep, order_idx, running_bonf, conf, screen):
            for j in np.nonzero(mask)[0]:
                screen_ctx.append((int(batch.positions[cols[j]]),
                                   int(running_bonf[sel[j]])))
        return

    # the exact pass packs unsorted: the screens and the Poisson
    # approximation pre-filter (snpcaller.c:1128-1142) are permutation
    # invariant, and the reference's eps-comparator qsort is observable
    # only through the exact DP, so _snpcaller_with_screen sorts just the
    # candidate rows that reach it
    pvalues = np.full((n_test, 3), PH.LDBL_MAX, dtype=np.longdouble)
    for sel, cols, probs, mask in _screened_chunks(
            ep, order_idx, running_bonf, conf, screen):
        pvalues[sel] = _snpcaller_with_screen(
            probs, ep["depths"][cols], ep["alt_counts"][cols],
            running_bonf[sel].astype(np.float64), conf,
            presorted=False, precomputed_mask=mask)

    _emit_snvs(out_vars, batch, ep, order_idx, pvalues, running_bonf, conf)


def _screened_chunks(ep, order_idx, running_bonf, conf, screen):
    """(sel, cols, probs, mask) of each depth chunk of the tested
    columns, in chunk order: sel indexes order_idx, probs is the unsorted
    pack and mask the host candidate filter combined with the sub-screen.
    Up to SCREEN_PIPE chunks' sub-screens are in flight before the first
    of them is fetched, so the consumer's work on a chunk overlaps the
    later chunks' screens."""
    q = deque()  # (sel, cols, probs, host_mask, sub) FIFO
    for sel in _depth_chunks(ep["depths"][order_idx]) + [None]:
        if sel is not None:
            cols = order_idx[sel]
            depths, alts = ep["depths"][cols], ep["alt_counts"][cols]
            bonf_f = running_bonf[sel].astype(np.float64)
            with stagetimer.stage("pack_sort"):
                probs = pack_probs(ep["flat_probs"], ep["starts"],
                                   ep["depths"], cols, sort=False)
            with stagetimer.stage("prescreen"):
                host_mask = _host_candidate_mask(probs, depths, alts,
                                                 bonf_f, conf)
            with stagetimer.stage("screen"):
                sub = _screen_dispatch_sub(probs, depths, alts, bonf_f,
                                           conf, host_mask, screen)
            q.append((sel, cols, probs, host_mask, sub))
        while q and (len(q) > SCREEN_PIPE or sel is None):
            psel, pcols, pprobs, pmask, psub = q.popleft()
            with stagetimer.stage("screen"):
                mask = _screen_apply(pmask, psub)
            yield psel, pcols, pprobs, mask


def _emit_snvs(out_vars, batch, ep, order_idx, pvalues, running_bonf, conf):
    """Significance gate + VCF record construction (lofreq_call.c:820-877)."""
    sig = conf.sig
    err_state = np.errstate(over="ignore")  # LDBL_MAX * bonf -> inf is fine
    with err_state:
        sig_mask = pvalues * np.asarray(running_bonf)[:, None].astype(
            np.longdouble) < sig
    for j, c in enumerate(order_idx):
        for i in range(D.NUM_NONCONS_BASES):
            alt_b = int(ep["alt_nt"][c, i])
            pv = pvalues[j, i]
            if not sig_mask[j, i]:
                continue
            alt_count = int(ep["alt_counts"][c, i])
            alt_raw = int(ep["alt_raw_counts"][c, i])
            ref_b = int(batch.ref_nt4[c])
            af = np.float32(alt_raw) / np.float32(batch.coverage_plp[c])
            dp4 = (
                int(batch.fw_counts[c, ref_b]), int(batch.rv_counts[c, ref_b]),
                int(batch.fw_counts[c, alt_b]), int(batch.rv_counts[c, alt_b]),
            )
            _report_var(
                out_vars, batch.target, batch.positions[c],
                NT4[ref_b], NT4[alt_b], af, PH.prob_to_phred(pv),
                0, 0, dp4, int(batch.coverage_plp[c]),
                int(batch.hrun[c]), alt_count,
            )


class LazyCandidates:
    """Deferred screen-fetch marker appended to screen_ctx by the
    code-native screening flow: resolve() blocks on the in-flight
    device masks and returns the [(position, bonf)] candidate list.
    Consumers (confirm_snv_candidates via the pipeline's confirm
    executor) resolve it off the calling thread, so the sub-screen and
    its fetch run under later windows' sweeps."""

    __slots__ = ("_resolve",)

    def __init__(self, resolve):
        self._resolve = resolve

    def resolve(self):
        return self._resolve()


def resolve_candidates(cands):
    """Flatten a screen_ctx list that may hold LazyCandidates markers
    and/or plain (position, bonf) tuples."""
    out = []
    for c in cands:
        if isinstance(c, LazyCandidates):
            out.extend(c.resolve())
        else:
            out.append(c)
    return out


def _screen_codes_flow(batch, ep, order_idx, running_bonf, conf,
                       screen_ctx, screen) -> bool:
    """Code-native screening for the whole batch: C-side top-S u8 codes,
    integer-cumsum top-k prescreen, survivors-only sub-screen on the
    device `screen` (host clipped-K DP when it is None), candidates
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

    def _resolve():
        cands = []
        for lo in range(0, len(surv), PACK_MAX_COLS):
            ch = surv[lo:lo + PACK_MAX_COLS]
            bonf_f = running_bonf[ch].astype(np.float64)
            with stagetimer.stage("screen"):
                if screen is not None:
                    cand = screen_fetch(screen_dispatch_codes(
                        codes[ch], ks_t[ch], bonf_f, conf.sig, screen))
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


def _host_candidate_mask(probs, depths, alt_counts, bonf,
                         conf: VarcallConf) -> np.ndarray:
    """The host candidate filter: alt bases present, the reference's
    optional Poisson approximation (snpcaller.c:1128-1142), and the
    top-k product lower bound (_topk_prescreen).  All permutation
    invariant, all only ever discard provably-insignificant columns."""
    B = probs.shape[0]
    ks = alt_counts.max(axis=1)
    run_mask = ks > 0
    # the Poisson approximation branch mirrors the reference's double-
    # precision mu (snpcaller.c:1128-1142) and is only applied to f64
    # packs: a screening-engine f32 pack rounds each prob either way,
    # so its mu could exceed the exact sum and discard a column the
    # reference would test (ADVICE r4) — those packs keep the column
    # and let the exact confirm pass (f64 rebuild) apply the branch
    # bit-exactly instead
    if (conf.approx_threshold_n > 0 and B
            and probs.dtype != np.float32):
        from scipy.stats import poisson

        deep = depths > conf.approx_threshold_n
        if np.any(deep):
            valid = probs <= 1.0
            mu = np.where(valid, probs, 0.0).sum(axis=1,
                                                 dtype=np.float64)
            approx = poisson.sf(np.maximum(ks, 1) - 1, mu)
            run_mask &= ~(deep & (approx * bonf > conf.sig))
    if B:
        run_mask &= _topk_prescreen(probs, ks, bonf, conf.sig)
    return run_mask


def _screen_dispatch_sub(probs, depths, alt_counts, bonf,
                         conf: VarcallConf, host_mask, screen):
    """Issue the sub-screen for the host-mask survivors only: on the
    device `screen` (asynchronous until _screen_apply), or, when it is
    None, the host f64 clipped-K tail DP.

    Returns ('dev', sidx, handle) | ('host', sidx, keep) | None."""
    sidx = np.nonzero(host_mask)[0]
    if not len(sidx):
        return None
    ks = alt_counts.max(axis=1)
    if screen is not None:
        h = screen_dispatch(probs[sidx], depths[sidx], ks[sidx],
                            bonf[sidx], conf.sig, screen)
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


_TOPK_MAX = 64


def _topk_prescreen(probs, ks, bonf, sig) -> np.ndarray:
    """Keep-mask from a mathematically safe host pre-screen: the
    Poisson-binomial tail P(X >= k) is bounded below by the probability
    that the k most error-prone reads ALL err, i.e. the product of the
    top-k err probs.  A column whose lower bound already fails the
    significance test (lb * bonf > sig) provably gets no emission from
    the reference's exact DP either (it emits on pv*bonf < sig,
    lofreq_call.c:820-838, and pv >= lb), so skipping its qsort + DP is
    output-identical.  This is what makes the default conf fast: the
    reference ships with no pre-filter at all (approx_threshold_n = -1)
    and sorts + DPs every covered column.

    Works unchanged on the device-BAQ screening path's deflated probs
    (per-base lower bounds -> the product is still a lower bound).
    Rows with k > _TOPK_MAX or k < 1 are kept unconditionally; a 0.5
    safety factor absorbs f64 product rounding vs the DP's longdouble.
    """
    B, D = probs.shape
    if B == 0:
        return np.ones(0, bool)
    ks = np.asarray(ks, dtype=np.int64)
    kmax = int(min(max(int(ks.max(initial=1)), 1), _TOPK_MAX))
    valid = probs <= 1.0  # the 2.0 pad and invalid markers drop out
    arr = np.where(valid, probs, 0.0)
    if D > kmax:
        top = np.partition(arr, D - kmax, axis=1)[:, D - kmax:]
    else:
        top = arr.copy()
    top.sort(axis=1)
    with np.errstate(divide="ignore"):
        # f64 log/cumsum even for f32 screening packs ([B, kmax] is tiny);
        # the f32 storage rounding itself is absorbed by the 0.5 factor
        lg = np.log(top[:, ::-1].astype(np.float64))  # descending
    csum = np.cumsum(lg, axis=1)
    k_idx = np.clip(np.minimum(ks, kmax) - 1, 0, csum.shape[1] - 1)
    lb_log = csum[np.arange(B), k_idx]
    bounded = (ks >= 1) & (ks <= _TOPK_MAX)
    with np.errstate(divide="ignore"):
        discard = bounded & (
            lb_log + np.log(np.asarray(bonf, dtype=np.float64))
            + np.log(0.5) > np.log(np.float64(sig)))
    return ~discard


def dp_cells(n_done, ks) -> int:
    """DP cells the native DP evaluated: a row of tail K that ran n_done
    reads updates min(n, K) + 1 cells at its n-th read, so
    sum over rows of sum_{n=1..n_done} (min(n, K) + 1)."""
    m = np.asarray(n_done, dtype=np.int64)
    k = np.asarray(ks, dtype=np.int64)
    j = np.minimum(m, k)
    return int((j * (j + 1) // 2 + j + (m - j) * (k + 1)).sum())


def _snpcaller_with_screen(probs, depths, alt_counts, bonf, conf: VarcallConf,
                           presorted=True, precomputed_mask=None,
                           screen=None):
    """snpcaller over packed columns, candidate-filtered first.

    The host candidate mask (alt present + Poisson approx + top-k lower
    bound) and the sub-screen (on the device `screen`, or the host f64 DP
    when it is None) discard columns that provably get no emission; only
    survivors run the exact native DP.

    presorted=False: rows are packed unsorted; the reference's
    eps-comparator qsort is applied only to the candidate rows that
    reach the exact DP (it is only observable through the DP).

    precomputed_mask: the pipelined caller already combined host mask +
    sub-screen for this chunk (call_snvs_batch).
    """
    from .. import native

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
                                               bonf, conf, run_mask, screen))
    idx = np.nonzero(run_mask)[0]
    if len(idx) == 0:
        return pvalues
    sub = probs[idx]
    if not presorted:
        with stagetimer.stage("pack_sort"):
            native.sort_errprobs_batch(sub, depths[idx])
    sub_ks = ks[idx]
    with stagetimer.stage("exact_dp"):
        state, n_done = pruned_prob_dist_batch(sub, depths[idx], sub_ks,
                                               bonf[idx], conf.sig)
        if stagetimer.tracing():
            stagetimer.note(cols=len(idx), cells=dp_cells(n_done, sub_ks),
                            threads=native.last_dp_threads())
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


def confirm_snv_candidates(rdr, tid: int, chrom: str, ref: bytes,
                           pconf, conf: VarcallConf, cands: list,
                           ign_pos=None, raw=None) -> list:
    """Exact re-scoring of the columns a screening pass kept (either
    screening engine: host no-BAQ or device BAQ).

    cands: [(position, running_bonf)] collected by the screening pass.
    Candidate clusters are re-ingested with the exact C BAQ (csrc/baq.c),
    columns rebuilt from `conf`, which carries no screening flag, and the
    host f64 screen and exact DP run at each column's recorded
    dynamic-Bonferroni factor — reproducing precisely what the all-exact
    path computes for these columns.  Returns emitted Vars in position
    order.

    raw: the originating window's raw record bytes; when given, cluster
    re-ingests parse them in memory instead of re-reading the BAM."""
    from ..pileup.fast_columns import build_snv_batch
    from ..pileup.native_ingest import ingest_region

    out: list = []
    cands = resolve_candidates(cands)  # blocks on in-flight screen masks
    if not cands:
        return out
    cands = sorted(set(cands))
    # merge candidates into one interval only when they can share reads
    # (~read length apart); all intervals go into ONE native ingest pass
    # (csrc/ingest.c in_region interval list), so the window's raw bytes
    # are parsed once and the exact C BAQ runs only on overlapping reads.
    # 150 ~ max short-read reference span: a wider gap only pulls in
    # reads that cover NO candidate column — they'd be BAQ'd for nothing
    # (the old 300 measured ~2x the necessary confirm BAQ work); a read
    # genuinely covering two candidates implies they are < read-length
    # apart, which 150 preserves.  Correctness is GAP-independent: each
    # candidate's interval keeps every read overlapping that column.
    GAP = 150
    intervals = [[cands[0][0], cands[0][0] + 1]]
    for p, _bf in cands[1:]:
        if p - intervals[-1][1] > GAP:
            intervals.append([p, p + 1])
        else:
            intervals[-1][1] = p + 1
    ign_arr = None
    if ign_pos:
        ign_arr = np.asarray(sorted(ign_pos), dtype=np.int64)
    reg_list = np.asarray(intervals, dtype=np.int64).ravel()
    lo, hi = cands[0][0], cands[-1][0] + 1
    if raw is not None:
        # parse only the records near the candidate intervals: the
        # native trim returns a conservative superset and the ingest's
        # interval filter re-applies exactly, so output is unchanged
        from ..pileup.native_ingest import trim_raw_to_regions

        trimmed = trim_raw_to_regions(raw, tid, reg_list)
        if trimmed is not None:
            raw = trimmed
    # recycled slab pool: cluster re-ingests run once per window on the
    # confirm executor; without pooling they fresh-allocated (and page-
    # faulted) hundreds of MB of row/column arrays per whole-genome run.
    # One generation is enough — rows and batch share it via disjoint
    # slab names, and everything extracted below is scalar
    from ..pileup.native_ingest import SlabPool

    cpool = SlabPool.acquire(1)
    rows = batch = None
    try:
        with stagetimer.stage("confirm.reingest"):
            rows = ingest_region(rdr, pconf, ref, tid, beg=lo, end=hi,
                                 ign_pos=ign_arr, raw=raw, reg_list=reg_list,
                                 pool=cpool)
            if len(rows.pos):
                batch = build_snv_batch(rows, rows.raw_flags, lo, hi, ref,
                                        chrom, pconf, conf, pool=cpool)
            stagetimer.note(cols=0 if batch is None
                            else len(batch.positions))
        if batch is None:
            return out
        return _confirm_score(out, batch, cands, conf)
    finally:
        rows = batch = None
        SlabPool.release(cpool)


def _confirm_score(out, batch, cands, vc):
    """Exact DP + emission over the confirmed candidate columns."""
    pos_to_col = {int(p): i for i, p in enumerate(batch.positions)}
    cols, bonfs = [], []
    for p, bf in cands:
        ci = pos_to_col.get(p)
        if ci is not None:
            cols.append(ci)
            bonfs.append(bf)
    if not cols:
        return out
    cols = np.asarray(cols)
    bonfs = np.asarray(bonfs, dtype=np.int64)
    ep = batch.ep
    probs = pack_probs(ep["flat_probs"], ep["starts"], ep["depths"], cols)
    pv = _snpcaller_with_screen(
        probs, ep["depths"][cols], ep["alt_counts"][cols],
        bonfs.astype(np.float64), vc)
    _emit_snvs(out, batch, ep, cols, pv, bonfs, vc)
    out.sort(key=lambda v: v.pos)
    return out


# ---------------------------------------------------------------------------
# indels
# ---------------------------------------------------------------------------

def _indel_errprob_groups(neq, events, conf: VarcallConf):
    """Per-group merged err probs for one column's ins (or del) side
    (plp_to_{ins,del}_errprobs, snpcaller.c:501-623).

    Returns (neq_probs, {key: (probs_without_aq, probs_with_aq)}).  Each
    event's test vector is neq_probs + [with_aq if g is the tested event
    else without_aq for every event g] in insertion order — merging each
    group once instead of once per tested event."""
    q_ne, mq_ne, _sq_ne = neq if neq else ([], [], [])
    q_arr = np.asarray(q_ne, dtype=np.int64)
    mq_arr = np.asarray(mq_ne, dtype=np.int64)
    if len(q_arr):
        mqv = mq_arr if conf.use_mq else np.full_like(mq_arr, -1)
        neq_probs = merge_srcq_mapq_baq_and_bq(
            np.full_like(q_arr, -1), mqv, np.full_like(q_arr, -1), q_arr
        )
    else:
        neq_probs = np.zeros(0)
    ev_probs = {}
    for key, ev in (events or {}).items():
        q = np.asarray(ev.quals, dtype=np.int64)
        aq = np.asarray(ev.aln_quals, dtype=np.int64)
        mq = np.asarray(ev.map_quals, dtype=np.int64)
        sq = np.asarray(ev.source_quals, dtype=np.int64)
        mqv = np.where(mq == 255, -1, mq) if conf.use_mq else np.full_like(q, -1)
        sqv = sq if conf.use_sq else np.full_like(q, -1)
        noaq = merge_srcq_mapq_baq_and_bq(sqv, mqv, np.full_like(q, -1), q)
        withaq = merge_srcq_mapq_baq_and_bq(sqv, mqv, aq, q) \
            if conf.use_idaq else noaq
        ev_probs[key] = (noaq, withaq)
    return neq_probs, ev_probs


def _indel_errprobs(neq, events, this_key, conf: VarcallConf, is_ins: bool,
                    groups=None):
    """One event's sorted err-prob vector (snpcaller.c:501-623)."""
    neq_probs, ev_probs = groups if groups is not None \
        else _indel_errprob_groups(neq, events, conf)
    probs = [neq_probs] if len(neq_probs) else []
    for key in (events or {}):
        noaq, withaq = ev_probs[key]
        probs.append(withaq if key == this_key else noaq)
    if not probs:
        return np.zeros(0)
    # group order (non-event quals, then events in insertion order) matches
    # plp_to_{ins,del}_errprobs; sort = reference eps-comparator qsort
    # (lofreq_call.c:692,714)
    from .. import native

    return native.sort_errprobs(np.concatenate(probs))


def call_indels_batch(batch: ColumnBatch, conf: VarcallConf, stats: CallStats,
                      out_vars: list, screen=None):
    """call_indels over a batch (lofreq_call.c:618-726)."""
    with stagetimer.stage("indels"):
        _call_indels_batch(batch, conf, stats, out_vars, screen)


def _call_indels_batch(batch: ColumnBatch, conf: VarcallConf,
                       stats: CallStats, out_vars: list, screen):
    """Two passes over the batch (vs the reference's per-event snpcaller
    calls, lofreq_call.c:618-726): pass 1 walks columns/events in reference
    order building each event's sorted err-prob vector and its dynamic
    Bonferroni factor; pass 2 packs all events into one [E, Dmax] matrix
    and runs a single screened batch DP, then emits in the same order."""
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
    # bound the packed-matrix footprint (depth-bucketed so one deep
    # event column can't inflate the whole chunk, _depth_chunks)
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
            probs, depths, alt_counts, bonfs, conf, screen=screen)[:, 0]

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
                    stats: CallStats, screen_ctx: list = None,
                    screen=None) -> list:
    """call_vars over a batch: indels first, then SNVs (lofreq_call.c:887).
    screen: the sub-screen's torch device, None for the host f64 DP."""
    out: list[Var] = []
    if batch is None:
        return out
    if not conf.no_indels:
        call_indels_batch(batch, conf, stats, out, screen)
    if not conf.only_indels:
        call_snvs_batch(batch, conf, stats, out, screen_ctx, screen)
    # emit per position: indels then SNVs at the same position, both already
    # position-sorted within their group -> stable sort by position keeps
    # the reference's per-column ordering (indels before SNVs).
    out.sort(key=lambda v: v.pos)
    return out
