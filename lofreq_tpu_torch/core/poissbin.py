"""Exact Poisson-binomial significance engine (host, float64/longdouble).

Re-derivation of the reference's pruned DP (snpcaller.c:830-972), vectorized
over a *batch* of pileup columns instead of one column at a time.  The DP
computes, per column, the log-space distribution of the number of error reads
X = sum Bernoulli(p_i) over cells 0..K-1 plus a tail accumulator at cell K
holding P(X >= K) (once n > K the recurrence drops the (1-p) term on cell K,
which is exactly the tail update P(X_n>=K) = P(X_{n-1}>=K) + p_n P(X_{n-1}=K-1)).

Bit-identity contract with the C implementation:
  * per-read log_pn / log_1_pn with the DBL_EPSILON clamps (snpcaller.c:870-881)
  * log_sum(a,b) = max + log1p(exp(min-max)) in float64
  * early exit after the update of read n when n > K and
    expl(tail)*bonf > sig   (long double exp; snpcaller.c:912-957);
    the returned distribution is then the *truncated* one — observable
    through source_qual (plp.c:559) so it is reproduced faithfully.
  * final p-values via expl with underflow clamped to LDBL_MIN
    (snpcaller.c:1050-1059).
"""

from __future__ import annotations

import numpy as np

from .phred import DBL_EPSILON, LDBL_MAX, LDBL_MIN, LOGZERO

_LOG_DBL_EPSILON = np.log(DBL_EPSILON)  # log(pn) clamp for pn ~ 0


def _log_sum(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """log(exp(a)+exp(b)) exactly as the reference's log_sum (snpcaller.c:693)."""
    take_a = a > b
    hi = np.where(take_a, a, b)
    lo = np.where(take_a, b, a)
    return hi + np.log1p(np.exp(lo - hi))


def _log_pn_pair(p: np.ndarray):
    """Per-read (log_pn, log_1_pn) with the reference's clamps."""
    log_pn = np.where(np.abs(p) < DBL_EPSILON, _LOG_DBL_EPSILON, np.log(
        np.where(np.abs(p) < DBL_EPSILON, 1.0, p)))
    near1 = np.abs(p - 1.0) < DBL_EPSILON
    log_1_pn = np.where(near1, np.log1p(-p + DBL_EPSILON), np.log1p(
        np.where(near1, 0.0, -p)))
    return log_pn, log_1_pn


def _exp_longdouble(x: np.ndarray) -> np.ndarray:
    """expl() with the reference's FE-exception clamping: underflow -> LDBL_MIN
    (overflow -> LDBL_MAX can't occur for x <= 0)."""
    v = np.exp(np.asarray(x, dtype=np.longdouble))
    v = np.where(v < LDBL_MIN, LDBL_MIN, v)
    return v


def pruned_prob_dist_batch(err_probs, depths, ks, bonf, sig):
    """Native (libm-exact) batch DP — see csrc/exact_stats.c."""
    from .. import native

    err_probs = np.atleast_2d(np.asarray(err_probs, dtype=np.float64))
    return native.poissbin_dp_batch(err_probs, depths, ks, bonf, sig)


def pruned_prob_dist_batch_py(
    err_probs: np.ndarray,
    depths: np.ndarray,
    ks: np.ndarray,
    bonf,
    sig: float,
):
    """Pure-numpy rendition of the DP (last-ulp differences possible vs the
    native version because numpy's SIMD exp/log1p are not glibc's; kept as
    executable documentation and a cross-check).

    Args:
      err_probs: [B, Dmax] float64, ascending-sorted per row (rows padded
        arbitrarily past ``depths``).
      depths: [B] int, number of valid err probs per row (N).
      ks: [B] int, max non-consensus count per row (K >= 1).
      bonf: scalar or [B] Bonferroni factor used for the early-exit test.
      sig: significance level.

    Returns:
      probvec: [B, Kmax+1] float64 log-space distribution (cell K = tail).
      n_done: [B] number of reads processed before (early) exit.
    """
    err_probs = np.ascontiguousarray(err_probs, dtype=np.float64)
    depths = np.asarray(depths, dtype=np.int64)
    ks = np.asarray(ks, dtype=np.int64)
    B, Dmax = err_probs.shape
    Kmax = int(ks.max()) if B else 0
    bonf = np.broadcast_to(np.asarray(bonf, dtype=np.float64), (B,))

    state = np.full((B, Kmax + 1), LOGZERO, dtype=np.float64)
    state[:, 0] = 0.0
    cell_idx = np.arange(Kmax + 1)[None, :]  # [1, K+1]
    is_tail = cell_idx == ks[:, None]  # per-column tail cell
    beyond = cell_idx > ks[:, None]
    active = depths > 0
    n_done = np.zeros(B, dtype=np.int64)

    log_sig = sig  # compare in linear space like the C code

    for n in range(1, Dmax + 1):
        active &= n <= depths
        if not active.any():
            break
        pn = err_probs[:, n - 1]
        log_pn, log_1_pn = _log_pn_pair(pn)

        prev = state
        shifted = np.empty_like(prev)
        shifted[:, 1:] = prev[:, :-1]
        shifted[:, 0] = LOGZERO
        # standard cells: logsum(prev[k] + log_1_pn, prev[k-1] + log_pn)
        std = _log_sum(prev + log_1_pn[:, None], shifted + log_pn[:, None])
        # tail cell K: logsum(prev[K], prev[K-1] + log_pn)
        tail = _log_sum(prev, shifted + log_pn[:, None])
        new = np.where(is_tail, tail, std)
        new[:, 0] = prev[:, 0] + log_1_pn
        new = np.where(beyond, LOGZERO, new)

        state = np.where(active[:, None], new, prev)
        n_done = np.where(active, n, n_done)

        # early exit: n > K and tail pvalue * bonf > sig
        check = active & (n > ks)
        if check.any():
            tail_val = state[np.arange(B), ks]
            pv = _exp_longdouble(tail_val)
            exit_now = check & (pv * bonf > log_sig)
            active &= ~exit_now
    return state, n_done


def probvec_tailsum_batch(probvec, start, ks) -> np.ndarray:
    """Native log tail-sum over cells [start, K] per row."""
    from .. import native

    return native.tailsum_batch(probvec, start, ks)


def probvec_tailsum_batch_py(probvec: np.ndarray, start: np.ndarray,
                             ks: np.ndarray) -> np.ndarray:
    """log sum of cells [start, K] per row, accumulated left-to-right with
    log_sum, matching probvec_tailsum (snpcaller.c:730)."""
    B, KP1 = probvec.shape
    start = np.asarray(start, dtype=np.int64)
    ks = np.asarray(ks, dtype=np.int64)
    acc = probvec[np.arange(B), np.minimum(start, KP1 - 1)].copy()
    for k in range(1, KP1):
        idx = start + k
        valid = idx <= ks
        if not valid.any():
            break
        vals = probvec[np.arange(B), np.minimum(idx, KP1 - 1)]
        upd = _log_sum(acc, vals)
        acc = np.where(valid, upd, acc)
    return acc


def snpcaller_batch(
    err_probs: np.ndarray,
    depths: np.ndarray,
    alt_counts: np.ndarray,
    bonf,
    sig: float,
):
    """Batched equivalent of snpcaller() (snpcaller.c:1074-1205).

    Args:
      err_probs: [B, Dmax] ascending-sorted merged error probs.
      depths: [B] valid lengths.
      alt_counts: [B, 3] per-alt filtered counts (0 => no test for that alt).
      bonf, sig: significance parameters (bonf scalar or [B]).

    Returns:
      pvalues: [B, 3] longdouble p-values; LDBL_MAX where not significant /
        not computed — same contract as the reference.
    """
    B = err_probs.shape[0]
    alt_counts = np.asarray(alt_counts, dtype=np.int64)
    pvalues = np.full((B, 3), LDBL_MAX, dtype=np.longdouble)
    if B == 0:
        return pvalues
    ks = alt_counts.max(axis=1)
    run = ks > 0
    if not run.any():
        return pvalues
    idx = np.nonzero(run)[0]
    bonf_arr = np.broadcast_to(np.asarray(bonf, dtype=np.float64), (B,))
    probvec, _ = pruned_prob_dist_batch(
        err_probs[idx], depths[idx], ks[idx], bonf_arr[idx], sig
    )
    sub_ks = ks[idx]
    tail = probvec[np.arange(len(idx)), sub_ks]
    pv_max = _exp_longdouble(tail)
    sig_ok = pv_max * bonf_arr[idx] < sig
    # per alt base: pvalue = exp(tailsum(probvec, count_i, K+1)) where count>0
    for i in range(3):
        counts = alt_counts[idx, i]
        todo = sig_ok & (counts != 0)
        if not todo.any():
            continue
        sel = np.nonzero(todo)[0]
        ts = probvec_tailsum_batch(probvec[sel], counts[sel], sub_ks[sel])
        pv = _exp_longdouble(ts)
        rows = idx[sel]
        pvalues[rows, i] = pv
    return pvalues


def poissbin_single(err_probs: np.ndarray, num_failures: int,
                    bonf: float, sig: float):
    """Single-column poissbin() (snpcaller.c:1019-1062): returns
    (pvalue longdouble, probvec).  Used by source_qual and uniq."""
    err_probs = np.asarray(err_probs, dtype=np.float64)[None, :]
    depths = np.array([err_probs.shape[1]])
    ks = np.array([num_failures])
    probvec, _ = pruned_prob_dist_batch(err_probs, depths, ks, bonf, sig)
    pvalue = _exp_longdouble(probvec[0, num_failures])
    return pvalue, probvec[0]


def source_qual_batch(err_probs: np.ndarray, depths: np.ndarray,
                      num_non_matches: np.ndarray) -> np.ndarray:
    """Batched source-quality probability computation (plp.c:546-569).

    For each read: poissbin with K = num_non_matches (already decremented by
    the caller), bonf=1, sig=0.05; src_prob = exp(probvec[K-1]) (float64 exp,
    with DBL_MIN/DBL_MAX clamping); returns PROB_TO_PHREDQUAL(1-src_prob).
    """
    from .phred import DBL_MAX, DBL_MIN, prob_to_phred_vec

    err_probs = np.ascontiguousarray(err_probs, dtype=np.float64)
    depths = np.asarray(depths, dtype=np.int64)
    nnm = np.asarray(num_non_matches, dtype=np.int64)
    B = err_probs.shape[0]
    out = np.zeros(B, dtype=np.int64)
    if B == 0:
        return out
    probvec, _ = pruned_prob_dist_batch(err_probs, depths, nnm, 1.0, 0.05)
    cell = probvec[np.arange(B), nnm - 1]
    # C: exp() into double with FE checks: underflow -> DBL_MIN
    src_prob = np.exp(cell)
    src_prob = np.where((cell < 0) & (src_prob == 0.0), DBL_MIN, src_prob)
    src_prob = np.where(np.isinf(src_prob), DBL_MAX, src_prob)
    return prob_to_phred_vec(1.0 - src_prob)
