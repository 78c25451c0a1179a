"""The plain reference of the default `lofreq call`: SNVs from reads to
the filtered VCF records, in PyTorch and NumPy, on any device.

It implements LoFreq's published semantics for the reads the benchmark
generates (single-end, one M operation, MQ 60, base qualities of at
least the pileup's thresholds, no N) and raises on any other input:

  * pileup: per column, each base's count by strand; every base is kept
    (quality >= min_bq and min_alt_bq);
  * a column is tested when its reference base is A, C, G or T and it
    shows an alternative base; the dynamic Bonferroni factor of the t-th
    tested column (from 1) is 3 t, and the number of SNV tests is 3 per
    tested column;
  * each base's error probability merges mapping quality, BAQ and base
    quality, P = PM + (1-PM) PBAQ + (1-PM)(1-PBAQ) PB;
  * BAQ: reference/baq.py;
  * the Poisson-binomial tail P(X >= k) of the column's error
    probabilities, by the exact dynamic programme in log space; an
    alternative base is called when P * bonf < sig, its QUAL is the
    truncated phred of P held in x87 long double (so P floors at
    LDBL_MIN);
  * strand bias: phred of Fisher's two-sided exact test on DP4;
  * the default filter: coverage >= 10, QUAL >= the phred of
    sig / the final Bonferroni factor, and no strand bias by
    Benjamini-Hochberg at 0.001 with 85% of the alt bases on one strand.

Work is cut by bounds that only ever keep a column: BAQ can only raise an
error probability, so a column that is not significant without it is not
significant with it; the product of the k largest error probabilities
bounds the tail from below; and P(X >= k) <= exp(-mu) (e mu / k)^k bounds
it from above (it then floors at LDBL_MIN whatever the exact value).

The precision is a parameter: `dtype` for the DP, the merge and the BAQ
HMM, and `p_floor` for the p-values ("longdouble" or "double"), so that
the same code in the next precision down is the control.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from . import baq as BAQ

SIG = float(np.float32(0.01))      # LoFreq keeps sig as a C float
MIN_BQ = 6
MIN_ALT_BQ = 6
MIN_PLP_BQ = 3
DP_MIN = 10
SB_ALPHA = 0.001
ALT_STRAND_RATIO = np.float32(0.85)
NUM_NONCONS = 3
INT_MAX = 2 ** 31 - 1
DBL_MIN = 2.2250738585072014e-308
LN10 = math.log(10.0)
# ln of the smallest normal p-value each precision holds
LN_FLOOR = {"longdouble": math.log(3.3621031431120935) - 4932 * LN10,
            "double": math.log(DBL_MIN)}
NT = "ACGT"

_CODE = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _CODE[_c] = _i
_Q2P = [math.pow(10.0, -q / 10.0) for q in range(256)]


def q2p(q, dtype, device):
    """PHREDQUAL_TO_PROB as C's pow gives it, for integer tensors q."""
    tab = torch.tensor(_Q2P, dtype=torch.float64).to(device=device,
                                                     dtype=dtype)
    return tab[q.long()]


def merge(mq, baq, bq, dtype, device):
    """LoFreq's merged error probability with source quality unknown;
    baq None means BAQ unknown (probability 0)."""
    mp = q2p(mq, dtype, device)
    bp = q2p(bq, dtype, device)
    bap = torch.zeros_like(bp) if baq is None else q2p(baq, dtype, device)
    sp = 0.0
    return (mp + (1.0 - mp) * sp + (1 - mp) * (1 - sp) * bap
            + (1 - mp) * (1 - sp) * (1 - bap) * bp)


def phred_qual(ln_p: float, p_floor: str) -> int:
    """(int)(-10 log10 P) of a p-value given by its log, P floored at the
    precision's smallest normal value."""
    return int(-10.0 * max(ln_p, LN_FLOOR[p_floor]) / LN10)


# ---------------------------------------------------------------------------
# Poisson-binomial tail
# ---------------------------------------------------------------------------

def tail_dp(probs, depths, K, dtype):
    """log P(X >= k) for k = 0..K of each column: probs [B, D] (rows past
    depths[b] ignored), exact DP in log space, cell K the tail."""
    B, D = probs.shape
    dev = probs.device
    neg = torch.tensor(-math.inf, dtype=dtype, device=dev)
    state = torch.full((B, K + 1), -math.inf, dtype=dtype, device=dev)
    state[:, 0] = 0.0
    p = probs.to(dtype)
    eps = torch.finfo(torch.float64).eps
    lp = torch.log(torch.clamp(p, min=eps))
    l1p = torch.log1p(-torch.clamp(p, max=1.0 - eps))
    for n in range(D):
        a, b = lp[:, n:n + 1], l1p[:, n:n + 1]
        shifted = torch.cat([neg.expand(B, 1), state[:, :-1]], 1)
        new = torch.logaddexp(state + b, shifted + a)
        new[:, K] = torch.logaddexp(state[:, K], shifted[:, K] + a[:, 0])
        state = torch.where((n < depths)[:, None], new, state)
    # cells hold P(X = j) for j < K; turn them into tails P(X >= j)
    rev = torch.logcumsumexp(state.flip(1), 1).flip(1)
    return rev


# ---------------------------------------------------------------------------
# strand bias and the default filter
# ---------------------------------------------------------------------------

def fisher_two_sided(a, b, c, d) -> float:
    """Two-sided Fisher exact p of [[a, b], [c, d]]: the tables with the
    margins fixed that are no likelier than the observed one (with a
    relative band of 1e-8 for ties), summed and capped at 1."""
    r1, c1, n = a + b, a + c, a + b + c + d
    lo, hi = max(0, r1 + c1 - n), min(r1, c1)
    if lo == hi:
        return 1.0
    x = np.arange(lo, hi + 1, dtype=np.float64)
    lg = np.vectorize(math.lgamma)

    def lchoose(nn, kk):
        return lg(nn + 1) - lg(kk + 1) - lg(nn - kk + 1)

    pmf = np.exp(lchoose(r1, x) + lchoose(n - r1, c1 - x) - lchoose(n, c1))
    q = pmf[a - lo]
    return float(min(pmf[pmf < 1.00000001 * q].sum(), 1.0))


def strand_bias(dp4) -> int:
    rf, rr, af, ar = dp4
    if rf + rr == 0 and (af == 0 or ar == 0):
        return INT_MAX
    p = fisher_two_sided(rf, rr, af, ar)
    return INT_MAX if p <= 0.0 else int(-10.0 * np.log10(np.longdouble(p)))


def default_filter(recs, bonf_final):
    """Records that pass LoFreq's default filter after `call`."""
    if not recs:
        return []
    thr = int(max(int(-10.0 * np.log10(np.longdouble(
        np.float32(SIG) / np.float32(bonf_final)))), 0))
    n = len(recs)
    sbp = np.array([DBL_MIN if r["sb"] == INT_MAX
                    else math.pow(10.0, -1.0 * r["sb"] / 10.0)
                    for r in recs])
    order = np.argsort(sbp, kind="stable")
    nf = np.float64(np.float32(n))
    nrej = 0
    for i in range(n, 0, -1):
        if sbp[order[i - 1]] < np.float64(SB_ALPHA * i) / nf:
            nrej = i
            break
    sb_sig = np.zeros(n, bool)
    sb_sig[order[:nrej]] = True
    out = []
    for r, sig in zip(recs, sb_sig):
        af, ar = r["dp4"][2], r["dp4"][3]
        one_strand = (af + ar > 0 and np.float32(max(af, ar))
                      / np.float32(af + ar) > ALT_STRAND_RATIO)
        if r["dp"] < DP_MIN or r["qual"] < thr or (sig and one_strand):
            continue
        out.append(r)
    return out


def vcf_line(chrom, r) -> str:
    rf, rr, af, ar = r["dp4"]
    info = (f"DP={r['dp']};AF={r['af']:f};SB={r['sb']};"
            f"DP4={rf},{rr},{af},{ar};HQA={r['hqa']}")
    return "\t".join([chrom, str(r["pos"] + 1), ".", r["ref"], r["alt"],
                      str(r["qual"]), "PASS", info])


# ---------------------------------------------------------------------------
# the call
# ---------------------------------------------------------------------------

def _check_input(sample, read_len):
    q = sample["quals"]
    if int(q.min()) < max(MIN_BQ, MIN_ALT_BQ, MIN_PLP_BQ):
        raise ValueError("reference covers base qualities >= 6 only")
    if (_CODE[sample["seqs"]] > 3).any() or (_CODE[sample["genome"]] > 3).any():
        raise ValueError("reference covers A, C, G, T bases only")
    if np.any(np.diff(sample["starts"]) < 0):
        raise ValueError("reads must be sorted by position")
    if read_len < 16:
        raise ValueError("reads shorter than 16 bases")


class _Clock:
    """Adds the seconds since its last call to times[step]."""

    def __init__(self, device, times):
        self.cuda = torch.device(device).type == "cuda"
        self.times = times
        self.t = time.perf_counter()

    def __call__(self, step):
        if self.times is None:
            return
        if self.cuda:
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.times[step] = self.times.get(step, 0.0) + now - self.t
        self.t = now


def pileup(starts, seqs, flags, G, device, chunk=1 << 16):
    """counts [G, 4, 2] (base, strand) and the reads' base codes."""
    n, L = seqs.shape
    counts = torch.zeros(G * 8, dtype=torch.int64, device=device)
    offs = torch.arange(L, device=device)
    code = torch.from_numpy(_CODE).to(device)
    for lo in range(0, n, chunk):
        st = torch.from_numpy(starts[lo:lo + chunk]).to(device)
        b = code[torch.from_numpy(seqs[lo:lo + chunk]).to(device).long()]
        strand = (torch.from_numpy(flags[lo:lo + chunk].astype(np.int64))
                  .to(device) >> 4) & 1
        col = st[:, None] + offs
        counts += torch.bincount((col * 8 + b.long() * 2 + strand[:, None])
                                 .flatten(), minlength=G * 8)
    return counts.view(G, 4, 2)


def _column_reads(starts, L, cols):
    """For each column, the index range [lo, hi) of the reads covering it
    (reads sorted by start, all of length L)."""
    lo = np.searchsorted(starts, cols - L + 1, side="left")
    hi = np.searchsorted(starts, cols, side="right")
    return lo, hi


def _gather_column(cols, starts, L, per_read_vals):
    """[B, Dmax] values of the reads covering each column, and depths."""
    lo, hi = _column_reads(starts, L, cols)
    depth = hi - lo
    Dm = int(depth.max()) if len(cols) else 0
    ridx = lo[:, None] + np.arange(max(Dm, 1))
    valid = ridx < hi[:, None]
    ridx = np.where(valid, ridx, 0)
    off = cols[:, None] - starts[ridx]
    off = np.where(valid, off, 0)
    return [v[ridx, off] for v in per_read_vals], valid, depth


def call(sample, chrom, **kw):
    """(VCF record lines after the default filter, number of SNV tests)
    of the default `lofreq call` on one sample: a dict with genome,
    starts, seqs, quals, flags as the generator draws them."""
    return call_many([sample], chrom, **kw)[0]


def call_many(samples, chrom, *, device="cpu", dtype=torch.float64,
              p_floor="longdouble", mq=60, times=None):
    """call() of each sample, each called on its own; the BAQ and the
    exact tails of all the samples run in shared batches.  `times`, a
    dict, gets the seconds of each step."""
    clock = _Clock(device, times)
    dev = torch.device(device)
    jobs = [_screen(s, dev, mq, clock) for s in samples]
    _baq(jobs, dev, dtype)
    clock("baq")
    _tails(jobs, dev, dtype, mq, p_floor)
    clock("tails")
    out = []
    for j in jobs:
        recs = default_filter(_records(j, p_floor), bonf_final=j["n_tests"])
        out.append(([vcf_line(chrom, r) for r in recs], j["n_tests"]))
    clock("filter")
    return out


def _screen(sample, dev, mq, clock) -> dict:
    """Pileup, tested columns and their Bonferroni factors, then the
    columns that can be significant: step 1 bounds the tail from below by
    the k largest error probabilities without BAQ; step 2 computes it
    exactly without BAQ (each quality a binomial class) for k <= KC."""
    genome = sample["genome"]
    starts = np.asarray(sample["starts"], np.int64)
    seqs, quals, flags = sample["seqs"], sample["quals"], sample["flags"]
    G = len(genome)
    L = seqs.shape[1]
    _check_input(sample, L)
    counts = pileup(starts, seqs, flags, G, dev)
    clock("pileup")
    ref = torch.from_numpy(_CODE[genome].astype(np.int64)).to(dev)
    per_base = counts.sum(2)                                   # [G, 4]
    alt_mask = torch.ones((G, 4), dtype=torch.bool, device=dev)
    alt_mask[torch.arange(G, device=dev), ref] = False
    tested = (per_base.sum(1) >= 1) & ((per_base * alt_mask).sum(1) > 0)
    tcols = torch.nonzero(tested).flatten()
    n_tested = int(tcols.numel())
    job = dict(genome=genome, starts=starts, seqs=seqs, quals=quals, L=L,
               counts=counts.cpu().numpy(), ref=_CODE[genome],
               n_tests=NUM_NONCONS * n_tested, cols=np.zeros(0, np.int64))
    if n_tested == 0:
        return job
    bonf = NUM_NONCONS * torch.arange(1, n_tested + 1, device=dev,
                                      dtype=torch.float64)
    # alt bases in ACGT order without the reference base
    alt_nt = torch.tensor([[b for b in range(4) if b != r] for r in range(4)],
                          device=dev)[ref[tcols]]               # [T, 3]
    alt_cnt = torch.gather(per_base[tcols], 1, alt_nt)            # [T, 3]
    K = alt_cnt.max(1).values
    thr = SIG / bonf
    # 1. the k largest error probabilities without BAQ, from the
    #    columns' quality histograms (a lower bound of the tail)
    qmax = int(quals.max())
    hist = torch.zeros(G * (qmax + 1), dtype=torch.int64, device=dev)
    offs = torch.arange(L, device=dev)
    for lo in range(0, len(starts), 1 << 16):
        st = torch.from_numpy(starts[lo:lo + (1 << 16)]).to(dev)
        qq = torch.from_numpy(quals[lo:lo + (1 << 16)]).to(dev).long()
        hist += torch.bincount(((st[:, None] + offs) * (qmax + 1) + qq)
                               .flatten(), minlength=G * (qmax + 1))
    hist = hist.view(G, qmax + 1)[tcols]                        # [T, Q]
    qs = torch.arange(qmax + 1, device=dev)
    p_q = merge(torch.full_like(qs, mq), None, qs, torch.float64, dev)
    before = torch.cumsum(hist, 1) - hist                       # reads of lower q
    take = torch.clamp(torch.minimum(hist, K[:, None] - before), min=0)
    lower = (take * torch.log(p_q)).sum(1)
    keep = lower < torch.log(thr) + 1e-9
    clock("bound")
    # 2. the exact tail without BAQ where k is small
    small = keep & (K <= KC)
    idx = torch.nonzero(small).flatten()
    if len(idx):
        tail = tail_by_class(hist[idx], p_q, K[idx])
        keep[idx] = tail < thr[idx] * (1 + 1e-4) + 1e-9
    clock("tail_without_baq")
    idx = torch.nonzero(keep).flatten()
    job.update(cols=tcols[idx].cpu().numpy(),
               alt_nt=alt_nt[idx].cpu().numpy(),
               alt_cnt=alt_cnt[idx].cpu().numpy(),
               bonf=bonf[idx].cpu().numpy())
    return job


KC = 64


def tail_by_class(hist, p_q, K):
    """P(X >= k) of columns whose reads fall into classes of one error
    probability each (hist [B, Q] reads per class, p_q [Q]), for k <= KC:
    the distribution of X below k by convolving each class's binomial,
    in float64; the tail is 1 minus it, so its error is absolute
    (~1e-12), which the caller's margin covers."""
    B = hist.shape[0]
    dev = hist.device
    j = torch.arange(KC, device=dev, dtype=torch.float64)
    dist = torch.zeros((B, KC), dtype=torch.float64, device=dev)
    dist[:, 0] = 1.0
    for q in torch.nonzero(hist.sum(0)).flatten().tolist():
        n = hist[:, q].double()[:, None]
        p = p_q[q]
        lpmf = (torch.lgamma(n + 1) - torch.lgamma(j + 1)
                - torch.lgamma(torch.clamp(n - j, min=0) + 1)
                + j * torch.log(p) + (n - j) * torch.log1p(-p))
        pmf = torch.where(j <= n, torch.exp(lpmf), torch.zeros_like(lpmf))
        new = torch.zeros_like(dist)
        for i in range(KC):
            new[:, i:] += dist[:, i:i + 1] * pmf[:, :KC - i]
        dist = new
    below = torch.where(j < K[:, None], dist, torch.zeros_like(dist)).sum(1)
    return torch.clamp(1.0 - below, min=0.0)


def _baq(jobs, dev, dtype):
    """BAQ of every read over a surviving column, all samples' reads in
    shared batches."""
    parts, owners = [], []
    for job in jobs:
        job["baq"] = None
        if not len(job["cols"]):
            continue
        lo, hi = _column_reads(job["starts"], job["L"], job["cols"])
        rsel = np.unique(np.concatenate([np.arange(a, b)
                                         for a, b in zip(lo, hi)]))
        parts.append((torch.from_numpy(job["ref"]).to(dev),
                      torch.from_numpy(job["starts"][rsel]).to(dev),
                      torch.from_numpy(_CODE[job["seqs"][rsel]]).to(dev),
                      torch.from_numpy(job["quals"][rsel]).to(dev)))
        owners.append((job, rsel))
    for (job, rsel), q in zip(owners, BAQ.read_baq_many(parts, dtype)):
        baq = np.zeros(job["seqs"].shape, np.uint8)
        baq[rsel] = q.cpu().numpy()
        job["baq"] = baq


def _probs(cols, starts, L, quals, baq, mq, dev, dtype):
    """[B, D] merged error probabilities (with BAQ) of the reads over
    each column, sorted ascending (2.0 past a column's depth), and the
    depths."""
    got, valid, depth = _gather_column(np.asarray(cols), starts, L,
                                       [quals, baq])
    bq = torch.from_numpy(got[0].astype(np.int64)).to(dev)
    bq_baq = torch.from_numpy(got[1].astype(np.int64)).to(dev)
    p = merge(torch.full_like(bq, mq), bq_baq, bq, dtype, dev)
    p = torch.where(torch.from_numpy(valid).to(dev), p,
                    torch.full_like(p, 2.0))
    return torch.sort(p, 1).values, torch.from_numpy(depth).to(dev)


def _tails(jobs, dev, dtype, mq, p_floor, max_cells=1 << 27):
    """ln P(X >= count) of every alternative base of every surviving
    column, into job["tails"] [S, 3] (nan where the count is 0).  A tail
    whose Chernoff bound exp(-mu) (e mu / k)^k lies far below the smallest
    p-value floors there; the others run through the exact DP, the
    samples' columns together."""
    pending = []                        # (job, rows, alts, [B, D] probs)
    for job in jobs:
        cnt = job.get("alt_cnt")
        job["tails"] = np.full((len(job["cols"]), 3), np.nan)
        if not len(job["cols"]):
            continue
        p, d = _probs(job["cols"], job["starts"], job["L"], job["quals"],
                      job["baq"], mq, dev, dtype)
        mu = torch.where(p <= 1.0, p, torch.zeros_like(p)).sum(1) \
            .double().cpu().numpy()
        ka = cnt.astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            bound = -mu[:, None] + ka * (1.0 + np.log(mu[:, None] / ka))
        need = cnt > 0
        floor = need & (ka > mu[:, None]) & (bound < LN_FLOOR[p_floor] - 50)
        job["tails"][floor] = -np.inf
        rows, alts = np.nonzero(need & ~floor)
        if len(rows):
            r = torch.from_numpy(rows).to(dev)
            pending.append((job, rows, alts, p[r], d[r]))
    if not pending:
        return
    D = max(int(x[4].max()) for x in pending)
    probs = torch.cat([torch.nn.functional.pad(x[3], (0, D - x[3].shape[1]),
                                               value=2.0) for x in pending])
    depths = torch.cat([x[4] for x in pending])
    ks = np.concatenate([x[0]["alt_cnt"][x[1], x[2]] for x in pending])
    order = np.argsort(depths.cpu().numpy(), kind="stable")[::-1].copy()
    out = np.zeros(len(ks))
    i = 0
    while i < len(order):
        dmax = int(depths[order[i]])
        n = max(1, min(len(order) - i, max_cells // max(dmax, 1)))
        sel = torch.from_numpy(order[i:i + n]).to(dev)
        k = torch.from_numpy(ks[order[i:i + n]]).to(dev)
        t = tail_dp(probs[sel, :dmax], depths[sel], int(k.max()), dtype)
        out[order[i:i + n]] = t[torch.arange(n, device=dev), k] \
            .double().cpu().numpy()
        i += n
    at = 0
    for job, rows, alts, p, _d in pending:
        job["tails"][rows, alts] = out[at:at + len(rows)]
        at += len(rows)


def _records(job, p_floor):
    """Records of the significant alternative bases of a sample."""
    ln_sig = math.log(SIG)
    counts, ref = job["counts"], job["ref"]
    recs = []
    for i, c in enumerate(job["cols"]):
        r = int(ref[c])
        dp = int(counts[c].sum())
        for a in range(3):
            n_alt = int(job["alt_cnt"][i, a])
            t = job["tails"][i, a]
            if n_alt == 0 or not (t + math.log(job["bonf"][i]) < ln_sig):
                continue
            b = int(job["alt_nt"][i, a])
            dp4 = (int(counts[c, r, 0]), int(counts[c, r, 1]),
                   int(counts[c, b, 0]), int(counts[c, b, 1]))
            recs.append(dict(
                pos=int(c), ref=NT[r], alt=NT[b], dp=dp,
                af=np.float32(n_alt) / np.float32(dp),
                qual=phred_qual(t, p_floor), sb=strand_bias(dp4), dp4=dp4,
                hqa=n_alt))
    return recs
