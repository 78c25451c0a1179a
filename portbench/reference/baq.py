"""Base-alignment quality (BAQ) in plain PyTorch: the banded glocal
profile HMM of samtools' kprobaln, with LoFreq's extended smoothing.

For reads of one length aligned without indels or clips (a single M
operation), each against the reference window [pos - bw/2, pos + L + bw/2)
clipped to the contig.  The arithmetic follows the published algorithm
and LoFreq's observable quirks:
  * per-base error probabilities rounded through float32;
  * row 1 of the forward pass is rescaled by division, later rows by
    multiplication with the reciprocal;
  * the MAP posterior's phred is (int)(-4.343 log(1 - max) + .499),
    capped to 99 above 100, and 0 where 1 - max is 0 or undefined (the C
    conversion of an infinite or NaN value);
  * extended BAQ: a base off the diagonal of its alignment gets 0, then
    each base takes the smaller of the running maxima from either end;
    the result is capped at 93.

Vectorized over reads: each row of the band (2 bw + 1 lanes, lane j of
row i is reference column k = i - bw + j) is one tensor op over a batch.
Works on any device and in any float dtype (float64 for the reference,
float32 for its control).
"""

from __future__ import annotations

import torch

PAR_D = 0.00001
PAR_E = 0.4
BW = 7
EI = 0.25
EM = 0.33333333333
SANGER_PHRED_MAX = 93


def window(pos, read_len: int, ref_len: int, bw: int = BW):
    """(xb, xe) of each read's reference window: LoFreq's window for a
    read that is one M operation."""
    xb = torch.clamp(pos - bw // 2, min=0)
    xe = torch.clamp(pos + read_len + bw // 2, max=ref_len)
    return xb, xe


def _q2p32(dtype, device):
    tab = torch.tensor([10.0 ** (-i / 10.0) for i in range(256)],
                       dtype=torch.float64).to(torch.float32)
    return tab.to(device=device, dtype=dtype)


def glocal(ref_codes, l_ref: int, read_codes, quals, dtype=torch.float64):
    """(q [R, L] int, state [R, L] int) of reads that share l_ref.

    ref_codes [R, l_ref] and read_codes [R, L]: bases coded A0 C1 G2 T3
    (the caller rules out N); quals [R, L] phred.  Each cell is computed
    in the C code's order of operations."""
    dev = read_codes.device
    R, L = read_codes.shape
    bw = min(max(l_ref, L), BW)
    bw = max(bw, abs(l_ref - L))
    W = 2 * bw + 1
    f = dict(dtype=dtype, device=dev)
    qual = _q2p32(dtype, dev)[quals.long()]                  # [R, L]
    match, mismatch = 1.0 - qual, qual * EM
    sM = sI = 1.0 / (2 * L + 2)
    m = [(1 - PAR_D - PAR_D) * (1 - sM), PAR_D * (1 - sM), PAR_D * (1 - sM),
         (1 - PAR_E) * (1 - sI), PAR_E * (1 - sI), 0.0,
         1 - PAR_E, 0.0, PAR_E]
    bM = (1 - PAR_D) / l_ref
    bI = PAR_D / l_ref
    # reference codes padded so that row i's lanes are refpad[:, i:i+W]
    refpad = torch.full((R, l_ref + 2 * W + L), 4, dtype=torch.uint8,
                        device=dev)
    refpad[:, bw + 1:bw + 1 + l_ref] = ref_codes

    def band(i, hi=None):
        """Lanes of row i in the band (k in [1, l_ref], or [1, hi]): the
        first and last, and a 0/1 mask."""
        top = l_ref if hi is None else hi
        lanes = [j for j in range(W) if 1 <= i - bw + j <= top]
        mask = torch.zeros(W, **f)
        if lanes:
            mask[lanes[0]:lanes[-1] + 1] = 1.0
        return (lanes[0], lanes[-1]) if lanes else (0, -1), mask

    def emission(i, refs):
        return torch.where(refs == read_codes[:, i - 1:i],
                           match[:, i - 1:i], mismatch[:, i - 1:i])

    zero = torch.zeros(R, **f)
    FM = torch.zeros((L + 1, R, W), **f)
    FI = torch.zeros((L + 1, R, W), **f)
    s = torch.zeros((L + 2, R), **f)
    # row 1: rescaled by division
    _, ok = band(1, min(l_ref, bw + 1))
    e = emission(1, refpad[:, 1:1 + W])
    fm = e * bM * ok
    fi = torch.full_like(fm, EI * bI) * ok
    tot = (fm + fi).sum(1, keepdim=True)
    s[1] = tot[:, 0]
    FM[1], FI[1] = fm / tot, fi / tot
    fd = torch.zeros_like(fm)
    for i in range(2, L + 1):
        (jlo, jhi), ok = band(i)
        e = emission(i, refpad[:, i:i + W])
        pm, pi_ = FM[i - 1], FI[i - 1]
        pm_s = torch.nn.functional.pad(pm[:, 1:], (0, 1))
        pi_s = torch.nn.functional.pad(pi_[:, 1:], (0, 1))
        fm = e * (m[0] * pm + m[3] * pi_ + m[6] * fd) * ok
        fi = EI * (m[1] * pm_s + m[4] * pi_s) * ok
        cols = [zero] * W
        for j in range(jlo + 1, jhi + 1):
            cols[j] = m[2] * fm[:, j - 1] + m[8] * cols[j - 1]
        fd = torch.stack(cols, 1)
        tot = (fm + fi + fd).sum(1)
        s[i] = tot
        r = (1.0 / tot)[:, None]
        FM[i], FI[i], fd = fm * r, fi * r, fd * r
    _, ok = band(L)
    s[L + 1] = (FM[L] * sM + FI[L] * sI).sum(1)

    q = torch.zeros((R, L), dtype=torch.int64, device=dev)
    state = torch.zeros((R, L), dtype=torch.int64, device=dev)

    def map_row(i, bm, bi):
        z = torch.stack([FM[i] * bm, FI[i] * bi], 2).reshape(R, 2 * W)
        tot = z.sum(1)                              # k ascending, M then I
        mx, arg = z.max(1)
        kk = i - bw + arg // 2
        state[:, i - 1] = torch.where(mx > 0, (kk - 1) * 4 + arg % 2, -1)
        val = -4.343 * torch.log(1.0 - mx / tot) + 0.499
        qi = torch.where(torch.isfinite(val), val,
                         torch.zeros_like(val)).floor().long()
        q[:, i - 1] = torch.where(qi > 100, 99, qi)

    bm = (sM / s[L] / s[L + 1])[:, None] * ok
    bi = (sI / s[L] / s[L + 1])[:, None] * ok
    map_row(L, bm, bi)
    for i in range(L - 1, 0, -1):
        (jlo, jhi), ok = band(i)
        _, below_end = band(i, l_ref - 1)           # k < l_ref
        y = 1.0 if i > 1 else 0.0
        # (i+1, k+1) is lane j of row i+1; (i+1, k) is lane j-1
        e = emission(i + 1, refpad[:, i + 1:i + 1 + W]) * bm * below_end
        bi_s = torch.nn.functional.pad(bi[:, :-1], (1, 0))
        nbi = (e * m[3] + EI * m[4] * bi_s) * ok
        e6 = e * m[6]
        cols = [zero] * (W + 1)
        for j in range(jhi, jlo - 1, -1):
            cols[j] = (e6[:, j] + m[8] * cols[j + 1]) * y
        dnext = torch.stack(cols[1:], 1)
        nbm = (e * m[0] + EI * m[1] * bi_s + m[2] * dnext) * ok
        r = (1.0 / s[i])[:, None]
        bm, bi = nbm * r, nbi * r
        map_row(i, bm, bi)
    return q, state


def ext_baq(q, state, pos, xb):
    """LoFreq's extended BAQ of reads that are one M operation."""
    R, L = q.shape
    i = torch.arange(L, device=q.device)
    diag = (pos - xb)[:, None] + i
    bq = torch.where(((state & 3) != 0) | ((state >> 2) != diag),
                     torch.zeros_like(q), q)
    left = torch.cummax(bq, 1).values
    right = torch.cummax(bq.flip(1), 1).values.flip(1)
    return torch.clamp(torch.minimum(left, right), max=SANGER_PHRED_MAX)


def read_baq_many(parts, dtype=torch.float64, batch=None):
    """Extended BAQ [R, L] of the reads of each (genome_codes, pos,
    read_codes, quals) part: reads at 0-based positions pos, one M
    operation each, against the contig genome_codes [G]; the parts' reads
    share one length and run in shared batches."""
    if not parts:
        return []
    dev = parts[0][2].device
    L = parts[0][2].shape[1]
    if batch is None:
        # a batch's band rows: 2 [L+1, batch, 15] tensors
        batch = 131072 if dev.type == "cuda" else 4096
    outs = [torch.zeros((p[2].shape[0], L), dtype=torch.int64, device=dev)
            for p in parts]
    win = [window(pos, L, g.shape[0]) for g, pos, _r, _q in parts]
    lrefs = sorted({int(x) for xb, xe in win
                    for x in torch.unique(xe - xb).tolist()})
    for lr in lrefs:
        sel = [torch.nonzero((xe - xb) == lr).flatten() for xb, xe in win]
        ar = torch.arange(lr, device=dev)
        ref = torch.cat([g[xb[s, None] + ar] for (g, *_), (xb, _), s
                         in zip(parts, win, sel)])
        reads = torch.cat([p[2][s] for p, s in zip(parts, sel)])
        quals = torch.cat([p[3][s] for p, s in zip(parts, sel)])
        diag = torch.cat([p[1][s] - xb[s] for p, (xb, _), s
                          in zip(parts, win, sel)])
        res = torch.empty((len(reads), L), dtype=torch.int64, device=dev)
        for lo in range(0, len(reads), batch):
            hi = lo + batch
            q, st = glocal(ref[lo:hi], lr, reads[lo:hi], quals[lo:hi], dtype)
            res[lo:hi] = ext_baq(q, st, diag[lo:hi],
                                 torch.zeros_like(diag[lo:hi]))
        at = 0
        for out, s in zip(outs, sel):
            out[s] = res[at:at + len(s)]
            at += len(s)
    return outs
