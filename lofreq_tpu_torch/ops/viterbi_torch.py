"""Batched Viterbi realignment on a torch device.

Counterpart of lofreq_tpu/ops/viterbi_jax.py, with its steps: full-width
DP rows over the reference window, one query row at a time; the D state's
within-row max-plus recurrence
    D[k] = max(M[k-1] + a, D[k-1] + b)
by its closed form  D[k] = b*k + cummax_{j<=k}(M[j-1] + a - b*j);
first-listed tie-breaking (the reference's argmax_first); the three
back-pointers packed into one uint8 per cell; and the traceback on the
device, so only the state codes and the final ref column leave it.

The reference program reaches no Pallas kernel, so torch ops on the
device are the port.  Its loop over the L query rows and its L + Lr
traceback steps issue a few dozen small ops each: on a card the batch
is bound by launches.  f32, like the reference: ties beyond f32
resolution may resolve unlike the C realigner (csrc/host/realign.c),
which stays the realigner of the `viterbi` subcommand.

Differences from the reference: the window is padded to a multiple of
128 from the longest window of the batch (the reference pads from the
first, and so needs the first to be the longest); and the device is
explicit, "cuda" by default, raising without a card (engine_device).
"""

from __future__ import annotations

import numpy as np
import torch

from . import engine_device

ALPHA = 0.00001
BETA = 0.4
NEG = float(np.float32(-2147483648.0))  # INT_MIN like the reference init

# pointer encodings
PM_S, PM_M, PM_I, PM_D = 0, 1, 2, 3  # ptr for match state ("SMID")
PI_S, PI_M, PI_I = 0, 1, 2  # "SMI"
PD_M, PD_D = 0, 1  # "MD"

EP_INS = float(np.float32(np.log10(0.25)))
TP_DM = float(np.float32(np.log10(1 - BETA)))
TP_DD = float(np.float32(np.log10(BETA)))
LG10 = float(np.float32(np.log(10.0)))
ONE_OVER_LOG10 = float(np.float32(0.4342944819032518))

_BASECODE = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    _BASECODE[ord(_c)] = _i
    _BASECODE[ord(_c.lower())] = _i


def first_argmax(vals):
    """argmax with first-listed tie-breaking over a list of tensors;
    returns (best, idx)."""
    best = vals[0]
    idx = torch.zeros_like(vals[0], dtype=torch.uint8)
    for j, v in enumerate(vals[1:], start=1):
        take = v > best
        best = torch.where(take, v, best)
        idx = torch.where(take, torch.full_like(idx, j), idx)
    return best, idx


def _lg(x):
    return torch.log(x) / LG10


def _log10(x):
    # jnp.log10's own form: log(x) times 1 / log(10) rounded to f32
    return torch.log(x) * ONE_OVER_LOG10


def _shift1(x):
    return torch.nn.functional.pad(x[:, :-1], (1, 0), value=NEG)


def viterbi_rows(refw, query, bp, l_ref):
    """The forward pass.  refw [B, Lr] codes; query [B, L] codes; bp
    [B, L] f32 error probs (Q2 already replaced); l_ref [B].  Returns
    (end_is_ins [B], end_k [B], ptrs [L, B, Lr] uint8)."""
    B, Lr = refw.shape
    L = query.shape[1]
    dev = refw.device
    ks = torch.arange(Lr, device=dev)
    ksf = ks.to(torch.float32)[None, :]
    in_ref = ks[None, :] < l_ref[:, None]
    # transition probs use the *per-read* DP length rlen = l_ref + 1
    # (viterbi.c:127-143)
    rlen = (l_ref + 1).to(torch.float32)[:, None]
    gamma = 1.0 / (2.0 * rlen)
    tp_mm = _lg((1 - 2 * ALPHA) * (1 - gamma))
    tp_mi = _lg(ALPHA * (1 - gamma))
    tp_md = tp_mi
    tp_im = _lg((1 - BETA) * (1 - gamma))
    tp_ii = _lg(BETA * (1 - gamma))
    tp_sm = _lg((1 - ALPHA) / rlen)
    tp_si = _lg(ALPHA / rlen)
    neg = torch.full((B, Lr), NEG, dtype=torch.float32, device=dev)
    vM, vI, vD = neg, neg, neg
    ptrs = torch.empty((L, B, Lr), dtype=torch.uint8, device=dev)
    ep_match = _log10(1.0 - bp)
    ep_mismatch = _log10(bp / 3.0)
    tp_dd_k = TP_DD * ksf
    for i in range(L):
        vs_prev = 0.0 if i == 0 else NEG  # V_start[i-1]
        mterms = [
            torch.full((B, Lr), vs_prev, device=dev) + tp_sm,
            _shift1(vM) + tp_mm,
            _shift1(vI) + tp_im,
            _shift1(vD) + TP_DM,
        ]
        bestM, ptrM = first_argmax(mterms)
        match = refw == query[:, i:i + 1]
        e = torch.where(match, ep_match[:, i:i + 1],
                        ep_mismatch[:, i:i + 1])
        newM = e + bestM

        iterms = [
            torch.full((B, Lr), vs_prev, device=dev) + tp_si,
            vM + tp_mi,
            vI + tp_ii,
        ]
        bestI, ptrI = first_argmax(iterms)
        newI = EP_INS + bestI

        # D row: D[k] = max(M[k-1]+tp_md, D[k-1]+tp_dd), D[<0] = NEG
        a = _shift1(newM) + tp_md
        run_val = torch.cummax(a - tp_dd_k, dim=1).values
        newD = torch.clamp_min(run_val + tp_dd_k, NEG)
        d_prev = _shift1(newD)
        ptrD = (~(a >= d_prev + TP_DD)).to(torch.uint8)  # PD_M, PD_D

        vM = torch.where(in_ref, newM, NEG)
        vI = torch.where(in_ref, newI, NEG)
        vD = torch.where(in_ref, newD, NEG)
        ptrs[i] = ptrM | (ptrI << 2) | (ptrD << 4)

    m_best = vM.max(dim=1).values
    i_best = vI.max(dim=1).values
    end_is_ins = i_best > m_best
    end_k = torch.where(end_is_ins, torch.argmax(vI, dim=1),
                        torch.argmax(vM, dim=1))
    return end_is_ins, end_k, ptrs


def traceback(end_is_ins, end_k, ptrs):
    """The traceback on the device.  States: 0=M 1=I 2=D 3=done.
    Returns (aln_codes [B, L+Lr] uint8 with 0=M,1=I,2=D,255=empty,
    filled right-to-left, k_final [B])."""
    L, B, Lr = ptrs.shape
    dev = ptrs.device
    maxs = L + Lr
    state = end_is_ins.to(torch.int64)
    i = torch.full((B,), L, dtype=torch.int64, device=dev)  # 1-based row
    k = end_k.to(torch.int64) + 1  # 1-based ref col
    kfin = k
    bidx = torch.arange(B, device=dev)
    outs = torch.empty((maxs, B), dtype=torch.uint8, device=dev)
    for si in range(maxs):
        active = (state < 3) & (i > 0) & (k > 0)
        outs[si] = torch.where(active, state, 255).to(torch.uint8)
        p = ptrs[torch.clamp(i - 1, 0, L - 1), bidx,
                 torch.clamp(k - 1, 0, Lr - 1)].to(torch.int64)
        pm = p & 3
        pi = (p >> 2) & 3
        pd = (p >> 4) & 1
        # next pointer by current state
        nxt = torch.where(
            state == 0, pm,  # SMID
            torch.where(state == 1,
                        torch.where(pi == PI_S, PM_S,
                                    torch.where(pi == PI_M, PM_M, PM_I)),
                        torch.where(pd == PD_M, PM_M, PM_D)))
        di = (state <= 1).to(torch.int64)
        dk = (state != 1).to(torch.int64)
        new_i = torch.where(active, i - di, i)
        new_k = torch.where(active, k - dk, k)
        # map pointer to next state: S -> done
        new_state = torch.where(active,
                                torch.where(nxt == PM_S, 3, nxt - 1), state)
        kfin = torch.where(active & ~((new_state < 3) & (new_i > 0)
                                      & (new_k > 0)), new_k, kfin)
        state, i, k = new_state, new_i, new_k
    return outs.T.flip(1), kfin


def prepare_batch(ref_wins, queries, bquals, q2defaults):
    """numpy inputs of a batch: refw [B, Lr_pad] codes (4 beyond each
    window), query [B, L] codes, bp [B, L] f32 error probs with Q2
    replaced by the read's q2default, l_ref [B]."""
    B = len(queries)
    L = len(queries[0])
    Lr = max(len(w) for w in ref_wins)
    Lr_pad = -(-Lr // 128) * 128
    refw = np.full((B, Lr_pad), 4, dtype=np.int32)
    l_ref = np.zeros(B, dtype=np.int32)
    query = np.zeros((B, L), dtype=np.int32)
    bp = np.zeros((B, L), dtype=np.float32)
    for b in range(B):
        w = _BASECODE[np.frombuffer(ref_wins[b], np.uint8)]
        refw[b, : len(w)] = w
        l_ref[b] = len(w)
        query[b] = _BASECODE[np.frombuffer(queries[b], np.uint8)]
        q = bquals[b].astype(np.float64)
        q = np.where(q == 2, q2defaults[b], q)
        bp[b] = 10.0 ** (-q / 10.0)
    return refw, query, bp, l_ref


def viterbi_batch(ref_wins, queries, bquals, q2defaults, device="cuda"):
    """Batch realignment of same-length queries against windows of up to
    the batch's longest length, on `device` ("cuda", or "cpu" for tests).

    ref_wins: list of bytes; queries: list of bytes (equal length);
    bquals: list of np.uint8 phred arrays; q2defaults: per-read Q2
    replacement.  Returns a list of (shift, aln_string) like
    ops.viterbi.viterbi_align."""
    dev = engine_device(device)
    arrays = prepare_batch(ref_wins, queries, bquals, q2defaults)
    refw, query, bp, l_ref = (torch.from_numpy(a).to(dev) for a in arrays)
    with torch.no_grad():
        end_is_ins, end_k, ptrs = viterbi_rows(refw, query, bp, l_ref)
        codes, kfin = traceback(end_is_ins, end_k, ptrs)
    codes = codes.cpu().numpy()
    kfin = kfin.cpu().numpy()
    out = []
    lut = np.array([77, 73, 68], dtype=np.uint8)  # 'M','I','D'
    for b in range(len(queries)):
        c = codes[b]
        c = c[c != 255]
        aln = lut[c].tobytes().decode()
        shift = int(kfin[b])
        aln = _left_align(ref_wins[b], queries[b], shift, aln)
        out.append((shift, aln))
    return out


def _left_align(ref_win: bytes, query: bytes, shift: int, aln: str) -> str:
    """Left-align indels in the state string (viterbi.c:48-96 semantics),
    reconstructing the padded ref/query strings from the alignment."""
    r = []
    q = []
    ri = shift
    qi = 0
    for ch in aln:
        if ch == "M":
            r.append(chr(ref_win[ri]) if ri < len(ref_win) else "N")
            q.append(chr(query[qi]) if qi < len(query) else "N")
            ri += 1
            qi += 1
        elif ch == "I":
            r.append("*")
            q.append(chr(query[qi]) if qi < len(query) else "N")
            qi += 1
        else:
            r.append(chr(ref_win[ri]) if ri < len(ref_win) else "N")
            q.append("*")
            ri += 1
    r = list("".join(r))
    q = list("".join(q))
    n = len(r)
    i = 0
    while i < n - 1:
        if r[i] != "*" and q[i] != "*":
            if r[i + 1] == "*":
                ilen = 0
                while i + 1 + ilen < n and r[i + 1 + ilen] == "*":
                    ilen += 1
                if i + ilen < n and q[i + ilen] == r[i]:
                    r[i + ilen] = r[i]
                    r[i] = "*"
                    i -= 1
                    continue
            elif q[i + 1] == "*":
                dlen = 0
                while i + 1 + dlen < n and q[i + 1 + dlen] == "*":
                    dlen += 1
                if i + dlen < n and q[i] == r[i + dlen]:
                    q[i + dlen] = q[i]
                    q[i] = "*"
                    i -= 1
                    continue
        i += 1
    out = []
    for j in range(n):
        if r[j] == "*":
            out.append("I")
        elif q[j] == "*":
            out.append("D")
        else:
            out.append("M")
    return "".join(out)
