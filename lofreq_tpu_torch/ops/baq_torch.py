"""Batched BAQ forward/backward HMM in plain PyTorch.

Counterpart of lofreq_tpu/ops/baq_jax.py: the banded glocal HMM of
base-alignment quality (csrc/baq.c:glocal is the exact f64 host version)
in the same full-window, band-as-mask formulation.  Each DP row spans the
read's whole reference window and the band (bw = 7) is a mask; the D
state's within-row chain fD[k] = a[k] + m22 * fD[k-1] is one triangular
Toeplitz product in full f32 (m22^j underflows f32 past j ~ 127, so the
matrix is the exact chain).

This is the plain version of the Hopper kernels K3/K4 (ops/cuda_baq.py):
the CPU path of the device-BAQ runner, and what the kernels are held
against on the card.  The IDAQ posteriors (baq_jax's want_pd) are not
ported: nothing on the port's paths asks for them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# the HMM's parameters and tables, as in lofreq_tpu/ops/baq_jax.py
PAR_D = 0.00001
PAR_E = 0.4
EI = 0.25
EM = 0.33333333333

_BASECODE = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    _BASECODE[ord(_c)] = _i
    _BASECODE[ord(_c.lower())] = _i

_Q2P = np.array([np.float32(10.0 ** (-q / 10.0)) for q in range(256)],
                dtype=np.float32)

BW = 7  # band width of the M-only reads the device path takes (baq.c:422)
LANES = 16  # band lanes per row in the kernels: 2 * BW + 1 cells, one idle


def _f32(x: float) -> float:
    """x rounded to f32, as JAX rounds a weakly typed Python scalar."""
    return float(np.float32(x))


def hmm_consts(L: int) -> dict:
    """Transition constants for read length L (baq_jax.py:38-44), in
    f64 and then rounded to f32.  sM = sI = 1 / (2L + 2) depends on the
    batch's read length."""
    sM = sI = 1.0 / (2 * L + 2)
    c = dict(sM=sM, sI=sI,
             m00=(1 - PAR_D - PAR_D) * (1 - sM),
             m01=PAR_D * (1 - sM), m02=PAR_D * (1 - sM),
             m10=(1 - PAR_E) * (1 - sI), m11=PAR_E * (1 - sI),
             m20=1 - PAR_E, m22=PAR_E)
    return {k: _f32(v) for k, v in c.items()}


def _chain_matrix(Lr: int, m22: float, device) -> torch.Tensor:
    """T [Lr, Lr] with T[j, k] = m22^(k-j) for j <= k, else 0, so that
    a @ T is the chain fD[k] = sum_{j<=k} a[j] m22^(k-j) (baq_jax.py:66)."""
    kj = np.arange(Lr)[:, None] - np.arange(Lr)[None, :]
    t = np.where(kj <= 0, np.power(np.float64(m22), -kj, where=kj <= 0,
                                   out=np.zeros_like(kj, np.float64)), 0.0)
    return torch.from_numpy(t.astype(np.float32)).to(device)


def _shift_right(x):
    """x[:, k-1] at k, 0 at k = 0."""
    return F.pad(x, (1, 0))[:, :-1]


def _shift_left(x):
    """x[:, k+1] at k, 0 at the last lane."""
    return F.pad(x, (0, 1))[:, 1:]


class _Hmm:
    """One batch's inputs, constants and masks (baq_jax._build's closure)."""

    def __init__(self, refw, query, qualp, l_ref):
        dev = self.dev = refw.device
        if dev.type == "cuda":
            # jnp.dot(..., HIGHEST) is full f32: no TF32 in the chain product
            torch.backends.cuda.matmul.allow_tf32 = False
        B, self.Lr = refw.shape
        self.L = query.shape[1]
        self.c = hmm_consts(self.L)
        self.refw = refw.to(torch.int32)
        self.query = query.to(torch.int32)
        self.qualp = qualp.to(torch.float32)
        self.l_ref = l_ref.to(torch.int32)
        self.T = _chain_matrix(self.Lr, self.c["m22"], dev)
        self.ks = torch.arange(1, self.Lr + 1, device=dev,
                               dtype=torch.int32)[None, :]
        self.in_ref = self.ks <= self.l_ref[:, None]

    def band_mask(self, i: int):
        hi = torch.clamp(self.l_ref, max=i + BW)[:, None]
        return (self.ks >= max(1, i - BW)) & (self.ks <= hi) & self.in_ref

    def emission(self, r: int):
        """Emission rows [B, Lr] of 0-based read position r."""
        qual_i = self.qualp[:, r:r + 1]
        query_i = self.query[:, r:r + 1]
        amb = (self.refw > 3) | (query_i > 3)
        match = self.refw == query_i
        return torch.where(amb, 1.0, torch.where(match, 1.0 - qual_i,
                                                 qual_i * _f32(EM)))

    def forward(self):
        """Rows 1..L of the scaled M and I ([B, Lr] each) and the row
        scales ([B]), as lists."""
        c, ks, ei = self.c, self.ks, _f32(EI)
        m00, m01, m02 = c["m00"], c["m01"], c["m02"]
        m10, m11, m20 = c["m10"], c["m11"], c["m20"]
        lref_f = self.l_ref.to(torch.float32)[:, None]
        bM = _f32(1 - PAR_D) / lref_f
        bI = _f32(PAR_D) / lref_f
        e1 = self.emission(0)
        mask1 = self.band_mask(1) & (
            ks <= torch.clamp(self.l_ref, max=BW + 1)[:, None])
        fM = torch.where(mask1, e1 * bM, 0.0)
        fI = torch.where(mask1, ei * bI, 0.0)
        fD = torch.zeros_like(fM)
        s1 = torch.clamp_min((fM + fI).sum(1), 1e-30)
        fM = fM / s1[:, None]
        fI = fI / s1[:, None]
        Ms, Is, ss = [fM], [fI], [s1]
        for i in range(2, self.L + 1):
            e = self.emission(i - 1)
            mask = self.band_mask(i)
            newM = e * (m00 * _shift_right(fM) + m10 * _shift_right(fI)
                        + m20 * _shift_right(fD))
            newI = ei * (m01 * fM + m11 * fI)
            newM = torch.where(mask, newM, 0.0)
            newI = torch.where(mask, newI, 0.0)
            newD = torch.matmul(m02 * _shift_right(newM), self.T)
            newD = torch.where(mask, newD, 0.0)
            s = torch.clamp_min((newM + newI + newD).sum(1), 1e-30)
            inv = (1.0 / s)[:, None]
            fM, fI, fD = newM * inv, newI * inv, newD * inv
            Ms.append(fM)
            Is.append(fI)
            ss.append(s)
        return Ms, Is, ss

    def backward_map(self, Ms, Is, ss, want_margin: bool):
        """The backward pass from row L with each row's MAP folded in (no
        [L, B, Lr] posterior tensor is kept): per row (q, st[, margins])."""
        c, L, ei = self.c, self.L, _f32(EI)
        m00, m01, m02 = c["m00"], c["m01"], c["m02"]
        m10, m11, m20 = c["m10"], c["m11"], c["m20"]
        sM, sI = c["sM"], c["sI"]
        T_rev = self.T.T.contiguous()
        lane = torch.arange(self.Lr, device=self.dev)[None, :]

        def map_row(zM, zI):
            """Per-row MAP phred and state; the failure mass is the sum
            minus the winning cell (not 1 - max/tot, which saturates f32
            for posteriors near 1)."""
            best_m = zM.max(1).values
            best_i = zI.max(1).values
            is_ins = best_i > best_m
            best = torch.where(is_ins, best_i, best_m)
            # torch.argmax returns the first maximal lane, as jnp.argmax
            best_k = torch.where(is_ins, zI.argmax(1), zM.argmax(1))
            win = lane == best_k[:, None]
            rest_m = torch.where(~is_ins[:, None] & win, 0.0, zM)
            rest_i = torch.where(is_ins[:, None] & win, 0.0, zI)
            rest = rest_m.sum(1) + rest_i.sum(1)
            pfail = rest / torch.clamp_min(rest + best, 1e-30)
            y = -4.343 * torch.log(torch.clamp_min(pfail, 1e-38)) + 0.499
            qph = y.to(torch.int32)
            qph = torch.where(qph > 100, 99, qph)  # C: k > 100 ? 99 : k
            st = (best_k.to(torch.int32) << 2) | is_ins.to(torch.int32)
            if not want_margin:
                return qph, st
            frac = y - torch.floor(y)
            margin_q = torch.minimum(frac, 1.0 - frac)
            second = torch.maximum(rest_m.max(1).values,
                                   rest_i.max(1).values)
            margin_s = 1.0 - second / torch.clamp_min(best, 1e-30)
            return qph, st, margin_q, margin_s

        sL1 = (Ms[-1] * sM + Is[-1] * sI).sum(1)
        maskL = self.band_mask(L)
        bMc = torch.where(maskL, sM / ss[-1][:, None] / sL1[:, None], 0.0)
        bIc = torch.where(maskL, sI / ss[-1][:, None] / sL1[:, None], 0.0)
        rows = [None] * L
        rows[L - 1] = map_row(Ms[-1] * bMc, Is[-1] * bIc)
        for i in range(L - 1, 0, -1):
            e = self.emission(i)               # row i+1's query and qual
            eb_shift = _shift_left(e * bMc)    # e * bM of row i+1 at k+1
            common = ei * bIc
            mask = self.band_mask(i)
            bDn = torch.matmul(torch.where(mask, eb_shift * m20, 0.0), T_rev)
            bDn = torch.where(mask, bDn * float(i > 1), 0.0)  # none on row 1
            bD_next = _shift_left(bDn)
            bMn = eb_shift * m00 + m01 * common + m02 * bD_next
            bIn = eb_shift * m10 + m11 * common
            inv = (1.0 / ss[i - 1])[:, None]
            bMc = torch.where(mask, bMn, 0.0) * inv
            bIc = torch.where(mask, bIn, 0.0) * inv
            rows[i - 1] = map_row(Ms[i - 1] * bMc, Is[i - 1] * bIc)
        return rows


def baq_hmm_torch(refw, query, qualp, l_ref, want_margin: bool = False):
    """The BAQ HMM of baq_jax._build's BAQ-only and margin branches.

    refw [B, Lr] reference codes of each read's window (0..3, 4 = N or
    pad), query [B, L] read codes, qualp [B, L] f32 error probs (the q2p
    table applied), l_ref [B] window lengths; codes of any integer
    dtype, all on one device.  Returns (q, st) [B, L] int32: the MAP
    phred and state (k << 2) | is_ins, k the 0-based window lane.  With
    want_margin, also (margin_q, margin_s) [B, L] f32: the distance of
    the pre-truncation phred to an integer, and the relative gap of the
    MAP winner to the runner-up cell."""
    hmm = _Hmm(refw, query, qualp, l_ref)
    rows = hmm.backward_map(*hmm.forward(), want_margin)
    return tuple(torch.stack(col, dim=1) for col in zip(*rows))


def forward_band_torch(refw, query, qualp, l_ref):
    """The plain forward pass in kernel K3's layout: the scaled M and I
    rows on the 16 band lanes, [B, L, 16] f32 each (lane u of row i is
    window position i - bw + u, 1-based; 0 off the window), and the row
    scales [B, L] f32."""
    hmm = _Hmm(refw, query, qualp, l_ref)
    Ms, Is, ss = hmm.forward()
    B, L = hmm.query.shape
    # window lane k - 1 = i - bw - 1 + u, shifted by the BW + 1 left pad
    idx = (torch.arange(1, L + 1, device=hmm.dev)[:, None]
           + torch.arange(LANES, device=hmm.dev)[None, :]).expand(B, L, LANES)

    def band(rows):
        full = F.pad(torch.stack(rows, dim=1), (BW + 1, L + LANES))
        return full.gather(2, idx)

    return band(Ms), band(Is), torch.stack(ss, dim=1)


def baq_batch(reads_info, ref: bytes, device="cuda"):
    """Device BAQ for a batch of same-length reads (baq_batch_jax).

    reads_info: list of (pos, seq bytes, qual np.uint8, xb, xe), [xb, xe)
    the read's reference window.  Runs ops/cuda_baq.py:baq_hmm on
    `device`: K3/K4 on "cuda" (which raises without a card), the plain
    version on "cpu".
    Returns (q [B, L], state [B, L]) int32 numpy arrays."""
    from . import engine_device
    from .cuda_baq import baq_hmm

    B = len(reads_info)
    L = len(reads_info[0][1])
    Lr = max(r[4] - r[3] for r in reads_info)
    refarr = np.frombuffer(ref, dtype=np.uint8)
    refw = np.full((B, Lr), 4, dtype=np.uint8)
    l_ref = np.zeros(B, dtype=np.int32)
    query = np.zeros((B, L), dtype=np.uint8)
    qualp = np.zeros((B, L), dtype=np.float32)
    for i, (_pos, seq, qual, xb, xe) in enumerate(reads_info):
        w = _BASECODE[refarr[xb:xe]]
        refw[i, :len(w)] = w
        l_ref[i] = len(w)
        query[i] = _BASECODE[np.frombuffer(seq, dtype=np.uint8)]
        qualp[i] = _Q2P[qual]
    dev = engine_device(device)
    q, st = baq_hmm(*(torch.from_numpy(a).to(dev)
                      for a in (refw, query, qualp, l_ref)))
    return q.cpu().numpy(), st.cpu().numpy()
