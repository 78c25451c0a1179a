"""The fused column call (kernel K2), its plain PyTorch version, and the
fused column step built on it.

Counterpart of lofreq_tpu/ops/pallas_fused_call.py.  The device column
step (ops/device_call.py) makes about a dozen passes over its [B, D]
inputs; K2 makes one, over a packed int32 stream of 4 bytes per read
instead of 11 across five arrays:
    bits  0-6   bq   (0..93; 127 = invalid/missing row)
    bits  7-13  baq  (stored +1: 0 = missing)
    bits 14-20  mq   (stored +1 and clamped to 125: 0 = missing; 255 in
                      the BAM maps to missing per snpcaller.c:302)
    bits 21-27  sq   (stored +1 and clamped to 125: 0 = missing)
    bits 28-30  nt4  (0-3 ACGT, 4 N)
The mq/sq clamp adds at most 10^-12.5 of absolute error prob per read,
orders of magnitude inside the screen's MARGIN slack.

Per column K2 computes the quality merge, the base filters, the per-ACGT
kept-alt and raw-alt counts, the depth, and the linear-space
Poisson-binomial DP with the full distribution P(X = j), j = 0..16, plus
an overflow cell P(X > 16), so that the tail cell (the largest kept-alt
count) need not be known before the column's last read.  The tail
sum_{j >= kc} P(X = j) + overflow is a positive sum; f32 underflow only
shrinks it, which only adds candidates, the conservative direction.

`fused_columns` is the wrapper: for CUDA tensors it launches K2
(csrc/fused_call.cu, built at first use) or raises; for CPU tensors it
runs `fused_column_torch`.  There is no fallback from one to the other.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .. import defaults as D
from . import engine_device
from .device_call import alt_ids, check_inputs, screen_outputs
from .screen import KMAX

NCELL = KMAX + 2     # P(X = 0..16) and the overflow cell P(X > 16)
NEG_LN10_10 = float(np.float32(-np.log(10.0) / 10.0))
MQ0_ERRPROB = D.MQ0_ERRPROB
INVALID_BQ = 127
TAIL_FLOOR = 1e-37

_count_lock = threading.Lock()
_launches = 0


def launch_count() -> int:
    """Launches of K2 by `fused_columns` since the last reset."""
    with _count_lock:
        return _launches


def reset_launch_count() -> None:
    global _launches
    with _count_lock:
        _launches = 0


def pack_columns_np(nt4, bq, baq, mq, sq, valid):
    """Host-side packer: [B, D] field arrays -> [D, B] packed int32."""
    bq_f = np.where(valid & (bq >= 0), np.minimum(bq, 93), INVALID_BQ)
    baq_f = np.where(baq < 0, 0, np.minimum(baq, 93) + 1)
    mq_f = np.where((mq < 0) | (mq == 255), 0, np.minimum(mq, 125) + 1)
    sq_f = np.where(sq < 0, 0, np.minimum(sq, 125) + 1)
    packed = (bq_f.astype(np.int32)
              | (baq_f.astype(np.int32) << 7)
              | (mq_f.astype(np.int32) << 14)
              | (sq_f.astype(np.int32) << 21)
              | (np.minimum(nt4, 4).astype(np.int32) << 28))
    return np.ascontiguousarray(packed.T)


def fused_column_torch(packed_t, ref_nt4, min_bq=D.DEFAULT_MIN_BQ,
                       min_alt_bq=D.DEFAULT_MIN_ALT_BQ, use_baq=True,
                       use_mq=True, use_sq=False):
    """Plain version of K2: packed_t [D, B] int32, ref_nt4 [B] int ->
    (log tail [B] f32, depth [B] int32, kept-alt counts [B, 4] int32,
    raw-alt counts [B, 4] int32), the counts per ACGT id.  Each multiply
    and add is the kernel's (csrc/fused_call.cuh) and the Pallas
    kernel's."""
    dev = packed_t.device
    w = packed_t.to(torch.int32)
    bq = w & 0x7F
    baq = ((w >> 7) & 0x7F) - 1
    mq = ((w >> 14) & 0x7F) - 1
    sq = ((w >> 21) & 0x7F) - 1
    nt4 = (w >> 28) & 0x7
    ref = ref_nt4.to(torch.int32)

    not_n = (bq != INVALID_BQ) & (nt4 != 4)
    is_alt = not_n & (nt4 != ref[None, :])
    keep = not_n & (bq >= min_bq) & (~is_alt | (bq >= min_alt_bq))

    def q2p(q, use):
        if not use:
            return torch.zeros(q.shape, dtype=torch.float32, device=dev)
        return torch.where(q < 0, 0.0,
                           torch.exp(q.to(torch.float32) * NEG_LN10_10))

    sp = q2p(sq, use_sq)
    mp = q2p(mq, use_mq)
    if use_mq:
        mp = torch.where(mq == 0, MQ0_ERRPROB, mp)
    bap = q2p(baq, use_baq)
    bp = q2p(bq, True)
    merged = (mp + (1 - mp) * sp + (1 - mp) * (1 - sp) * bap
              + (1 - mp) * (1 - sp) * (1 - bap) * bp)
    p_all = torch.where(keep, torch.clamp(merged, 0.0, 1.0), 0.0)

    kept_alt = keep & is_alt
    acnt = torch.stack([(kept_alt & (nt4 == b)).sum(0) for b in range(4)],
                       dim=1).to(torch.int32)
    araw = torch.stack([(is_alt & (nt4 == b)).sum(0) for b in range(4)],
                       dim=1).to(torch.int32)
    depth = keep.sum(0).to(torch.int32)

    B = w.shape[1]
    cell = torch.arange(NCELL, device=dev)
    # the overflow cell never decays: it only collects P(X = 16) p
    keep_decay = (cell != NCELL - 1).to(torch.float32)
    state = (cell == 0).to(torch.float32).expand(B, NCELL).contiguous()
    zero = torch.zeros(B, 1, dtype=torch.float32, device=dev)
    for d in range(w.shape[0]):
        p = p_all[d][:, None]
        shifted = torch.cat([zero, state[:, :-1]], dim=1)
        state = state * (1.0 - p * keep_decay) + shifted * p

    ids = torch.arange(4, device=dev)[None, :]
    ks = torch.where(ids != ref[:, None], acnt, 0).max(dim=1).values
    kc = ks.clamp(1, KMAX)
    tail_sel = (((cell[None, :] >= kc[:, None]) & (cell[None, :] <= KMAX))
                | (cell[None, :] == NCELL - 1))
    lin = torch.where(tail_sel, state, 0.0).sum(dim=1)
    tail = torch.log(torch.clamp_min(lin, TAIL_FLOOR))
    return tail, depth, acnt, araw


def _check_cuda_args(packed_t, ref_nt4) -> None:
    if ref_nt4.device != packed_t.device:
        raise ValueError("packed_t and ref_nt4 must be on one device")
    if packed_t.dtype != torch.int32 or packed_t.dim() != 2:
        raise ValueError(f"packed_t must be [D, B] int32, got "
                         f"{tuple(packed_t.shape)} {packed_t.dtype}")
    B = packed_t.shape[1]
    if ref_nt4.dtype != torch.int32 or tuple(ref_nt4.shape) != (B,):
        raise ValueError(f"ref_nt4 must be [{B}] int32, got "
                         f"{tuple(ref_nt4.shape)} {ref_nt4.dtype}")
    if not (packed_t.is_contiguous() and ref_nt4.is_contiguous()):
        raise ValueError("packed_t and ref_nt4 must be contiguous")


def fused_columns(packed_t: torch.Tensor, ref_nt4: torch.Tensor,
                  min_bq=D.DEFAULT_MIN_BQ, min_alt_bq=D.DEFAULT_MIN_ALT_BQ,
                  use_baq=True, use_mq=True, use_sq=False):
    """(log tail [B] f32, depth [B] int32, kept-alt counts [B, 4] int32,
    raw-alt counts [B, 4] int32) of packed_t [D, B] int32
    (pack_columns_np) and ref_nt4 [B] int32.

    CPU tensors run the plain version; CUDA tensors launch K2 on the
    current stream (asynchronously) or raise."""
    global _launches
    kw = dict(min_bq=min_bq, min_alt_bq=min_alt_bq, use_baq=use_baq,
              use_mq=use_mq, use_sq=use_sq)
    if packed_t.device.type == "cpu":
        return fused_column_torch(packed_t, ref_nt4, **kw)
    if packed_t.device.type != "cuda":
        raise ValueError(f"no fused-call kernel for device {packed_t.device}")
    _check_cuda_args(packed_t, ref_nt4)
    from .._kernel_build import get_kernel_lib

    lib = get_kernel_lib()
    dev = packed_t.device
    Dd, B = packed_t.shape
    tail = torch.empty(B, dtype=torch.float32, device=dev)
    depth = torch.empty(B, dtype=torch.int32, device=dev)
    acnt = torch.empty((B, 4), dtype=torch.int32, device=dev)
    araw = torch.empty((B, 4), dtype=torch.int32, device=dev)
    if B == 0:
        return tail, depth, acnt, araw
    err = lib.lfq_fused_call_launch(
        packed_t.data_ptr(), ref_nt4.data_ptr(), tail.data_ptr(),
        depth.data_ptr(), acnt.data_ptr(), araw.data_ptr(), B, Dd,
        int(min_bq), int(min_alt_bq), int(bool(use_baq)),
        int(bool(use_mq)), int(bool(use_sq)), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("fused column call kernel (K2) launch failed: "
                           + lib.lfq_cuda_error_string(err).decode())
    with _count_lock:
        _launches += 1
    return tail, depth, acnt, araw


def build_fused_column_call(min_bq=D.DEFAULT_MIN_BQ,
                            min_alt_bq=D.DEFAULT_MIN_ALT_BQ,
                            sig=D.DEFAULT_SIG,
                            use_baq=True, use_mq=True, use_sq=False,
                            device="cuda"):
    """Returns fn(packed_t [D, B] int32, ref_nt4 [B] int32, bonf_base [B])
    -> the build_column_call output dict, computed in one pass over the
    packed stream (K2).  The tensors lie on `device`: "cuda" launches K2
    and raises without a card, "cpu" runs its plain version, for tests.
    Any B and D."""
    dev = engine_device(device)

    def fused(packed_t, ref_nt4, bonf_base):
        check_inputs(dev, (packed_t, ref_nt4, bonf_base))
        tail_val, depths, acnt4, araw4 = fused_columns(
            packed_t, ref_nt4, min_bq=min_bq, min_alt_bq=min_alt_bq,
            use_baq=use_baq, use_mq=use_mq, use_sq=use_sq)
        alt_nt = alt_ids(ref_nt4)
        return screen_outputs(alt_nt, torch.gather(acnt4, 1, alt_nt),
                              torch.gather(araw4, 1, alt_nt), depths,
                              ref_nt4, tail_val, sig, bonf_base)

    return fused
