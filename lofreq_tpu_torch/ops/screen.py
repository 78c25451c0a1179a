"""Device significance screening for the Poisson-binomial test, on PyTorch.

Counterpart of lofreq_tpu/ops/screen.py.  The screen is a conservative
lower bound of each column's tail: a fixed-length clipped-K DP over the
column's top-S u8 error-prob codes (ops/cuda_poissbin.py).  Columns whose
bound already exceeds (sig * MARGIN) / bonf can never be called and are
screened out; everything else is confirmed by the exact native DP, so the
output is identical to running the exact DP everywhere.

The numpy and C helpers of the host side (prescreen_codes,
screen_codes_for, host_screen_tail, host_screen_tail_codes) keep the
reference's bodies.  The reference's compile ladder, deadlines, mode memo
files and link probe existed only for a remotely compiled TPU and have no
counterpart: on CUDA tensors a dispatch always launches the kernel.

Multi-card: the reference shards the screen's columns over a mesh of every
local chip (its _local_mesh and _build_screen_fn(mesh=...)).  Here, when
the device is the unindexed "cuda" and the process drives more than one
card (parallel/distributed.py:local_mesh), a dispatch splits its columns
into contiguous blocks, launches the kernel on each card and gathers the
masks in column order (screen_split).  The mask is per column, so no
collective is needed.  On one card a dispatch is one copy and one launch.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from ..parallel.distributed import column_blocks, local_mesh
from .cuda_poissbin import CODE_PAD, S_ALIGN, screen_codes

# max probs shipped/scanned per column: deep columns are screened from
# their top-S largest err probs (subset tail = lower bound of full tail)
TOP_S = 128
KMAX = 16  # clipped tail cell (tail at smaller k bounds tail at k)
MARGIN = 1e3  # screening slack for f32 drift + running-bonf growth

# "did the device screen run in this process": dispatches and the columns
# they carried (bench and chip_smoke report these)
DISPATCH_STATS = {"dispatched": 0, "columns": 0}
_stats_lock = threading.Lock()


def screen_ready(device) -> bool:
    """Make the screen usable on `device`: on CUDA this builds (or loads)
    the kernel library, raising if it cannot."""
    if torch.device(device).type == "cuda":
        from .._kernel_build import get_kernel_lib

        get_kernel_lib()
    return True


def quantize_codes(probs, depths) -> np.ndarray:
    """[B, S] u8 codes of a packed prob matrix, S = the depth rounded up
    to 16 and capped at TOP_S: the top-S largest valid probs of deeper
    columns (a subset tail is a lower bound of the full tail), the probs
    themselves otherwise, and 255 for padding, invalid probs and rows
    beyond a column's depth.  The rounding is the reference's
    (lofreq_tpu/ops/screen.py:screen_dispatch): ceil, so each decode is
    <= its prob, the conservative direction."""
    probs = np.asarray(probs, dtype=np.float64)
    B, D = probs.shape
    s = min(TOP_S, -(-max(D, 1) // S_ALIGN) * S_ALIGN)
    in_depth = np.arange(D)[None, :] < np.asarray(depths)[:, None]
    if D > s:
        # invalid probs and rows beyond depth become 0.0 (an identity)
        # first, so they can never crowd out real probs
        arr = np.where((probs <= 1.0) & in_depth, probs, 0.0)
        prefix = np.partition(arr, D - s, axis=1)[:, D - s:]
    else:
        prefix = np.full((B, s), 2.0)
        prefix[:, :D] = np.where(in_depth, probs, 2.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        lg = np.ceil(-np.log2(np.maximum(prefix, 1e-300)) * 8.0)
    return np.where((prefix <= 0.0) | (prefix > 1.0) | (lg > 254), CODE_PAD,
                    np.clip(lg, 0, 254)).astype(np.uint8)


def _issue(codes, ks, bonf, sig, device) -> torch.Tensor:
    """The candidate mask [B] bool (True = needs exact confirmation) of
    u8 codes [B, S], on `device`.  The reference's `depths` argument is
    gone: the host sets codes beyond a column's depth to 255, the exact
    identity of the DP."""
    B = codes.shape[0]
    ks = np.maximum(np.asarray(ks, dtype=np.int32), 1)
    bonf = np.broadcast_to(np.asarray(bonf, dtype=np.float64), (B,))
    # threshold in f64, then rounded to f32, as the reference does
    log_thresh = np.log(sig * MARGIN / bonf).astype(np.float32)
    dev = torch.device(device)
    cards = local_mesh(dev)
    with _stats_lock:
        DISPATCH_STATS["dispatched"] += 1
        DISPATCH_STATS["columns"] += B
    if len(cards) > 1:
        return screen_split(codes, ks, log_thresh, cards)
    return screen_codes(torch.from_numpy(np.ascontiguousarray(codes)).to(dev),
                        torch.from_numpy(ks).to(dev),
                        torch.from_numpy(log_thresh).to(dev))[1]


def screen_split(codes, ks, log_thresh, devices) -> torch.Tensor:
    """The candidate mask [B] bool of u8 codes [B, S], int32 ks [B] and
    f32 log_thresh [B] (numpy), with the columns split into contiguous
    blocks over `devices` (one device may be listed more than once): one
    screen_codes per block, on its device, all issued before the masks
    are gathered, in column order, on devices[0]."""
    masks = []
    for d, (lo, hi) in zip(devices, column_blocks(codes.shape[0],
                                                  len(devices))):
        block = (torch.from_numpy(np.ascontiguousarray(a[lo:hi])).to(d)
                 for a in (codes, ks, log_thresh))
        masks.append(screen_codes(*block)[1])
    return torch.cat([m.to(devices[0]) for m in masks])


def screen_dispatch(probs, depths, ks, bonf, sig, device) -> torch.Tensor:
    """Quantize a packed prob chunk on the host and issue the screen on
    `device`.  Returns a handle for screen_fetch; on CUDA the kernel runs
    asynchronously until the fetch."""
    return _issue(quantize_codes(probs, depths), ks, bonf, sig, device)


def screen_dispatch_codes(codes, ks, bonf, sig, device) -> torch.Tensor:
    """screen_dispatch for pre-quantized [B, TOP_S] codes
    (screen_codes_for, csrc/screen_pack.c): no partition, no quantize,
    and no padding of B, since the kernel masks its own ragged edge."""
    return _issue(codes, ks, bonf, sig, device)


def screen_fetch(handle: torch.Tensor) -> np.ndarray:
    """Blocking fetch of a dispatch handle's candidate mask [B] bool."""
    return handle.cpu().numpy()


def host_screen_tail(probs, depths, ks, bonf, sig) -> np.ndarray:
    """Host (numpy f64) mirror of the device screen's clipped-K partial
    tail DP: True = candidate (needs the exact DP).  Same semantics as
    screen_body — top-S largest err probs per row (subset tail = lower
    bound of the full tail), K clipped to KMAX (a clipped tail can rule
    nothing out beyond it), same MARGIN slack — minus the u8
    quantization (f64 here).

    This is the sub-screen when the device screen is off (no card, or
    --no-device-screen) and the exact confirm's own screen: without it,
    every top-k-prescreen survivor would reach the exact DP.  It only
    ever sees prescreen survivors."""
    probs = np.asarray(probs, dtype=np.float64)
    B, D = probs.shape
    if B == 0:
        return np.ones(0, dtype=bool)
    ks = np.asarray(ks, dtype=np.int64)
    kc = np.minimum(np.maximum(ks, 1), KMAX)
    in_depth = np.arange(D)[None, :] < np.asarray(depths)[:, None]
    arr = np.where((probs <= 1.0) & in_depth, probs, 0.0)
    s = min(D, TOP_S)
    if D > s:
        arr = np.partition(arr, D - s, axis=1)[:, D - s:]
    cell = np.arange(KMAX + 1)[None, :]
    is_tail = cell == kc[:, None]
    not_beyond = cell <= kc[:, None]
    state = np.zeros((B, KMAX + 1))
    state[:, 0] = 1.0
    for j in range(arr.shape[1]):
        p = arr[:, j][:, None]
        shifted = np.concatenate([np.zeros((B, 1)), state[:, :-1]], axis=1)
        adv = shifted * p
        tail = state + adv
        state = np.where(is_tail, tail, state * (1.0 - p) + adv)
        state *= not_beyond
    lin_tail = state[np.arange(B), kc]
    thresh = np.float64(sig) * MARGIN / np.asarray(bonf, dtype=np.float64)
    return (lin_tail < thresh) | (ks > KMAX)


# -- code-native screening (csrc/screen_pack.c) -------------------------
#
# The fused sweep's CSR f32 probs are quantized/top-S-selected in C —
# per column, sorted ascending, 255-padded — so the whole screening
# front-end (prescreen bound + device/host sub-screen) runs on u8 codes
# with no per-chunk numpy partition/quantize pass at all.

LN2_8 = float(np.log(2.0)) / 8.0


def screen_codes_for(flat_probs, starts, cols) -> np.ndarray | None:
    """[len(cols), TOP_S] u8 top-S codes via the native kernel, or None
    when the native lib is unavailable (callers use the prob path).

    flat_probs may be f32 probs (quantize + counting select) or a
    pre-quantized u8 code CSR straight from the fused sweep
    (screen_flat==2 — pure counting select, the cheapest path)."""
    import ctypes

    if flat_probs.dtype not in (np.float32, np.uint8):
        return None
    try:
        from .._native_build import get_native_lib

        lib = get_native_lib()
    except Exception:
        return None
    n = len(cols)
    out = np.empty((n, TOP_S), np.uint8)
    if n == 0:
        return out
    flat = np.ascontiguousarray(flat_probs)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    nthreads = int(os.environ.get("LOFREQ_NATIVE_THREADS",
                                  min(4, os.cpu_count() or 1)))
    i64p = ctypes.POINTER(ctypes.c_int64)
    if flat.dtype == np.uint8:
        lib.lfq_screen_codes_u8(
            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            starts.ctypes.data_as(i64p), cols.ctypes.data_as(i64p),
            ctypes.c_int64(n), ctypes.c_int32(TOP_S),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int32(nthreads))
    else:
        lib.lfq_screen_codes(
            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            starts.ctypes.data_as(i64p), cols.ctypes.data_as(i64p),
            ctypes.c_int64(n), ctypes.c_int32(TOP_S),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int32(nthreads))
    return out


def prescreen_codes(codes, ks, bonf, sig,
                    topk_max: int = 64) -> np.ndarray:
    """Top-k product lower bound straight from the codes: the product of
    the k largest decoded probs is exp(-(ln2/8) * sum of the k smallest
    codes) — an integer cumsum instead of a partition+log pass.  Decodes
    are <= the true probs, so the bound is a lower bound of the true
    top-k product, itself a lower bound of the Poisson-binomial tail:
    discarding on (bound * bonf > sig) is provably output-identical
    (same argument as caller._topk_prescreen; the 0.5 slack is kept for
    uniformity although the code sum is exact integer math).  Rows with
    ks outside [1, topk_max] or whose k-th code is padding (255 = a
    zero prob: the bound degenerates) are kept.  Returns keep mask."""
    B = codes.shape[0]
    if B == 0:
        return np.ones(0, bool)
    ks = np.asarray(ks, dtype=np.int64)
    kmax = int(min(max(int(ks.max(initial=1)), 1), topk_max))
    csum = np.cumsum(codes[:, :kmax].astype(np.int64), axis=1)
    k_idx = np.clip(np.minimum(ks, kmax) - 1, 0, kmax - 1)
    rows = np.arange(B)
    code_sum = csum[rows, k_idx]
    kth = codes[rows, k_idx]
    lb_log = -LN2_8 * code_sum.astype(np.float64)
    bounded = (ks >= 1) & (ks <= topk_max) & (kth < 255)
    with np.errstate(divide="ignore"):
        discard = bounded & (
            lb_log + np.log(np.asarray(bonf, dtype=np.float64))
            + np.log(0.5) > np.log(np.float64(sig)))
    return ~discard


def host_screen_tail_codes(codes, ks, bonf, sig) -> np.ndarray:
    """Host fallback of the code sub-screen: the same clipped-K partial
    tail DP as host_screen_tail, over the decoded codes (f64)."""
    dec = np.zeros(256)
    dec[:255] = np.exp2(-np.arange(255, dtype=np.float64) / 8.0)
    return host_screen_tail(dec[codes], np.full(codes.shape[0],
                                                codes.shape[1]),
                            ks, bonf, sig)
