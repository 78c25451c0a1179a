"""The device-BAQ runner: eligible reads of an ingest window through the
BAQ HMM on the card, final BAQ values extracted there.

Counterpart of lofreq_tpu/ops/device_baq.py.  The shared native ingest
(lofreq_tpu/pileup/native_ingest.py:_splice_device_baq) calls
`run(ref, codes, quals, pos, xb, xe)` with the M-only reads at the
window's mode read length that lfq_extract_reads found, and splices the
[N, L] u8 BAQ it returns into the column sweep.  The f32 BAQ is a
screening signal: the caller deflates it by BAQ_SCREEN_DELTA, and every
candidate column is re-scored with the exact C BAQ before a variant is
emitted (call/caller.py:confirm_snv_candidates), so the VCF is that of
the all-exact path.

One step per batch of reads, all on the runner's device: gather each
read's reference window from the window's codes (shipped once per
ingest window), apply the q2p table, run the HMM (ops/cuda_baq.py:baq_hmm:
kernels K3 and K4 on a CUDA device, the plain PyTorch version on the
CPU), then extract the BAQ as torch ops: with ext_baq, zero the bases
whose MAP state is off the read's diagonal, take the minimum of the
cumulative maxima from both ends and cap at 93; without it, the raw
posterior capped at 93.  Only the final u8 matrix returns to the host.

The batch tile bounds the HMM's scratch.  The kernels keep band rows:
L x 16 lanes x 2 (M, I) x 4 B plus L x 4 B of scales, 13.2 KB per read
at L = 100, so TILE_B = 32768 reads take 433 MB.  The plain version
keeps full-window rows, L x Lr x 2 x 4 B, about 102 KB per read at
L = 100 and Lr = 128, so the CPU tile of 1024 reads takes 105 MB.

The reference's link probe, compile deadline, measured-rate auto-off,
memo files, fixed compile window with its split recursion, and tail
padding existed for a remotely compiled TPU; none has a counterpart
here.  `run` never returns None: native_ingest would silently hand the
window to the C BAQ, so any failure raises.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from .baq_torch import _BASECODE, _Q2P
from .cuda_baq import baq_hmm

TILE_B = 32768     # reads per batch on a CUDA device
TILE_B_CPU = 1024  # reads per batch of the plain version on the CPU
BAQ_CAP = 93

# "did reads go through the device BAQ in this process": reads and batches
RUN_STATS = {"reads": 0, "batches": 0}
_stats_lock = threading.Lock()

_RUNNERS: dict = {}
_runners_lock = threading.Lock()


def get_runner(ext_baq: bool = True, device=None) -> "DeviceBaqRunner":
    """The process's runner for (ext_baq, device); device None means
    "cuda" when a card is present, else "cpu"."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (bool(ext_baq), str(dev))
    with _runners_lock:
        r = _RUNNERS.get(key)
        if r is None:
            r = _RUNNERS[key] = DeviceBaqRunner(ext_baq=ext_baq, device=dev)
    return r


@contextlib.contextmanager
def count_extracted_reads():
    """Count, inside the block, the eligible reads that the native
    ingest's lfq_extract_reads flags in each window it extracts: the
    reads the ingest hands to the runner.  Yields a dict
    {"eligible": reads, "windows": extract calls}; a run shows with it
    that RUN_STATS["reads"] covers every eligible read."""
    from lofreq_tpu._native_build import get_native_lib

    lib = get_native_lib()
    counted = {"eligible": 0, "windows": 0}
    lock = threading.Lock()
    orig = lib.lfq_extract_reads

    class _Counting:
        # native_ingest sets restype before each call
        restype = property(lambda self: orig.restype,
                           lambda self, v: setattr(orig, "restype", v))

        def __call__(self, *args):
            k = orig(*args)
            elig = np.ctypeslib.as_array(args[5], shape=(int(k),))
            with lock:
                counted["eligible"] += int(elig.sum())
                counted["windows"] += 1
            return k

    lib.lfq_extract_reads = _Counting()
    try:
        yield counted
    finally:
        lib.lfq_extract_reads = orig


def extract_baq_torch(q, st, diag0, ext: bool = True) -> torch.Tensor:
    """Final BAQ [B, L] u8 from the MAP phred q and state st [B, L]
    (the extraction of lofreq_tpu/ops/device_baq.py:_build_step and of
    baq_jax.extract_baq).  diag0 [B] is pos - xb, the window lane of each
    read's first base.  Non-ext BAQ is the raw posterior with no state
    masking: the reference's compiled build dead-codes that zeroing
    (bam_md_ext.c:417-421)."""
    if ext:
        L = q.shape[1]
        diag = diag0[:, None] + torch.arange(L, device=q.device,
                                             dtype=torch.int32)[None, :]
        ok = ((st & 3) == 0) & ((st >> 2) == diag)
        bq = torch.where(ok, q, 0)
        left = torch.cummax(bq, dim=1).values
        right = torch.cummax(bq.flip(1), dim=1).values.flip(1)
        q = torch.minimum(left, right)
    return torch.clamp(q, max=BAQ_CAP).to(torch.uint8)


class DeviceBaqRunner:
    """Runs the device-BAQ step for the ingest windows on one device.
    Use get_runner(); the runner keeps only the q2p table on its device."""

    def __init__(self, ext_baq: bool = True, device="cpu"):
        self.ext_baq = ext_baq
        self.device = torch.device(device)
        self.tile = TILE_B if self.device.type == "cuda" else TILE_B_CPU
        self._q2p = torch.from_numpy(_Q2P).to(self.device)

    def run(self, ref: bytes, codes, quals, pos, xb, xe) -> np.ndarray:
        """codes, quals [N, L] u8 and pos, xb, xe [N] int64 from
        lfq_extract_reads, [xb, xe) each read's reference window.
        Returns the final BAQ [N, L] u8 (0..93)."""
        N, L = codes.shape
        if N == 0:
            return np.empty((0, L), np.uint8)
        dev = self.device
        xb = np.asarray(xb, np.int64)
        xe = np.asarray(xe, np.int64)
        # the window's reference codes, shipped once for all batches; its
        # span is the batch's, so no read's window is cut
        base = int(xb.min())
        refwin = torch.from_numpy(
            _BASECODE[np.frombuffer(ref, np.uint8)[base:int(xe.max())]]
        ).to(dev)
        l_ref_np = (xe - xb).astype(np.int32)
        Lr = int(l_ref_np.max())
        xbrel = torch.from_numpy((xb - base).astype(np.int64)).to(dev)
        l_ref = torch.from_numpy(l_ref_np).to(dev)
        diag0 = torch.from_numpy((np.asarray(pos) - xb).astype(np.int32)).to(
            dev)
        codes_t = torch.from_numpy(np.ascontiguousarray(codes, np.uint8)).to(
            dev)
        quals_t = torch.from_numpy(np.ascontiguousarray(quals, np.uint8)).to(
            dev)
        lane = torch.arange(Lr, device=dev)
        out = torch.empty((N, L), dtype=torch.uint8, device=dev)
        batches = 0
        for lo in range(0, N, self.tile):
            hi = min(lo + self.tile, N)
            lr = l_ref[lo:hi]
            gidx = (xbrel[lo:hi, None] + lane[None, :]).clamp_(
                max=refwin.numel() - 1)
            refw = torch.where(lane[None, :] < lr[:, None], refwin[gidx],
                               4).to(torch.uint8)
            qualp = self._q2p[quals_t[lo:hi].long()]
            q, st = baq_hmm(refw, codes_t[lo:hi], qualp, lr)
            out[lo:hi] = extract_baq_torch(q, st, diag0[lo:hi], self.ext_baq)
            batches += 1
        res = out.cpu().numpy()
        with _stats_lock:
            RUN_STATS["reads"] += N
            RUN_STATS["batches"] += batches
        return res
