"""The BAQ HMM kernels K3 (forward) and K4 (backward + MAP), and the
wrapper that picks them or the plain PyTorch version.

Counterpart of lofreq_tpu/ops/pallas_baq.py.  `baq_hmm` takes one batch
of same-length reads: for CUDA tensors it launches the hand-written
kernels (csrc/baq_hmm.cu, built at first use) or raises; for CPU tensors
it runs the plain version, ops/baq_torch.py:baq_hmm_torch.  There is no
fallback from one to the other.  `baq_forward` runs K3 alone (plain:
baq_torch.forward_band_torch), so that K3 can be held against the plain
forward pass by itself.

The kernels index the band, not the window: K3 (one half-warp per read)
writes the scaled M and I rows as 16 band lanes per row to a scratch this
wrapper allocates, [B, L, 16] f32 each, and the row scales [B, L] f32,
132 B per read and row (13.2 KB per read at L = 100); K4 (one read per
thread, the band in registers) reads them back.  K4's q and st equal
those of the kernels' body built by g++ (testing/cuh_shims.py) bit for
bit.
"""

from __future__ import annotations

import threading

import torch

from .baq_torch import LANES, baq_hmm_torch, forward_band_torch

_count_lock = threading.Lock()
_launches = {"baq_fwd": 0, "baq_bwd": 0}


def launch_count() -> dict:
    """Launches of K3 ("baq_fwd") and K4 ("baq_bwd") since the last
    reset."""
    with _count_lock:
        return dict(_launches)


def reset_launch_count() -> None:
    with _count_lock:
        for k in _launches:
            _launches[k] = 0


def _count(kernel: str) -> None:
    with _count_lock:
        _launches[kernel] += 1


def _check_cuda_args(refw, query, qualp, l_ref) -> None:
    dev = refw.device
    if any(t.device != dev for t in (query, qualp, l_ref)):
        raise ValueError("refw, query, qualp and l_ref must be on one device")
    if refw.dtype != torch.uint8 or refw.dim() != 2:
        raise ValueError(f"refw must be [B, Lr] uint8, got "
                         f"{tuple(refw.shape)} {refw.dtype}")
    B, Lr = refw.shape
    if query.dtype != torch.uint8 or query.dim() != 2 \
            or query.shape[0] != B or query.shape[1] < 1:
        raise ValueError(f"query must be [{B}, L >= 1] uint8, got "
                         f"{tuple(query.shape)} {query.dtype}")
    if qualp.dtype != torch.float32 or qualp.shape != query.shape:
        raise ValueError(f"qualp must be {tuple(query.shape)} float32")
    if l_ref.dtype != torch.int32 or tuple(l_ref.shape) != (B,):
        raise ValueError(f"l_ref must be [{B}] int32")
    if Lr < 1:
        raise ValueError("refw needs at least one window lane")
    if not all(t.is_contiguous() for t in (refw, query, qualp, l_ref)):
        raise ValueError("refw, query, qualp and l_ref must be contiguous")


def _forward(lib, refw, query, qualp, l_ref):
    """Launch K3: the scaled M and I band rows [B, L, 16] and the row
    scales [B, L]."""
    dev = refw.device
    B, Lr = refw.shape
    L = query.shape[1]
    fm = torch.empty((B, L, LANES), dtype=torch.float32, device=dev)
    fi = torch.empty((B, L, LANES), dtype=torch.float32, device=dev)
    fs = torch.empty((B, L), dtype=torch.float32, device=dev)
    if B == 0:
        return fm, fi, fs
    err = lib.lfq_baq_fwd_launch(
        refw.data_ptr(), query.data_ptr(), qualp.data_ptr(),
        l_ref.data_ptr(), fm.data_ptr(), fi.data_ptr(), fs.data_ptr(), B, L,
        Lr, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("BAQ forward kernel (K3) launch failed: "
                           + lib.lfq_cuda_error_string(err).decode())
    _count("baq_fwd")
    return fm, fi, fs


def _backward(lib, refw, query, qualp, l_ref, fm, fi, fs):
    """Launch K4 on K3's rows: q and st [B, L] int32."""
    dev = refw.device
    B, Lr = refw.shape
    L = query.shape[1]
    q = torch.empty((B, L), dtype=torch.int32, device=dev)
    st = torch.empty((B, L), dtype=torch.int32, device=dev)
    if B == 0:
        return q, st
    err = lib.lfq_baq_bwd_launch(
        refw.data_ptr(), query.data_ptr(), qualp.data_ptr(),
        l_ref.data_ptr(), fm.data_ptr(), fi.data_ptr(), fs.data_ptr(),
        q.data_ptr(), st.data_ptr(), B, L, Lr, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("BAQ backward kernel (K4) launch failed: "
                           + lib.lfq_cuda_error_string(err).decode())
    _count("baq_bwd")
    return q, st


def _cuda_lib(refw, query, qualp, l_ref):
    if refw.device.type != "cuda":
        raise ValueError(f"no BAQ kernel for device {refw.device}")
    _check_cuda_args(refw, query, qualp, l_ref)
    from .._kernel_build import get_kernel_lib

    return get_kernel_lib()


def baq_forward(refw: torch.Tensor, query: torch.Tensor,
                qualp: torch.Tensor, l_ref: torch.Tensor):
    """The forward pass alone (K3): (fm, fi) [B, L, 16] f32 scaled M and I
    band rows and fs [B, L] f32 row scales.  CPU tensors run the plain
    version (baq_torch.forward_band_torch); CUDA tensors launch K3 or
    raise."""
    if refw.device.type == "cpu":
        return forward_band_torch(refw, query, qualp, l_ref)
    return _forward(_cuda_lib(refw, query, qualp, l_ref), refw, query,
                    qualp, l_ref)


def baq_hmm(refw: torch.Tensor, query: torch.Tensor, qualp: torch.Tensor,
            l_ref: torch.Tensor):
    """(q, st) [B, L] int32 MAP phred and state for one batch.

    refw [B, Lr] window codes, query [B, L] read codes, qualp [B, L] f32
    error probs, l_ref [B] window lengths (baq_hmm_torch's arguments).
    CPU tensors run the plain version; CUDA tensors (uint8, uint8,
    float32, int32, contiguous) launch K3 then K4 on the current stream,
    asynchronously, or raise."""
    if refw.device.type == "cpu":
        return baq_hmm_torch(refw, query, qualp, l_ref)
    lib = _cuda_lib(refw, query, qualp, l_ref)
    rows = _forward(lib, refw, query, qualp, l_ref)
    return _backward(lib, refw, query, qualp, l_ref, *rows)
