"""The Poisson-binomial tail kernel (K1) and its plain PyTorch version.

Counterpart of lofreq_tpu/ops/pallas_poissbin.py.  Per pileup column K1
computes log P(X >= kc), X = sum of Bernoulli(p_i) over the column's error
probs and kc = min(k, KMAX), as a clipped-K DP in linear f32 space (17
cells).  It has two entries, each a wrapper that launches the hand-written
kernel (csrc/poissbin_screen.cu, built at first use) for CUDA tensors or
raises, and runs the plain version for CPU tensors; there is no fallback
from one to the other.

- `screen_codes`: over u8 error-prob codes, with the decode and the
  threshold compare of lofreq_tpu/ops/screen.py:screen_body fused in
  (the candidate mask (log tail < log_thresh) | (k > KMAX)); plain
  version `screen_codes_torch`.  The `call` path's sub-screen.
- `tail_probs`: over f32 probs, the counterpart of
  pallas_poissbin.tail_device; plain version `tail_torch`.  The device
  column step's DP (ops/device_call.py).  `poissbin_tail` is the
  counterpart of pallas_poissbin.poissbin_tail_pallas on top of it.

Each entry counts its own launches, in all and per card (launch_count);
`tail_probs` also counts the layout copies it makes (layout_copy_count).
"""

from __future__ import annotations

import threading

import torch

KMAX = 16
NCELL = KMAX + 1
CODE_PAD = 255   # decodes to p = 0, the DP identity
TAIL_FLOOR = 1e-37
S_ALIGN = 16     # the kernel reads each row as 16-byte vectors

_count_lock = threading.Lock()
_launches = {"screen_codes": 0, "tail_probs": 0}
_card_launches = {}   # (entry, card index) -> launches
_layout_copies = [0]


def launch_count(entry: str = "screen_codes", card: int = None) -> int:
    """Kernel launches by the entry `entry` ("screen_codes" or
    "tail_probs") since the last reset: on every card, or on card index
    `card`."""
    with _count_lock:
        if card is None:
            return _launches[entry]
        return _card_launches.get((entry, card), 0)


def layout_copy_count() -> int:
    """Copies of probs into a layout tail_probs' kernel reads, since the
    last reset."""
    with _count_lock:
        return _layout_copies[0]


def reset_launch_count() -> None:
    """Zero the launch counts and the layout copy count."""
    with _count_lock:
        for k in _launches:
            _launches[k] = 0
        _card_launches.clear()
        _layout_copies[0] = 0


def _count(entry: str, card: int) -> None:
    with _count_lock:
        _launches[entry] += 1
        _card_launches[(entry, card)] = _card_launches.get((entry, card),
                                                           0) + 1


def decode_codes(codes: torch.Tensor) -> torch.Tensor:
    """u8 log-quantized codes -> f32 probs: 2^(-c/8), 255 -> 0."""
    probs = torch.exp2(-codes.to(torch.float32) / 8.0)
    return torch.where(codes == CODE_PAD, 0.0, probs)


def tail_torch(probs: torch.Tensor, kc: torch.Tensor) -> torch.Tensor:
    """Plain clipped-K tail DP: probs [B, D] f32 in any order (p > 1.5 is
    pad and acts as the identity), kc [B] in [1, KMAX].  Returns
    log(max(P(X >= kc), 1e-37)) [B] f32, the value of pallas_poissbin's
    tail_device."""
    B, D = probs.shape
    dev = probs.device
    p_all = torch.where(probs > 1.5, 0.0, probs).clamp(0.0, 1.0)
    kc = kc.to(torch.int64)
    cell = torch.arange(NCELL, device=dev)[None, :]
    is_tail = cell == kc[:, None]
    not_beyond = cell <= kc[:, None]
    state = (cell == 0).to(torch.float32).expand(B, NCELL).contiguous()
    zero = torch.zeros(B, 1, dtype=torch.float32, device=dev)
    for j in range(D):
        p = p_all[:, j:j + 1]
        adv = torch.cat([zero, state[:, :-1]], dim=1) * p
        std = state * (1.0 - p) + adv
        tail = state + adv
        state = torch.where(not_beyond, torch.where(is_tail, tail, std), 0.0)
    lin = state.gather(1, kc[:, None])[:, 0]
    return torch.log(torch.clamp_min(lin, TAIL_FLOOR))


def screen_codes_torch(codes: torch.Tensor, ks: torch.Tensor,
                       log_thresh: torch.Tensor):
    """Plain version of the kernel: codes [B, S] u8, ks [B] int,
    log_thresh [B] f32 -> (log tail [B] f32, candidate mask [B] bool)."""
    tail = tail_torch(decode_codes(codes), ks.clamp(1, KMAX))
    return tail, (tail < log_thresh) | (ks > KMAX)


def _check_cuda_args(codes, ks, log_thresh) -> None:
    dev = codes.device
    if ks.device != dev or log_thresh.device != dev:
        raise ValueError("codes, ks and log_thresh must be on one device")
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise ValueError(f"codes must be [B, S] uint8, got "
                         f"{tuple(codes.shape)} {codes.dtype}")
    B, S = codes.shape
    if S > 128 or S % S_ALIGN:
        raise ValueError(f"codes width {S} must be a multiple of "
                         f"{S_ALIGN} and at most 128")
    if ks.dtype != torch.int32 or tuple(ks.shape) != (B,):
        raise ValueError(f"ks must be [{B}] int32")
    if (log_thresh.dtype != torch.float32
            or tuple(log_thresh.shape) != (B,)):
        raise ValueError(f"log_thresh must be [{B}] float32")
    if not (codes.is_contiguous() and ks.is_contiguous()
            and log_thresh.is_contiguous()):
        raise ValueError("codes, ks and log_thresh must be contiguous")
    if codes.data_ptr() % S_ALIGN:
        raise ValueError("codes must be 16-byte aligned")


def screen_codes(codes: torch.Tensor, ks: torch.Tensor,
                 log_thresh: torch.Tensor):
    """(log tail [B] f32, candidate mask [B] bool) for u8 codes [B, S].

    CPU tensors run the plain version; CUDA tensors launch the kernel on
    the current stream (asynchronously) or raise."""
    if codes.device.type == "cpu":
        return screen_codes_torch(codes, ks, log_thresh)
    if codes.device.type != "cuda":
        raise ValueError(f"no screen kernel for device {codes.device}")
    _check_cuda_args(codes, ks, log_thresh)
    from .._kernel_build import get_kernel_lib

    lib = get_kernel_lib()
    B, S = codes.shape
    tail = torch.empty(B, dtype=torch.float32, device=codes.device)
    mask = torch.empty(B, dtype=torch.bool, device=codes.device)
    if B == 0:
        return tail, mask
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    err = lib.lfq_screen_codes_launch(
        codes.data_ptr(), ks.data_ptr(), log_thresh.data_ptr(),
        tail.data_ptr(), mask.data_ptr(), B, S, codes.device.index,
        stream)
    if err:
        raise RuntimeError("screen_codes kernel launch failed: "
                           + lib.lfq_cuda_error_string(err).decode())
    _count("screen_codes", codes.device.index)
    return tail, mask


def _check_tail_args(probs, kc) -> None:
    if kc.device != probs.device:
        raise ValueError("probs and kc must be on one device")
    if probs.dtype != torch.float32 or probs.dim() != 2 \
            or probs.shape[1] < 1:
        raise ValueError(f"probs must be [B, D >= 1] float32, got "
                         f"{tuple(probs.shape)} {probs.dtype}")
    if kc.dtype != torch.int32 or tuple(kc.shape) != (probs.shape[0],):
        raise ValueError(f"kc must be [{probs.shape[0]}] int32, got "
                         f"{tuple(kc.shape)} {kc.dtype}")
    if not kc.is_contiguous():
        raise ValueError("kc must be contiguous")


def row_stride(probs: torch.Tensor):
    """The row stride (elements) with which tail_probs' kernel reads
    probs [B, D] as it lies, or None when it must be copied: the kernel
    reads row i at i * stride, D consecutive elements, so it takes unit
    stride along D and a row stride of at least D (a size-1 dimension's
    stride does not matter)."""
    B, D = probs.shape
    if D > 1 and probs.stride(1) != 1:
        return None
    if B == 1:
        return D
    return probs.stride(0) if probs.stride(0) >= D else None


def tail_probs(probs: torch.Tensor, kc: torch.Tensor) -> torch.Tensor:
    """log(max(P(X >= kc), 1e-37)) [B] f32 of probs [B, D] f32 in any
    order, any D >= 1 (p > 1.5 is pad and acts as the identity; other
    values are clipped to [0, 1]), kc [B] int32 in [1, KMAX].

    CPU tensors run the plain version (tail_torch).  CUDA tensors launch
    the kernel on the current stream (asynchronously) or raise.  The
    kernel reads probs as [B, D] rows with unit stride along D and any row
    stride of at least D (row_stride): the column step's contiguous probs,
    or a row-sliced view of them, go in as they are; any other layout is
    copied into a contiguous one, and the copy is counted
    (layout_copy_count)."""
    if probs.device.type == "cpu":
        return tail_torch(probs, kc)
    if probs.device.type != "cuda":
        raise ValueError(f"no tail kernel for device {probs.device}")
    _check_tail_args(probs, kc)
    from .._kernel_build import get_kernel_lib

    lib = get_kernel_lib()
    B, D = probs.shape
    out = torch.empty(B, dtype=torch.float32, device=probs.device)
    if B == 0:
        return out
    ld = row_stride(probs)
    if ld is None:
        probs = probs.contiguous()
        ld = D
        with _count_lock:
            _layout_copies[0] += 1
    err = lib.lfq_tail_probs_launch(
        probs.data_ptr(), ld, kc.data_ptr(), out.data_ptr(), B, D,
        probs.device.index,
        torch.cuda.current_stream(probs.device).cuda_stream)
    if err:
        raise RuntimeError("tail_probs kernel launch failed: "
                           + lib.lfq_cuda_error_string(err).decode())
    _count("tail_probs", probs.device.index)
    return out


def poissbin_tail(probs: torch.Tensor, valid: torch.Tensor,
                  ks: torch.Tensor) -> torch.Tensor:
    """probs [B, D] f32 (any order), valid [B, D] bool, ks [B] int.
    Returns the log tail [B] f32 at cell min(max(ks, 1), KMAX), the value
    of pallas_poissbin.poissbin_tail_pallas, through tail_probs."""
    return tail_probs(torch.where(valid, probs, 2.0).to(torch.float32),
                      ks.clamp(1, KMAX).to(torch.int32).contiguous())
