"""Device kernels on PyTorch: the Poisson-binomial screen (cuda_poissbin,
hand-written CUDA for Hopper) and its dispatch layer (screen); the BAQ
HMM (cuda_baq, hand-written CUDA; plain version baq_torch) and the
device-BAQ runner (device_baq); the device column step (device_call) and
its fused kernel (fused_call).  baq and baq_hmm are the host C BAQ of the
pure-Python pileup path.  Exact confirmation happens on the host
(lofreq_tpu_torch.core / lofreq_tpu_torch.native)."""

from __future__ import annotations

import torch


def engine_device(device="cuda") -> torch.device:
    """The torch device of a device engine.  "cuda" launches the
    hand-written kernels; "cpu" runs their plain PyTorch versions and is
    meant for tests.  Nothing falls back from one to the other: "cuda" on
    a host without a card raises."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no device engine for {dev}: use cuda or cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card: the device engines need one.  Pass --device cpu "
            "(device=\"cpu\") to run their plain PyTorch versions on the "
            "CPU, for tests.")
    return dev
