"""Bytes and operations of the `call` screen's kernel function K1
(`screen_codes_kernel`, lofreq_tpu_torch/ops/cuda_poissbin.py), one
dispatch at a time.

The function reads u8 codes [B, S], int32 ks [B] and f32 log thresholds
[B], and writes an f32 log tail [B] and a bool mask [B].  Its f32
operations are those of the clipped-K Poisson-binomial DP: for each code
that is not padding, 3 kc + 1 in the step plus 2 for the decode, at the
column's tail cell kc = clamp(ks, 1, 16).
"""

import numpy as np

#: where the dispatch is hooked in a traced run: the port's screen issue,
#: which receives the host codes and ks of every dispatch
HOOK = ("lofreq_tpu_torch.ops.screen", "_issue")
KMAX = 16
CODE_PAD = 255


def cost(codes, ks, *_args, **_kw):
    """(bytes, f32 operations) of one dispatch of `codes` [B, S]."""
    codes = np.asarray(codes)
    B = codes.shape[0]
    kc = np.clip(np.asarray(ks, np.int64), 1, KMAX)
    steps = (codes != CODE_PAD).sum(1)
    return float(codes.size + B * (4 + 4 + 4 + 1)), \
        float((steps * (3 * kc + 3)).sum())


def launches():
    """{kernel: launches since the last reset}, the port's own count."""
    from lofreq_tpu_torch.ops import cuda_poissbin

    return {"screen_codes_kernel": cuda_poissbin.launch_count("screen_codes")}


def reset():
    from lofreq_tpu_torch.ops import cuda_poissbin

    cuda_poissbin.reset_launch_count()
