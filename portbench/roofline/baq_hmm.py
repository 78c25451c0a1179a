"""Bytes and operations of the device BAQ's kernel function, K3 + K4
(`baq_fwd_kernel`, `baq_bwd_kernel`, lofreq_tpu_torch/ops/cuda_baq.py),
one batch of reads at a time.

Counted at the function's own inputs and outputs: window codes [B, Lr]
u8, read codes [B, L] u8, error probabilities [B, L] f32 and window
lengths [B] int32 in; MAP phred q and state [B, L] int32 out.  The band
rows that K3 writes and K4 reads back are left out: they are the
implementation's, so a fused kernel is held to the same bound.  f32
operations per band cell (2 bw + 1 = 15 per row): 32 forward, 48
backward and MAP.
"""

#: hooked in a traced run: the name the device-BAQ runner calls
HOOK = ("lofreq_tpu_torch.ops.device_baq", "baq_hmm")
BAND = 15
OPS_PER_CELL = 32 + 48


def cost(refw, query, *_args, **_kw):
    """(bytes, f32 operations) of one batch: refw [B, Lr], query [B, L]."""
    B, Lr = refw.shape
    L = query.shape[1]
    nbytes = B * (Lr + L + 4 * L + 4) + 2 * B * L * 4
    return float(nbytes), float(B * L * BAND * OPS_PER_CELL)


def launches():
    from lofreq_tpu_torch.ops import cuda_baq

    n = cuda_baq.launch_count()
    return {"baq_fwd_kernel": n["baq_fwd"], "baq_bwd_kernel": n["baq_bwd"]}


def reset():
    from lofreq_tpu_torch.ops import cuda_baq

    cuda_baq.reset_launch_count()
