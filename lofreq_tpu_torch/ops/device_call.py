"""The device column step: one function that takes per-base column tensors
and produces everything the host needs to emit variants, with only
screened candidate columns requiring exact host confirmation.

Counterpart of lofreq_tpu/ops/device_call.py.  Per column batch [B, D]
(D = padded depth):
  1. merge qualities  PJ = PM + (1-PM)PS + (1-PM)(1-PS)PBAQ + ...PB
  2. base filters (min_bq / min_alt_bq / min_jq) + alt counts (masked sums)
  3. linear-space screening DP over the full depth (filtered reads enter
     as p=0 = exact identity) -> candidate mask

Steps 1 and 2, the alt ids and the prefix selection are plain torch ops,
as the JAX package leaves them to XLA.  The DP is K1's f32 entry,
ops/cuda_poissbin.py:tail_probs: the kernel on a CUDA tensor, its plain
version (tail_torch) on a CPU tensor.  The reference's use_pallas switch
is gone: the device decides.

Multi-card: build_sharded_column_call splits the columns into contiguous
blocks over a list of devices (by default the cards this process drives,
parallel/distributed.py:local_mesh) and runs the step on each; the only
reduction is the tested-column count, summed over the blocks and
all-reduced over the torch.distributed process group, the reference's psum
(the global dynamic-Bonferroni reduction of the reference's parallel
wrapper, lofreq2_call_pparallel.py:131-161).
"""

from __future__ import annotations

import torch

from .. import defaults as D
from . import engine_device
from .cuda_poissbin import tail_probs
from .screen import KMAX, MARGIN

MQ0_ERRPROB = D.MQ0_ERRPROB


def merge_quals_f32(sq, mq, baq, bq):
    """f32 joint error prob; -1 = missing; MQ0 -> 0.5 (snpcaller.c:302)."""
    def q2p(q):
        return torch.where(q < 0, 0.0,
                           torch.pow(10.0, -q.to(torch.float32) / 10.0))

    sp = q2p(sq)
    mp = torch.where(mq == 0, MQ0_ERRPROB, q2p(mq))
    bap = q2p(baq)
    bp = q2p(bq)
    return (mp + (1 - mp) * sp + (1 - mp) * (1 - sp) * bap
            + (1 - mp) * (1 - sp) * (1 - bap) * bp)


def alt_ids(ref_nt4):
    """[B, 3] int64: each column's non-ref ACGT ids in ACGT order ([0, 1, 2]
    for an N reference), the stable argsort of the reference."""
    base_ids = torch.arange(4, device=ref_nt4.device)[None, :]
    alt_sel = base_ids != ref_nt4[:, None]  # [B, 4], 3 True per row
    return torch.argsort((~alt_sel).to(torch.uint8), dim=1,
                         stable=True)[:, :3]


def log_threshold(sig, bonf_base):
    """The screen's f32 log threshold log(sig * MARGIN) - log(max(bonf, 1)).
    The running bonf can only grow, so bonf_base makes it an upper bound
    (a conservative screen)."""
    return (torch.log(torch.tensor(sig * MARGIN, dtype=torch.float32))
            .to(bonf_base.device)
            - torch.log(torch.clamp_min(bonf_base.to(torch.float32), 1.0)))


def screen_outputs(alt_nt, alt_counts, alt_raw, depths, ref_nt4, tail_val,
                   sig, bonf_base):
    """The step's output dict from the alt ids [B, 3], the kept-alt and
    raw-alt counts of those ids [B, 3], depths [B] and the log tail [B]:
    the keys, dtypes and shapes of the JAX step."""
    ks = alt_counts.max(dim=1).values
    tested = (ref_nt4 != 4) & (depths >= 0) & (ks > 0)
    candidate = tested & ((tail_val < log_threshold(sig, bonf_base))
                          | (ks > KMAX))
    return dict(
        alt_counts=alt_counts.to(torch.int32),
        alt_raw=alt_raw.to(torch.int32),
        alt_nt=alt_nt.to(torch.int32),
        depths=depths.to(torch.int32), tested=tested, candidate=candidate,
        screen_tail=tail_val,
        num_tested=tested.sum().to(torch.int32),
    )


def check_inputs(dev: torch.device, tensors) -> None:
    """The step's tensors must lie on the device it was built for."""
    for t in tensors:
        if t.device.type != dev.type:
            raise ValueError(f"the column step was built for {dev.type}, "
                             f"got a tensor on {t.device}")


def build_column_call(min_bq=D.DEFAULT_MIN_BQ, min_alt_bq=D.DEFAULT_MIN_ALT_BQ,
                      min_jq=D.DEFAULT_MIN_JQ, min_alt_jq=D.DEFAULT_MIN_ALT_JQ,
                      min_cov=D.DEFAULT_MIN_COV, sig=D.DEFAULT_SIG,
                      use_baq=True, use_mq=True, use_sq=False,
                      s=None, kmax=KMAX, device="cuda"):
    """Returns fn(nt4, bq, baq, mq, sq, valid, ref_nt4, bonf_base) -> dict
    of per-column outputs, the JAX step's keys, dtypes and shapes.  The
    tensors lie on `device`: "cuda" runs the DP as kernel K1 and raises
    without a card, "cpu" runs its plain version, for tests.  The DP has
    KMAX + 1 cells, so kmax must be KMAX."""
    if kmax != KMAX:
        raise ValueError(f"the DP kernel has {KMAX} + 1 cells: kmax must be "
                         f"{KMAX}, got {kmax}")
    dev = engine_device(device)

    def column_call(nt4, bq, baq, mq, sq, valid, ref_nt4, bonf_base):
        check_inputs(dev, (nt4, bq, baq, mq, sq, valid, ref_nt4,
                           bonf_base))
        Dd = nt4.shape[1]
        not_n = valid & (nt4 != 4)
        is_alt = not_n & (nt4 != ref_nt4[:, None])

        keep = not_n & (bq >= min_bq) & (~is_alt | (bq >= min_alt_bq))
        mq_eff = torch.where((mq == 255) | (not use_mq), -1, mq)
        baq_eff = baq if use_baq else torch.full_like(baq, -1)
        sq_eff = sq if use_sq else torch.full_like(sq, -1)
        merged = merge_quals_f32(sq_eff, mq_eff, baq_eff, bq)
        if min_jq > 0 or min_alt_jq > 0:
            mq_phred = -10.0 * torch.log10(torch.clamp_min(merged, 1e-30))
            keep &= mq_phred >= min_jq
            keep &= ~is_alt | (mq_phred >= min_alt_jq)

        # per-base counts via masked sums over [B, D], one per ACGT id,
        # never a one-hot [B, D, 5] tensor
        kept_alt = keep & is_alt
        alt_raw4 = torch.stack(
            [((nt4 == b) & is_alt).sum(1) for b in range(4)], dim=1)
        alt_cnt4 = torch.stack(
            [((nt4 == b) & kept_alt).sum(1) for b in range(4)], dim=1)
        depths = keep.sum(1)
        alt_nt = alt_ids(ref_nt4)
        alt_counts = torch.gather(alt_cnt4, 1, alt_nt)
        alt_raw = torch.gather(alt_raw4, 1, alt_nt)

        # the tail is permutation invariant: the DP streams the unsorted
        # masked probs; a filtered read is p = 0, the exact identity
        masked = torch.where(keep, merged, 0.0).to(torch.float32)
        if s is None or s >= Dd:
            prefix = masked
        else:
            # prefix mode: DP over only the s smallest nonzero probs (the
            # 2.0 sentinel keeps zeros out of the bottom-s, then maps back
            # to the p=0 identity)
            neg_top = torch.topk(-torch.where(masked > 0.0, masked, 2.0),
                                 s, dim=1).values
            prefix = torch.where(-neg_top > 1.5, 0.0, -neg_top)
        prefix = torch.clamp(prefix, 0.0, 1.0)
        kc = alt_counts.max(dim=1).values.clamp(1, KMAX).to(torch.int32)
        tail_val = tail_probs(prefix, kc)
        return screen_outputs(alt_nt, alt_counts, alt_raw, depths, ref_nt4,
                              tail_val, sig, bonf_base)

    return column_call


STEP_KEYS = ("alt_counts", "alt_raw", "alt_nt", "depths", "tested",
             "candidate", "screen_tail")


def build_sharded_column_call(devices=None, **kw):
    """(fn, devices): the column step with its columns split into
    contiguous blocks over `devices` (default: local_mesh("cuda"), the
    cards this process drives; one device may be listed more than once).
    fn takes the step's tensors, on any one device, copies each block to
    its device, issues every block's step before waiting for any, and
    returns the step's dict on the inputs' device with the per-column
    outputs in column order.  num_tested is the blocks' sum, all-reduced
    over the process group when one of several ranks is initialised.  A
    pad column (no valid read) is never tested, so padding changes no
    output of the real columns.  kw as build_column_call, which builds
    each device's step (and raises for a card on a host without one)."""
    import torch.distributed as dist

    from ..parallel.distributed import column_blocks, local_mesh, world

    devices = [torch.device(d) for d in
               (local_mesh("cuda") if devices is None else devices)]
    if not devices:
        raise ValueError("build_sharded_column_call needs a device")
    steps = {d: build_column_call(device=d, **kw) for d in set(devices)}

    def sharded(*args):
        out_dev = args[0].device
        blocks = [tuple(a[lo:hi].to(d) for a in args) for d, (lo, hi) in
                  zip(devices, column_blocks(args[0].shape[0],
                                             len(devices)))]
        outs = [steps[d](*blk) for d, blk in zip(devices, blocks)]
        out = {k: torch.cat([o[k].to(out_dev) for o in outs])
               for k in STEP_KEYS}
        num_tested = sum(o["num_tested"].to(out_dev) for o in outs)
        if world()[1] > 1:
            dist.all_reduce(num_tested)
        out["num_tested"] = num_tested.to(torch.int32)
        return out

    return sharded, devices
