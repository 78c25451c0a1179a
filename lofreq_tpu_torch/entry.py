"""The forward step of the flagship device pipeline, with an example batch.

Counterpart of the single-chip `entry` of the repository's
__graft_entry__.py: the device column step (ops/device_call.py, quality
merge + filters + counts + screening DP) and an example batch.  The
multi-device dry run needs torch.distributed and is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import engine_device


def _example_batch(B=256, D=512, seed=0):
    """The example column batch: the same numpy draws as
    __graft_entry__._example_batch."""
    rng = np.random.default_rng(seed)
    ref_nt4 = rng.integers(0, 4, B).astype(np.int8)
    nt4 = rng.integers(0, 4, (B, D)).astype(np.int8)
    keep_ref = rng.random((B, D)) < 0.997
    nt4 = np.where(keep_ref, ref_nt4[:, None], nt4).astype(np.int8)
    bq = rng.integers(20, 41, (B, D)).astype(np.int16)
    baq = rng.integers(10, 60, (B, D)).astype(np.int16)
    mq = np.full((B, D), 60, dtype=np.int16)
    sq = np.full((B, D), -1, dtype=np.int16)
    valid = rng.random((B, D)) < 0.95
    bonf = np.full(B, 30000.0, dtype=np.float32)
    return nt4, bq, baq, mq, sq, valid, ref_nt4, bonf


def entry(device="cuda"):
    """(fn, args): the column step with device BAQ in the merge, and the
    example batch as tensors on `device`.  "cuda" runs the step's DP as
    kernel K1 and raises without a card; "cpu" runs its plain version,
    for tests."""
    from .ops.device_call import build_column_call

    dev = engine_device(device)
    fn = build_column_call(use_baq=True, device=device)
    args = tuple(torch.from_numpy(a).to(dev) for a in _example_batch())
    return fn, args
