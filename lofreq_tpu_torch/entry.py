"""The forward step of the flagship device pipeline, with an example batch,
and the multi-device dry run.

Counterpart of the repository's __graft_entry__.py: `entry` is the device
column step (ops/device_call.py, quality merge + filters + counts +
screening DP) and an example batch; `dryrun_multichip` runs the sharded
step and the split screen on n devices against the unsharded ones
(`dryrun_checks`, which takes any device list).
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


def _padded(args, B0: int, Bp: int):
    """The batch `args` (nt4, bq, baq, mq, sq, valid, ref_nt4, bonf) of B0
    columns padded to Bp with pad columns: zeros (no valid read), bonf 1."""
    out = []
    for a, fill in zip(args, (0,) * 7 + (1.0,)):
        p = np.full((Bp,) + a.shape[1:], fill, dtype=a.dtype)
        p[:B0] = a
        out.append(p)
    return tuple(out)


def dryrun_checks(devices) -> None:
    """The dry run's checks of the sharded column step and the split
    screen over `devices` (a list of torch devices; one may repeat)
    against the unsharded step and screen on devices[0], as
    __graft_entry__.dryrun_multichip makes them.  Raises AssertionError on
    a difference.  Per-column outputs are compared exactly (the same
    kernel or plain version runs on the same rows), num_tested too; the
    padded batch's pad columns must be untested."""
    from .ops.cuda_poissbin import screen_codes
    from .ops.device_call import STEP_KEYS, build_column_call, \
        build_sharded_column_call
    from .ops.screen import TOP_S, screen_split

    devices = [torch.device(d) for d in devices]
    n = len(devices)
    dev = devices[0]
    fn, _ = build_sharded_column_call(devices, use_baq=True)
    serial = build_column_call(use_baq=True, device=dev)

    def run(args):
        ts = tuple(torch.from_numpy(a).to(dev) for a in args)
        return fn(*ts), serial(*ts)

    def same(out, ref, what, rows=None):
        for k in STEP_KEYS:
            got = out[k] if rows is None else out[k][:rows]
            if not torch.equal(got, ref[k]):
                raise AssertionError(f"{what}: sharded {k} differs")
        if int(out["num_tested"]) != int(ref["num_tested"]):
            raise AssertionError(f"{what}: num_tested {int(out['num_tested'])}"
                                 f" != {int(ref['num_tested'])}")

    total = 0
    for step in range(3):  # multi-batch: exercises steady-state reuse
        # step 0 runs ONE production-shaped batch (the call pipeline's
        # 4096-column chunks at real padded depth); later steps stay small
        B, D = (4096, 512) if step == 0 else (16 * n, 128)
        out, ref = run(_example_batch(B=B, D=D, seed=step))
        if tuple(out["alt_counts"].shape) != (B, 3):
            raise AssertionError(f"step {step}: alt_counts "
                                 f"{tuple(out['alt_counts'].shape)}")
        same(out, ref, f"step {step} [{B}, {D}]")
        total += int(out["num_tested"])
    if total <= 0:
        raise AssertionError("the dry run tested no column")

    # non-divisible B, padded as production pads batches: the pad columns
    # are inert, so the padded sharded run equals the serial run on the
    # real prefix and counts no pad column as tested
    B0 = 16 * n + 7
    args0 = _example_batch(B=B0, D=96, seed=11)
    Bp = B0 + (-B0) % n
    ts0 = tuple(torch.from_numpy(a).to(dev) for a in args0)
    out = fn(*(torch.from_numpy(a).to(dev) for a in _padded(args0, B0, Bp)))
    same(out, serial(*ts0), f"padded [{B0} -> {Bp}, 96]", rows=B0)
    if out["tested"][B0:].any():
        raise AssertionError("a pad column was tested")

    # indel-mode-shaped batch: heavy N / deletion-marker rows (nt4 == 4)
    # and clustered validity, excluded identically under sharding
    rng = np.random.default_rng(23)
    B1, D1 = 32 * n, 160
    nt4, bq, baq, mq, sq, valid, ref_nt4, bonf = _example_batch(
        B=B1, D=D1, seed=12)
    nt4 = np.where(rng.random((B1, D1)) < 0.3, 4, nt4).astype(np.int8)
    valid = valid & (rng.random((B1, D1)) < 0.8)
    out, ref = run((nt4, bq, baq, mq, sq, valid, ref_nt4, bonf))
    same(out, ref, f"indel-shaped [{B1}, {D1}]")

    # the production device path, the u8-code screen, split over the same
    # devices against one launch on devices[0]
    Bs = 128 * n
    codes = rng.integers(0, 256, (Bs, TOP_S)).astype(np.uint8)
    ks = rng.integers(1, 20, Bs).astype(np.int32)
    lt = rng.uniform(-40, -1, Bs).astype(np.float32)
    split = screen_split(codes, ks, lt, devices)
    whole = screen_codes(*(torch.from_numpy(a).to(dev)
                           for a in (codes, ks, lt)))[1]
    if not torch.equal(split, whole):
        raise AssertionError("the split screen's mask differs")


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The sharded column step and the split screen on n devices against
    the unsharded ones (dryrun_checks).  "cuda" takes the first n cards
    and raises if there are fewer; "cpu" runs n CPU shards, the
    counterpart of the reference's virtual CPU mesh."""
    dev = engine_device(device)
    if dev.type == "cpu":
        devices = [dev] * n_devices
    else:
        have = torch.cuda.device_count()
        if have < n_devices:
            raise RuntimeError(f"dryrun_multichip needs {n_devices} cards "
                               f"but this host has {have}")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    dryrun_checks(devices)
