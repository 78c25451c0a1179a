#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lofreq_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero before the result:
1. the card: torch.cuda must be available; its name and power limit;
2. build: the CUDA kernels are compiled from lofreq_tpu_torch/csrc with
   nvcc (sm_90a) into lofreq_tpu_torch/csrc/build/; each kernel's
   registers and spills, and no spill in K1's two kernels, K2 and K4;
3. kernel vs plain: the screen kernel (K1) against its plain PyTorch
   version on the card, at [4096, 128], at a ragged [292, 128] and at
   [48, 16], and against its split body (T = 8) built by g++ on this host
   (lofreq_tpu_torch/testing/cuh_shims.py), launched twice: the two
   launches identical bit for bit;
4. main path: the port's `call` (run_call, device screen on the card) on
   the bench workload (simulated 200 kb at 800x, seed 3).  The first run
   is the counted one: it must launch the kernel.  Every run must give
   the records and test count of the port's host-screen path (the f64
   host DP, which K1 does not touch).  After it, WALL_PAIRS pairs of the
   two are timed in turns (host, device, device, host, ...), with the
   median stage breakdown of each;
5. device profile: one profiled main-path call, its device time by
   kernel and the card's busy share (torch.profiler);
6. timings at the main path's mean dispatch shape and at [4096, 128]:
   K1's device time per launch (profiler), the wrapper's throughput per
   call (CUDA events), and the plain version's time per call (CUDA
   events, median of timing windows);
7. BAQ kernels vs plain: K3 alone against the plain forward pass (band
   rows and row scales) and K3 + K4 against the plain HMM (q, st), at
   the runner's batch of 32768 reads x L = 100 and at a ragged 1000 x 75;
   and K3 + K4 against the kernels' body built by g++ on this host
   (lofreq_tpu_torch/testing/cuh_shims.py), q and st bit for bit, on the
   ragged batch and on the runner batch's first 4096 reads;
8. device-BAQ path: the port's `call --device-baq` (run_call with
   use_device_baq, K3/K4 in the runner, K1 in the sub-screen) on the same
   workload.  The counted run must launch K1, K3 and K4, and its runner
   must have taken every eligible read that lfq_extract_reads flagged;
   every run must give the host-screen path's records and test count.
   Then BAQ_PAIRS pairs of walls in turns against the host path, with
   median stages, and one profiled call;
9. timings at the runner's batch shape: K3's and K4's device time per
   launch (profiler) and the plain HMM's time per call (CUDA events);
10. column step: the device column step of lofreq_tpu_torch.entry (the
   quality merge, filters and counts as torch ops, the DP as K1's f32
   entry) and the fused column step (kernel K2).  The counted run drives
   entry(device="cuda")'s function on its example batch and both steps
   on the deployment batch of tools/device_step_bench.py (65,536 columns
   x 2,016 reads, seed 3); it must launch K1's f32 entry and K2.  Then, on
   that batch, on a batch of the same shape whose tails spread over
   [-80, -1] with candidates on both sides of the threshold (spread_batch,
   its reach checked), and on a ragged 1,000 x 75 one: K2 against its
   plain version, each step against its plain version (the DP's plain
   version in place of K1), the fused step against the unfused one, and
   K1's f32 entry, on the DP inputs the unfused step gives it, against its
   body built by g++ (lfq_tail_column), within 2 f32 ulps per tail; the
   unfused step must make no layout copy of its DP input; on the spread
   batch K2 is launched twice and must repeat bit for bit;
11. timings at the deployment shape: K2's and K1's f32 entry's device
   time per launch (profiler), K1's on the step's own [B, D] probs, both
   steps' columns/s (CUDA events) and the plain versions' time per call;
   and, for the record, a copy of the DP input into [D, B] (CUDA events),
   which the f32 entry's first design made on every call;
12. device Viterbi: viterbi_batch (ops/viterbi_torch.py, torch ops on the
   card) on the 109 cases of tests/golden/viterbi.json, one per batch, and
   on a batch of 4,096 reads of 100 bp with 1-5 bp indels planted (seed
   3) against 120 bp windows: at least 95% of paths identical to the C
   realigner (viterbi_align) on each, the card's paths against the same
   call on the CPU (the count that differ), three runs of the batch
   identical; the batch's time (CUDA events) beside the C realigner's for
   the same reads, one by one and in its 8-lane groups;
13. call-parallel on the card: the port's CLI `call-parallel --pp-threads
   2` on phase 4's workload from this process, which holds a CUDA
   context: its workers start by spawn and launch K1, their summed SNV
   tests are phase 4's, and its VCF is the one phase 4's records and
   tests give through the same final filter; then the same with the host
   engine (forked workers, no dispatch); walls beside phase 4's median
   and each worker's start-up;
14. somatic on the card: the port's CLI `somatic --threads 2` on a
   tumor/normal pair of the port's simulator (one genome, two read
   seeds, SNVs planted in the tumor only): its workers launch K1, and
   every stage file equals the same command's with
   LOFREQ_TPU_DEVICE_SCREEN=0 (the host engine) but for ##fileDate;
15. call-distributed on the card: the port's CLI `call-distributed` with
   two ranks, each a subprocess (through
   lofreq_tpu_torch.testing.rank_harness, which records its
   run_distributed_call dict) with its own CUDA context on this host's
   card, joined over Gloo, on phase 4's workload: each rank launches K1,
   the all-reduced SNV tests are phase 4's, and the VCF is the one phase
   4's records and tests give through the same final filter; the wall
   beside phase 4's median, and each rank's start-up.  Each rank has a
   wall-clock limit and a process-group timeout; on a failure every rank
   is killed;
16. sharded column step and split screen: entry.dryrun_checks on two
   shards of one card, [cuda:0, cuda:0] (the dry run's batches, the
   sharded step against the unsharded one); the sharded step on the
   deployment and spread batches of phase 10 against the unsharded step,
   every output identical, tails bit for bit, one K1-f32 launch per
   shard; the production screen's dispatch split over the two shards
   against the same dispatch unsplit, masks identical.  Where the host
   has two cards or more, the NCCL forms too (nccl_phase:
   dryrun_multichip(2), the sharded step over two NCCL ranks, `call` with
   the screen split over the cards, call-distributed with NCCL);
   otherwise one line says they were not run.
Then a JSON line of the kernels (each with its bound: the bytes it must
move over the card's memory rate or its f32 operations over the card's
f32 rate, whichever is longer), the card line, and as the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import io
import json
import os
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch
from torch.autograd import DeviceType

REPO = os.path.dirname(os.path.abspath(__file__))
GENOME, DEPTH, SEED = 200_000, 800, 3   # bench.py's workload
TAIL_TOL = 1e-4   # |log tail| abs; f32 DP: exp2f/logf ulps + FMA vs mul-add
# K1 against its g++ bodies: the split screen at T = 8 takes the same
# slices, steps and merge tree, and differs by CUDA's exp2f and logf
# against libm's; the f32 entry runs lfq_tail_column's operations in its
# order, so its linear tails are the same bits and only logf differs
SCREEN_HOST_TOL = 1e-5
TAIL_ULPS = 2
SCREEN_SPLIT = 8
# kernels the build fails on a spill of
NO_SPILL = ("screen_codes_kernel", "tail_probs_kernel", "baq_bwd_kernel",
            "fused_call_kernel")
WALL_PAIRS = 8
BAQ_PAIRS = 4
KERNEL_REPS = 500          # launches per profiled / timed kernel window
PLAIN_WINDOWS, PLAIN_REPS = 5, 3
KERNEL_NAME = "screen_codes_kernel"
# BAQ HMM: the runner's batch (TILE_B reads of the workload's 100 bp reads,
# windows of L + 6) and a ragged one; tolerances as tests/test_torch_baq.py
BAQ_SHAPES = ((32768, 100, 106), (1000, 75, 81))
BAQ_ROW_TOL = 1e-5     # |K3 row - plain| abs (rows in [0, 1]), and rel scale
BAQ_SHARE = 0.999      # identical q and st; |dq| <= 1 everywhere
BAQ_REPS, BAQ_PLAIN_WINDOWS = 20, 3
HOST_READS = 4096      # reads of a BAQ batch held against the g++ body
BAQ_KERNELS = {"baq_fwd": "baq_fwd_kernel", "baq_bwd": "baq_bwd_kernel"}
# the device column step: tools/device_step_bench.py's deployment batch
# (D = 2,000 padded to 2,016) and a ragged one, both drawn from seed 3,
# and at the deployment shape a batch whose tails spread (spread_batch)
STEP_SHAPES = ((65536, 2016), (1000, 75))
STEP_SEED = 3
STEP_TAIL_FLOOR = -80.0  # below it a tail is lost in f32 underflow
STEP_FUSED_ATOL, STEP_FUSED_RTOL = 1e-2, 1e-3  # exp vs pow decode, 18 cells
# launches per profiled K2 / K1-f32 window: the profiler dropped 2 of 20
# K1-f32 launches on an H100, and 1% of a window may go unseen
STEP_REPS = 300
STEP_ITERS = 5           # whole-step calls per CUDA-event window
STEP_PLAIN_WINDOWS = 3
# the card's published rates (H100 SXM, NVIDIA's data sheet) for bounds
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations, counted from the kernel bodies.  K1 per read at tail
# cell kc: 3 kc + 1 in the DP step (csrc/poissbin_screen.cuh lfq_step)
# plus 2, for the decode (screen_codes) or the clip (tail_probs).  K2 per
# kept read: 52 in the 18-cell step, 2 for the clip, 11 for the merge and
# 2 per decoded field (csrc/fused_call.cuh lfq_fc_base).  K3 and K4 per
# band cell and row (csrc/baq_hmm.cuh lfq_baq_forward, lfq_baq_backward
# with lfq_baq_map; chain and butterfly steps included).
K2_OPS_PER_KEPT = 52 + 2 + 11
BAQ_FWD_OPS_PER_CELL, BAQ_BWD_OPS_PER_CELL = 32, 48
BAQ_BAND = 15            # non-zero cells of a band row (2 bw + 1)
# the device Viterbi: the realigner's goldens, and a batch of the size the
# `viterbi` subcommand flushes at (ops/viterbi.py run_viterbi, 1,024
# reads), four times over: reads of 100 bp against windows of the read
# plus RWIN = 10 bases on each side
VITERBI_GOLDEN = os.path.join(REPO, "tests", "golden", "viterbi.json")
VIT_READS, VIT_L, VIT_LR, VIT_RWIN = 4096, 100, 120, 10
VIT_SHARE = 0.95         # path-identical to C: tests/test_viterbi_jax.py's bar
VIT_RUNS = 3
# somatic: a tumor/normal pair of one genome (seed SEED), reads from two
# seeds, SNVs planted in the tumor only
SOMATIC_GENOME, SOMATIC_DEPTH = 50_000, 300
SOMATIC_SEEDS = {"normal": 11, "tumor": 12}
SOMATIC_SNVS = ((0.1, 10), (0.3, 10))
# call-distributed: two ranks, each a process with its own CUDA context on
# this host's card (over Gloo) or on a card of its own (NCCL, two cards
# or more), each within a wall-clock limit and a process-group timeout
DIST_RANKS = 2
DIST_RANK_S = 300
DIST_TIMEOUT_S = 240
# phase 16's screen split, and the NCCL form's batch and workload
SPLIT_B, SPLIT_SIG = 4096, 0.01
NCCL_BATCH = (8192, 512)
NCCL_GENOME = 50_000


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def register_use(log: str) -> dict:
    """{kernel: its registers and spills} from nvcc's ptxas -v log."""
    use, name = {}, None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            m = re.search(r"\d([a-z_]+_kernel)E", ln)
            name = m.group(1) if m else ln.split()[-1]
        elif name and ("registers" in ln or "spill" in ln):
            use.setdefault(name, []).append(ln.split(":", 1)[-1].strip())
    return {k: ", ".join(v) for k, v in use.items()}


def spill_bytes(use: str) -> int:
    """Spill stores plus spill loads, bytes, of a register_use entry."""
    found = re.findall(r"(\d+) bytes spill (?:stores|loads)", use)
    return sum(int(n) for n in found)


def check_no_spill(use: dict) -> None:
    """Every NO_SPILL kernel is in the build log and spills nothing."""
    for name in NO_SPILL:
        check(name in use and spill_bytes(use[name]) == 0,
              f"{name} spills or is missing from the build log: "
              f"{use.get(name)}")


def ulps(a, b) -> np.ndarray:
    """|a - b| in f32 ulps: the distance between the ordered bit patterns
    of two float32 arrays."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def events_ms(fn, reps: int) -> float:
    """Elapsed card time per fn() over reps back-to-back calls (CUDA
    events); for a short kernel this is the host's issue rate."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_profile(fn):
    """(fn's result, wall s, {kernel or copy: (count, device µs)}) of one
    profiled call.  Only the device's own events are kept: a host op's
    device time repeats that of the kernels it launched."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CPU and e.device_time_total > 0:
            dev[e.key] = (e.count, e.device_time_total)
    return out, wall, dev


def report_profile(name: str, prof_wall: float, dev: dict) -> None:
    total_us = sum(us for _, us in dev.values())
    say("profile", f"{name}: wall {prof_wall:.4f} s, device "
        f"time {total_us:.1f} us, busy share "
        f"{total_us / 1e6 / prof_wall:.6f}; " + "; ".join(
            f"{k[:60]} n={n} {us:.1f} us" for k, (n, us) in
            sorted(dev.items(), key=lambda kv: -kv[1][1])[:8]))


def kernel_us(dev: dict, name: str = KERNEL_NAME):
    """(launches, device µs) of a kernel in a profile, or None if absent."""
    hits = [v for k, v in dev.items() if name in k]
    if not hits:
        return None
    return sum(n for n, _ in hits), sum(us for _, us in hits)


def per_launch_ms(dev: dict, name: str, reps: int) -> float:
    """Device ms per launch of `name` over a profiled window of `reps`
    launches.  The profiler drops records of a window (on H100s it saw
    499 and 444 of 500 K1 launches, 296 of 300 K1-f32 launches, 19 of 20
    K3 launches), so the mean is over the launches it saw, and up to half
    of them may be missing; more than `reps` means other launches."""
    hit = kernel_us(dev, name)
    check(hit is not None and reps / 2 <= hit[0] <= reps,
          f"profile saw {hit} launches of {name}, want {reps}")
    return hit[1] / hit[0] / 1e3


def bound(nbytes: float, ops: float):
    """(bound ms, "bytes" or "operations"): the least time for a function
    that moves nbytes (each input read once, each output written once) and
    does ops f32 operations, at the card's published rates."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dp_ops(reads: torch.Tensor, kc: torch.Tensor) -> float:
    """K1's f32 operations for `reads` [B] DP steps per column at tail
    cells kc [B] (3 kc + 3 per read)."""
    return float((reads.double() * (3 * kc.double() + 3)).sum())


def screen_inputs(rng, B: int, S: int = 128):
    """Seeded codes [B, S] (30% padding), ks 1..24, log_thresh."""
    codes = rng.integers(16, 160, (B, S)).astype(np.uint8)
    codes[rng.random((B, S)) < 0.3] = 255
    ks = rng.integers(1, 25, B).astype(np.int32)
    lt = rng.uniform(-40.0, -1.0, B).astype(np.float32)
    return [torch.from_numpy(a).cuda() for a in (codes, ks, lt)]


def screen_vs_host(cp, host, codes, ks, lt, what: str) -> float:
    """screen_codes launched twice, the launches identical bit for bit,
    against the split column at T = SCREEN_SPLIT built by g++ (`host`, the
    shim of cuh_shims.build_screen_shim): log tails within
    SCREEN_HOST_TOL, masks equal except within it of the threshold.
    Returns the max |tail difference|."""
    from lofreq_tpu_torch.testing import cuh_shims

    t1, m1 = cp.screen_codes(codes, ks, lt)
    t2, m2 = cp.screen_codes(codes, ks, lt)
    torch.cuda.synchronize()
    check(torch.equal(t1, t2) and torch.equal(m1, m2),
          f"{what}: two screen_codes launches differ")
    c, k, lt_h = (x.cpu().numpy() for x in (codes, ks, lt))
    want, want_mask = cuh_shims.screen_columns(host, c, k, lt_h,
                                               SCREEN_SPLIT)
    tail = t1.cpu().numpy()
    check(tail.shape == want.shape and np.isfinite(tail).all(),
          f"{what}: tail shape {tail.shape} or non-finite")
    err = float(np.abs(tail - want).max(initial=0.0))
    check(err <= SCREEN_HOST_TOL, f"{what}: |tail - g++ split body| {err} "
          f"> {SCREEN_HOST_TOL}")
    near = np.abs(want - lt_h) <= SCREEN_HOST_TOL
    diff = m1.cpu().numpy() != want_mask
    check(not (diff & ~near).any(), f"{what}: {int((diff & ~near).sum())} "
          "masks differ from the g++ split body off the threshold")
    say("kernel", f"{what}: two launches identical; max |dtail| {err:.3g} "
        f"against the g++ split body (T = {SCREEN_SPLIT})")
    return err


def kernel_vs_plain(cp, rng, B: int, S: int, host) -> float:
    """K1 against its g++ split body (screen_vs_host) and its plain
    version at [B, S].  Returns the max |tail - plain|."""
    codes, ks, lt = screen_inputs(rng, B, S)
    screen_vs_host(cp, host, codes, ks, lt, f"B={B} S={S}")
    tail_k, mask_k = cp.screen_codes(codes, ks, lt)
    tail_p, mask_p = cp.screen_codes_torch(codes, ks, lt)
    torch.cuda.synchronize()
    tk, tp = tail_k.cpu().numpy(), tail_p.cpu().numpy()
    check(tk.shape == (B,) and np.isfinite(tk).all(),
          f"kernel tail at B={B}: shape {tk.shape} or non-finite")
    floor = np.log(np.float32(cp.TAIL_FLOOR))
    above = tp > floor
    err = float(np.abs(tk - tp)[above].max()) if above.any() else 0.0
    check(err <= TAIL_TOL, f"B={B}: |tail - plain| {err} > {TAIL_TOL}")
    near = np.abs(tp - lt.cpu().numpy()) <= TAIL_TOL
    diff = mask_k.cpu().numpy() != mask_p.cpu().numpy()
    check(not (diff & ~near).any(),
          f"B={B}: {int((diff & ~near).sum())} masks differ off the "
          "threshold")
    say("kernel", f"B={B} S={S}: max |dtail| {err:.3g} over {int(above.sum())} "
        f"rows above the floor; {int(near.sum())} rows within {TAIL_TOL} "
        f"of the threshold ({int(diff.sum())} of them differ); "
        f"{int(mask_k.sum())} candidates")
    return err


def time_shape(cp, rng, B: int):
    """(K1 ms per launch, plain ms per call, (bound ms, bound by)) at
    [B, 128]."""
    codes, ks, lt = screen_inputs(rng, B)
    # codes, ks and log_thresh in; log tail and mask out.  The DP steps
    # are the non-pad codes (a pad is the identity)
    nbytes = codes.numel() + B * (4 + 4 + 4 + 1)
    lim = bound(nbytes, dp_ops((codes != cp.CODE_PAD).sum(1),
                               ks.clamp(1, cp.KMAX)))

    def kernel():
        return cp.screen_codes(codes, ks, lt)

    def plain():
        return cp.screen_codes_torch(codes, ks, lt)

    wrapper_ms = events_ms(kernel, KERNEL_REPS)

    def loop():
        for _ in range(KERNEL_REPS):
            kernel()

    _, _, dev = device_profile(loop)
    plain_ms = statistics.median(events_ms(plain, PLAIN_REPS)
                                 for _ in range(PLAIN_WINDOWS))
    ms = per_launch_ms(dev, KERNEL_NAME, KERNEL_REPS)
    how = f"device time per launch (profiler, {kernel_us(dev)[0]} seen)"
    say("timing", f"B={B} x 128: kernel {ms:.6f} ms {how}; wrapper "
        f"throughput {wrapper_ms:.6f} ms per call (CUDA events, "
        f"{KERNEL_REPS} calls); plain torch {plain_ms:.6f} ms per call "
        f"(CUDA events, median of {PLAIN_WINDOWS} windows of {PLAIN_REPS}); "
        f"bound {lim[0]:.9f} ms by {lim[1]}")
    return ms, plain_ms, lim


def baq_inputs(bt, rng, B: int, L: int, Lr: int):
    """Seeded BAQ batch on the card, shaped as the runner builds it:
    window codes (1% N), reads copied from lane 3 of their window with 2%
    errors, quals 2..41 through the q2p table, l_ref = Lr except 5% of
    reads with shorter windows."""
    refw = rng.integers(0, 4, (B, Lr)).astype(np.uint8)
    refw[rng.random((B, Lr)) < 0.01] = 4
    query = refw[:, 3:3 + L].copy()
    err = rng.random((B, L)) < 0.02
    query[err] = rng.integers(0, 4, int(err.sum()))
    qualp = bt._Q2P[rng.integers(2, 42, (B, L))]
    l_ref = np.full(B, Lr, np.int32)
    short = rng.random(B) < 0.05
    l_ref[short] = rng.integers(L + 3, Lr + 1, int(short.sum()))
    return [torch.from_numpy(np.ascontiguousarray(a)).cuda()
            for a in (refw, query, qualp, l_ref)]


def baq_vs_plain(ca, bt, rng, B: int, L: int, Lr: int, host=None):
    """K3 alone vs the plain forward pass, then K3 + K4 vs the plain HMM,
    at [B, L] with windows of Lr, and, given `host` (the g++ shim of
    cuh_shims.build_baq_shim), K3 + K4 vs the kernels' host-built body on
    the first HOST_READS reads, bit for bit.  Returns (K3 max |row diff|,
    K4 max |dq|)."""
    ins = baq_inputs(bt, rng, B, L, Lr)
    c0 = ca.launch_count()
    fm, fi, fs = ca.baq_forward(*ins)
    q, st = ca.baq_hmm(*ins)
    torch.cuda.synchronize()
    c1 = ca.launch_count()
    n = {k: c1[k] - c0[k] for k in c1}
    check(n == {"baq_fwd": 2, "baq_bwd": 1},
          f"BAQ B={B}: launches {n}, want 2 K3 and 1 K4")
    pm, pi, ps = bt.forward_band_torch(*ins)
    row_err = max((fm - pm).abs().max().item(),
                  (fi - pi).abs().max().item())
    scale_err = (fs / ps - 1).abs().max().item()
    check(row_err <= BAQ_ROW_TOL and scale_err <= BAQ_ROW_TOL,
          f"BAQ B={B}: K3 rows {row_err} or scales {scale_err} > "
          f"{BAQ_ROW_TOL}")
    qp, sp = bt.baq_hmm_torch(*ins)
    q, st, qp, sp = (t.cpu().numpy() for t in (q, st, qp, sp))
    dq = int(np.abs(q.astype(np.int64) - qp).max())
    same_q, same_st = float((q == qp).mean()), float((st == sp).mean())
    check(q.shape == (B, L) and dq <= 1 and same_q >= BAQ_SHARE
          and same_st >= BAQ_SHARE,
          f"BAQ B={B} L={L}: max |dq| {dq}, identical q {same_q}, st "
          f"{same_st}")
    say("baq", f"B={B} L={L} Lr={Lr}: K3 max |drow| {row_err:.3g}, max "
        f"|ds/s| {scale_err:.3g}; K3+K4 max |dq| {dq}, identical q "
        f"{same_q:.6f}, st {same_st:.6f}; launches {n}")
    if host is not None:
        from lofreq_tpu_torch.testing import cuh_shims

        m = min(B, HOST_READS)
        q_h, st_h = cuh_shims.baq_grid(host, *(t[:m].cpu().numpy()
                                               for t in ins))
        bad_q, bad_st = int((q[:m] != q_h).sum()), int((st[:m] != st_h).sum())
        check(bad_q == 0 and bad_st == 0,
              f"BAQ B={B} L={L}: K3+K4 differ from the g++ body on {bad_q} q "
              f"and {bad_st} st of {m} reads")
        say("baq", f"B={B} L={L}: K3+K4 q and st identical to the g++ body "
            f"on the first {m} reads ({m * L} rows)")
    return row_err, float(dq)


def baq_bounds(B: int, L: int, Lr: int) -> dict:
    """{K3, K4: (bound ms, bound by)} at [B, L] with windows of Lr.  K3
    reads the window codes, read codes, error probs and l_ref and writes
    the M and I band rows and the row scales; K4 reads those and the same
    read inputs and writes q and st."""
    reads_in = B * (Lr + L + 4 * L + 4)
    rows = 2 * B * L * BAQ_BAND * 4 + B * L * 4
    cells = B * L * BAQ_BAND
    return {"baq_fwd": bound(reads_in + rows, cells * BAQ_FWD_OPS_PER_CELL),
            "baq_bwd": bound(reads_in + rows + 2 * B * L * 4,
                             cells * BAQ_BWD_OPS_PER_CELL)}


def time_baq(ca, bt, rng, B: int, L: int, Lr: int):
    """({K3, K4} device ms per launch, plain HMM ms per call) at [B, L]."""
    ins = baq_inputs(bt, rng, B, L, Lr)

    def loop():
        for _ in range(BAQ_REPS):
            ca.baq_hmm(*ins)

    loop()
    _, _, dev = device_profile(loop)
    ms = {key: per_launch_ms(dev, name, BAQ_REPS)
          for key, name in BAQ_KERNELS.items()}
    seen = [kernel_us(dev, name)[0] for name in BAQ_KERNELS.values()]
    plain_ms = statistics.median(
        events_ms(lambda: bt.baq_hmm_torch(*ins), 1)
        for _ in range(BAQ_PLAIN_WINDOWS))
    say("timing", f"BAQ [{B}, {L}] Lr={Lr}: K3 {ms['baq_fwd']:.6f} ms, K4 "
        f"{ms['baq_bwd']:.6f} ms device time per launch (profiler, "
        f"{seen} of {BAQ_REPS} launches seen); plain torch HMM {plain_ms:.6f} ms per call "
        f"(CUDA events, median of {BAQ_PLAIN_WINDOWS} calls)")
    return ms, plain_ms


def step_batch(B: int, Dd: int):
    """The column batch of tools/device_step_bench.py:make_batch, the same
    numpy draws, from STEP_SEED."""
    rng = np.random.default_rng(STEP_SEED)
    ref_nt4 = rng.integers(0, 4, B).astype(np.int8)
    nt4 = np.where(rng.random((B, Dd)) < 0.997, ref_nt4[:, None],
                   rng.integers(0, 4, (B, Dd))).astype(np.int8)
    bq = rng.integers(20, 41, (B, Dd)).astype(np.int16)
    baq = rng.integers(10, 60, (B, Dd)).astype(np.int16)
    mq = np.full((B, Dd), 60, dtype=np.int16)
    sq = np.full((B, Dd), -1, dtype=np.int16)
    valid = np.ones((B, Dd), dtype=bool)
    bonf = np.full(B, 30000.0, dtype=np.float32)
    return nt4, bq, baq, mq, sq, valid, ref_nt4, bonf


def spread_batch(B: int, Dd: int):
    """A column batch whose log tails spread over [-80, -1], from
    STEP_SEED + 1.  In step_batch's draws about 24 error reads are
    expected per column against a kc of about 3, so every tail is near 1
    and no column is a candidate.  Here each column has its own quality
    level (phred 20..47, so 0.05 to 30 expected errors at full depth), its
    own depth (a ragged edge of invalid rows from Dd / 4 to Dd), and 0..20
    planted reads of one alt base plus 0..3 of another, so that kc takes
    every value 1..16 and beyond and columns fall on both sides of the
    threshold.  It also has N rows, reads below min_bq, MQ0 and missing-MQ
    rows, and sq values that the step (use_sq off) must ignore."""
    rng = np.random.default_rng(STEP_SEED + 1)
    ref_nt4 = rng.integers(0, 4, B).astype(np.int8)
    level = rng.integers(20, 48, B).astype(np.int16)
    bq = level[:, None] + rng.integers(-3, 4, (B, Dd), dtype=np.int16)
    low = rng.random((B, Dd), dtype=np.float32) < 0.01
    bq[low] = rng.integers(0, 6, int(low.sum()), dtype=np.int16)
    baq = bq + rng.integers(0, 20, (B, Dd), dtype=np.int16)
    u = rng.random((B, Dd), dtype=np.float32)
    mq = np.where(u < 1e-4, 0, np.where(u < 0.02, 255, 60)).astype(np.int16)
    sq = rng.integers(20, 60, (B, Dd), dtype=np.int16)
    depth = rng.integers(Dd // 4, Dd + 1, B)
    valid = np.arange(Dd)[None, :] < depth[:, None]
    nt4 = np.repeat(ref_nt4[:, None], Dd, axis=1)
    nt4[rng.random((B, Dd), dtype=np.float32) < 0.002] = 4
    for top, most in ((21, 20), (4, 3)):   # the main alt, then a second
        alt = ((ref_nt4 + rng.integers(1, 4, B)) % 4).astype(np.int8)
        k = rng.integers(0, top, B)
        rows = rng.integers(0, depth[:, None], (B, most))
        cols = np.repeat(np.arange(B)[:, None], most, axis=1)
        plant = np.arange(most)[None, :] < k[:, None]
        nt4[cols[plant], rows[plant]] = alt[cols[plant]]
    bonf = np.full(B, 30000.0, dtype=np.float32)
    return nt4, bq, baq, mq, sq, valid, ref_nt4, bonf


def check_spread(dc, plain, bonf, what: str) -> None:
    """The spread batch reaches what the step's checks must see: most
    tested tails in [STEP_TAIL_FLOOR, -1], every kc 1..KMAX among them,
    columns past KMAX, and candidates and tested non-candidates with tails
    on both sides of the threshold."""
    from lofreq_tpu_torch.defaults import DEFAULT_SIG

    tested = plain["tested"].cpu().numpy()
    tail = plain["screen_tail"].cpu().numpy()
    ks = plain["alt_counts"].max(dim=1).values.cpu().numpy()
    lt = float(dc.log_threshold(DEFAULT_SIG, bonf)[0])
    spread = tested & (tail > STEP_TAIL_FLOOR) & (tail < -1.0)
    cand = plain["candidate"].cpu().numpy()
    kcs = set(np.unique(ks[spread]).tolist())
    check(spread.sum() >= tested.sum() // 2,
          f"{what}: {int(spread.sum())} of {int(tested.sum())} tested tails "
          f"in [{STEP_TAIL_FLOOR}, -1]")
    check(set(range(1, 17)) <= kcs, f"{what}: kc values {sorted(kcs)}")
    check((ks > 16).any() and (cand & (tail < lt)).any()
          and (tested & ~cand).any(),
          f"{what}: no column past KMAX, or no candidate below the "
          "threshold, or no tested non-candidate")
    say("step", f"{what}: {int(spread.sum())} of {int(tested.sum())} tested "
        f"tails in [{STEP_TAIL_FLOOR}, -1], kc 1..16 all present, "
        f"{int((ks > 16).sum())} columns past KMAX, {int(cand.sum())} "
        f"candidates, threshold {lt:.4f}")


def step_args(fc, batch):
    """(the unfused step's tensors, the fused step's tensors) on the card:
    the packed stream is packed on the host, as the fused step takes it."""
    nt4, bq, baq, mq, sq, valid, ref_nt4, bonf = batch
    packed = fc.pack_columns_np(nt4, bq, baq, mq, sq, valid)
    unfused = tuple(torch.from_numpy(a).cuda() for a in batch)
    fused = tuple(torch.from_numpy(a).cuda() for a in
                  (packed, ref_nt4.astype(np.int32), bonf))
    return unfused, fused


@contextlib.contextmanager
def step_dp(dc, dp):
    """The unfused column step with `dp` in place of K1's f32 entry: with
    cuda_poissbin.tail_torch it is the step's plain version on the same
    device; a wrapper of tail_probs sees the DP's inputs."""
    kernel = dc.tail_probs
    dc.tail_probs = dp
    try:
        yield
    finally:
        dc.tail_probs = kernel


def check_step(dc, got, want, bonf, what: str,
               fused_vs_unfused=False) -> float:
    """Integer outputs identical; tails within TAIL_TOL where the plain
    tail is above STEP_TAIL_FLOOR and masks identical except within
    TAIL_TOL of the threshold; fused vs unfused, tails within atol 1e-2,
    rtol 1e-3 where both are above the floor.  Returns the max |tail
    difference| compared."""
    for k in ("alt_counts", "alt_raw", "alt_nt", "depths", "tested",
              "num_tested"):
        check(got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]),
              f"{what}: {k} differs")
    t_g = got["screen_tail"].cpu().numpy()
    t_w = want["screen_tail"].cpu().numpy()
    check(np.isfinite(t_g).all(), f"{what}: non-finite tails")
    if fused_vs_unfused:
        m = (t_g > STEP_TAIL_FLOOR) & (t_w > STEP_TAIL_FLOOR)
        ok = np.allclose(t_g[m], t_w[m], atol=STEP_FUSED_ATOL,
                         rtol=STEP_FUSED_RTOL)
        err = float(np.abs(t_g - t_w)[m].max(initial=0.0))
        check(ok, f"{what}: tails differ beyond atol {STEP_FUSED_ATOL}, "
              f"rtol {STEP_FUSED_RTOL} (max {err})")
        say("step", f"{what}: counts, depths, alt ids and tested identical; "
            f"max |dtail| {err:.3g} over {int(m.sum())} columns; "
            f"candidates {int(got['candidate'].sum())} vs "
            f"{int(want['candidate'].sum())}")
        return err
    m = t_w > STEP_TAIL_FLOOR
    err = float(np.abs(t_g - t_w)[m].max(initial=0.0))
    check(err <= TAIL_TOL, f"{what}: |tail - plain| {err} > {TAIL_TOL}")
    from lofreq_tpu_torch.defaults import DEFAULT_SIG

    lt = dc.log_threshold(DEFAULT_SIG, bonf).cpu().numpy()
    near = np.abs(t_w - lt) <= TAIL_TOL
    diff = got["candidate"].cpu().numpy() != want["candidate"].cpu().numpy()
    check(not (diff & ~near).any(),
          f"{what}: {int((diff & ~near).sum())} masks differ off the "
          "threshold")
    say("step", f"{what}: integer outputs identical; max |dtail| {err:.3g} "
        f"over {int(m.sum())} columns above the floor; {int(near.sum())} "
        f"within {TAIL_TOL} of the threshold ({int(diff.sum())} of them "
        f"differ); {int(got['candidate'].sum())} candidates of "
        f"{int(got['num_tested'])} tested")
    return err


def k1_f32_vs_host(cp, dc, step, unf_args, host, what: str) -> int:
    """K1's f32 entry on the DP inputs the unfused step gives it, against
    lfq_tail_column built by g++ (`host`, the shim of
    cuh_shims.build_screen_shim): within TAIL_ULPS f32 ulps on every tail,
    and no layout copy of the step's probs.  Returns the max ulps."""
    from lofreq_tpu_torch.testing import cuh_shims

    seen = {}

    def capture(p, kc):
        out = cp.tail_probs(p, kc)
        seen.update(p=p, kc=kc, out=out)
        return out

    copies = cp.layout_copy_count()
    with step_dp(dc, capture):
        step(*unf_args)
    torch.cuda.synchronize()
    check(cp.layout_copy_count() == copies,
          f"{what}: tail_probs copied the step's probs into another layout")
    got = seen["out"].cpu().numpy()
    want = cuh_shims.tail_columns(host, seen["p"].cpu().numpy(),
                                  seen["kc"].cpu().numpy(),
                                  workers=os.cpu_count() or 1)
    check(got.shape == want.shape and np.isfinite(got).all(),
          f"{what}: K1-f32 tail shape {got.shape} or non-finite")
    d = ulps(got, want)
    worst = int(d.max(initial=0))
    check(worst <= TAIL_ULPS, f"{what}: K1-f32 {worst} f32 ulps from "
          f"lfq_tail_column (g++) on {int((d > TAIL_ULPS).sum())} tails")
    say("step", f"{what}: K1-f32 within {worst} f32 ulps of lfq_tail_column "
        f"(g++) on all {got.size} tails ({int((d == 0).sum())} identical); "
        "no layout copy")
    return worst


def fused_vs_plain(fc, packed, ref4, what: str) -> float:
    """K2 against fused_column_torch on the card: depths and counts
    identical, log tails within TAIL_TOL where the plain tail is above
    STEP_TAIL_FLOOR.  Returns the max |tail difference|."""
    c0 = fc.launch_count()
    got = fc.fused_columns(packed, ref4)
    torch.cuda.synchronize()
    check(fc.launch_count() == c0 + 1,
          f"{what}: K2 launched {fc.launch_count() - c0} times, want 1")
    want = fc.fused_column_torch(packed, ref4)
    for name, g, w in zip(("depths", "kept-alt counts", "raw-alt counts"),
                          got[1:], want[1:]):
        check(torch.equal(g, w), f"{what}: K2 {name} differ from plain")
    t, tw = got[0].cpu().numpy(), want[0].cpu().numpy()
    check(t.shape == tw.shape and np.isfinite(t).all(),
          f"{what}: K2 tail shape {t.shape} or non-finite")
    above = tw > STEP_TAIL_FLOOR
    err = float(np.abs(t - tw)[above].max(initial=0.0))
    check(err <= TAIL_TOL, f"{what}: K2 |tail - plain| {err} > {TAIL_TOL}")
    say("fused", f"{what}: K2 vs plain: depths and counts identical, max "
        f"|dtail| {err:.3g} over {int(above.sum())} columns above the floor")
    return err


def fused_repeats(fc, packed, ref4, what: str) -> None:
    """Two launches of K2 on the same inputs agree bit for bit (its
    partials merge in a fixed tree, with no atomics)."""
    a = fc.fused_columns(packed, ref4)
    b = fc.fused_columns(packed, ref4)
    torch.cuda.synchronize()
    same = [torch.equal(x, y) for x, y in zip(a, b)]
    check(all(same), f"{what}: two K2 launches differ ({same})")
    say("fused", f"{what}: two K2 launches identical bit for bit")


def time_column_step(cp, dc, fc, step, fused, unf_args, fus_args) -> dict:
    """At the deployment shape: K1's f32 entry and K2, device ms per
    launch (profiler) and bound; both whole steps, columns/s (CUDA
    events); the plain versions, ms per call (CUDA events, median)."""
    B, Dd = unf_args[0].shape
    seen = {}

    def capture(p, kc):
        seen.update(p=p, kc=kc)
        return cp.tail_probs(p, kc)

    with step_dp(dc, capture):   # the DP's inputs, as the step gives them
        step(*unf_args)
    probs, kc = seen["p"], seen["kc"]   # [B, D], as the step gives them
    packed, ref4, _ = fus_args
    kept = int(fused(*fus_args)["depths"].sum())

    def k1_loop():
        for _ in range(STEP_REPS):
            cp.tail_probs(probs, kc)

    def k2_loop():
        for _ in range(STEP_REPS):
            fc.fused_columns(packed, ref4)

    ms, lim, plain, n_seen = {}, {}, {}, {}
    copies = cp.layout_copy_count()
    for key, loop, name in (("tail_probs", k1_loop, "tail_probs_kernel"),
                            ("fused", k2_loop, "fused_call_kernel")):
        loop()
        _, _, dev = device_profile(loop)
        ms[key] = per_launch_ms(dev, name, STEP_REPS)
        n_seen[key] = kernel_us(dev, name)[0]
    check(cp.layout_copy_count() == copies,
          "K1-f32's timing window copied the step's probs")
    plain["tail_probs"] = statistics.median(
        events_ms(lambda: cp.tail_torch(probs, kc), 1)
        for _ in range(STEP_PLAIN_WINDOWS))
    plain["fused"] = statistics.median(
        events_ms(lambda: fc.fused_column_torch(packed, ref4), 1)
        for _ in range(STEP_PLAIN_WINDOWS))
    # K1: probs and kc in, log tail out; every read is a DP step.  K2: the
    # stream and ref ids in, tail, depth and 4 + 4 counts out; the kept
    # reads step the DP (bq, baq and mq decoded), each column sums 18 cells
    lim["tail_probs"] = bound(probs.numel() * 4 + B * 8,
                              dp_ops((probs <= 1.5).sum(1), kc))
    lim["fused"] = bound(packed.numel() * 4 + B * 4 + B * (4 + 4 + 16 + 16),
                         kept * (K2_OPS_PER_KEPT + 2 * 3) + B * 18)
    step_ms = {"unfused": events_ms(lambda: step(*unf_args), STEP_ITERS),
               "fused": events_ms(lambda: fused(*fus_args), STEP_ITERS)}
    # for the record: the copy of the step's [B, D] probs into [D, B] that
    # the f32 entry's first design made before every launch
    copy_ms = events_ms(lambda: probs.t().contiguous(), STEP_ITERS)
    # a window of calls: the profiler drops a launch now and then, and
    # missed the fused step's one K2 launch in a one-call profile
    for key, fn in (("unfused", lambda: step(*unf_args)),
                    ("fused", lambda: fused(*fus_args))):
        _, wall, dev = device_profile(
            lambda: [fn() for _ in range(STEP_ITERS)])
        report_profile(f"{STEP_ITERS} calls of the {key} column step "
                       f"[{B}, {Dd}]", wall, dev)
    for key, label in (("tail_probs", "K1 f32 entry"), ("fused", "K2")):
        say("timing", f"column step [{B}, {Dd}]: {label} {ms[key]:.6f} ms "
            f"device time per launch (profiler, {n_seen[key]} of {STEP_REPS} "
            f"launches seen); bound {lim[key][0]:.6f} ms by {lim[key][1]}; "
            f"plain torch {plain[key]:.6f} ms per call (CUDA events, "
            f"median of {STEP_PLAIN_WINDOWS} calls)")
    say("timing", f"column step [{B}, {Dd}]: a [B, D] -> [D, B] copy of the "
        f"DP input, which tail_probs no longer makes, {copy_ms:.6f} ms per "
        f"call (CUDA events, {STEP_ITERS} copies)")
    say("timing", f"column step [{B}, {Dd}]: whole step per call (CUDA "
        f"events, {STEP_ITERS} calls): unfused {step_ms['unfused']:.6f} ms "
        f"= {B / step_ms['unfused'] * 1e3:.1f} columns/s, fused "
        f"{step_ms['fused']:.6f} ms = {B / step_ms['fused'] * 1e3:.1f} "
        f"columns/s; {kept} kept reads")
    return {"ms": ms, "bound": lim, "plain_ms": plain}


def records(res):
    return [(v.pos, v.ref, v.alt, v.qual, v.info) for v in res.vars]


def median_stages(reports):
    keys = sorted({k for r in reports for k in r})
    return {k: round(statistics.median(r.get(k, 0.0) for r in reports), 4)
            for k in keys}


def viterbi_inputs(rng):
    """VIT_READS reads of VIT_L bases, each with a 1-5 bp insertion or
    deletion planted at offset 20-79 and base errors at its qualities'
    rate (20-40, a tenth of the reads ending in a Q2 tail), against the
    VIT_LR-base window realign_prep would take; the Q2 replacement is the
    median of the read's other qualities, as realign_prep computes it."""
    bases = np.frombuffer(b"ACGT", np.uint8)
    genome = bases[rng.integers(0, 4, 200_000)]
    wins, queries, bquals, q2ds = [], [], [], []
    for _ in range(VIT_READS):
        s = int(rng.integers(VIT_RWIN, len(genome) - VIT_LR))
        src = genome[s:s + VIT_L + 10]
        n, at = int(rng.integers(1, 6)), int(rng.integers(20, 80))
        if rng.random() < 0.5:
            q = np.concatenate([src[:at], bases[rng.integers(0, 4, n)],
                                src[at:]])[:VIT_L]
        else:
            q = np.concatenate([src[:at], src[at + n:]])[:VIT_L]
        bq = rng.integers(20, 41, VIT_L).astype(np.uint8)
        if rng.random() < 0.1:
            bq[-int(rng.integers(5, 30)):] = 2
        err = rng.random(VIT_L) < 10.0 ** (-bq / 10.0)
        q[err] = bases[rng.integers(0, 4, int(err.sum()))]
        vals = np.sort(bq[bq != 2]).astype(np.int64)
        m = len(vals)
        q2d = (int((vals[m // 2] + vals[m // 2 - 1]) / 2.0) if m % 2 == 0
               else int(vals[m // 2]))
        wins.append(genome[s - VIT_RWIN:s - VIT_RWIN + VIT_LR].tobytes())
        queries.append(q.tobytes())
        bquals.append(bq)
        q2ds.append(q2d)
    return wins, queries, bquals, q2ds


def viterbi_phase(card: str) -> dict:
    """Phase 12: the device Viterbi against the C realigner and against
    itself on the CPU."""
    from lofreq_tpu_torch.ops import viterbi as vc
    from lofreq_tpu_torch.ops.viterbi_torch import viterbi_batch

    with open(VITERBI_GOLDEN) as fh:
        cases = json.load(fh)
    t0 = time.perf_counter()
    card_p, cpu_p, c_p = [], [], []
    for c in cases:
        bq = np.frombuffer(c["bqual"].encode("latin-1"), np.uint8) - 33
        args = ([c["ref"].encode()], [c["query"].encode()], [bq],
                [c["q2def"]])
        card_p.append(viterbi_batch(*args, device="cuda")[0])
        cpu_p.append(viterbi_batch(*args, device="cpu")[0])
        c_p.append(vc.viterbi_align(c["ref"].encode(), c["query"].encode(),
                                    c["bqual"].encode(), c["q2def"]))
    golden_s = time.perf_counter() - t0
    g_same = sum(a == b for a, b in zip(card_p, c_p))
    g_cpu = sum(a != b for a, b in zip(card_p, cpu_p))
    check(g_same >= int(len(cases) * VIT_SHARE),
          f"device Viterbi: {g_same} of {len(cases)} golden paths equal the "
          "C realigner's")

    rng = np.random.default_rng(SEED)
    wins, queries, bquals, q2ds = viterbi_inputs(rng)
    viterbi_batch(wins[:64], queries[:64], bquals[:64], q2ds[:64],
                  device="cuda")   # warm-up
    runs, ms = [], []
    for _ in range(VIT_RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        runs.append(viterbi_batch(wins, queries, bquals, q2ds,
                                  device="cuda"))
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    got = runs[0]
    check(all(r == got for r in runs), "device Viterbi: runs of one batch "
          "differ")
    prof_got, prof_wall, dev = device_profile(
        lambda: viterbi_batch(wins, queries, bquals, q2ds, device="cuda"))
    check(prof_got == got, "device Viterbi: the profiled run differs")
    report_profile(f"one device Viterbi batch {[VIT_READS, VIT_L, VIT_LR]}",
                   prof_wall, dev)
    t0 = time.perf_counter()
    cpu = viterbi_batch(wins, queries, bquals, q2ds, device="cpu")
    cpu_ms = (time.perf_counter() - t0) * 1e3
    preps = [(q, (b + 33).tobytes(), d, w)
             for w, q, b, d in zip(wins, queries, bquals, q2ds)]
    t0 = time.perf_counter()
    want = [vc.viterbi_align(w, q, b, d) for q, b, d, w in preps]
    c_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    grouped = [r for i in range(0, len(preps), 8)
               for r in vc.viterbi_align_group(preps[i:i + 8], 8)]
    c_group_ms = (time.perf_counter() - t0) * 1e3
    check(grouped == want, "the C realigner's 8-lane groups differ from its "
          "one-read form")
    same = sum(a == b for a, b in zip(got, want))
    n_cpu = sum(a != b for a, b in zip(got, cpu))
    check(same >= int(VIT_READS * VIT_SHARE),
          f"device Viterbi: {same} of {VIT_READS} batch paths equal the C "
          "realigner's")
    check(n_cpu <= VIT_READS - int(VIT_READS * VIT_SHARE),
          f"device Viterbi: {n_cpu} of {VIT_READS} paths differ between the "
          "card and the CPU")
    out = {"golden_cases": len(cases), "golden_same_as_c": g_same,
           "golden_card_vs_cpu_differ": g_cpu, "golden_s": golden_s,
           "batch": [VIT_READS, VIT_L, VIT_LR], "batch_same_as_c": same,
           "batch_card_vs_cpu_differ": n_cpu,
           "batch_ms": [round(m, 3) for m in ms],
           "batch_ms_median": statistics.median(ms),
           "batch_launches": sum(n for n, _ in dev.values()),
           "batch_device_ms": sum(us for _, us in dev.values()) / 1e3,
           "cpu_batch_ms": cpu_ms, "c_one_by_one_ms": c_ms,
           "c_8_lane_ms": c_group_ms, "card": card}
    say("viterbi", json.dumps(out))
    return out


def _vcf_body(path: str, skip=("##fileDate", "##source")) -> list:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        return [ln for ln in fh.read().splitlines() if not ln.startswith(skip)]


def single_vcf(art, want, td) -> str:
    """The VCF that phase 4's records and tests give through the final
    filter of call-parallel and call-distributed (their own merge)."""
    from lofreq_tpu_torch.call.caller import VarcallConf
    from lofreq_tpu_torch.pipelines import parallel_call as pc

    single = os.path.join(td, "single.vcf")
    with contextlib.redirect_stderr(io.StringIO()):
        pc.finalize_parallel_output(
            [v.to_line() for v in want.vars], want.stats.num_snv_tests,
            want.stats.num_indel_tests,
            argparse.Namespace(ref=art["fa"], out=single,
                               no_default_filter=False), VarcallConf())
    return single


def call_parallel_phase(art, want, call_median, td, single, reset_counts,
                        cp, card: str) -> dict:
    """Phase 13: the CLI's call-parallel with two workers, from this
    process (which holds a CUDA context), on the card and on the host."""
    from lofreq_tpu_torch.cli import main as cli_main
    from lofreq_tpu_torch.pipelines import parallel_call as pc

    check(torch.cuda.is_initialized(), "chip_smoke holds no CUDA context "
          "before call-parallel")
    out = {}
    for name, flags in (("device", []), ("host", ["--no-device-screen"])):
        path = os.path.join(td, f"parallel_{name}.vcf")
        err = io.StringIO()
        reset_counts()
        pc.reset_parallel_stats()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = cli_main(["call-parallel", "--pp-threads", "2", "-f",
                           art["fa"], "-o", path, *flags, art["bam"]])
        wall = time.perf_counter() - t0
        stats = dict(pc.PARALLEL_DISPATCH_STATS)
        pool = dict(pc.POOL_STATS)
        check(rc == 0, f"call-parallel ({name}) exited {rc}: "
              f"{err.getvalue()[-2000:]}")
        n_snv = int(re.search(r"substitution tests performed: (\d+)",
                              err.getvalue()).group(1))
        check(n_snv == want.stats.num_snv_tests,
              f"call-parallel ({name}): {n_snv} SNV tests, phase 4 "
              f"{want.stats.num_snv_tests}")
        check(_vcf_body(path) == _vcf_body(single),
              f"call-parallel ({name}): its VCF differs from phase 4's "
              "records through the same filter")
        check(cp.launch_count() == 0, "this process launched K1 during "
              "call-parallel: the workers should")
        if name == "device":
            check(pool["start_method"] == "spawn",
                  f"workers on the card started by {pool['start_method']}")
            check(stats["dispatched"] > 0 and stats["screen_codes"] > 0,
                  f"call-parallel's workers launched K1 {stats}")
            check(stats["screen_codes"] == stats["dispatched"],
                  f"{stats['screen_codes']} K1 launches for "
                  f"{stats['dispatched']} dispatches in the workers")
        else:
            check(pool["start_method"] == "fork" and stats["dispatched"] == 0,
                  f"host-engine call-parallel: {pool} {stats}")
        out[name] = {"wall_s": wall, "snv_tests": n_snv,
                     "records": len(_vcf_body(path, ("#",))),
                     "workers": stats, "start_method": pool["start_method"],
                     "worker_ready_s": pool["ready_s"]}
    out["single_call_median_s"] = call_median
    out["card"] = card
    say("parallel", json.dumps(out))
    return out


def somatic_phase(td, reset_counts, cp, card: str) -> dict:
    """Phase 14: the CLI's somatic with two workers on the card, against
    the same command on the host engine."""
    from lofreq_tpu_torch.cli import main as cli_main
    from lofreq_tpu_torch.pipelines import parallel_call as pc
    from lofreq_tpu_torch.testing.simulate_fast import simulate_fast

    t0 = time.perf_counter()
    sims = {}
    for sample, seed in SOMATIC_SEEDS.items():
        d = os.path.join(td, f"somatic_{sample}")
        os.makedirs(d)
        sims[sample] = simulate_fast(
            d, genome_len=SOMATIC_GENOME, depth=SOMATIC_DEPTH, seed=seed,
            genome_seed=SEED,
            snvs=SOMATIC_SNVS if sample == "tumor" else ())
    check(sims["tumor"]["genome"] == sims["normal"]["genome"],
          "the tumor and normal samples differ in genome")
    sim_s = time.perf_counter() - t0
    out = {}
    for name, env in (("device", {}),
                      ("host", {"LOFREQ_TPU_DEVICE_SCREEN": "0"})):
        d = os.path.join(td, f"somatic_out_{name}")
        os.makedirs(d)
        reset_counts()
        pc.reset_parallel_stats()
        t0 = time.perf_counter()
        with mock.patch.dict(os.environ, env):
            rc = cli_main(["somatic", "-t", sims["tumor"]["bam"], "-n",
                           sims["normal"]["bam"], "-f", sims["tumor"]["fa"],
                           "-o", d + os.sep, "--threads", "2"])
        wall = time.perf_counter() - t0
        stats = dict(pc.PARALLEL_DISPATCH_STATS)
        check(rc == 0, f"somatic ({name}) exited {rc}")
        check(cp.launch_count() == 0, "this process launched K1 during "
              "somatic: the workers should")
        out[name] = {"dir": d, "wall_s": wall, "workers": stats,
                     "start_method": pc.POOL_STATS["start_method"],
                     "worker_ready_s": pc.POOL_STATS["ready_s"]}
    dev, host = out["device"], out["host"]
    check(dev["start_method"] == "spawn" and dev["workers"]["dispatched"] > 0
          and dev["workers"]["screen_codes"] == dev["workers"]["dispatched"],
          f"somatic's workers on the card: {dev['start_method']} "
          f"{dev['workers']}")
    check(host["start_method"] == "fork"
          and host["workers"]["dispatched"] == 0,
          f"somatic on the host engine: {host['start_method']} "
          f"{host['workers']}")
    names = sorted(n for n in os.listdir(dev["dir"])
                   if n.endswith((".vcf.gz", ".log")))
    check(names == sorted(n for n in os.listdir(host["dir"])
                          if n.endswith((".vcf.gz", ".log")))
          and len(names) >= 10, f"somatic's stage files differ: {names}")
    for n in names:
        a, b = (os.path.join(r["dir"], n) for r in (dev, host))
        check(_vcf_body(a, ("##fileDate",)) == _vcf_body(b, ("##fileDate",)),
              f"somatic: {n} differs between the card and the host engine")
    final = _vcf_body(os.path.join(dev["dir"], "somatic_final.snvs.vcf.gz"),
                      ("#",))
    truth = {(t[0] + 1) for t in sims["tumor"]["truth"]}
    called = {int(r.split("\t")[1]) for r in final}
    check(final and called <= truth, f"somatic called {sorted(called)}, "
          f"planted {sorted(truth)}")
    res = {k: {x: y for x, y in v.items() if x != "dir"}
           for k, v in out.items()}
    res.update(simulated_s=sim_s, final_snvs=len(final),
               planted=len(truth), stage_files=len(names), card=card)
    say("somatic", json.dumps(res))
    return res


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_procs(cmds, what: str) -> list:
    """Run the commands `cmds` as subprocesses started together, from the
    repo and with it on PYTHONPATH, each within DIST_RANK_S of wall time
    (failing the run past it); every one still running is killed on the
    way out.  Returns [(exit code, stderr)]."""
    env = {**os.environ, "PYTHONPATH": REPO,
           "LOFREQ_TPU_DIST_TIMEOUT": str(DIST_TIMEOUT_S)}
    procs = []
    try:
        for cmd in cmds:
            procs.append(subprocess.Popen(
                cmd, cwd=REPO, env=env, stdout=subprocess.DEVNULL,
                stderr=subprocess.PIPE, text=True))
        out = []
        for r, p in enumerate(procs):
            try:
                _, err = p.communicate(timeout=DIST_RANK_S)
            except subprocess.TimeoutExpired:
                fail(f"{what}: process {r} ran past {DIST_RANK_S} s")
            out.append((p.returncode, err))
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)


def run_ranks(td: str, name: str, argv_of, n: int = DIST_RANKS) -> tuple:
    """Ranks 0..n-1 of the port's CLI, argv_of(rank), through
    lofreq_tpu_torch.testing.rank_harness (which records each rank's
    run_distributed_call dict), with a process-group timeout of
    DIST_TIMEOUT_S (run_procs).  Returns (the wall-clock time the ranks
    were started, [(exit code, stderr, the rank's dict or None)])."""
    infos = [os.path.join(td, f"{name}_rank{r}.json") for r in range(n)]
    started = time.time()
    res = run_procs([[sys.executable, "-m",
                      "lofreq_tpu_torch.testing.rank_harness", infos[r],
                      *argv_of(r)] for r in range(n)], name)
    out = []
    for (rc, err), info in zip(res, infos):
        rec = None
        if os.path.exists(info):
            with open(info) as fh:
                rec = json.load(fh)
        out.append((rc, err, rec))
    return started, out


def distributed_phase(art, want, call_median, td, single, reset_counts, cp,
                      card: str) -> dict:
    """Phase 15: the CLI's call-distributed with DIST_RANKS ranks on this
    host's card over Gloo, each a process with its own CUDA context,
    against phase 4's records and tests through the same final filter."""
    path = os.path.join(td, "distributed.vcf")
    port = free_port()
    reset_counts()
    t0 = time.perf_counter()
    started, ranks = run_ranks(td, "distributed", lambda r: [
        "call-distributed", "--num-processes", str(DIST_RANKS),
        "--process-id", str(r), "--coordinator", f"127.0.0.1:{port}",
        "--threads-per-host", "2", "-f", art["fa"], "-o", path, art["bam"]])
    wall = time.perf_counter() - t0
    for r, (rc, err, _) in enumerate(ranks):
        check(rc == 0, f"call-distributed rank {r} exited {rc}: {err[-2000:]}")
    infos = [info for _, _, info in ranks]
    n_snv = want.stats.num_snv_tests
    check(all(i is not None and i["num_snv_tests"] == n_snv for i in infos),
          f"call-distributed: the ranks' all-reduced SNV tests "
          f"{[i and i['num_snv_tests'] for i in infos]}, phase 4 {n_snv}")
    check(f"substitution tests performed: {n_snv}" in ranks[0][1],
          "call-distributed: rank 0 did not report phase 4's SNV tests")
    check(_vcf_body(path) == _vcf_body(single),
          "call-distributed: its VCF differs from phase 4's records through "
          "the same filter")
    n_records = len(_vcf_body(path, ("#",)))
    check(n_records == len(_vcf_body(single, ("#",))) > 0
          and sum(i["n_local_vars"] for i in infos) >= n_records,
          f"call-distributed: {n_records} records, phase 4's through the "
          f"filter {len(_vcf_body(single, ('#',)))}")
    for i in infos:
        c = i["counts"]
        check(c["screen_codes"] > 0 and c["screen_codes"] == c["dispatched"],
              f"call-distributed rank {i['rank']} launched K1 "
              f"{c['screen_codes']} times for {c['dispatched']} dispatches")
    check(cp.launch_count() == 0, "this process launched K1 during "
          "call-distributed: the ranks should")
    out = {"ranks": DIST_RANKS, "backend": "gloo", "wall_s": wall,
           "snv_tests": n_snv, "records": n_records,
           "rank_records": [i["n_local_vars"] for i in infos],
           "rank_counts": [i["counts"] for i in infos],
           "rank_ready_s": [i["ready_at"] - started for i in infos],
           "single_call_median_s": call_median, "card": card}
    say("distributed", json.dumps(out))
    return out


def sharded_phase(cp, dc, screen, batches, reset_counts, card: str,
                  dev=torch.device("cuda", 0)) -> dict:
    """Phase 16: the sharded column step and the split screen over two
    shards on one card, [dev, dev], against the unsharded ones on dev."""
    from lofreq_tpu_torch.entry import dryrun_checks

    shards = [dev, dev]
    reset_counts()
    t0 = time.perf_counter()
    try:
        dryrun_checks(shards)
    except AssertionError as e:
        fail(f"the dry run's checks on {shards}: {e}")
    torch.cuda.synchronize()
    dry_s = time.perf_counter() - t0
    # 5 batches, each through the sharded step (2 shards) and the serial
    # one; the screen split (2) and the whole screen (1)
    dry = {e: cp.launch_count(e, card=dev.index) for e in ("tail_probs",
                                                            "screen_codes")}
    check(dry == {"tail_probs": 15, "screen_codes": 3},
          f"the dry run's K1 launches {dry}, want 15 and 3")
    out = {"dryrun_s": dry_s, "dryrun_launches": dry}
    fn, devs = dc.build_sharded_column_call(shards, use_baq=True)
    serial = dc.build_column_call(use_baq=True, device=dev)
    for name in ("deployment", "spread"):
        unf_args = batches[name][0]
        reset_counts()
        got = fn(*unf_args)
        torch.cuda.synchronize()
        launches = cp.launch_count("tail_probs", card=dev.index)
        check(launches == len(devs), f"sharded step {name}: {launches} K1-f32 "
              f"launches for {len(devs)} shards")
        want = serial(*unf_args)
        for k in dc.STEP_KEYS + ("num_tested",):
            check(got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                                want[k]),
                  f"sharded step {name}: {k} differs from the unsharded step")
        out[name] = {"shape": list(unf_args[0].shape),
                     "tested": int(got["num_tested"]),
                     "candidates": int(got["candidate"].sum()),
                     "launches_per_shard": launches // len(devs)}
    check(out["spread"]["candidates"] > 0, "the spread batch has no "
          "candidate")
    # the production screen's dispatch, split over the two shards, against
    # the same dispatch on one card
    rng = np.random.default_rng(SEED + 16)
    codes = rng.integers(16, 160, (SPLIT_B, 128)).astype(np.uint8)
    codes[rng.random((SPLIT_B, 128)) < 0.3] = 255
    ks = rng.integers(1, 25, SPLIT_B).astype(np.int32)
    lt = rng.uniform(-40.0, -1.0, SPLIT_B)
    bonf = SPLIT_SIG * screen.MARGIN / np.exp(lt)
    reset_counts()
    with mock.patch.object(screen, "local_mesh", lambda d: shards):
        split = screen.screen_fetch(screen.screen_dispatch_codes(
            codes, ks, bonf, SPLIT_SIG, dev))
    split_launches = cp.launch_count("screen_codes", card=dev.index)
    whole = screen.screen_fetch(screen.screen_dispatch_codes(
        codes, ks, bonf, SPLIT_SIG, dev))
    check(split_launches == 2 and cp.launch_count("screen_codes") == 3
          and screen.DISPATCH_STATS["dispatched"] == 2,
          f"the split screen: {split_launches} launches, then "
          f"{cp.launch_count('screen_codes')} with the whole one, "
          f"{screen.DISPATCH_STATS['dispatched']} dispatches")
    check(np.array_equal(split, whole) and 0 < whole.sum() < SPLIT_B,
          f"the split screen's mask differs from the whole one's "
          f"({int((split != whole).sum())} columns) or is uniform")
    out["screen"] = {"shape": [SPLIT_B, 128], "candidates": int(whole.sum()),
                     "launches_per_shard": split_launches // 2}
    out["card"] = card
    say("sharded", json.dumps(out))
    return out


def nccl_rank(rank: int, port: int, out_path: str, ranks: int = DIST_RANKS,
              device: str = "cuda") -> None:
    """One rank of the NCCL check (nccl_phase): joins the process group
    as call-distributed does (on "cuda": its own card, NCCL for CUDA
    tensors), runs its share of a spread batch through the sharded step,
    whose num_tested is all-reduced over the group, and writes what it saw
    to out_path."""
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from lofreq_tpu_torch.ops import cuda_poissbin as cp
    from lofreq_tpu_torch.ops import device_call as dc
    from lofreq_tpu_torch.parallel import distributed as pd

    os.environ.setdefault("LOFREQ_TPU_DIST_TIMEOUT", str(DIST_TIMEOUT_S))
    check(pd.initialize(f"127.0.0.1:{port}", ranks, rank, device=device),
          "nccl_rank: no process group")
    try:
        dev = pd.local_mesh(device)[0]
        batch = [torch.from_numpy(a).to(dev)
                 for a in spread_batch(*NCCL_BATCH)]
        B = NCCL_BATCH[0]
        lo, hi = B * rank // ranks, B * (rank + 1) // ranks
        fn, devs = dc.build_sharded_column_call(pd.local_mesh(device),
                                                use_baq=True)
        got = fn(*(a[lo:hi] for a in batch))
        launches = cp.launch_count("tail_probs", card=dev.index)
        want = dc.build_column_call(use_baq=True, device=dev)(*batch)
        same = all(torch.equal(got[k], want[k][lo:hi]) for k in dc.STEP_KEYS)
        with open(out_path, "w") as fh:
            json.dump({"rank": rank, "backend": str(dist.get_backend()),
                       "devices": [str(d) for d in devs],
                       "num_tested": int(got["num_tested"]),
                       "serial_num_tested": int(want["num_tested"]),
                       "rows_equal": same, "launches": launches}, fh)
    finally:
        dist.destroy_process_group()


def nccl_phase(card: str) -> dict:
    """The multi-card forms, where this host has two cards or more:
    dryrun_multichip(2) on cuda:0 and cuda:1; two ranks of the sharded
    step over NCCL, all-reduced num_tested against the serial step's; two
    ranks of call-distributed (NCCL chosen for them) and a `call` whose
    screen splits over the local cards, against the host engine."""
    from lofreq_tpu_torch.call.caller import VarcallConf
    from lofreq_tpu_torch.entry import dryrun_multichip
    from lofreq_tpu_torch.ops import cuda_poissbin as cp
    from lofreq_tpu_torch.parallel import distributed as pd
    from lofreq_tpu_torch.pipelines.call_pipeline import run_call
    from lofreq_tpu_torch.testing.simulate_fast import simulate_fast

    out = {"cards": torch.cuda.device_count(), "card": card}
    check(pd.backend_for("cuda", DIST_RANKS) == "cpu:gloo,cuda:nccl",
          f"{DIST_RANKS} ranks on {out['cards']} cards do not take NCCL")
    cp.reset_launch_count()
    t0 = time.perf_counter()
    try:
        dryrun_multichip(2)
    except AssertionError as e:
        fail(f"dryrun_multichip(2): {e}")
    out["dryrun_s"] = time.perf_counter() - t0
    out["dryrun_launches"] = {c: cp.launch_count("tail_probs", card=c)
                              for c in (0, 1)}
    check(all(n > 0 for n in out["dryrun_launches"].values()),
          f"dryrun_multichip(2) launched K1-f32 {out['dryrun_launches']}")

    with tempfile.TemporaryDirectory() as td:
        port = free_port()
        paths = [os.path.join(td, f"nccl{r}.json") for r in range(DIST_RANKS)]
        res = run_procs([[sys.executable, "-c", "import chip_smoke; "
                          f"chip_smoke.nccl_rank({r}, {port}, {paths[r]!r})"]
                         for r in range(DIST_RANKS)], "NCCL sharded step")
        for r, (rc, err) in enumerate(res):
            check(rc == 0, f"NCCL rank {r} exited {rc}: {err[-2000:]}")
        ranks = []
        for path in paths:
            with open(path) as fh:
                ranks.append(json.load(fh))
        for i in ranks:
            check("nccl" in i["backend"] and i["rows_equal"]
                  and i["num_tested"] == i["serial_num_tested"] > 0
                  and i["launches"] == 1
                  and i["devices"] == [f"cuda:{i['rank']}"],
                  f"NCCL sharded step, rank {i['rank']}: {i}")
        out["sharded_ranks"] = ranks

        art = simulate_fast(td, genome_len=NCCL_GENOME, depth=DEPTH,
                            seed=SEED)
        host = run_call(art["bam"], art["fa"],
                        vconf=VarcallConf(use_device_screen=False))
        cp.reset_launch_count()
        split = run_call(art["bam"], art["fa"],
                         vconf=VarcallConf(use_device_screen=True))
        per_card = {c: cp.launch_count("screen_codes", card=c)
                    for c in range(len(pd.local_mesh("cuda")))}
        check(records(split) == records(host) and split.stats.num_snv_tests
              == host.stats.num_snv_tests, "call with the screen split over "
              "the cards differs from the host engine")
        check(len(per_card) >= 2 and all(n > 0 for n in per_card.values()),
              f"the split screen's launches per card {per_card}")
        out["call_split_launches"] = per_card
        single = single_vcf(art, host, td)
        path = os.path.join(td, "nccl.vcf")
        port = free_port()
        started, res = run_ranks(td, "nccl_call", lambda r: [
            "call-distributed", "--num-processes", str(DIST_RANKS),
            "--process-id", str(r), "--coordinator", f"127.0.0.1:{port}",
            "-f", art["fa"], "-o", path, art["bam"]])
        for r, (rc, err, info) in enumerate(res):
            check(rc == 0 and info["counts"]["screen_codes"] > 0,
                  f"NCCL call-distributed rank {r}: exit {rc}, {info}: "
                  f"{err[-2000:]}")
        check(_vcf_body(path) == _vcf_body(single), "NCCL call-distributed's "
              "VCF differs from the host engine's records through the same "
              "filter")
        out["call_distributed"] = {
            "genome": NCCL_GENOME, "records": len(host.vars),
            "rank_counts": [i["counts"] for _, _, i in res],
            "rank_ready_s": [i["ready_at"] - started for _, _, i in res]}
    say("nccl", json.dumps(out))
    return out


def multi_card() -> int:
    """The multi-card forms alone (nccl_phase), on a host with two cards or
    more:  python3 -c 'import chip_smoke, sys; sys.exit(chip_smoke.multi_card())'"""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        fail("the multi-card forms need two CUDA cards")
    sys.path.insert(0, REPO)
    card = card_line()
    say("card", f"{card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    nccl_phase(card)
    return 0


def main() -> int:
    started = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA card")
    sys.path.insert(0, REPO)
    from lofreq_tpu_torch import _kernel_build
    from lofreq_tpu_torch.ops import baq_torch as bt
    from lofreq_tpu_torch.ops import cuda_baq as ca
    from lofreq_tpu_torch.ops import cuda_poissbin as cp
    from lofreq_tpu_torch.ops import device_baq, screen
    from lofreq_tpu_torch.ops import device_call as dc
    from lofreq_tpu_torch.ops import fused_call as fc

    card = card_line()
    say("card", f"{card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    screen.screen_ready("cuda")
    build_s = time.perf_counter() - t0
    use = register_use(_kernel_build.build_log())
    say("build", f"{build_s:.3f} s -> "
        f"{os.path.relpath(_kernel_build.library_path(), REPO)}; "
        + "; ".join(f"{k}: {v}" for k, v in use.items()))
    check_no_spill(use)

    from lofreq_tpu_torch.testing import cuh_shims

    # the g++ forms of K1's bodies, for phases 3 and 10
    shim_dir = tempfile.TemporaryDirectory()
    host_k1 = cuh_shims.build_screen_shim(shim_dir.name)
    rng = np.random.default_rng(SEED)
    max_err = max(kernel_vs_plain(cp, rng, B, S, host_k1)
                  for B, S in ((4096, 128), (292, 128), (48, 16)))
    with tempfile.TemporaryDirectory() as td:
        host_baq = cuh_shims.build_baq_shim(td)
        baq_errs = [baq_vs_plain(ca, bt, rng, *shape, host=host_baq)
                    for shape in BAQ_SHAPES]

    from lofreq_tpu_torch.call.caller import VarcallConf
    from lofreq_tpu_torch.pipelines.call_pipeline import run_call, stagetimer

    from lofreq_tpu_torch.testing.simulate_fast import simulate_fast

    def reset_counts():
        cp.reset_launch_count()
        ca.reset_launch_count()
        fc.reset_launch_count()
        screen.DISPATCH_STATS.update(dispatched=0, columns=0)
        device_baq.RUN_STATS.update(reads=0, batches=0)

    def timed(fn):
        stagetimer.reset()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, stagetimer.report()

    def in_turns(name, counted, path, host_path, pairs):
        """`pairs` pairs of walls of `name` and the host path in turns
        after the counted run (host, name, name, host, ...)."""
        runs = {name: [counted], "host": []}
        for i in range(pairs):
            order = ("host", name) if i % 2 == 0 else (name, "host")
            for side in order:
                runs[side].append(timed(path if side == name
                                        else host_path))
        return runs

    def check_same(runs, want):
        for side, rs in runs.items():
            for j, (r, _, _) in enumerate(rs):
                check(records(r) == records(want),
                      f"records differ: {side} run {j} {len(r.vars)}, host "
                      f"path {len(want.vars)}")
                check(r.stats.num_snv_tests == want.stats.num_snv_tests,
                      f"num_snv_tests differ: {side} run {j} "
                      f"{r.stats.num_snv_tests} vs "
                      f"{want.stats.num_snv_tests}")

    def report_walls(name, runs, pairs):
        walls = {s: [round(w, 4) for _, w, _ in rs] for s, rs in runs.items()}
        say("call", f"{name}: {pairs} pairs, records and SNV tests "
            f"identical in all; walls s {json.dumps(walls)}; medians "
            f"{name} {statistics.median(walls[name]):.4f} s, host "
            f"{statistics.median(walls['host']):.4f} s; card: {card}")
        stages = {}
        for side, rs in runs.items():
            stages[side] = median_stages([st for _, _, st in rs])
            say("stages", f"{side} median s {json.dumps(stages[side])}")
        return stages

    # the workload's files stay until the end: phases 13 and 14 reuse them
    work = tempfile.TemporaryDirectory()
    td = work.name
    t0 = time.perf_counter()
    art = simulate_fast(td, genome_len=GENOME, depth=DEPTH, seed=SEED)
    say("data", f"simulated {GENOME // 1000} kb at {DEPTH}x, seed "
        f"{SEED}, in {time.perf_counter() - t0:.3f} s")
    # warm-up region: builds the native C library and the executors
    run_call(art["bam"], art["fa"], region=f"{art['chrom']}:1-6000",
             vconf=VarcallConf(use_device_screen=True))

    def device_path():
        return run_call(art["bam"], art["fa"],
                        vconf=VarcallConf(use_device_screen=True))

    def baq_path():
        return run_call(art["bam"], art["fa"],
                        vconf=VarcallConf(use_device_screen=True,
                                          use_device_baq=True))

    def host_path():
        return run_call(art["bam"], art["fa"],
                        vconf=VarcallConf(use_device_screen=False))

    # the counted main-path run
    reset_counts()
    counted = timed(device_path)
    launches = cp.launch_count()
    stats = dict(screen.DISPATCH_STATS)
    res, wall, _ = counted
    check(launches > 0, "the main path launched the screen kernel 0 "
          "times")
    check(stats["dispatched"] > 0, "the main path dispatched no screen")
    check(launches == stats["dispatched"],
          f"{launches} launches for {stats['dispatched']} dispatches")
    check(ca.launch_count() == {"baq_fwd": 0, "baq_bwd": 0},
          "the default path launched a BAQ kernel")
    check(len(res.vars) > 0, "the port called no variant")
    say("call", f"counted run: {wall:.4f} s, {len(res.vars)} records, "
        f"{res.stats.num_snv_tests} SNV tests, {stats['columns']} "
        f"survivor columns in {stats['dispatched']} dispatches, "
        f"{launches} kernel launches")
    runs = in_turns("device", counted, device_path, host_path,
                    WALL_PAIRS)
    want = runs["host"][0][0]
    check_same(runs, want)
    report_walls("device", runs, WALL_PAIRS)
    call_median = statistics.median(w for _, w, _ in runs["device"])
    prof_res, prof_wall, dev = device_profile(device_path)
    check(records(prof_res) == records(want), "profiled run differs")
    report_profile("one device-path call", prof_wall, dev)

    # the counted device-BAQ run: K3/K4 in the runner, K1 in the
    # sub-screen, and every eligible read of every window on the card
    reset_counts()
    with device_baq.count_extracted_reads() as extracted:
        counted = timed(baq_path)
    baq_launches = ca.launch_count()
    k1_baq = cp.launch_count()
    baq_stats = dict(device_baq.RUN_STATS)
    res, wall, _ = counted
    check(baq_launches["baq_fwd"] > 0 and baq_launches["baq_bwd"] > 0,
          f"the device-BAQ path launched the BAQ kernels {baq_launches}")
    check(baq_launches["baq_fwd"] == baq_launches["baq_bwd"]
          == baq_stats["batches"],
          f"{baq_launches} launches for {baq_stats['batches']} batches")
    check(k1_baq > 0, "the device-BAQ path launched the screen kernel 0 "
          "times")
    check(baq_stats["reads"] == extracted["eligible"] > 0,
          f"the runner took {baq_stats['reads']} reads of the "
          f"{extracted['eligible']} eligible ones")
    say("call", f"device-BAQ counted run: {wall:.4f} s, "
        f"{len(res.vars)} records, {res.stats.num_snv_tests} SNV "
        f"tests; runner reads {baq_stats['reads']} in "
        f"{baq_stats['batches']} batches = eligible reads "
        f"{extracted['eligible']} over {extracted['windows']} "
        f"extracted windows; launches K3 {baq_launches['baq_fwd']}, "
        f"K4 {baq_launches['baq_bwd']}, K1 {k1_baq}")
    runs = in_turns("device_baq", counted, baq_path, host_path,
                    BAQ_PAIRS)
    check_same(runs, want)
    stages = report_walls("device_baq", runs, BAQ_PAIRS)
    for stage in ("ingest.extract", "ingest.device_baq"):
        check(stage in stages["device_baq"], f"no {stage} stage")
    prof_res, prof_wall, dev = device_profile(baq_path)
    check(records(prof_res) == records(want),
          "profiled device-BAQ run differs")
    report_profile("one device-BAQ call", prof_wall, dev)

    mean_b = max(1, round(stats["columns"] / stats["dispatched"]))
    ms, plain_ms, k1_bound = time_shape(cp, rng, mean_b)
    time_shape(cp, rng, 4096)
    baq_ms, baq_plain_ms = time_baq(ca, bt, rng, *BAQ_SHAPES[0])
    baq_bound = baq_bounds(*BAQ_SHAPES[0])

    # the column step: entry()'s unfused step (K1's f32 entry) and the
    # fused step (K2), on tools/device_step_bench.py's batches
    from lofreq_tpu_torch.entry import entry

    deploy, ragged = STEP_SHAPES
    step_batches = (("deployment", step_batch, deploy),
                    ("spread", spread_batch, deploy),
                    ("ragged", step_batch, ragged))
    t0 = time.perf_counter()
    batches = {name: step_args(fc, make(*shape))
               for name, make, shape in step_batches}
    say("data", f"column batches {[(n, s) for n, _, s in step_batches]} "
        f"drawn, packed and copied to the card in "
        f"{time.perf_counter() - t0:.3f} s")
    step, ex_args = entry(device="cuda")
    fused = fc.build_fused_column_call(use_baq=True)
    unf_args, fus_args = batches["deployment"]
    # the counted run: entry()'s function on its example batch, and both
    # steps at the deployment shape
    reset_counts()
    t0 = time.perf_counter()
    ex_out = step(*ex_args)
    unf_out = step(*unf_args)
    fus_out = fused(*fus_args)
    torch.cuda.synchronize()
    step_wall = time.perf_counter() - t0
    step_launches = {"tail_probs": cp.launch_count("tail_probs"),
                     "fused": fc.launch_count(),
                     "screen_codes": cp.launch_count("screen_codes"),
                     **ca.launch_count()}
    check(step_launches == {"tail_probs": 2, "fused": 1, "screen_codes": 0,
                            "baq_fwd": 0, "baq_bwd": 0},
          f"the column step's launches {step_launches}, want 2 of K1's f32 "
          "entry and 1 of K2")
    check(cp.layout_copy_count() == 0,
          f"the unfused step made {cp.layout_copy_count()} layout copies of "
          "its DP input")
    check(int(ex_out["num_tested"]) > 0 and int(unf_out["num_tested"]) > 0,
          "the column step tested no column")
    say("step", f"counted run: {step_wall:.4f} s for entry()'s batch "
        f"{list(ex_args[0].shape)} and both steps at {list(deploy)}; "
        f"launches {step_launches}, no layout copy; tested "
        f"{int(ex_out['num_tested'])} and {int(unf_out['num_tested'])} "
        "columns")
    with step_dp(dc, cp.tail_torch):
        ex_plain = step(*ex_args)
    step_errs = [check_step(dc, ex_out, ex_plain, ex_args[-1],
                            "entry() batch vs plain")]
    fused_errs = []
    for name, _, shape in step_batches:
        unf_args, fus_args = batches[name]
        what = f"{name} [{shape[0]}, {shape[1]}]"
        unf = unf_out if name == "deployment" else step(*unf_args)
        fus = fus_out if name == "deployment" else fused(*fus_args)
        with step_dp(dc, cp.tail_torch):
            plain = step(*unf_args)
        if name == "spread":
            check_spread(dc, plain, unf_args[-1], what)
        step_errs.append(check_step(dc, unf, plain, unf_args[-1],
                                    f"unfused step {what} vs plain"))
        k1_f32_vs_host(cp, dc, step, unf_args, host_k1, what)
        fused_errs.append(fused_vs_plain(fc, *fus_args[:2], what))
        if name == "spread":
            fused_repeats(fc, *fus_args[:2], what)
        check_step(dc, fus, unf, unf_args[-1], f"fused vs unfused {what}",
                   fused_vs_unfused=True)
        del unf, fus, plain
    col = time_column_step(cp, dc, fc, step, fused, *batches["deployment"])
    shim_dir.cleanup()

    t0 = time.perf_counter()
    viterbi_phase(card)
    single = single_vcf(art, want, td)
    call_parallel_phase(art, want, call_median, td, single, reset_counts, cp,
                        card)
    somatic_phase(td, reset_counts, cp, card)
    say("phases", f"12-14 took {time.perf_counter() - t0:.1f} s; chip_smoke "
        f"{time.perf_counter() - started:.1f} s so far")

    t0 = time.perf_counter()
    distributed_phase(art, want, call_median, td, single, reset_counts, cp,
                      card)
    work.cleanup()
    sharded_phase(cp, dc, screen, batches, reset_counts, card)
    if torch.cuda.device_count() >= 2:
        nccl_phase(card)
    else:
        say("nccl", f"not run: the NCCL forms need two cards and this host "
            f"has {torch.cuda.device_count()}; phases 15 and 16 ran two "
            "ranks and two shards on one card, over Gloo")
    say("phases", f"15-16 took {time.perf_counter() - t0:.1f} s; chip_smoke "
        f"{time.perf_counter() - started:.1f} s so far")

    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "lofreq_tpu"))
    check(not foreign, f"modules of jax or lofreq_tpu were imported: "
          f"{foreign[:8]}")

    def entry_line(name, source, replaces, launches, err, ms, plain, lim):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": lim[0], "bound_by": lim[1],
                # no single PyTorch call computes any of these functions
                "library_ms": None}

    k1_src = "lofreq_tpu_torch/csrc/poissbin_screen.cu"
    baq_src = "lofreq_tpu_torch/csrc/baq_hmm.cu"
    print(json.dumps({"kernels": [
        entry_line("screen_codes", k1_src,
                   "lofreq_tpu/ops/pallas_poissbin.py:43", launches,
                   max_err, ms, plain_ms, k1_bound),
        entry_line("baq_fwd", baq_src, "lofreq_tpu/ops/pallas_baq.py:104",
                   baq_launches["baq_fwd"], max(e for e, _ in baq_errs),
                   baq_ms["baq_fwd"], baq_plain_ms, baq_bound["baq_fwd"]),
        entry_line("baq_bwd", baq_src, "lofreq_tpu/ops/pallas_baq.py:165",
                   baq_launches["baq_bwd"], max(e for _, e in baq_errs),
                   baq_ms["baq_bwd"], baq_plain_ms, baq_bound["baq_bwd"]),
        entry_line("poissbin_tail", k1_src,
                   "lofreq_tpu/ops/pallas_poissbin.py:43",
                   step_launches["tail_probs"], max(step_errs),
                   col["ms"]["tail_probs"], col["plain_ms"]["tail_probs"],
                   col["bound"]["tail_probs"]),
        entry_line("fused_column_call", "lofreq_tpu_torch/csrc/fused_call.cu",
                   "lofreq_tpu/ops/pallas_fused_call.py:66",
                   step_launches["fused"], max(fused_errs),
                   col["ms"]["fused"], col["plain_ms"]["fused"],
                   col["bound"]["fused"]),
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
