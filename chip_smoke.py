#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lofreq_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero before the result:
1. the card: torch.cuda must be available; its name and power limit;
2. build: the CUDA kernels are compiled from lofreq_tpu_torch/csrc with
   nvcc (sm_90a) into lofreq_tpu_torch/csrc/build/;
3. kernel vs plain: the screen kernel (K1) against its plain PyTorch
   version on the card, at [4096, 128] and at a ragged [292, 128];
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
8. device-BAQ path: the port's `call --device-baq` (run_call with
   use_device_baq, K3/K4 in the runner, K1 in the sub-screen) on the same
   workload.  The counted run must launch K1, K3 and K4, and its runner
   must have taken every eligible read that lfq_extract_reads flagged;
   every run must give the host-screen path's records and test count.
   Then BAQ_PAIRS pairs of walls in turns against the host path, with
   median stages, and one profiled call;
9. timings at the runner's batch shape: K3's and K4's device time per
   launch (profiler) and the plain HMM's time per call (CUDA events).
Then a JSON line of the kernels, the card line, and as the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType

REPO = os.path.dirname(os.path.abspath(__file__))
GENOME, DEPTH, SEED = 200_000, 800, 3   # bench.py's workload
TAIL_TOL = 1e-4   # |log tail| abs; f32 DP: exp2f/logf ulps + FMA vs mul-add
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
BAQ_KERNELS = {"baq_fwd": "baq_fwd_kernel", "baq_bwd": "baq_bwd_kernel"}


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


def kernel_us(dev: dict, name: str = KERNEL_NAME):
    """(launches, device µs) of a kernel in a profile, or None if absent."""
    hits = [v for k, v in dev.items() if name in k]
    if not hits:
        return None
    return sum(n for n, _ in hits), sum(us for _, us in hits)


def per_launch_ms(dev: dict, name: str, reps: int) -> float:
    """Device ms per launch of `name` over a profiled window of `reps`
    launches.  The profiler drops a record of a window (it saw 499 of
    500 K1 launches and 19 of 20 K3 launches on an H100), so the mean is
    over the launches it saw, and one launch or 1% of them, whichever is
    more, may be missing."""
    hit = kernel_us(dev, name)
    check(hit is not None and reps - max(1, reps // 100) <= hit[0] <= reps,
          f"profile saw {hit} launches of {name}, want {reps}")
    return hit[1] / hit[0] / 1e3


def screen_inputs(rng, B: int):
    """Seeded codes [B, 128] (30% padding), ks 1..24, log_thresh."""
    codes = rng.integers(16, 160, (B, 128)).astype(np.uint8)
    codes[rng.random((B, 128)) < 0.3] = 255
    ks = rng.integers(1, 25, B).astype(np.int32)
    lt = rng.uniform(-40.0, -1.0, B).astype(np.float32)
    return [torch.from_numpy(a).cuda() for a in (codes, ks, lt)]


def kernel_vs_plain(cp, rng, B: int) -> float:
    codes, ks, lt = screen_inputs(rng, B)
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
    say("kernel", f"B={B}: max |dtail| {err:.3g} over {int(above.sum())} "
        f"rows above the floor; {int(near.sum())} rows within {TAIL_TOL} "
        f"of the threshold ({int(diff.sum())} of them differ); "
        f"{int(mask_k.sum())} candidates")
    return err


def time_shape(cp, rng, B: int):
    """(K1 ms per launch, plain ms per call) at [B, 128]."""
    codes, ks, lt = screen_inputs(rng, B)

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
        f"(CUDA events, median of {PLAIN_WINDOWS} windows of {PLAIN_REPS})")
    return ms, plain_ms


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


def baq_vs_plain(ca, bt, rng, B: int, L: int, Lr: int):
    """K3 alone vs the plain forward pass, then K3 + K4 vs the plain HMM,
    at [B, L] with windows of Lr.  Returns (K3 max |row diff|, K4 max
    |dq|)."""
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
    return row_err, float(dq)


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


def records(res):
    return [(v.pos, v.ref, v.alt, v.qual, v.info) for v in res.vars]


def median_stages(reports):
    keys = sorted({k for r in reports for k in r})
    return {k: round(statistics.median(r.get(k, 0.0) for r in reports), 4)
            for k in keys}


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA card")
    sys.path.insert(0, REPO)
    from lofreq_tpu_torch import _kernel_build
    from lofreq_tpu_torch.ops import baq_torch as bt
    from lofreq_tpu_torch.ops import cuda_baq as ca
    from lofreq_tpu_torch.ops import cuda_poissbin as cp
    from lofreq_tpu_torch.ops import device_baq, screen

    card = card_line()
    say("card", f"{card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    screen.screen_ready("cuda")
    build_s = time.perf_counter() - t0
    regs = [ln.strip() for ln in _kernel_build.build_log().splitlines()
            if "registers" in ln or "spill" in ln]
    say("build", f"{build_s:.3f} s -> "
        f"{os.path.relpath(_kernel_build.library_path(), REPO)}; "
        + " | ".join(regs))

    rng = np.random.default_rng(SEED)
    max_err = max(kernel_vs_plain(cp, rng, B) for B in (4096, 292))
    baq_errs = [baq_vs_plain(ca, bt, rng, *shape) for shape in BAQ_SHAPES]

    from lofreq_tpu_torch.call.caller import VarcallConf
    from lofreq_tpu_torch.pipelines.call_pipeline import run_call, stagetimer

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from simulate_fast import simulate_fast

    def reset_counts():
        cp.reset_launch_count()
        ca.reset_launch_count()
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

    def report_profile(name, prof_wall, dev):
        total_us = sum(us for _, us in dev.values())
        say("profile", f"one {name} call: wall {prof_wall:.4f} s, device "
            f"time {total_us:.1f} us, busy share "
            f"{total_us / 1e6 / prof_wall:.6f}; " + "; ".join(
                f"{k[:60]} n={n} {us:.1f} us" for k, (n, us) in
                sorted(dev.items(), key=lambda kv: -kv[1][1])[:8]))

    with tempfile.TemporaryDirectory() as td:
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
        prof_res, prof_wall, dev = device_profile(device_path)
        check(records(prof_res) == records(want), "profiled run differs")
        report_profile("device-path", prof_wall, dev)

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
        report_profile("device-BAQ", prof_wall, dev)

    mean_b = max(1, round(stats["columns"] / stats["dispatched"]))
    ms, plain_ms = time_shape(cp, rng, mean_b)
    time_shape(cp, rng, 4096)
    baq_ms, baq_plain_ms = time_baq(ca, bt, rng, *BAQ_SHAPES[0])
    check("jax" not in sys.modules, "jax was imported")

    baq_src = "lofreq_tpu_torch/csrc/baq_hmm.cu"
    print(json.dumps({"kernels": [{
        "name": "screen_codes",
        "route": "cuda",
        "source": "lofreq_tpu_torch/csrc/poissbin_screen.cu",
        "replaces": "lofreq_tpu/ops/pallas_poissbin.py:43",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }, {
        "name": "baq_fwd",
        "route": "cuda",
        "source": baq_src,
        "replaces": "lofreq_tpu/ops/pallas_baq.py:104",
        "launches": baq_launches["baq_fwd"],
        "max_abs_err": max(e for e, _ in baq_errs),
        "ms": baq_ms["baq_fwd"],
        "plain_ms": baq_plain_ms,
    }, {
        "name": "baq_bwd",
        "route": "cuda",
        "source": baq_src,
        "replaces": "lofreq_tpu/ops/pallas_baq.py:165",
        "launches": baq_launches["baq_bwd"],
        "max_abs_err": max(e for _, e in baq_errs),
        "ms": baq_ms["baq_bwd"],
        "plain_ms": baq_plain_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
