"""The benchmark of lofreq_tpu_torch: one cell of BENCHMARK.json per run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A cell names a configuration (portbench/configs/<config>.json: the
deployment's genome, reads and samples) and a traffic mix
(portbench/traffic/<traffic>.json: the call's options, nothing else).  The run makes the samples from the seed (or reuses them
from portbench/.cache/inputs), warms up one call of each, then calls
lofreq_tpu_torch's `call_and_filter` (BAM -> screen -> confirm -> filter
-> VCF on disk) in a closed loop, one call at a time, round robin over
the samples, for --seconds.  Every call's VCF records and SNV tests are
then compared with the plain reference (portbench/reference), and the
last line of standard output is the JSON result.

--trace 0 reports the cell's end-to-end metrics, --trace 1 its per-layer
metrics, each read from the run's record by portbench/metrics/<name>.py.
The run needs a CUDA card and never falls back to the CPU.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, not portbench/, is where imports resolve
sys.path[0] = ROOT

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "lofreq_tpu")
# what a traffic mix may set: a key that nothing reads is refused
TRAFFIC_KEYS = {"why", "varcall"}


def set_cache_dirs(cache: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout.
    (The port keeps its own libraries in lofreq_tpu_torch/csrc/build.)"""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def find_cell(bench: dict, workload: str, root: str = ROOT):
    """(cell, configuration dict, traffic dict) of a workload, by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, cfg_entry["file"])) as fh:
        cfg = json.load(fh)
    with open(os.path.join(root, "portbench", "traffic",
                           cell["traffic"] + ".json")) as fh:
        traffic = json.load(fh)
    unknown = set(traffic) - TRAFFIC_KEYS
    if unknown:
        raise ValueError(f"traffic {cell['traffic']!r}: keys "
                         f"{sorted(unknown)} are read by nothing")
    return cell, cfg, traffic


def metric_reader(name: str):
    """portbench/metrics/<name>.py's read(record)."""
    return importlib.import_module(f"portbench.metrics.{name}").read


def roofline_modules() -> dict:
    """{function: module} of every portbench/roofline/<function>.py."""
    d = os.path.dirname(importlib.import_module("portbench.roofline").__file__)
    return {f[:-3]: importlib.import_module(f"portbench.roofline.{f[:-3]}")
            for f in sorted(os.listdir(d))
            if f.endswith(".py") and not f.startswith("_")}


def metrics_of(bench: dict, workload: str, trace: bool) -> list:
    """The cell's metric entries for this kind of run."""
    kind = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in kind if workload in m.get("workloads", [workload])]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is jax's or the JAX package's."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def card(chips: int) -> dict:
    import torch

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        power = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        power = None
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": 0,
            "cards_present": torch.cuda.device_count(),
            "power_limit_w": power}


def host_clock() -> dict:
    """The wall and the process's CPU seconds."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    return dict(wall=time.perf_counter(), cpu=ru.ru_utime + ru.ru_stime)


def host_probe() -> float:
    """Milliseconds for one thread to deflate a fixed 1 MB at level 6,
    the best of three: how fast the host's cores are at this moment."""
    import zlib

    import numpy as np

    buf = np.random.default_rng(0).choice(
        np.frombuffer(b"ACGT", np.uint8), 1 << 20).tobytes()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        zlib.compress(buf, 6)
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def host_line(a: dict, b: dict, probes: tuple) -> str:
    """What the host gave the window: the cores the process kept busy,
    and the probe before and after it, to tell a slower host from a
    program that waits."""
    import threading

    wall = b["wall"] - a["wall"]
    cpu = b["cpu"] - a["cpu"]
    return (f"portbench: host in the window: {cpu:.3f} cpu s over "
            f"{wall:.3f} s ({cpu / wall:.3f} cores), "
            f"{threading.active_count()} threads, {os.cpu_count()} cpus; "
            f"probe {probes[0]:.2f} ms before, {probes[1]:.2f} ms after")


def verdict(checks: dict) -> bool:
    """`correct`: every number compared within its limit."""
    return all(c["value"] <= c["limit"] for c in checks.values())


def vcf_records(path: str):
    """The record lines of a VCF, or None when the call wrote none."""
    try:
        with open(path) as fh:
            return [ln.rstrip("\n") for ln in fh if not ln.startswith("#")]
    except FileNotFoundError:
        return None


def compare(calls: list, cfg: dict, seed: int, device: str, drawn=None,
            steps: dict = None) -> dict:
    """The numbers that decide `correct`, each with its limit: every
    call's records and SNV tests against the reference's for its
    sample.  drawn: the samples as made for the run, else drawn again;
    `steps` gets the reference's seconds by step."""
    import torch

    from portbench.gen import inputs
    from portbench.reference import lofreq as REF

    t0 = time.perf_counter()
    if drawn is None:
        drawn = inputs.draw_all(cfg, seed)
    if steps is not None:
        steps["draw"] = time.perf_counter() - t0
    used = sorted({c["sample"] for c in calls})
    want = dict(zip(used, REF.call_many(
        [drawn[j] for j in used], cfg["chrom"], device=device,
        dtype=torch.float64, p_floor="longdouble", times=steps)))
    rec_diff = tests_diff = missing = failed = 0
    for c in calls:
        lines, tests = want[c["sample"]]
        if c["records"] is None:
            missing += 1
            failed += 1
            continue
        d = len(set(c["records"]) ^ set(lines)) \
            + abs(len(c["records"]) - len(set(c["records"])))
        t = abs(c["tests"] - tests)
        rec_diff += d
        tests_diff += t
        failed += bool(d or t)
    return dict(failed=failed, checks={
        "records_differing": {"value": rec_diff, "limit": 0},
        "snv_tests_differing": {"value": tests_diff, "limit": 0},
        "calls_without_vcf": {"value": missing, "limit": 0}})


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", root: str = ROOT, out=print):
    """One run of a cell; returns (exit code, result dict or None)."""
    import torch

    bench = load_benchmark(root)
    cell, cfg, traffic = find_cell(bench, workload, root)
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell["chips"]):
        print(f"portbench: {workload} needs {cell['chips']} CUDA card(s); "
              f"this host has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3, None
    set_cache_dirs(os.path.join(root, "portbench", ".cache"))
    from portbench.gen import inputs

    samples, gen_s, drawn = inputs.prepare(
        cfg, cell["config"], seed, os.path.join(root, "portbench", ".cache",
                                                "inputs"))
    out(f"portbench: inputs of {cell['config']} seed {seed}: "
        + ("reused" if drawn is None else f"generated in {gen_s:.3f} s"))

    from lofreq_tpu_torch.call.caller import VarcallConf
    from lofreq_tpu_torch.core import stagetimer
    from lofreq_tpu_torch.ops import screen
    from lofreq_tpu_torch.pipelines.call_pipeline import call_and_filter

    outdir = os.path.join(root, "portbench", ".cache", "out")
    os.makedirs(outdir, exist_ok=True)
    vcf = os.path.join(outdir, f"{workload}.vcf")
    varcall = dict(traffic.get("varcall", {}))
    order = list(range(len(samples)))           # one round of calls

    def one_call(j):
        if os.path.exists(vcf):
            os.remove(vcf)
        s = samples[j]
        t0 = time.perf_counter()
        try:
            res = call_and_filter(s["bam"], s["fa"], vcf,
                                  vconf=VarcallConf(device=device, **varcall))
            tests = res.stats.num_snv_tests
        except Exception as exc:  # a failed call is counted, not fatal
            print(f"portbench: call of sample {j} failed: {exc!r}",
                  file=sys.stderr)
            tests = -1
        t1 = time.perf_counter()
        return dict(sample=j, t0=t0, t1=t1, tests=tests,
                    records=vcf_records(vcf) if tests >= 0 else None)

    # one warm call, of the largest sample: it sizes the port's pools
    one_call(max(order, key=lambda j: os.path.getsize(samples[j]["bam"])))
    if device == "cuda":
        torch.cuda.synchronize()
    probe_open = host_probe()

    tracer = None
    if trace:
        from portbench.tracing import Tracer

        tracer = Tracer(roofline_modules())
        tracer.install()
    stagetimer.reset()
    for k in screen.DISPATCH_STATS:
        screen.DISPATCH_STATS[k] = 0
    calls = []
    if tracer:
        tracer.start()
    host_open = host_clock()
    t_open = host_open["wall"]
    setup_s = t_open - T_START
    # whole rounds: the window ends with the round in which it passes
    # `seconds`, so every sample weighs alike in the rate
    while not calls or calls[-1]["t1"] - t_open < seconds:
        calls.extend(one_call(j) for j in order)
    t_close = calls[-1]["t1"]
    host_close = host_clock()
    if tracer:
        tracer.stop()
        tracer.uninstall()
    window_s = t_close - t_open
    secs = sorted(c["t1"] - c["t0"] for c in calls)
    out(f"portbench: {len(calls)} calls in {window_s:.3f} s, call seconds "
        f"min {secs[0]:.4f} median {secs[len(secs) // 2]:.4f} "
        f"max {secs[-1]:.4f}; first {calls[0]['t1'] - calls[0]['t0']:.4f} "
        f"last {calls[-1]['t1'] - calls[-1]['t0']:.4f}")
    out(host_line(host_open, host_close, (probe_open, host_probe())))

    dev = card(cell["chips"]) if device == "cuda" else {
        "platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if device == "cuda":
        dev["memory_peak_bytes"] = int(max(
            torch.cuda.max_memory_allocated(d)
            for d in range(cell["chips"])))
    if tracer:
        rec = tracer.record(len(calls), window_s, t_open, t_close)
        rec["dispatch"] = dict(screen.DISPATCH_STATS)
        dev["busy_s"] = rec["busy_s"]
        dev["window_s"] = window_s
    else:
        rec = dict(setup_s=setup_s, calls=len(calls), window_s=window_s,
                   call_s=[c["t1"] - c["t0"] for c in calls],
                   cols=[samples[c["sample"]]["cols"] for c in calls])
    metrics = {}
    for m in metrics_of(bench, workload, trace):
        v = metric_reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # the program's cached card memory goes before the reference runs
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    steps = {}
    cmp = compare(calls, cfg, seed, device, drawn, steps)
    out(f"portbench: reference of {len({c['sample'] for c in calls})} "
        f"sample(s) in {time.perf_counter() - t_ref:.3f} s: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in steps.items()))
    checks = cmp["checks"]
    correct = len(calls) > 0 and verdict(checks)
    result = {"correct": correct, "attempted": len(calls),
              "failed": cmp["failed"], "metrics": metrics, "device": dev}
    if tracer:
        result["breakdown"] = rec["breakdown"]
    result["checks"] = checks
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4, None
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    return 0, result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    code, result = run(a.workload, a.seed, a.seconds, bool(a.trace))
    if result is not None:
        sys.stdout.flush()
        print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
