"""Region-parallel calling: the reference's only parallelism strategy
(lofreq2_call_pparallel.py), rebuilt in-process.

Genome regions are binned from the BAM header (read-free chroms skipped),
the largest bin is bisected greedily until max bin < total/(2*threads),
bins run as independent call workers (multiprocessing across host cores;
each worker can additionally use the CUDA screen), per-bin test counts
are *summed globally* before the final quality filter — the same
two-phase dynamic-Bonferroni structure as the reference — and per-bin
variant lists are concatenated in BAM chromosome order.

The port's fork of lofreq_tpu/pipelines/parallel_call.py.  The binning,
the job records, the merge and the final filter keep the reference's
bodies; four things differ, all about workers that use the card:

- The reference resolves its device gate once before forking, so that
  forked workers inherit the cached decision and its link probe.  The
  port has no probe: the parent resolves the device screen in the
  workers' conf (resolve_engines), so no worker asks torch for the card.
- A CUDA context does not survive fork: a child forked after its parent
  initialised CUDA cannot use the card.  So the pool starts by spawn
  whenever a worker will run the device screen or the device BAQ on
  CUDA, and by fork (the reference's method) only when no worker touches
  the card (the host engine, --device cpu).  pool_context guards that
  choice: a fork of workers on the card, once the parent has initialised
  CUDA, raises; it neither hangs nor runs the workers on the CPU.
- A worker's screen dispatches and kernel launches are counted in its
  own process, so each job returns its share beside its lines and test
  counts, and run_parallel_regions adds them up in
  PARALLEL_DISPATCH_STATS (and the pool's start method and the workers'
  start-up times in POOL_STATS).  The records, test counts and VCF are
  the reference's.  A worker that fails to build or launch a kernel fails
  the run: nothing re-runs a bin on the host.
- The workers run in a concurrent.futures.ProcessPoolExecutor, not a
  multiprocessing.Pool: a Pool replaces a worker that dies (a spawned
  child that cannot start, say) and waits forever for its job, where the
  executor raises BrokenProcessPool.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import sys
import threading
import time
from concurrent.futures import ProcessPoolExecutor

import torch

from ..filt.filter import FilterConf, MtcFilter, run_filter
from ..io.bai import BaiIndex, build_bai
from ..io.bam import BamReader
from ..io.vcf import VcfWriter, new_header

BIN_PER_THREAD = 2

# what the workers of run_parallel_regions did, summed over their jobs
# since the last reset_parallel_stats(): device screen dispatches and the
# columns they carried (ops.screen.DISPATCH_STATS), and launches of K1's
# screen entry and of the BAQ kernels K3/K4 (cuda_poissbin, cuda_baq)
PARALLEL_DISPATCH_STATS = {"dispatched": 0, "columns": 0,
                           "screen_codes": 0, "baq_fwd": 0, "baq_bwd": 0}
# the last pool: its start method (None when the jobs ran in this
# process) and, per worker process, the seconds from the pool's start to
# the end of its first job's set-up (imports, and on the card the kernel
# library and a CUDA context)
POOL_STATS = {"start_method": None, "ready_s": []}
_stats_lock = threading.Lock()
# pid -> when this process's first-job set-up was done (see _ready); by
# pid, so that a forked child does not take its parent's entry
_READY_AT = {}


def reset_parallel_stats() -> None:
    with _stats_lock:
        for k in PARALLEL_DISPATCH_STATS:
            PARALLEL_DISPATCH_STATS[k] = 0
        POOL_STATS.update(start_method=None, ready_s=[])


def add_dispatch_stats(counts: dict) -> None:
    """Add a job's (or a process's) dispatches and launches, as _worker
    returns them, to PARALLEL_DISPATCH_STATS."""
    with _stats_lock:
        for k, v in counts.items():
            PARALLEL_DISPATCH_STATS[k] += v


def bins_from_bamheader(bam_path):
    """[(chrom, start, end)] per chromosome with mapped reads
    (bins_from_bamheader, lofreq2_call_pparallel.py:270-299)."""
    rdr = BamReader(bam_path)
    bai_path = str(bam_path) + ".bai"
    if not os.path.exists(bai_path):
        build_bai(bam_path)
    idx = BaiIndex.load(bai_path)
    bins = []
    for tid, (name, length) in enumerate(rdr.header.references):
        mapped, _un = idx.mapped_unmapped(tid)
        if mapped == 0:
            continue
        bins.append((name, 0, length))
    chrom_order = [name for name, _l in rdr.header.references]
    rdr.close()
    return bins, chrom_order


def split_bins(bins, threads):
    """Greedy bisection of the largest bin (lofreq2_call_pparallel.py:595)."""
    total = sum(e - s for _c, s, e in bins)
    if total == 0:
        return bins
    target = total / (BIN_PER_THREAD * threads)
    bins = list(bins)
    while True:
        bins.sort(key=lambda b: b[2] - b[1], reverse=True)
        chrom, s, e = bins[0]
        if (e - s) <= target or (e - s) < 2:
            break
        mid = s + (e - s) // 2
        bins[0] = (chrom, s, mid)
        bins.append((chrom, mid, e))
    return bins


def sort_bins(bins, chrom_order):
    order = {c: i for i, c in enumerate(chrom_order)}
    return sorted(bins, key=lambda b: (order.get(b[0], 1 << 30), b[1]))


def _counts() -> dict:
    from ..ops import cuda_baq, cuda_poissbin
    from ..ops.screen import DISPATCH_STATS

    return {"dispatched": DISPATCH_STATS["dispatched"],
            "columns": DISPATCH_STATS["columns"],
            "screen_codes": cuda_poissbin.launch_count("screen_codes"),
            **cuda_baq.launch_count()}


def _ready(vconf, pconf):
    """This process's set-up before its first job: on the card, the
    kernel library (built or loaded; raises if it cannot be) and a CUDA
    context.  Returns the wall-clock time it was done at on the first
    call, else None."""
    if os.getpid() in _READY_AT:
        return None
    if vconf.device_screen_on() or vconf.device_baq_on(pconf):
        from ..ops.screen import screen_ready

        dev = vconf.screen_device()
        screen_ready(dev)
        torch.zeros(1, device=dev)
    _READY_AT[os.getpid()] = time.time()
    return _READY_AT[os.getpid()]


def _worker(job):
    from ..call.caller import VarcallConf
    from ..io.bed import BedIndex
    from ..pileup.engine import PileupConf
    from .call_pipeline import run_call

    vconf = VarcallConf(**job["vconf_kw"])
    pconf = PileupConf(**job["pconf_kw"])
    ready_at = _ready(vconf, pconf)
    bed = BedIndex.read(job["bed_path"]) if job["bed_path"] else None
    region = f"{job['chrom']}:{job['start'] + 1}-{job['end']}"
    before = _counts()
    res = run_call(job["bam"], job["ref"], vconf=vconf, pconf=pconf,
                   region=region, bed=bed, ign_pos=job.get("ign_pos"))
    counts = {k: v - before[k] for k, v in _counts().items()}
    return ([v.to_line() for v in res.vars], res.stats.num_snv_tests,
            res.stats.num_indel_tests, counts, ready_at)


def make_job(bam, ref, chrom, start, end, vconf_kw, pconf_kw,
             bed_path=None, ign_pos=None):
    """Worker job record — keyed, so new fields can't be silently
    dropped by positional callers."""
    return dict(bam=str(bam), ref=str(ref), chrom=chrom, start=start,
                end=end, vconf_kw=vconf_kw, pconf_kw=pconf_kw,
                bed_path=bed_path, ign_pos=ign_pos)


def resolve_engines(vconf_kw, pconf_kw):
    """The workers' conf fields with the device screen resolved here
    (None = on where a card is present, or as LOFREQ_TPU_DEVICE_SCREEN
    says), and whether a worker will use the card: the device screen or
    the device BAQ on, on a CUDA device."""
    from ..call.caller import VarcallConf
    from ..pileup.engine import PileupConf

    vconf = VarcallConf(**vconf_kw)
    screen = vconf.device_screen_on()
    engines = screen or vconf.device_baq_on(PileupConf(**pconf_kw))
    on_card = engines and torch.device(vconf.device).type == "cuda"
    return dict(vconf_kw, use_device_screen=screen), on_card


def start_method(on_card: bool) -> str:
    """spawn when a worker will use the card, else fork."""
    return "spawn" if on_card else "fork"


def pool_context(method: str, on_card: bool):
    """The multiprocessing context to start the workers by.  Raises for
    fork with workers on the card once this process has initialised CUDA:
    the children could not use it."""
    if method == "fork" and on_card and torch.cuda.is_initialized():
        raise RuntimeError(
            "call-parallel: workers that use the CUDA card cannot be forked "
            "from a process that has initialised CUDA; start them by spawn")
    return mp.get_context(method)


def run_parallel_regions(bam_path, ref_path, vconf_kw, pconf_kw, threads,
                         bed_path=None, ign_pos=None):
    """Returns (lines-in-order, num_snv_tests, num_indel_tests).
    ign_pos: chrom -> set of 0-based positions for -S source-qual.
    Adds the workers' dispatches and launches to PARALLEL_DISPATCH_STATS."""
    bins, chrom_order = bins_from_bamheader(bam_path)
    bins = split_bins(bins, threads)
    bins = sort_bins(bins, chrom_order)
    vconf_kw, on_card = resolve_engines(vconf_kw, pconf_kw)
    jobs = [make_job(bam_path, ref_path, c, s, e, vconf_kw, pconf_kw,
                     bed_path, ign_pos) for c, s, e in bins]
    t0 = time.time()
    if threads > 1:
        method = start_method(on_card)
        ctx = pool_context(method, on_card)
        # process-parallel workers each get a single native BAQ thread —
        # region parallelism already saturates the cores.  Set before the
        # pool starts: spawned children take the environment at start
        prev = os.environ.get("LOFREQ_NATIVE_THREADS")
        os.environ["LOFREQ_NATIVE_THREADS"] = "1"
        try:
            with ProcessPoolExecutor(threads, mp_context=ctx) as ex:
                results = list(ex.map(_worker, jobs))
        finally:
            if prev is None:
                os.environ.pop("LOFREQ_NATIVE_THREADS", None)
            else:
                os.environ["LOFREQ_NATIVE_THREADS"] = prev
    else:
        method = None
        results = [_worker(j) for j in jobs]
    lines = []
    n_snv = 0
    n_indel = 0
    ready_s = []
    for ls, s, i, counts, ready_at in results:
        lines.extend(ls)
        n_snv += s
        n_indel += i
        add_dispatch_stats(counts)
        if ready_at is not None:
            ready_s.append(ready_at - t0)
    POOL_STATS.update(start_method=method, ready_s=ready_s)
    return lines, n_snv, n_indel


def load_ign_vcfs(paths: str):
    """chrom -> set of positions from a comma-separated vcf list (-S)."""
    from ..io.vcf import VcfReader

    ign = {}
    for path in paths.split(","):
        if not os.path.exists(path):
            print(f"FATAL: ign-vcf file {path} does not exist",
                  file=sys.stderr)
            raise SystemExit(1)
        with VcfReader(path) as rdr:
            for v in rdr:
                ign.setdefault(v.chrom, set()).add(v.pos)
    return ign


def run_call_parallel(args, extra) -> int:
    """CLI glue for `call-parallel` (mirrors the wrapper's restrictions:
    no -r/--plp-summary-only under the parallel driver)."""
    from ..call.caller import VarcallConf

    if args.region:
        print("FATAL: regions not allowed with call-parallel",
              file=sys.stderr)
        return 1
    if args.plp_summary_only:
        print("FATAL: --plp-summary-only not allowed with call-parallel",
              file=sys.stderr)
        return 1
    from ..cli import confs_from_args

    vconf, pconf = confs_from_args(args)
    vconf_kw = {k: getattr(vconf, k) for k in vconf.__dataclass_fields__}
    pconf_kw = {k: getattr(pconf, k) for k in pconf.__dataclass_fields__
                if k != "bed"}
    ign_pos = load_ign_vcfs(args.ign_vcf) if getattr(
        args, "ign_vcf", None) else None
    lines, n_snv, n_indel = run_parallel_regions(
        args.bam, args.ref, vconf_kw, pconf_kw, args.pp_threads,
        bed_path=args.bed, ign_pos=ign_pos,
    )
    return finalize_parallel_output(lines, n_snv, n_indel, args, vconf,
                                    tool="call-parallel")


def finalize_parallel_output(lines, n_snv, n_indel, args, vconf,
                             tool="call-parallel") -> int:
    """Merge worker VCF lines, apply the final filter with the globally
    summed test counts, emit the load-bearing counter lines."""
    from ..io.vcf import Var

    vars_ = [Var.from_line(l) for l in lines]
    header = new_header(f"lofreq_tpu {tool}", args.ref)

    cfg = FilterConf(no_defaults=args.no_default_filter)
    if vconf.bonf_dynamic:
        # mirror the wrapper script's OWN arithmetic
        # (lofreq2_call_pparallel.py:54-70,697-709): python-double
        # division, round-half-even, prob==0 -> MAXINT, bonf 0 -> 1 —
        # note round() where the C auto-filter truncates
        import math

        def _script_phred(bonf: int) -> int:
            prob = float(vconf.sig) / float(max(bonf, 1))
            if prob == 0.0:
                return 2**31 - 1
            return int(round(-10.0 * math.log10(prob)))

        cfg.snvqual = MtcFilter(thresh=_script_phred(n_snv))
        cfg.indelqual = MtcFilter(thresh=_script_phred(n_indel))
    header, out_vars = run_filter(header, vars_, cfg)
    with VcfWriter(args.out, header) as w:
        for v in out_vars:
            w.write(v)
    if str(args.out).endswith(".gz"):
        # tabix the merged output like the reference wrapper's
        # `bcftools index -t` step (lofreq2_call_pparallel.py:164-185)
        from ..io.tabix import build_tbi

        build_tbi(args.out)
    print(f"Number of substitution tests performed: {n_snv}",
          file=sys.stderr)
    print(f"Number of indel tests performed: {n_indel}", file=sys.stderr)
    return 0
