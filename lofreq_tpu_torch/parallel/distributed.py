"""Multi-process / multi-card execution helpers on torch.distributed.

Counterpart of lofreq_tpu/parallel/distributed.py, with its design (the
genome is the long axis):
  * Processes: contiguous region bins assigned round-robin per process by
    the greedy-bisection scheduler; each process streams its regions'
    reads from its BAM replica (BAI random access), like the reference's
    process-parallel wrapper but across processes and hosts.
  * Cards of one process: column batches split into contiguous blocks
    over the cards the process drives (local_mesh):
    ops.device_call.build_sharded_column_call, and the production screen
    (ops/screen.py).  The sharded step's tested-column count is summed
    over its blocks and all-reduced over the process group, the
    reference's psum.
  * Global reduction: per-process (num_snv_tests, num_indel_tests)
    counters are summed by one all-reduce, so the final dynamic-Bonferroni
    threshold is identical on every process.
  * Output: each process writes its regions' VCF shard; process 0 merges
    the shards, re-sorts them into genome order and filters.

Backends and cards.  The process group's CPU tensors (the counters) go
over Gloo.  CUDA tensors go over NCCL where every rank can have a card of
its own, and over Gloo otherwise: NCCL refuses two ranks on one card, and
a rank cannot see before it joins how many others share its host, so it
takes NCCL only when all num_processes ranks could each have a card of
this host (backend_for).  A rank whose device is the unindexed "cuda"
drives card process_id % torch.cuda.device_count() (rank_device): ranks
on one host with as many cards as ranks get a card each; with fewer
cards, ranks share them, each with its own CUDA context.  Every wait
(joining, and each collective) ends after timeout() with an error, so a
missing rank fails the run instead of hanging it.

Everything here degrades to a single process (no process group), where
the counters pass through and the process drives every local card.
"""

from __future__ import annotations

import datetime
import os
import sys
from typing import NamedTuple

import torch
import torch.distributed as dist

# seconds a rank waits for the others, to join and at each collective,
# before it fails; the counter all-reduce waits for the slowest rank's
# regions, so this bounds one rank's calling time too
TIMEOUT_S = 1800.0


def timeout() -> datetime.timedelta:
    """The process group's timeout: LOFREQ_TPU_DIST_TIMEOUT seconds, else
    TIMEOUT_S."""
    return datetime.timedelta(seconds=float(
        os.environ.get("LOFREQ_TPU_DIST_TIMEOUT", TIMEOUT_S)))


def world():
    """(rank, world size) of this process: (0, 1) without a process
    group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def rank_device(device, process_id: int) -> torch.device:
    """The device of process `process_id`: the unindexed "cuda" becomes
    card process_id % torch.cuda.device_count(); an indexed card or the
    CPU stays as it is."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", process_id % torch.cuda.device_count())
    return dev


def backend_for(device, num_processes: int) -> str:
    """"cpu:gloo,cuda:nccl" when the ranks run on the unindexed "cuda"
    and there are no more of them than this host has cards, so that
    rank_device gives each its own card; "gloo" otherwise."""
    dev = torch.device(device)
    if (dev.type == "cuda" and dev.index is None
            and torch.cuda.is_available() and dist.is_nccl_available()
            and num_processes <= torch.cuda.device_count()):
        return "cpu:gloo,cuda:nccl"
    return "gloo"


def initialize(coordinator: str = None, num_processes: int = None,
               process_id: int = None, device="cpu") -> bool:
    """torch.distributed.init_process_group over tcp://coordinator (a
    no-op, returning False, for one process).  `device` is where the
    device engines run: a rank on the unindexed "cuda" makes its card
    (rank_device) the current one before it joins."""
    if num_processes is None:
        num_processes = int(os.environ.get("LOFREQ_TPU_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return False
    if coordinator is None or process_id is None:
        raise ValueError("call-distributed over several processes needs "
                         "--coordinator host:port and --process-id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process-id {process_id} is not in "
                         f"[0, {num_processes})")
    dev = rank_device(device, process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend_for(device, num_processes),
        init_method=f"tcp://{coordinator}", rank=process_id,
        world_size=num_processes, timeout=timeout())
    return True


def local_mesh(device="cuda") -> list:
    """The devices this process drives: for the unindexed "cuda", the
    first p local cards, p the largest power of two not above their count
    (as lofreq_tpu/ops/screen.py:_local_mesh takes them), or, for a rank
    of a process group of several, its own card (rank_device); an indexed
    card or the CPU alone otherwise."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return [dev]
    rank, size = world()
    if size > 1:
        return [rank_device(dev, rank)]
    p = 1
    while p * 2 <= torch.cuda.device_count():
        p *= 2
    return [torch.device("cuda", i) for i in range(p)]


def column_blocks(n_cols: int, n_blocks: int) -> list:
    """[(lo, hi)]: n_cols columns split into n_blocks contiguous blocks in
    column order, their sizes within one of each other (a block may be
    empty when there are fewer columns than blocks)."""
    bounds = [n_cols * i // n_blocks for i in range(n_blocks + 1)]
    return list(zip(bounds[:-1], bounds[1:]))


class GlobalMesh(NamedTuple):
    rank: int
    world_size: int
    local: list


def global_mesh(device="cuda") -> GlobalMesh:
    """This process's rank, the world size and its local devices."""
    rank, size = world()
    return GlobalMesh(rank, size, local_mesh(device))


def host_region_assignment(bins, num_hosts: int, host_id: int):
    """Round-robin contiguous assignment of region bins to hosts, keeping
    genome order within each host (so shard concatenation stays sorted)."""
    return [b for i, b in enumerate(bins) if i % num_hosts == host_id]


def allreduce_counters(local_counts):
    """Sum per-PROCESS integer counters across the process group (and act
    as a barrier).  local_counts: dict[str, int].  One all-reduce of an
    int64 CPU tensor, over Gloo: exact, where the reference sums float64
    and rounds."""
    if world()[1] == 1:
        return dict(local_counts)
    keys = sorted(local_counts)
    vals = torch.tensor([int(local_counts[k]) for k in keys],
                        dtype=torch.int64)
    dist.all_reduce(vals)
    return {k: int(v) for k, v in zip(keys, vals.tolist())}


def run_distributed_call(bam_path, ref_path, vconf_kw, pconf_kw,
                         out_prefix, threads_per_host=1):
    """Multi-process region-parallel call: each process calls its
    assigned bins in turn, writes `{out_prefix}.shard{pid}.vcf`, and the
    test counters are all-reduced.  Returns the shard, the global test
    counts, this process's record count, its screen dispatches and kernel
    launches (`counts`, also added to
    pipelines.parallel_call.PARALLEL_DISPATCH_STATS) and the wall-clock
    time its first job's set-up was done (`ready_at`)."""
    from ..pipelines.parallel_call import (
        PARALLEL_DISPATCH_STATS,
        _worker,
        add_dispatch_stats,
        bins_from_bamheader,
        make_job,
        sort_bins,
        split_bins,
    )

    pid, nproc = world()
    bins, chrom_order = bins_from_bamheader(bam_path)
    bins = sort_bins(split_bins(bins, max(threads_per_host * nproc, 1)),
                     chrom_order)
    mine = host_region_assignment(bins, nproc, pid)

    lines = []
    n_snv = 0
    n_indel = 0
    counts = dict.fromkeys(PARALLEL_DISPATCH_STATS, 0)
    ready_at = None
    for chrom, s, e in mine:
        ls, a, b, c, r = _worker(make_job(bam_path, ref_path, chrom, s, e,
                                          vconf_kw, pconf_kw))
        lines.extend(ls)
        n_snv += a
        n_indel += b
        for k, v in c.items():
            counts[k] += v
        if ready_at is None:
            ready_at = r
    add_dispatch_stats(counts)

    # write the shard BEFORE the counter all-reduce: the blocking
    # collective then doubles as the barrier that guarantees every
    # process's shard is on disk when process 0 merges
    shard_path = f"{out_prefix}.shard{pid}.vcf"
    tmp_path = shard_path + ".part"
    with open(tmp_path, "w") as fh:
        for l in lines:
            fh.write(l + "\n")
    os.replace(tmp_path, shard_path)
    totals = allreduce_counters({"snv": n_snv, "indel": n_indel})
    return dict(shard=shard_path, num_snv_tests=totals["snv"],
                num_indel_tests=totals["indel"], n_local_vars=len(lines),
                counts=counts, ready_at=ready_at)


def run_call_distributed(args, extra) -> int:
    """CLI glue for `call-distributed`: multi-process region-parallel
    calling over torch.distributed.  Each process calls its assigned bins
    and writes a VCF shard; counters are all-reduced; process 0 merges
    shards in genome order and applies the final global-Bonferroni filter
    (requires a shared filesystem for the shards, like the reference's
    parallel wrapper's tmp dir).  A device engine asked for on a host
    without a card raises before the process joins or calls anything."""
    from ..cli import confs_from_args
    from ..io.bam import BamReader
    from ..pipelines.parallel_call import (finalize_parallel_output,
                                           resolve_engines)

    if args.region:
        print("FATAL: regions not allowed with call-distributed",
              file=sys.stderr)
        return 1
    vconf, pconf = confs_from_args(args)
    vconf_kw = {k: getattr(vconf, k) for k in vconf.__dataclass_fields__}
    pconf_kw = {k: getattr(pconf, k) for k in pconf.__dataclass_fields__
                if k != "bed"}
    vconf_kw, on_card = resolve_engines(vconf_kw, pconf_kw)
    if on_card:
        vconf.screen_device()
    started = initialize(args.coordinator, args.num_processes,
                         args.process_id,
                         device=vconf.device if on_card else "cpu")
    try:
        pid, nproc = world()
        if started and on_card:
            vconf_kw["device"] = str(rank_device(vconf.device, pid))
        prefix = str(args.out) + ".tmp"
        info = run_distributed_call(args.bam, args.ref, vconf_kw, pconf_kw,
                                    prefix,
                                    threads_per_host=args.threads_per_host)
        if pid != 0:
            return 0

        lines = []
        for p in range(nproc):
            shard = f"{prefix}.shard{p}.vcf"
            with open(shard) as fh:
                lines.extend(l.rstrip("\n") for l in fh if l.strip())
            os.remove(shard)
        # shards interleave bins round-robin -> re-sort into genome order
        rdr = BamReader(args.bam)
        order = {name: i for i, (name, _l) in
                 enumerate(rdr.header.references)}
        rdr.close()
        lines.sort(key=lambda l: (order.get(l.split("\t", 2)[0], 1 << 30),
                                  int(l.split("\t", 2)[1])))
        return finalize_parallel_output(lines, info["num_snv_tests"],
                                        info["num_indel_tests"], args,
                                        vconf, tool="call-distributed")
    finally:
        if started:
            dist.destroy_process_group()
