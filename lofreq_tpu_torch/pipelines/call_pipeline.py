"""The `call` pipeline: BAM -> pileup windows -> batched calling -> filter.

Counterpart of lofreq_tpu/pipelines/call_pipeline.py.  run_call and
call_and_filter are forked so that the windows go through the port's
caller (lofreq_tpu_torch.call.caller) and the device-BAQ engine uses the
port's runner (lofreq_tpu_torch.ops.device_baq); the ingest, window
builders, filters and VCF writer are the reference's own.
"""

from __future__ import annotations

import copy
import os
import sys
from collections import deque
from concurrent.futures import wait as _fwait

from lofreq_tpu.core import stagetimer
from lofreq_tpu.defaults import BAQ_SCREEN_DELTA
from lofreq_tpu.filt.filter import run_filter
from lofreq_tpu.io.bam import BamReader
from lofreq_tpu.io.fasta import Fasta
from lofreq_tpu.io.vcf import new_header
from lofreq_tpu.pileup.engine import PileupConf, read_passes_filters
from lofreq_tpu.pipelines.call_pipeline import (  # noqa: F401
    HEARTBEAT_COLS,
    WINDOW,
    CallResult,
    _borrow_executor,
    _can_use_native,
    _native_window_batches,
    _prepare_chunk,
    _return_executor,
    _window_batches,
    default_filter_conf,
    parse_region,
    write_vcf,
)

from ..call.caller import VarcallConf, call_vars_batch, confirm_snv_candidates
from ..ops.device_baq import get_runner
from ..ops.screen import screen_ready


def run_call(
    bam_path,
    ref_path,
    vconf: VarcallConf = None,
    pconf: PileupConf = None,
    region: str = None,
    bed=None,
    ign_pos=None,
    progress=None,
    native: bool = True,
) -> CallResult:
    """Run variant calling; returns unfiltered variants + stats.

    The reference's body (lofreq_tpu/pipelines/call_pipeline.py:run_call),
    with both screening engines: device BAQ when vconf.device_baq_on
    (--device-baq), else host no-BAQ.  vconf must be the port's
    VarcallConf (VarcallConf.from_reference converts a reference conf)."""
    vconf = vconf if vconf is not None else VarcallConf()
    if not isinstance(vconf, VarcallConf):
        raise TypeError("run_call needs lofreq_tpu_torch's VarcallConf; "
                        "convert with VarcallConf.from_reference")
    pconf = pconf or PileupConf()
    pconf.bed = bed
    res = CallResult()
    fa = Fasta(ref_path)
    rdr = BamReader(bam_path)
    use_native = native and _can_use_native(bam_path, ign_pos, pconf)

    if region:
        chrom, rstart, rend = parse_region(region)
        chroms = [(chrom, rstart, rend)]
    else:
        chroms = [(name, None, None) for name, _len in rdr.header.references]

    for chrom, rstart, rend in chroms:
        tid = rdr.header.tid(chrom)
        if tid < 0:
            raise ValueError(f"chromosome {chrom} not in BAM header")
        ref = fa.fetch(chrom)
        if len(ref) != rdr.header.references[tid][1]:
            raise ValueError(
                f"reference length mismatch for {chrom}: fasta "
                f"{len(ref)} vs BAM {rdr.header.references[tid][1]}"
            )

        if use_native:
            n_cols = 0
            next_beat = HEARTBEAT_COLS
            chrom_ign = None
            if ign_pos is not None and pconf.use_sq:
                chrom_ign = ign_pos.get(chrom)
            device_baq = None
            screen_ctx = None
            sweep_pconf = pconf
            # a reused conf object may carry the flags from a previous run
            vconf.baq_screen_null = False
            vconf.baq_screen_bias = 0
            if pconf.bed is None and vconf.baq_screen_config_ok(pconf) \
                    and os.environ.get(
                        "LOFREQ_TPU_BAQ_SCREEN", "1") != "0":
                if vconf.device_baq_on(pconf):
                    # device BAQ: eligible reads get f32 BAQ from the card
                    # (K3/K4), deflated by BAQ_SCREEN_DELTA in the merge;
                    # the rest keep the exact C BAQ.  The screen must be
                    # usable (screen_ready raises otherwise)
                    screen_ready(vconf.screen_device())
                    device_baq = get_runner(ext_baq=pconf.ext_baq,
                                            device=vconf.screen_device())
                    vconf.baq_screen_bias = BAQ_SCREEN_DELTA
                else:
                    # host no-BAQ screening: the sweep skips the C BAQ
                    # (its err probs are per-base lower bounds)
                    vconf.baq_screen_null = True
                    sweep_pconf = copy.copy(pconf)
                    sweep_pconf.use_baq = False
                # either way the prescreen and the sub-screen discard
                # provably insignificant columns, and candidate clusters
                # are re-scored with the exact C BAQ
                screen_ctx = []
            # window confirms run concurrently with later windows' ingest
            # and screen; results drain FIFO, so res.vars stays in order
            CONF_PIPE = int(os.environ.get("LOFREQ_TPU_CONFIRM_PIPE", "3"))
            conf_ex = _borrow_executor(max(CONF_PIPE, 1)) \
                if screen_ctx is not None else None

            def _timed_confirm(cands, raw):
                with stagetimer.stage("confirm"):
                    return confirm_snv_candidates(
                        rdr, tid, chrom, ref, pconf, vconf, cands,
                        ign_pos=chrom_ign, raw=raw)

            pending = deque()  # (vs, fut|None, n_cols, last_pos)

            def _drain_one():
                nonlocal n_cols, next_beat
                vs, fut, ncols_b, last_pos = pending.popleft()
                if fut is not None:
                    with stagetimer.stage("confirm_wait"):
                        confirmed = fut.result()
                    # indels before SNVs at one position (stable sort)
                    vs = sorted(vs + confirmed, key=lambda v: v.pos)
                res.vars.extend(vs)
                n_cols += ncols_b
                if n_cols >= next_beat:
                    print(f"Alive and happily crunching away on pos "
                          f"{last_pos + 1} of {chrom}...",
                          file=sys.stderr)
                    next_beat += HEARTBEAT_COLS
                if progress:
                    progress(chrom, last_pos)

            try:
                for batch in _native_window_batches(
                        rdr, tid, chrom, ref, sweep_pconf,
                        rstart, rend, window=WINDOW, vconf=vconf,
                        ign_pos=chrom_ign, device_baq=device_baq,
                        keep_raw=screen_ctx is not None):
                    vs = call_vars_batch(batch, vconf, res.stats,
                                         screen_ctx=screen_ctx)
                    fut = None
                    if screen_ctx:
                        fut = conf_ex.submit(_timed_confirm,
                                             list(screen_ctx),
                                             getattr(batch, "raw", None))
                        screen_ctx.clear()
                    pending.append((vs, fut, len(batch.positions),
                                    int(batch.positions[-1])))
                    while len(pending) > CONF_PIPE:
                        _drain_one()
                while pending:
                    _drain_one()
            finally:
                if conf_ex is not None:
                    # recycled, not shut down: drain this run's confirm
                    # futures first
                    _fwait([f for _vs, f, _n, _p in pending
                            if f is not None])
                    _return_executor(max(CONF_PIPE, 1), conf_ex)
            continue

        if region:
            reads = rdr.fetch(chrom, rstart, rend)
        else:
            reads = rdr.fetch(chrom)

        def filtered_reads():
            for r in reads:
                if not read_passes_filters(r, pconf, chrom):
                    continue
                if r.mapq > pconf.max_mq:
                    r.mapq = pconf.max_mq
                yield r

        # per-chrom ignore set (ign_pos is a chrom -> set-of-positions map)
        chrom_ign_py = ign_pos.get(chrom) if ign_pos else None

        def prepared_reads():
            # attach BAQ/IDAQ/SQ tags window-wise for batching
            CHUNK = 2000
            chunk = []
            for r in filtered_reads():
                chunk.append(r)
                if len(chunk) >= CHUNK:
                    yield from _prepare_chunk(chunk, ref, pconf,
                                              chrom_ign_py)
                    chunk = []
            if chunk:
                yield from _prepare_chunk(chunk, ref, pconf, chrom_ign_py)

        for batch in _window_batches(prepared_reads(), chrom, ref, pconf,
                                     rstart, rend, window=WINDOW):
            vs = call_vars_batch(batch, vconf, res.stats)
            res.vars.extend(vs)
            if progress:
                progress(chrom, int(batch.positions[-1]))

    res.header = ""
    return res


def call_and_filter(
    bam_path, ref_path, out_path, vconf=None, pconf=None,
    no_default_filter=False, src=None, **kw
):
    """Full default `call` flow: call, then filter with dynamic-bonf
    thresholds (+ default filters unless no_default_filter).  `src` is
    the ##source= header payload."""
    vconf = vconf if vconf is not None else VarcallConf()
    res = run_call(bam_path, ref_path, vconf=vconf, pconf=pconf, **kw)
    if src is None:
        src = "lofreq_tpu call"
    header = new_header(src, str(ref_path))

    if no_default_filter and not vconf.bonf_dynamic:
        write_vcf(out_path, res.vars, header)
        return res

    cfg = default_filter_conf(vconf, no_default_filter)
    header, vars_ = run_filter(header, res.vars, cfg)
    write_vcf(out_path, vars_, header)
    res.vars = vars_
    return res
