"""The `call` pipeline: BAM -> pileup windows -> batched calling -> filter.

In-process equivalent of main_call + mpileup + auto-filter
(lofreq_call.c:1006-1588).  Reads stream through position windows; each
window becomes a ColumnBatch processed by the batched caller; the default
filter chain runs in-process at the end.

The port's copy of lofreq_tpu/pipelines/call_pipeline.py.  Every body is
the reference's apart from run_call, whose screening engines run on the
port's torch device: the device screen (K1) and the device-BAQ runner
(K3/K4) on VarcallConf.device, and what the tracer (core/stagetimer.py)
needs: each call's root span, the stages `call.batch`, `filter` and
`vcf_write`, and the window builds, raw prefetch and confirms submitted
under the call's context, so that their spans carry its id.
"""

from __future__ import annotations

import contextvars
import copy
import os
import sys
from collections import deque
from concurrent.futures import wait as _fwait
from dataclasses import dataclass, field

import numpy as np

from .. import defaults as D
from ..call.caller import (
    CallStats,
    VarcallConf,
    call_vars_batch,
    confirm_snv_candidates,
)
from ..core import stagetimer
from ..defaults import BAQ_SCREEN_DELTA
from ..core.phred import prob_to_phred
from ..filt.filter import FilterConf, MtcFilter, run_filter
from ..io.bam import BamReader
from ..io.fasta import Fasta
from ..io.vcf import VcfWriter, new_header
from ..pileup.engine import PileupConf, compile_columns, read_passes_filters, rows_from_reads
from ..pileup.sourcequal import compute_source_quals
from ..ops.device_baq import get_runner
from ..ops.screen import screen_ready

#: position-window width of the streaming pileup.  12.5 kb measured
#: fastest after the r5 pipeline changes (rotated-order sweep
#: 6.25k/8k/12.5k/25k/37.5k/50k on the 4-core host: the cheaper sweeps +
#: executor confirms + span-cached inflation made deeper pipelining win —
#: 25 kb had been optimal before; med 4.9s -> 3.2s, best 1.76s at the
#: bench workload).  Output is window-size-invariant (asserted in the
#: invariance test and by the differentials).
WINDOW = int(__import__("os").environ.get("LOFREQ_TPU_WINDOW", "12500"))
HEARTBEAT_COLS = 100_000  # progress log cadence (cf. plp.c:1434-1438)


@dataclass
class CallResult:
    vars: list = field(default_factory=list)
    stats: CallStats = field(default_factory=CallStats)
    header: str = ""


def parse_region(region: str):
    """chrom[:start-end], 1-based inclusive like samtools."""
    if ":" not in region:
        return region, None, None
    chrom, rng = region.rsplit(":", 1)
    if "-" in rng:
        s, e = rng.split("-")
        return chrom, int(s.replace(",", "")) - 1, int(e.replace(",", ""))
    return chrom, int(rng.replace(",", "")) - 1, None


def _window_batches(reads_iter, chrom, ref, pconf: PileupConf,
                    region_start=None, region_end=None, window=WINDOW):
    """Yield ColumnBatch objects over position windows of one chromosome.

    reads_iter must be position-sorted reads of a single chromosome that
    already passed read-level filters (and have sq/BAQ tags attached).
    """
    buf = []
    win_start = None
    pending = None

    def flush(win_s, win_e, reads):
        rows = rows_from_reads(reads, pconf)
        if len(rows.pos) == 0:
            return None
        keep = (rows.pos >= win_s) & (rows.pos < win_e)
        if region_start is not None:
            keep &= rows.pos >= region_start
        if region_end is not None:
            keep &= rows.pos < region_end
        if pconf.bed is not None:
            keep &= pconf.bed.overlap_mask(chrom, rows.pos)
        if not np.any(keep):
            return None
        for name in ("pos", "nt4", "bq", "baq", "mq", "sq", "strand",
                     "is_del", "is_refskip", "is_head", "is_tail", "indel",
                     "iq", "dq", "iaq", "daq", "has_ai", "has_ad",
                     "event_id"):
            setattr(rows, name, getattr(rows, name)[keep])
        return compile_columns(rows, pconf, ref, chrom)

    for r in reads_iter:
        if win_start is None:
            win_start = (r.pos // window) * window
        while r.pos >= win_start + window:
            batch = flush(win_start, win_start + window, buf)
            if batch is not None:
                yield batch
            win_start += window
            buf = [b for b in buf if b.endpos() > win_start]
        buf.append(r)
        pending = True
    if pending and buf:
        # flush remaining windows
        max_end = max(b.endpos() for b in buf)
        while win_start < max_end:
            batch = flush(win_start, win_start + window, buf)
            if batch is not None:
                yield batch
            win_start += window
            buf = [b for b in buf if b.endpos() > win_start]


_EX_POOL: dict = {}     # workers -> [idle executors]; threads (and their
_EX_LOCK = None         # native thread-local arenas) survive across runs
_EX_PID = None          # fork guard: a child inherits executor OBJECTS
                        # but not their threads — borrowing one would
                        # hang, so each process starts a fresh pool


def _borrow_executor(workers: int):
    """An exclusive ThreadPoolExecutor with `workers` threads, recycled
    across runs so the C ingest's _Thread_local arenas stay warm."""
    import os as _os
    import threading as _th
    from concurrent.futures import ThreadPoolExecutor as _TPE

    global _EX_LOCK, _EX_PID
    pid = _os.getpid()
    if _EX_LOCK is None or _EX_PID != pid:
        _EX_LOCK = _th.Lock()
        _EX_POOL.clear()
        _EX_PID = pid
    with _EX_LOCK:
        lst = _EX_POOL.get(workers)
        if lst:
            return lst.pop()
    return _TPE(workers, thread_name_prefix="lfq-window")


def _return_executor(workers: int, ex) -> None:
    import os as _os

    if _EX_PID != _os.getpid():
        return ex.shutdown(wait=False)
    with _EX_LOCK:
        lst = _EX_POOL.setdefault(workers, [])
        lst.append(ex)
        while len(lst) > 4:
            lst.pop(0).shutdown(wait=False)


def _native_window_batches(rdr, tid, chrom, ref, pconf, rstart, rend,
                           window=WINDOW, vconf=None, ign_pos=None,
                           device_baq=None, keep_raw=False):
    """Yield ColumnBatches via the native ingest engine (csrc/ingest.c)."""
    import numpy as _np

    from ..pileup.engine import compile_columns
    from ..pileup.fast_columns import build_snv_batch, supports_fused
    from ..pileup.native_ingest import ingest_region

    fused = (vconf is not None and supports_fused(vconf)
             and pconf.bed is None)
    lo = rstart if rstart is not None else 0
    hi = rend if rend is not None else len(ref)
    win = (lo // window) * window

    # software-pipelined window builds: PIPE_DEPTH windows in flight on a
    # small worker pool while the caller consumes the current batch.  The
    # C ingest/sweep releases the GIL and the device-BAQ wait parks in
    # jax, so window N's device compute/transfer hides under window N+1's
    # host sweep.  Only the raw BAM fetch touches the shared reader; a
    # lock serializes it (SURVEY's decode/compute overlap stage).
    import threading
    from concurrent.futures import ThreadPoolExecutor

    # depth 2 measured best at the 25 kb window default (interleaved
    # sweep 1/2/3/4 on the 4-core bench host: med 3.63/3.15-3.53/3.20-
    # 3.73/3.85s): one extra in-flight window keeps the sweep's pthread
    # stripes fed through the consumer's prescreen/confirm bursts, while
    # deeper pipes oversubscribe the cores.  (The old 100 kb windows
    # measured best at depth 1 — window size and pipe depth trade
    # against the same core budget.)
    PIPE_DEPTH = int(__import__("os").environ.get(
        "LOFREQ_TPU_PIPE_DEPTH", "2"))
    # persistent worker threads (borrow/return): the native ingest keeps
    # tens of MB of grow-only _Thread_local arenas per worker; a fresh
    # executor per run would kill those threads and re-fault every arena
    # page on the next run (measured: the dominant remaining source of
    # per-run kernel time).  Borrowed executors are never shared, so the
    # per-run pipe-depth semantics are unchanged.
    ex = _borrow_executor(PIPE_DEPTH)
    rdr_lock = threading.Lock()

    import numpy as _np

    ign_arr = None
    if ign_pos:
        ign_arr = _np.asarray(sorted(ign_pos), dtype=_np.int64)

    from ..pileup.fast_columns import _attach_indels, build_snv_batch_fused
    from ..pileup.native_ingest import SlabPool, raw_records_for_region

    # generations: one consumed + PIPE_DEPTH in flight; recycled across
    # runs (SlabPool.acquire/release) so repeated calls in one process
    # don't re-fault tens of MB of slab pages every run
    row_pool = SlabPool.acquire(PIPE_DEPTH + 1)
    col_pool = SlabPool.acquire(PIPE_DEPTH + 1)
    # fully-fused ingest->columns path (no row materialization).  Indel
    # mode runs it too: the per-event rows are re-ingested SPARSELY from
    # the window's raw bytes at event columns only (interval-list filter),
    # and the exact per-event attach supersedes the fused sweep's
    # conservative consensus-indel gate.
    fused_snv = fused and vconf is not None
    want_indels = (fused_snv and not vconf.no_indels
                   and pconf.collect_indels)

    def _attach_sparse(batch, b, e):
        ev_cols = _np.nonzero((batch.num_ins > 0) | (batch.num_dels > 0))[0]
        if not len(ev_cols):
            return
        from ..pileup.native_ingest import ingest_region

        ev_pos = batch.positions[ev_cols]
        brk = _np.nonzero(_np.diff(ev_pos) > 1)[0]
        starts = ev_pos[_np.concatenate([[0], brk + 1])]
        ends = ev_pos[_np.concatenate([brk, [len(ev_pos) - 1]])] + 1
        reg = _np.empty(2 * len(starts), dtype=_np.int64)
        reg[0::2] = starts
        reg[1::2] = ends
        from ..pileup.native_ingest import trim_raw_to_regions

        raw_ev = batch.raw
        trimmed = trim_raw_to_regions(raw_ev, tid, reg)
        if trimmed is not None:
            raw_ev = trimmed
        rows = ingest_region(rdr, pconf, ref, tid, beg=b, end=e,
                             raw=raw_ev, ign_pos=ign_arr, reg_list=reg,
                             pool=row_pool)
        _attach_indels(batch, rows, pconf, ref)

    # dedicated raw prefetcher: ONE thread fetches window raws in
    # ascending order (the native BGZF span cache extends sequentially,
    # so in-order fetches re-inflate ~nothing) up to PIPE_DEPTH+1 ahead,
    # decoupling the fetch chain from worker scheduling — a worker no
    # longer waits on the rdr lock before it can start a sweep
    raw_q: dict = {}
    raw_cv = threading.Condition()
    raw_stop = [False]
    PREFETCH_AHEAD = PIPE_DEPTH + 1

    def _prefetcher(windows):
        for w in windows:
            if raw_stop[0]:
                return
            b, e = max(w, lo), min(w + window, hi)
            with stagetimer.stage("ingest.raw"):
                try:
                    r = raw_records_for_region(rdr, tid, b, e)
                except Exception as exc:  # surface in the consumer
                    r = exc
            with raw_cv:
                raw_q[w] = r
                raw_cv.notify_all()
                while len(raw_q) > PREFETCH_AHEAD and not raw_stop[0]:
                    raw_cv.wait()

    def _take_raw(w):
        with raw_cv:
            while w not in raw_q:
                if raw_stop[0]:
                    # abnormal shutdown: the prefetcher stopped and this
                    # window's raw will never arrive — abort the build
                    # so the finally-drain can't deadlock on it
                    raise RuntimeError("window pipeline aborted")
                raw_cv.wait()
            r = raw_q.pop(w)
            raw_cv.notify_all()
        if isinstance(r, Exception):
            raise r
        return r

    from ..core import stagetimer

    def _fused_window(w):
        from ..core import stagetimer

        b, e = max(w, lo), min(w + window, hi)
        raw = _take_raw(w)
        if not raw:
            return None
        with stagetimer.stage("ingest_columns"):
            batch, ok = build_snv_batch_fused(
                rdr, ref, chrom, tid, b, e, pconf, vconf, raw=raw,
                ign_pos=ign_arr, device_baq=device_baq, pool=col_pool,
                keep_raw=keep_raw or want_indels,
                skip_consindel_gate=want_indels)
        if ok and batch is not None and want_indels:
            with stagetimer.stage("indel_attach"):
                _attach_sparse(batch, b, e)
            if not keep_raw:
                batch.raw = None    # only kept for the sparse re-ingest
        if not ok:
            # rare: a consensus-indel recheck needs per-event rows
            rows = ingest_region(rdr, pconf, ref, tid, beg=b, end=e,
                                 raw=raw, ign_pos=ign_arr,
                                 device_baq=device_baq, pool=row_pool,
                                 keep_raw=keep_raw)
            from ..pileup.fast_columns import build_snv_batch

            batch = build_snv_batch(rows, rows.raw_flags, b, e, ref,
                                    chrom, pconf, vconf, pool=col_pool)
            if batch is not None:
                batch.raw = getattr(rows, "raw", None)
        return batch

    def _submit(w):
        # under the call's context, so the build's spans carry its id
        run = contextvars.copy_context().run
        if fused_snv:
            return ex.submit(run, _fused_window, w)
        return ex.submit(run, ingest_region, rdr, pconf, ref, tid,
                         beg=max(w, lo), end=min(w + window, hi),
                         ign_pos=ign_arr, device_baq=device_baq,
                         pool=row_pool, keep_raw=keep_raw)

    from ..core import stagetimer

    pf = None
    futs = None
    try:
        if fused_snv:
            from collections import deque

            windows = list(range(win, hi, window))
            pf = threading.Thread(target=contextvars.copy_context().run,
                                  args=(_prefetcher, windows),
                                  name="raw-prefetch", daemon=True)
            pf.start()
            futs = deque()
            w = win
            while w < hi and len(futs) < PIPE_DEPTH:
                futs.append(_submit(w))
                w += window
            while futs:
                with stagetimer.stage("ingest_wait"):
                    batch = futs.popleft().result()
                # refill BEFORE the consumer crunches this batch so the
                # pipe stays PIPE_DEPTH deep during consumption
                if w < hi:
                    futs.append(_submit(w))
                    w += window
                if batch is not None:
                    yield batch
            pf.join()
            return
        fut = _submit(win) if win < hi else None
        if True:
            for _batch in _native_window_loop(
                    fut, _submit, win, hi, window, lo, fused, rdr, tid,
                    chrom, ref, pconf, vconf, col_pool):
                yield _batch
    finally:
        # stop + unblock a parked prefetcher and any worker blocked in
        # _take_raw before waiting out in-flight window builds
        with raw_cv:
            raw_stop[0] = True
            raw_q.clear()
            raw_cv.notify_all()
        if fused_snv:
            # the executor is returned for reuse, NOT shut down — so the
            # in-flight futures must be fully drained first (a zombie
            # build writing into released slab pools would corrupt the
            # next run that recycles them)
            from concurrent.futures import wait as _fwait

            if futs:
                for f in futs:
                    f.cancel()
                _fwait(list(futs))
            if pf is not None:
                pf.join()
            _return_executor(PIPE_DEPTH, ex)
        else:
            # legacy row path: in-flight futures aren't tracked here, so
            # a real shutdown remains the completion barrier
            ex.shutdown(wait=True)
        SlabPool.release(row_pool)
        SlabPool.release(col_pool)


def _native_window_loop(fut, submit, win, hi, window, lo, fused, rdr, tid,
                        chrom, ref, pconf, vconf, col_pool=None):
    import numpy as _np

    from ..pileup.engine import compile_columns
    from ..pileup.fast_columns import build_snv_batch

    from ..core import stagetimer

    while win < hi:
        win_e = win + window
        with stagetimer.stage("ingest_wait"):
            rows = fut.result()
        if win_e < hi:
            fut = submit(win_e)
        if fused and len(rows.pos):
            with stagetimer.stage("columns"):
                batch = build_snv_batch(rows, rows.raw_flags, max(win, lo),
                                        min(win_e, hi), ref, chrom, pconf,
                                        vconf, pool=col_pool)
            if batch is not None:
                batch.raw = getattr(rows, "raw", None)
                yield batch
            win = win_e
            continue
        if len(rows.pos):
            keep = (rows.pos >= max(win, lo)) & (rows.pos < min(win_e, hi))
            if pconf.bed is not None:
                keep &= pconf.bed.overlap_mask(chrom, rows.pos)
            if _np.any(keep):
                for name in ("pos", "nt4", "bq", "baq", "mq", "sq", "strand",
                             "is_del", "is_refskip", "is_head", "is_tail",
                             "indel", "iq", "dq", "iaq", "daq", "has_ai",
                             "has_ad", "event_id"):
                    setattr(rows, name, getattr(rows, name)[keep])
                batch = compile_columns(rows, pconf, ref, chrom)
                if batch is not None:
                    yield batch
        win = win_e


def _can_use_native(bam_path, ign_pos, pconf) -> bool:
    import os as _os

    from ..io.bgzf import is_bgzf

    # ign-list for source-qual is supported natively (sorted per-chrom
    # position array, csrc/ingest.c:in_ign)
    try:
        if not is_bgzf(bam_path):
            return False
    except OSError:
        return False
    bai = str(bam_path) + ".bai"
    if not _os.path.exists(bai):
        try:
            from ..io.bai import build_bai

            build_bai(bam_path)
        except OSError:
            return False
    return True


@stagetimer.call()
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
    VarcallConf (VarcallConf.from_reference converts a reference conf).
    Alone, it is one call of the tracer (stagetimer.call); its window
    builds, raw prefetch and confirms run under the call's context."""
    vconf = vconf if vconf is not None else VarcallConf()
    if not isinstance(vconf, VarcallConf):
        raise TypeError("run_call needs lofreq_tpu_torch's VarcallConf; "
                        "convert with VarcallConf.from_reference")
    if vconf.device_screen_on():
        # the device (K1 or its plain version) must be usable before the
        # sweep starts, not at the first column that survives the prescreen
        screen_ready(vconf.screen_device())
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
                    with stagetimer.stage("call.batch"):
                        vs = call_vars_batch(batch, vconf, res.stats,
                                             screen_ctx=screen_ctx)
                    fut = None
                    if screen_ctx:
                        fut = conf_ex.submit(contextvars.copy_context().run,
                                             _timed_confirm,
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
            with stagetimer.stage("call.batch"):
                vs = call_vars_batch(batch, vconf, res.stats)
            res.vars.extend(vs)
            if progress:
                progress(chrom, int(batch.positions[-1]))

    res.header = ""
    return res


def _prepare_chunk(chunk, ref, pconf: PileupConf, ign_pos):
    if pconf.use_baq or pconf.use_idaq:
        from ..ops.baq import add_alnqual_tags

        add_alnqual_tags(
            chunk, ref,
            baq=pconf.use_baq, ext_baq=pconf.ext_baq,
            idaq=pconf.use_idaq,
            redo_baq=pconf.redo_baq, redo_idaq=pconf.redo_idaq,
        )
    if pconf.use_sq:
        compute_source_quals(chunk, ref, pconf.def_nm_q, ign_pos=ign_pos,
                             count_eq=pconf.sq_count_eq)
    return chunk


def default_filter_conf(vconf: VarcallConf, no_default_filter: bool) -> FilterConf:
    """Thresholds derived from dynamic bonf (lofreq_call.c:1515-1541)."""
    cfg = FilterConf(no_defaults=no_default_filter)
    if vconf.bonf_dynamic:
        snv_th = 2**31 - 1
        indel_th = 2**31 - 1
        # C divides the FLOAT sig by the long-long bonf, so the quotient is
        # computed in float32, then phreded in long double
        # (snpcaller.h:53, lofreq_call.c:1524-1537)
        if vconf.bonf_subst:
            snv_th = max(prob_to_phred(
                np.float32(vconf.sig) / np.float32(vconf.bonf_subst)), 0)
        if vconf.bonf_indel:
            indel_th = max(prob_to_phred(
                np.float32(vconf.sig) / np.float32(vconf.bonf_indel)), 0)
        cfg.snvqual = MtcFilter(thresh=int(snv_th))
        cfg.indelqual = MtcFilter(thresh=int(indel_th))
    return cfg


def write_vcf(path, vars_, header: str):
    with stagetimer.stage("vcf_write"), VcfWriter(path, header) as w:
        for v in vars_:
            w.write(v)


@stagetimer.call()
def call_and_filter(
    bam_path, ref_path, out_path, vconf=None, pconf=None,
    no_default_filter=False, src=None, **kw
):
    """Full default `call` flow: call, then filter with dynamic-bonf
    thresholds (+ default filters unless no_default_filter).

    `src` is the ##source= header payload; the CLI passes the full
    command line like the reference (lofreq_call.c:1431-1437 concats
    every argv token plus a trailing space into mplp_conf.cmdline,
    which vcf_write_header emits verbatim, vcf.c:662).  One call of the
    tracer (stagetimer.call), run_call's included."""
    vconf = vconf or VarcallConf()
    res = run_call(bam_path, ref_path, vconf=vconf, pconf=pconf, **kw)
    if src is None:
        src = "lofreq_tpu call"
    header = new_header(src, str(ref_path))

    if no_default_filter and not vconf.bonf_dynamic:
        write_vcf(out_path, res.vars, header)
        return res

    cfg = default_filter_conf(vconf, no_default_filter)
    with stagetimer.stage("filter"):
        header, vars_ = run_filter(header, res.vars, cfg)
    write_vcf(out_path, vars_, header)
    res.vars = vars_
    return res
