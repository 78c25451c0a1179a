"""Command-line interface: `python -m lofreq_tpu_torch.cli <command> ...`

Counterpart of lofreq_tpu/cli.py, with all its subcommands and
arguments: call, call-parallel, call-distributed, filter, uniq, vcfset,
viterbi, alnqual, indelqual, somatic, checkref, faidx, index, sort,
idxstats, plpsummary, the tools (indel-ovlp, add-fake-gt/add-sample,
cluster, alt-allele-in-normal, analyze-somatic-fn, bias, vcfplot) and
version.  --profile writes a torch.profiler trace; --device-baq runs the
device-BAQ screening engine (the BAQ HMM kernels K3/K4).  --device names
where the device engines run: the CUDA card (default), or the CPU with the
kernels' plain PyTorch versions, for tests.  call-parallel starts its
workers by spawn when they use the card (pipelines/parallel_call.py);
call-distributed runs one process per --process-id over torch.distributed
(parallel/distributed.py).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

from . import __version__
from . import defaults as D


def _err(msg):
    print(f"FATAL: {msg}", file=sys.stderr)
    return 1


# ---------------------------------------------------------------------------
# call
# ---------------------------------------------------------------------------

def add_call_args(p: argparse.ArgumentParser):
    p.add_argument("-f", "--ref", required=False, help="reference fasta")
    p.add_argument("-o", "--out", default="-", help="vcf output")
    p.add_argument("-r", "--region")
    p.add_argument("-l", "--bed")
    p.add_argument("-q", "--min-bq", type=int, default=D.DEFAULT_MIN_BQ)
    p.add_argument("-Q", "--min-alt-bq", type=int, default=D.DEFAULT_MIN_ALT_BQ)
    p.add_argument("-R", "--def-alt-bq", type=int, default=D.DEFAULT_DEF_ALT_BQ)
    p.add_argument("-j", "--min-jq", type=int, default=D.DEFAULT_MIN_JQ)
    p.add_argument("-J", "--min-alt-jq", type=int, default=D.DEFAULT_MIN_ALT_JQ)
    p.add_argument("-K", "--def-alt-jq", type=int, default=D.DEFAULT_DEF_ALT_JQ)
    p.add_argument("-B", "--no-baq", action="store_true")
    p.add_argument("-A", "--no-idaq", action="store_true")
    p.add_argument("-D", "--del-baq", action="store_true")
    p.add_argument("-e", "--no-ext-baq", action="store_true")
    p.add_argument("-m", "--min-mq", type=int, default=D.DEFAULT_MIN_MQ)
    p.add_argument("-M", "--max-mq", type=int, default=D.DEFAULT_MAX_MQ)
    p.add_argument("-N", "--no-mq", action="store_true")
    p.add_argument("-s", "--src-qual", action="store_true")
    p.add_argument("-S", "--ign-vcf")
    p.add_argument("-T", "--def-nm-q", type=int, default=D.DEFAULT_DEF_NM_QUAL)
    p.add_argument("-a", "--sig", type=float, default=D.DEFAULT_SIG)
    p.add_argument("-b", "--bonf", default="dynamic")
    p.add_argument("-C", "--min-cov", type=int, default=D.DEFAULT_MIN_COV)
    p.add_argument("-d", "--max-depth", type=int,
                   default=D.DEFAULT_MAX_PLP_DEPTH)
    p.add_argument("-t", "--approx-threshold", type=int, default=-1)
    p.add_argument("--call-indels", action="store_true")
    p.add_argument("--only-indels", action="store_true")
    p.add_argument("--illumina-1.3", dest="illumina13", action="store_true")
    p.add_argument("--use-orphan", action="store_true")
    p.add_argument("--plp-summary-only", action="store_true")
    p.add_argument("--no-default-filter", action="store_true")
    p.add_argument("--force-overwrite", action="store_true")
    p.add_argument("--device-screen", dest="device_screen",
                   action="store_true", default=None,
                   help="screen columns on the device before exact "
                        "confirmation (default: on when a CUDA card is "
                        "present, else the host engine, whose output is "
                        "identical)")
    p.add_argument("--no-device-screen", dest="device_screen",
                   action="store_false",
                   help="force the all-exact host path")
    p.add_argument("--device-baq", dest="device_baq", action="store_true",
                   default=None,
                   help="read rescoring (BAQ) on the device with exact "
                        "host confirmation of candidate columns (default: "
                        "off)")
    p.add_argument("--no-device-baq", dest="device_baq",
                   action="store_false",
                   help="force the exact host BAQ kernel everywhere")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where --device-screen and --device-baq run: cuda "
                        "(default) launches the CUDA kernels and fails "
                        "without a card; cpu runs their plain PyTorch "
                        "versions and is meant for tests")
    p.add_argument("--profile", dest="profile_dir", metavar="DIR",
                   help="write a torch.profiler trace of the call to DIR")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--debug", action="store_true")
    p.add_argument("bam")


def confs_from_args(args):
    from .call.caller import VarcallConf
    from .pileup.engine import PileupConf

    vconf = VarcallConf(
        min_bq=args.min_bq, min_alt_bq=args.min_alt_bq,
        def_alt_bq=args.def_alt_bq, min_jq=args.min_jq,
        min_alt_jq=args.min_alt_jq, def_alt_jq=args.def_alt_jq,
        min_cov=args.min_cov, sig=args.sig,
        use_baq=not args.no_baq, use_mq=not args.no_mq,
        use_sq=args.src_qual, use_idaq=not args.no_idaq,
        no_indels=not args.call_indels and not args.only_indels,
        only_indels=args.only_indels,
        approx_threshold_n=args.approx_threshold,
        use_device_screen=getattr(args, "device_screen", None),
        use_device_baq=getattr(args, "device_baq", None),
        device=args.device,
    )
    if args.bonf != "dynamic":
        vconf.bonf_dynamic = False
        vconf.bonf_subst = int(args.bonf)
        vconf.bonf_indel = int(args.bonf)
    if vconf.no_indels:
        vconf.use_idaq = False
    pconf = PileupConf(
        min_mq=args.min_mq, max_mq=args.max_mq, max_depth=args.max_depth,
        def_nm_q=args.def_nm_q, no_orphan=not args.use_orphan,
        use_baq=not args.no_baq, redo_baq=args.del_baq,
        ext_baq=not args.no_ext_baq,
        use_idaq=(not args.no_idaq) and not vconf.no_indels,
        use_sq=args.src_qual, illumina13=args.illumina13,
        collect_indels=not vconf.no_indels,
    )
    return vconf, pconf


def _profiler(trace_dir):
    """torch.profiler over the call, on every thread where this torch can;
    the trace (chrome format, viewable in Perfetto or TensorBoard) is
    written into trace_dir when it stops, with the tracer's spans
    (core/stagetimer.py) added on the same timeline."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    kw = {}
    try:
        from torch._C._profiler import _ExperimentalConfig

        kw["experimental_config"] = _ExperimentalConfig(
            profile_all_threads=True)
    except (ImportError, TypeError):
        pass  # the profiler records the calling thread's ranges only
    return profile(activities=acts,
                   on_trace_ready=lambda p: _write_trace(p, trace_dir), **kw)


def _write_trace(prof, trace_dir):
    """The profiler's chrome trace under TensorBoard's file name, with
    one event per span of the tracer, each carrying its call id, span
    id, parent, thread CPU and attributes, placed through the tracer's
    anchor event."""
    import json
    import socket
    import time

    from .core import stagetimer

    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"{socket.gethostname()}_{os.getpid()}."
                        f"{time.time_ns() // 1_000_000}.pt.trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        trace = json.load(fh)
    anchor = next((e["ts"] for e in trace["traceEvents"]
                   if e.get("name") == stagetimer.ANCHOR), None)
    if anchor is not None:
        trace["traceEvents"].extend(stagetimer.chrome_events(anchor))
        with open(path, "w") as fh:
            json.dump(trace, fh)


def cmd_call(args) -> int:
    from .io.bed import BedIndex
    from .io.vcf import VcfReader

    from .pipelines.call_pipeline import call_and_filter

    if not args.ref:
        return _err("Need a reference for calling variants")
    if not os.path.exists(args.bam) and args.bam != "-":
        return _err(f"BAM file {args.bam} does not exist")
    if args.out != "-" and os.path.exists(args.out):
        if not args.force_overwrite:
            return _err(f"Cowardly refusing to overwrite file '{args.out}'")
        os.unlink(args.out)
    bed = BedIndex.read(args.bed) if args.bed else None
    ign_pos = None
    if args.ign_vcf:
        ign_pos = {}
        for path in args.ign_vcf.split(","):
            if not os.path.exists(path):
                return _err(f"ign-vcf file {path} does not exist")
            with VcfReader(path) as r:
                for v in r:
                    if bed is not None and not bed.overlap(
                            v.chrom, v.pos, v.pos + 1):
                        continue
                    ign_pos.setdefault(v.chrom, set()).add(v.pos)

    vconf, pconf = confs_from_args(args)
    if args.plp_summary_only:
        from .pipelines.plp_summary import run_plp_summary

        run_plp_summary(args.bam, args.ref, vconf, pconf,
                        region=args.region, bed=bed)
        return 0
    prof = (_profiler(args.profile_dir) if args.profile_dir
            else contextlib.nullcontext())
    with prof:
        res = call_and_filter(
            args.bam, args.ref, args.out, vconf=vconf, pconf=pconf,
            no_default_filter=args.no_default_filter, region=args.region,
            bed=bed, ign_pos=ign_pos, src=args.raw_cmdline,
        )
    if res.stats.indel_calls_wo_idaq and vconf.use_idaq:
        print(f"WARNING: {res.stats.indel_calls_wo_idaq} indel calls "
              "(before filtering) were made without indel alignment-quality!"
              " Did you forget to add indel alignment-quality to your"
              " bam-file?", file=sys.stderr)
    # load-bearing log lines: parsed by somatic/call-parallel wrappers
    print(f"Number of substitution tests performed: {res.stats.num_snv_tests}",
          file=sys.stderr)
    print(f"Number of indel tests performed: {res.stats.num_indel_tests}",
          file=sys.stderr)
    if args.verbose or args.debug:
        from .core import stagetimer

        print(f"Stage times (s): {stagetimer.report()}", file=sys.stderr)
    return 0


# ---------------------------------------------------------------------------
# filter
# ---------------------------------------------------------------------------

def add_filter_args(p):
    p.add_argument("-i", "--in", dest="vcf_in", required=True)
    p.add_argument("-o", "--out", dest="vcf_out", default="-")
    p.add_argument("-v", "--cov-min", type=int, default=-1)
    p.add_argument("-V", "--cov-max", type=int, default=-1)
    p.add_argument("-a", "--af-min", type=float, default=-1)
    p.add_argument("-A", "--af-max", type=float, default=-1)
    p.add_argument("-B", "--sb-thresh", type=int, default=0)
    p.add_argument("-b", "--sb-mtc", default="")
    p.add_argument("-c", "--sb-alpha", type=float, default=D.DEFAULT_SIG)
    p.add_argument("--sb-no-compound", action="store_true")
    p.add_argument("--sb-incl-indels", action="store_true")
    p.add_argument("-Q", "--snvqual-thresh", type=int, default=0)
    p.add_argument("-q", "--snvqual-mtc", default="")
    p.add_argument("-r", "--snvqual-alpha", type=float, default=D.DEFAULT_SIG)
    p.add_argument("-s", "--snvqual-ntests", type=int, default=0)
    p.add_argument("-K", "--indelqual-thresh", type=int, default=0)
    p.add_argument("-k", "--indelqual-mtc", default="")
    p.add_argument("-l", "--indelqual-alpha", type=float,
                   default=D.DEFAULT_SIG)
    p.add_argument("-m", "--indelqual-ntests", type=int, default=0)
    p.add_argument("--only-indels", action="store_true")
    p.add_argument("--only-snvs", action="store_true")
    p.add_argument("--print-all", action="store_true")
    p.add_argument("--no-defaults", action="store_true")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--debug", action="store_true")


def cmd_filter(args) -> int:
    from .core import multtest as MT
    from .filt.filter import FilterConf, MtcFilter, run_filter
    from .io.vcf import VcfReader, VcfWriter

    def mtc(name):
        if not name:
            return MT.MTC_NONE
        t = MT.mtc_str_to_type(name)
        if t < 0:
            raise SystemExit(_err(f"Unknown multiple testing correction "
                                  f"type '{name}'"))
        return t

    cfg = FilterConf(
        print_only_passed=not args.print_all,
        only_snvs=args.only_snvs, only_indels=args.only_indels,
        dp_min=args.cov_min, dp_max=args.cov_max,
        af_min=args.af_min, af_max=args.af_max,
        sb=MtcFilter(thresh=args.sb_thresh, mtc_type=mtc(args.sb_mtc),
                     alpha=args.sb_alpha),
        snvqual=MtcFilter(thresh=args.snvqual_thresh,
                          mtc_type=mtc(args.snvqual_mtc),
                          alpha=args.snvqual_alpha,
                          ntests=args.snvqual_ntests),
        indelqual=MtcFilter(thresh=args.indelqual_thresh,
                            mtc_type=mtc(args.indelqual_mtc),
                            alpha=args.indelqual_alpha,
                            ntests=args.indelqual_ntests),
        sb_no_compound=args.sb_no_compound,
        sb_incl_indels=args.sb_incl_indels,
        no_defaults=args.no_defaults,
    )
    if args.vcf_out != "-" and os.path.exists(args.vcf_out):
        return _err(f"Cowardly refusing to overwrite file '{args.vcf_out}'")
    if cfg.sb.thresh and cfg.sb.mtc_type != MT.MTC_NONE:
        return _err("Can't use fixed strand-bias threshold *and* multiple "
                    "testing correction.")
    if cfg.snvqual.thresh and cfg.snvqual.mtc_type != MT.MTC_NONE:
        return _err("Can't use fixed SNV quality threshold *and* multiple "
                    "testing correction.")
    if cfg.indelqual.thresh and cfg.indelqual.mtc_type != MT.MTC_NONE:
        return _err("Can't use fixed indel quality threshold *and* multiple "
                    "testing correction.")
    with VcfReader(args.vcf_in) as r:
        header = r.header
        vars_ = list(r)
    header, out_vars = run_filter(header, vars_, cfg)
    with VcfWriter(args.vcf_out, header) as w:
        for v in out_vars:
            w.write(v)
    return 0


# ---------------------------------------------------------------------------
# misc small commands
# ---------------------------------------------------------------------------

def cmd_checkref(args) -> int:
    from .io.bam import BamReader
    from .io.fasta import Fasta

    fa = Fasta(args.ref)
    rdr = BamReader(args.bam)
    ok = True
    for name, length in rdr.header.references:
        if name not in fa.references or fa.length(name) != length:
            ok = False
            break
    rdr.close()
    print("OK" if ok else "Failed")
    return 0 if ok else 1


def cmd_faidx(args) -> int:
    from .io.fasta import build_fai, write_fai

    write_fai(args.fasta, build_fai(args.fasta))
    return 0


def cmd_index(args) -> int:
    from .io.bai import build_bai

    try:
        build_bai(args.bam)
    except OSError as e:
        return _err(str(e))
    return 0


def cmd_sort(args) -> int:
    """Coordinate-sort a BAM (the reference delegates this to samtools;
    provided natively here since the preprocessing chain needs it).
    Sorts raw record blocks on (tid, pos) read straight from the fixed
    fields — records are never decoded."""
    from .io.bam import BamReader, BamWriter, raw_fields

    rdr = BamReader(args.bam)

    def key(buf):
        f = raw_fields(buf)
        return (f[0] if f[0] >= 0 else 1 << 30, f[1])

    reads = sorted(rdr.iter_raw(), key=key)
    rdr.close()
    hdr = rdr.header
    if "SO:" in hdr.text:
        import re as _re

        hdr.text = _re.sub(r"SO:\S+", "SO:coordinate", hdr.text)
    elif hdr.text.startswith("@HD"):
        nl = hdr.text.index("\n")
        hdr.text = hdr.text[:nl] + "\tSO:coordinate" + hdr.text[nl:]
    else:
        hdr.text = "@HD\tVN:1.6\tSO:coordinate\n" + hdr.text
    with BamWriter(args.out, hdr) as w:
        for r in reads:
            w.write_raw(r)
    return 0


def cmd_idxstats(args) -> int:
    from .io.bai import BaiIndex, build_bai
    from .io.bam import BamReader

    rdr = BamReader(args.bam)
    bai_path = args.bam + ".bai"
    if not os.path.exists(bai_path):
        build_bai(args.bam)
    idx = BaiIndex.load(bai_path)
    for tid, (name, length) in enumerate(rdr.header.references):
        mapped, unmapped = idx.mapped_unmapped(tid)
        print(f"{name}\t{length}\t{mapped}\t{unmapped}")
    print(f"*\t0\t0\t{idx.n_no_coor}")
    rdr.close()
    return 0


def cmd_viterbi(args) -> int:
    from .ops.viterbi import run_viterbi

    if args.out != "-" and os.path.exists(args.out):
        return _err(f"Cowardly refusing to overwrite file '{args.out}'")
    run_viterbi(args.bam, args.out, args.ref, q2default=args.defqual,
                del_flags=not args.keepflags, reclip=args.reclip)
    return 0


def cmd_alnqual(args) -> int:
    from .pipelines.indelqual import run_alnqual

    ref = args.ref or args.ref_pos
    if ref is None:
        print("FATAL: alnqual needs a reference "
              "(lofreq alnqual <aln.bam> <ref.fasta> or -f ref.fasta)",
              file=sys.stderr)
        return 1
    args.ref = ref
    run_alnqual(args.bam, args.out, args.ref, baq=not args.no_baq,
                ext_baq=not args.no_ext_baq, idaq=not args.no_idaq,
                redo_baq=args.redo_baq, redo_idaq=args.redo_baq)
    return 0


def cmd_indelqual(args) -> int:
    from .pipelines.indelqual import run_indelqual

    if args.uniform is None and not args.dindel:
        return _err("Need either --uniform or --dindel")
    if args.uniform is not None and args.dindel:
        return _err("Can't use --uniform and --dindel together")
    uniform = None
    if args.uniform is not None:
        parts = args.uniform.split(",")
        iq = int(parts[0])
        dq = int(parts[1]) if len(parts) > 1 else iq
        uniform = (iq, dq)
    if args.dindel and not args.ref:
        return _err("--dindel needs --ref")
    run_indelqual(args.bam, args.out, uniform=uniform, dindel=args.dindel,
                  ref_path=args.ref)
    return 0


def cmd_uniq(args) -> int:
    from .core import multtest as MT
    from .pipelines.uniq import run_uniq

    mtc_type = MT.mtc_str_to_type(args.uniq_mtc) if args.uniq_mtc else MT.MTC_FDR
    run_uniq(
        args.bam, args.ref, args.vcf_in, args.vcf_out,
        uni_freq=args.uni_freq, thresh=args.uniq_thresh,
        mtc_type=mtc_type, alpha=args.uniq_alpha, ntests=args.uniq_ntests,
        use_det_lim=args.use_det_lim, use_orphan=args.use_orphan,
        output_all=args.output_all, is_somatic=args.is_somatic,
    )
    return 0


def cmd_vcfset(args) -> int:
    from .pipelines.vcfset import run_vcfset

    n = run_vcfset(
        args.action, args.vcf1, args.vcf2, args.vcfout,
        add_info=args.add_info, count_only=args.count_only,
        only_pos=args.only_pos, only_passed=args.only_passed,
        only_snvs=args.only_snvs, only_indels=args.only_indels,
        concat_paths=args.extra or (),
    )
    if args.count_only:
        print(n)
    return 0


def cmd_call_parallel(args, extra) -> int:
    from .pipelines.parallel_call import run_call_parallel

    return run_call_parallel(args, extra)


def cmd_somatic(args) -> int:
    from .pipelines.somatic import SomaticCaller

    # with --no-src-qual the -S value is ignored entirely (the script
    # only reads args.ign_vcf in the src-qual-on branch,
    # lofreq2_somatic.py:821-832)
    sc = SomaticCaller(
        tumor_bam=args.tumor, normal_bam=args.normal, ref=args.ref,
        out_prefix=args.outprefix, dbsnp=args.dbsnp, bed=args.bed,
        threads=args.threads, call_indels=args.call_indels,
        continue_interrupted=args.cont, min_cov=args.min_cov,
        use_orphan=args.use_orphan, baq_off=args.baq_off,
        src_qual_on=not args.no_src_qual,
        ign_vcf=None if args.no_src_qual else args.ign_vcf,
        do_germline=args.germline,
    )
    return sc.run()


# ---------------------------------------------------------------------------

def build_parser():
    ap = argparse.ArgumentParser(
        prog="lofreq-tpu-torch",
        description="LoFreq-class variant caller, PyTorch/CUDA port",
    )
    sub = ap.add_subparsers(dest="cmd")

    p = sub.add_parser("call", help="call variants from BAM")
    add_call_args(p)

    p = sub.add_parser("plpsummary", help="print pileup summary per column")
    add_call_args(p)

    p = sub.add_parser("filter", help="filter variants in VCF")
    add_filter_args(p)

    p = sub.add_parser("checkref", help="check BAM against reference fasta")
    p.add_argument("ref")
    p.add_argument("bam")

    p = sub.add_parser("faidx", help="index fasta file")
    p.add_argument("fasta")

    p = sub.add_parser("index", help="index BAM file")
    p.add_argument("bam")

    p = sub.add_parser("sort", help="coordinate-sort BAM file")
    p.add_argument("-o", "--out", default="-")
    p.add_argument("bam")

    p = sub.add_parser("idxstats", help="BAM index stats")
    p.add_argument("bam")

    p = sub.add_parser("viterbi", help="viterbi realignment")
    p.add_argument("-f", "--ref", required=True)
    p.add_argument("-o", "--out", default="-")
    p.add_argument("-q", "--defqual", type=int, default=-1)
    p.add_argument("-k", "--keepflags", action="store_true")
    p.add_argument("-r", "--reclip", action="store_true")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("bam")

    p = sub.add_parser("alnqual", help="add BAQ/IDAQ alignment qualities")
    # reference form: lofreq alnqual [options] <aln.bam> <ref.fasta>
    # (lofreq_alnqual.c:52); -f kept as an alternative spelling
    p.add_argument("-f", "--ref")
    p.add_argument("-o", "--out", default="-")
    p.add_argument("-B", "--no-baq", action="store_true")
    p.add_argument("-A", "--no-idaq", action="store_true")
    p.add_argument("-e", "--no-ext-baq", action="store_true")
    p.add_argument("-r", "--redo-baq", action="store_true")
    p.add_argument("-u", "--uncompressed", action="store_true")
    p.add_argument("bam")
    p.add_argument("ref_pos", nargs="?", metavar="ref.fasta")

    p = sub.add_parser("indelqual", help="insert indel qualities (BI/BD)")
    p.add_argument("-u", "--uniform")
    p.add_argument("--dindel", action="store_true")
    p.add_argument("-f", "--ref")
    p.add_argument("-o", "--out", default="-")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("bam")

    p = sub.add_parser("uniq", help="test variant uniqueness vs another BAM")
    p.add_argument("-v", "--vcf-in", required=True)
    p.add_argument("-o", "--vcf-out", default="-")
    p.add_argument("-f", "--uni-freq", type=float, default=-1.0)
    p.add_argument("-t", "--uniq-thresh", type=int, default=0)
    p.add_argument("-m", "--uniq-mtc", default="fdr")
    p.add_argument("-a", "--uniq-alpha", type=float, default=0.001)
    p.add_argument("-n", "--uniq-ntests", type=int, default=0)
    p.add_argument("--use-det-lim", action="store_true")
    p.add_argument("--use-orphan", action="store_true")
    p.add_argument("--output-all", action="store_true")
    p.add_argument("--is-somatic", action="store_true")
    p.add_argument("--ref", default=None,
                   help="reference fasta (optional; the reference "
                        "binary pileups without one — all-N ref)")
    p.add_argument("bam")

    p = sub.add_parser("vcfset", help="vcf set operations")
    p.add_argument("-a", "--action", required=True,
                   choices=["intersect", "complement", "concat"])
    p.add_argument("-1", "--vcf1", required=True)
    p.add_argument("-2", "--vcf2")
    p.add_argument("-o", "--vcfout", default="-")
    p.add_argument("-I", "--add-info")
    p.add_argument("--count-only", action="store_true")
    p.add_argument("--only-pos", action="store_true")
    p.add_argument("--only-passed", action="store_true")
    p.add_argument("--only-snvs", action="store_true")
    p.add_argument("--only-indels", action="store_true")
    p.add_argument("extra", nargs="*")

    p = sub.add_parser("call-parallel",
                       help="multi-worker region-parallel call")
    p.add_argument("--pp-threads", type=int, default=1)
    p.add_argument("--pp-debug", action="store_true")
    p.add_argument("--pp-verbose", action="store_true")
    p.add_argument("--pp-dry-run", action="store_true")
    add_call_args(p)

    p = sub.add_parser("call-distributed",
                       help="multi-host region-parallel call over "
                            "torch.distributed")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--coordinator", default=None)
    p.add_argument("--threads-per-host", type=int, default=1)
    add_call_args(p)

    p = sub.add_parser("somatic", help="tumor-normal somatic calling")
    p.add_argument("-t", "--tumor", required=True)
    p.add_argument("-n", "--normal", required=True)
    p.add_argument("-f", "--ref", required=True)
    p.add_argument("-o", "--outprefix", required=True)
    p.add_argument("-d", "--dbsnp")
    p.add_argument("--threads", type=int, default=1)
    p.add_argument("--call-indels", action="store_true")
    p.add_argument("--continue", dest="cont", action="store_true")
    p.add_argument("--min-cov", type=int, default=7)
    p.add_argument("--use-orphan", action="store_true")
    p.add_argument("--baq-off", action="store_true")
    p.add_argument("--no-src-qual", action="store_true")
    p.add_argument("-S", "--ign-vcf", default="normal",
                   help="vcf(s) of known variants to ignore for source "
                        "quality; the special value 'normal' (the "
                        "default, lofreq2_somatic.py:715) uses the "
                        "normal sample's stringent calls")
    p.add_argument("--germline", action="store_true")
    p.add_argument("-l", "--bed")
    p.add_argument("--verbose", action="store_true")

    p = sub.add_parser("indel-ovlp", help="resolve overlapping indels")
    p.add_argument("vcf")
    p.add_argument("-o", "--out", default="-")

    p = sub.add_parser("add-fake-gt",
                       help="add FORMAT=GT + unknown-genotype samples")
    p.add_argument("-i", "--vcf-in", required=True)
    p.add_argument("-o", "--vcf-out", default="-")
    p.add_argument("-s", "--samples", nargs="+", required=True)

    p = sub.add_parser("add-sample", help="alias of add-fake-gt")
    p.add_argument("-i", "--vcf-in", required=True)
    p.add_argument("-o", "--vcf-out", default="-")
    p.add_argument("-s", "--samples", nargs="+", required=True)

    p = sub.add_parser("cluster", help="cluster variants by AF CI overlap")
    p.add_argument("vcf")

    p = sub.add_parser("alt-allele-in-normal",
                       help="MuTect observed-in-control somatic filter")
    p.add_argument("-i", "--vcf-in", required=True)
    p.add_argument("-o", "--out", default="-")
    p.add_argument("-b", "--normal-bam", required=True)
    p.add_argument("--print-filtered", action="store_true")

    p = sub.add_parser("analyze-somatic-fn",
                       help="explain somatic false negatives")
    p.add_argument("--truth", required=True)
    p.add_argument("--calls", required=True)
    p.add_argument("-t", "--tumor", required=True)
    p.add_argument("-n", "--normal", required=True)

    p = sub.add_parser("bias", help="quality-bias tests (MB/BB/CB tags)")
    p.add_argument("-b", "--bam", required=True,
                   help="Input BAM file matching vcf")
    p.add_argument("-i", "--vcfin", required=True)
    p.add_argument("-o", "--vcfout", default="-")
    p.add_argument("-m", "--mtc", default="fdr",
                   choices=["bonf", "holmbonf", "fdr", "None"])
    p.add_argument("--mtc-alpha", type=float, default=0.001)
    p.add_argument("-t", "--mtc-tag", default="BB",
                   choices=["BB", "MB", "CB"])
    p.add_argument("--mq-filter", dest="min_mq", type=int, default=-1)
    p.add_argument("--bq-filter", dest="min_bq", type=int, default=6)
    p.add_argument("-a", "--use-orphan", action="store_true")
    p.add_argument("-p", "--pass-only", action="store_true")

    p = sub.add_parser("vcfplot", help="VCF statistics plots")
    p.add_argument("-i", "--vcf-in", required=True)
    p.add_argument("-o", "--out", default="vcfplot.pdf")
    p.add_argument("--summary-only", action="store_true")
    p.add_argument("--simple", action="store_true",
                   help="skip the pairwise heatmap pages")
    p.add_argument("--ign-filter", action="store_true",
                   help="include variants with FILTER entries")
    p.add_argument("--maxdp", type=int,
                   help="ignore variants above this coverage")
    p.add_argument("--indels", dest="indels_only", action="store_true",
                   help="plot indels instead of substitutions")

    p = sub.add_parser("version", help="print version")
    return ap


def main(argv=None) -> int:
    try:
        return _main(argv)
    except IOError as e:
        # package I/O errors surface as clean FATALs, as in the reference
        print(f"FATAL: {e}", file=sys.stderr)
        return 1


def _main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = build_parser()
    args = ap.parse_args(argv)
    # full command line, reconstructed the way the reference stores it
    # for the ##source= VCF header (lofreq_call.c:1431-1437: every argv
    # token — including the program name — followed by one space)
    args.raw_cmdline = " ".join(["lofreq"] + argv) + " "
    if args.cmd is None:
        ap.print_help()
        return 1
    if args.cmd == "version":
        print(f"version: {__version__}")
        print("commit: lofreq_tpu_torch")
        return 0
    if args.cmd == "plpsummary":
        args.plp_summary_only = True
    if args.cmd in ("call", "plpsummary"):
        return cmd_call(args)
    if args.cmd == "call-distributed":
        from .parallel.distributed import run_call_distributed

        return run_call_distributed(args, [])
    if args.cmd == "call-parallel":
        return cmd_call_parallel(args, [])
    if args.cmd == "filter":
        return cmd_filter(args)
    if args.cmd == "checkref":
        return cmd_checkref(args)
    if args.cmd == "faidx":
        return cmd_faidx(args)
    if args.cmd == "index":
        return cmd_index(args)
    if args.cmd == "sort":
        return cmd_sort(args)
    if args.cmd == "idxstats":
        return cmd_idxstats(args)
    if args.cmd == "viterbi":
        return cmd_viterbi(args)
    if args.cmd == "alnqual":
        return cmd_alnqual(args)
    if args.cmd == "indelqual":
        return cmd_indelqual(args)
    if args.cmd == "uniq":
        return cmd_uniq(args)
    if args.cmd == "vcfset":
        return cmd_vcfset(args)
    if args.cmd == "somatic":
        return cmd_somatic(args)
    if args.cmd == "indel-ovlp":
        from .tools.vcftools import indel_ovlp

        indel_ovlp(args.vcf, args.out)
        return 0
    if args.cmd in ("add-fake-gt", "add-sample"):
        from .tools.vcftools import add_fake_gt

        add_fake_gt(args.vcf_in, args.vcf_out, args.samples)
        return 0
    if args.cmd == "cluster":
        from .tools.vcftools import cluster_vars

        cluster_vars(args.vcf)
        return 0
    if args.cmd == "alt-allele-in-normal":
        from .tools.somatic_filters import alt_allele_in_normal

        n = alt_allele_in_normal(args.vcf_in, args.normal_bam, args.out,
                                 print_filtered=args.print_filtered)
        print(f"filtered {n} variants", file=sys.stderr)
        return 0
    if args.cmd == "analyze-somatic-fn":
        from .tools.somatic_filters import analyze_somatic_fn

        analyze_somatic_fn(args.truth, args.calls, args.tumor, args.normal)
        return 0
    if args.cmd == "bias":
        from .tools.bias import run_bias

        run_bias(args.bam, args.vcfin, args.vcfout, mtc=args.mtc,
                 mtc_alpha=args.mtc_alpha, mtc_tag=args.mtc_tag,
                 min_mq=args.min_mq, min_bq=args.min_bq,
                 use_orphan=args.use_orphan, pass_only=args.pass_only)
        return 0
    if args.cmd == "vcfplot":
        from .tools.vcfplot import vcfplot

        vcfplot(args.vcf_in, args.out, summary_only=args.summary_only,
                simple=args.simple, ign_filter=args.ign_filter,
                maxdp=args.maxdp, indels_only=args.indels_only)
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
