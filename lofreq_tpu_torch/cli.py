"""Command-line interface: `python -m lofreq_tpu_torch.cli call ...`

Counterpart of lofreq_tpu/cli.py for the subcommands the port has: `call`
only, with the reference's arguments.  --profile writes a torch.profiler
trace; --device-baq runs the device-BAQ screening engine (the BAQ HMM
kernels K3/K4).  --device names where the device engines run: the CUDA
card (default), or the CPU with the kernels' plain PyTorch versions, for
tests.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

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
    """torch.profiler over the call; the trace (chrome format, viewable in
    Perfetto or TensorBoard) is written into trace_dir when it stops."""
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts,
                   on_trace_ready=tensorboard_trace_handler(trace_dir))


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


def build_parser():
    ap = argparse.ArgumentParser(
        prog="lofreq-tpu-torch",
        description="LoFreq-class variant caller, PyTorch/CUDA port",
    )
    sub = ap.add_subparsers(dest="cmd")
    add_call_args(sub.add_parser("call", help="call variants from BAM"))
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
    # the reference's ##source= payload: every argv token, program name
    # included, each followed by one space (lofreq_call.c:1431-1437)
    args.raw_cmdline = " ".join(["lofreq"] + argv) + " "
    if args.cmd != "call":
        ap.print_help()
        return 1
    return cmd_call(args)


if __name__ == "__main__":
    sys.exit(main())
