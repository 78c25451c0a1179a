"""Command-line interface: `python -m lofreq_tpu_torch.cli call ...`

Counterpart of lofreq_tpu/cli.py for the subcommands the port has: `call`
only, with the reference's own arguments.  --profile writes a
torch.profiler trace; --device-baq runs the device-BAQ screening engine
(the BAQ HMM kernels K3/K4 on the card, the plain PyTorch HMM without one).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

from lofreq_tpu.cli import _err, add_call_args
from lofreq_tpu.cli import confs_from_args as _ref_confs_from_args


def confs_from_args(args):
    """(VarcallConf, PileupConf) from parsed `call` arguments."""
    from .call.caller import VarcallConf

    vconf, pconf = _ref_confs_from_args(args)
    return VarcallConf.from_reference(vconf), pconf


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
    from lofreq_tpu.io.bed import BedIndex
    from lofreq_tpu.io.vcf import VcfReader

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
        from lofreq_tpu.pipelines.plp_summary import run_plp_summary

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
        from lofreq_tpu.core import stagetimer

        print(f"Stage times (s): {stagetimer.report()}", file=sys.stderr)
    return 0


def build_parser():
    ap = argparse.ArgumentParser(
        prog="lofreq-tpu-torch",
        description="LoFreq-class variant caller, PyTorch/CUDA port",
    )
    sub = ap.add_subparsers(dest="cmd")
    p = sub.add_parser("call", help="call variants from BAM")
    add_call_args(p)
    for action in p._actions:  # the reference's help names the TPU
        if action.dest in _HELP:
            action.help = _HELP[action.dest]
    return ap


_HELP = {
    "device_screen": "screen columns on the CUDA card before exact "
                     "confirmation (default: on when a card is present; "
                     "without one, --device-screen runs the plain PyTorch "
                     "screen on the CPU)",
    "device_baq": "read rescoring (BAQ) on the CUDA card with exact host "
                  "confirmation of candidate columns (default: off; "
                  "without a card the plain PyTorch HMM runs on the CPU)",
    "profile_dir": "write a torch.profiler trace of the call to DIR",
}


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
