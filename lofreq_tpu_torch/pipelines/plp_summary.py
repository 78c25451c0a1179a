"""--plp-summary-only: per-column text dump (plp_summary,
lofreq_call.c:438-599 format)."""

from __future__ import annotations

import sys

import numpy as np

from ..pileup.engine import NT4


def run_plp_summary(bam_path, ref_path, vconf, pconf, region=None, bed=None,
                    stream=None):
    stream = stream or sys.stdout
    from ..io.bam import BamReader
    from ..io.fasta import Fasta
    from ..pileup.engine import read_passes_filters
    from .call_pipeline import _window_batches, parse_region

    fa = Fasta(ref_path)
    rdr = BamReader(bam_path)
    pconf.bed = bed
    if region:
        chrom, rstart, rend = parse_region(region)
        chroms = [(chrom, rstart, rend)]
    else:
        chroms = [(n, None, None) for n, _l in rdr.header.references]
    for chrom, rstart, rend in chroms:
        ref = fa.fetch(chrom)
        reads = rdr.fetch(chrom, rstart, rend) if region else rdr.fetch(chrom)

        def filtered():
            for r in reads:
                if read_passes_filters(r, pconf, chrom):
                    if r.mapq > pconf.max_mq:
                        r.mapq = pconf.max_mq
                    yield r

        for batch in _window_batches(filtered(), chrom, ref, pconf,
                                     rstart, rend):
            _print_batch(batch, vconf, stream)
    rdr.close()


def _print_batch(batch, vconf, stream):
    C = len(batch.positions)
    for c in range(C):
        cons = batch.cons_indel[c]
        if cons is not None:
            cons_s = cons[0] + cons[1]
        else:
            cons_s = NT4[batch.cons_nt4[c]]
        parts = [batch.target, str(batch.positions[c] + 1),
                 NT4[batch.ref_nt4[c]], cons_s]
        line = "\t".join(parts)
        for i in range(5):
            line += f"\t{NT4[i]}:{batch.fw_counts[c, i]}/{batch.rv_counts[c, i]}"
        line += f"\theads:{batch.num_heads[c]}\ttails:{batch.num_tails[c]}"
        line += f"\tins:{batch.num_ins[c]}\tdels:{batch.num_dels[c]}"
        line += f"\thrun:{batch.hrun[c]}"
        stream.write(line + "\n")
        # rows of column c are the CSR slice [col_start[c], col_start[c+1])
        lo, hi = int(batch.col_start[c]), int(batch.col_start[c + 1])
        nt4_c = batch.b_nt4[lo:hi]
        titles = ["BQ", "BAQ", "MQ", "SQ"]
        nx = 4 if vconf.use_sq else 3
        def vline(prefix, vals):
            # reference emits " %d" per value: no trailing space when empty
            stream.write(prefix + "".join(f" {int(v)}" for v in vals) + "\n")

        for i in range(5):
            m = nt4_c == i
            if not np.any(m):
                continue
            for x in range(nx):
                arr = (batch.b_bq, batch.b_baq, batch.b_mq,
                       batch.b_sq)[x][lo:hi]
                if x == 1 and not vconf.use_baq:
                    vals = [-1] * int(m.sum())
                else:
                    vals = arr[m]
                vline(f"  {NT4[i]}\t{titles[x]} =\t", vals)
        for t, neq, events in (("+", batch.ins_neq_at(c), batch.ins_events[c]),
                               ("-", batch.del_neq_at(c), batch.del_events[c])):
            q, mq, _sq = neq
            vline(f"  {t}0\tIDQ =\t", q)
            vline(f"  {t}0\tMQ =\t", mq)
            for key, ev in (events or {}).items():
                tag = "IQ" if t == "+" else "IDQ"
                vline(f"  {t}{key}\t{tag} =\t", ev.quals)
                vline(f"  {t}{key}\tMQ =\t", ev.map_quals)
                vline(f"  {t}{key}\tAQ =\t", ev.aln_quals)
                vline(f"  {t}{key}\tSQ =\t", ev.source_quals)
        stream.write("\n")
