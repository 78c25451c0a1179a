"""VCF statistics plots — equivalent of lofreq2_vcfplot.py (615 LoC
reference, src/tools/scripts/lofreq2_vcfplot.py).

Reproduces the reference's full analysis/plot set:
- per-property (AF, DP, Distance-log10) boxplot+violin, histogram and
  neighbourhood scatter pages (lofreq2_vcfplot.py:520-562)
- strand-collapsed substitution-type bar chart with Ts/Tv ratio
  (:143-187, :565-581)
- pairwise property heatmaps unless --simple (:584-604)
- --summary-only percentile + histogram tables (:492-506)
- --ign-filter / --maxdp / --indels filters (:436-466)
All pages go into one multi-page PDF.  matplotlib is optional; the text
summary is always available.
"""

from __future__ import annotations

import itertools
import sys
from collections import Counter

import numpy as np

from ..io.vcf import VcfReader

_COMPL = str.maketrans("ACGT", "TGCA")

_TS = ({frozenset("AG"), frozenset("CT")})


def subst_type_str(ref: str, alt: str) -> str:
    """Strand-collapsed substitution label, e.g. 'A>C|T>G'
    (lofreq2_vcfplot.py:143-158)."""
    s = f"{ref}>{alt}"
    c = s.translate(_COMPL)
    return "|".join(sorted([s, c]))


def ts_tv_ratio(subst_counts: Counter) -> float:
    """Transition/transversion ratio over SNVs (:123-140)."""
    ts = tv = 0
    for (ref, alt), n in subst_counts.items():
        pair = frozenset((ref, alt))
        if pair in _TS:
            ts += n
        elif len(pair) == 2:
            tv += n
    return ts / tv if tv else float("inf")


def calc_dist_left(chroms, positions) -> np.ndarray:
    """Distance to the previous variant on the same chrom; -1 for each
    chrom's first (:189-215).  0 means multi-allelic."""
    dists = np.empty(len(positions), dtype=np.int64)
    prev_chrom, prev_pos = None, None
    for i, (c, p) in enumerate(zip(chroms, positions)):
        dists[i] = -1 if c != prev_chrom else p - prev_pos
        prev_chrom, prev_pos = c, p
    return dists


def _collect(vcf_in, ign_filter=False, maxdp=None, indels_only=False):
    rows = []
    subst = Counter()
    n_consvar = 0
    n_loaded = 0
    with VcfReader(vcf_in) as rdr:
        for v in rdr:
            n_loaded += 1
            if not ign_filter and not v.passes():
                continue
            if v.is_indel() != indels_only:
                continue
            _f, dp = v.info_value("DP")
            dp = int(dp) if dp else 0
            if maxdp and dp > maxdp:
                continue
            _f, af = v.info_value("AF")
            af = float(af) if af else 0.0
            if v.has_info_key("CONSVAR"):
                n_consvar += 1
            if not indels_only and v.ref and v.alt and len(v.ref) == 1 \
                    and len(v.alt) == 1:
                subst[(v.ref.upper(), v.alt.upper())] += 1
            rows.append((v.chrom, v.pos, af, dp, v.qual))
    chroms = [r[0] for r in rows]
    positions = [r[1] for r in rows]
    dist = calc_dist_left(chroms, positions)
    props = {
        "AF": np.array([r[2] for r in rows]),
        "DP": np.array([r[3] for r in rows]),
        "Distance (log10)": np.array(
            [np.log10(d) if d > 0 else -1 for d in dist]),
    }
    return dict(props=props, subst=subst, n=len(rows), n_loaded=n_loaded,
                n_consvar=n_consvar)


def _print_summary(stats, stream):
    """--summary-only tables (lofreq2_vcfplot.py:492-506 format)."""
    for p, x in stats["props"].items():
        if not len(x):
            continue
        for name, val in [("minimum", np.min(x)),
                          ("1st %ile", np.percentile(x, 1)),
                          ("25th %ile", np.percentile(x, 25)),
                          ("median", np.percentile(x, 50)),
                          ("75th %ile", np.percentile(x, 75)),
                          ("99th %ile", np.percentile(x, 99)),
                          ("maximum", np.max(x))]:
            stream.write("%s\t%s\t%f\n" % (p, name, val))
        stream.write("%s\trange-min\trange-max\tcount\n" % p)
        hist, bin_edges = np.histogram(x)
        for i, val in enumerate(hist):
            stream.write("%f\t%f\t%d\n" % (bin_edges[i], bin_edges[i + 1],
                                           val))


def vcfplot(vcf_in, out_path, summary_only=False, stream=None,
            ign_filter=False, maxdp=None, indels_only=False, simple=False):
    stats = _collect(vcf_in, ign_filter=ign_filter, maxdp=maxdp,
                     indels_only=indels_only)
    stream = stream or sys.stdout
    summary_txt = [
        f"Reading vars from {vcf_in}",
        f"Loaded {stats['n_loaded']} variants",
        f"{stats['n']} vars left after filtering",
        f"#vars = {stats['n']} (of which {stats['n_consvar']} are "
        "CONSVARs)",
    ]
    if summary_only:
        _print_summary(stats, stream)
        return stats
    if stats["n"] == 0:
        stream.write("Nothing to do. Exiting\n")
        return stats
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib.backends.backend_pdf import PdfPages
    except ImportError:
        stream.write("matplotlib unavailable; text summary only\n")
        _print_summary(stats, stream)
        return stats

    props = stats["props"]
    with PdfPages(out_path) as pp:
        # overview page (:511-517)
        fig = plt.figure()
        ax = plt.subplot(1, 1, 1)
        ax.axis("off")
        ax.text(0.05, 0.95, "\n".join(summary_txt), va="top", fontsize=9)
        plt.title("Overview")
        pp.savefig()
        plt.close()

        # per-prop boxplot+violin / histogram / neighbourhood scatter
        for p, x in props.items():
            if not len(x):
                continue
            fig = plt.figure()
            ax = plt.subplot(1, 1, 1)
            ax.boxplot(x, notch=True, positions=[0], vert=True)
            try:
                ax.violinplot(x, positions=[0])
            except Exception:
                pass
            ax.set_ylabel("#SNVs")
            ax.set_xlabel(p)
            plt.title(f"{p} Boxplot")
            pp.savefig()
            plt.close()

            fig = plt.figure()
            ax = plt.subplot(1, 1, 1)
            ax.hist(x, bins=20)
            ax.set_xlim([0, ax.get_xlim()[1]])
            ax.set_ylabel("#SNVs")
            ax.set_xlabel(p)
            plt.title(f"{p} Histogram")
            pp.savefig()
            plt.close()

            fig = plt.figure()
            ax = plt.subplot(1, 1, 1)
            ax.scatter(range(len(x)), x, s=6)
            ax.set_xlim([0, len(x)])
            ax.set_ylabel(p)
            ax.set_xlabel("Neighbourhood")
            pp.savefig()
            plt.close()

        # substitution types + Ts/Tv (:565-581)
        if not indels_only and stats["subst"]:
            counts = Counter()
            for (ref, alt), n in stats["subst"].items():
                counts[subst_type_str(ref, alt)] += n
            keys = sorted(counts)
            total = sum(counts.values())
            fig = plt.figure()
            ax = plt.subplot(1, 1, 1)
            ax.bar(range(len(keys)),
                   [100.0 * counts[k] / total for k in keys])
            ax.set_xticks(range(len(keys)))
            ax.set_xticklabels(keys, rotation=45, fontsize=8)
            ax.set_ylabel("[%]")
            plt.title("Substitution Types (Ts/Tv=%.2f)" %
                      ts_tv_ratio(stats["subst"]))
            fig.tight_layout()
            pp.savefig()
            plt.close()

        # pairwise heatmaps (:584-604)
        if not simple:
            for xk, yk in itertools.combinations(props.keys(), 2):
                if not len(props[xk]) or not len(props[yk]):
                    continue
                fig = plt.figure()
                ax = plt.subplot(1, 1, 1)
                try:
                    plt.hist2d(props[xk], props[yk], bins=20)
                    plt.colorbar()
                except Exception:
                    pass
                ax.set_xlabel(xk)
                ax.set_ylabel(yk)
                plt.title(f"{xk} vs. {yk}")
                pp.savefig()
                plt.close()
    return stats
