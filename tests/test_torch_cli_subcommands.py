"""Every subcommand of the port's CLI (lofreq_tpu_torch.cli.main) against
the reference's (lofreq_tpu.cli.main) on the same inputs: the fixtures of
tests/test_cli.py and the goldens of the filter, vcfset, indelqual,
tools, bias, uniq, plpsum, tabix and viterbi tests.  Output files are
identical byte for byte (VCFs apart from ##fileDate and ##source, which
name the run), and so are exit codes and standard output; where a
golden exists the port's output is also held to it."""

import gzip
import io
import json
import os

import numpy as np
import pytest
import torch

from lofreq_tpu.cli import main as ref_main
from lofreq_tpu.io.bam import BamHeader, BamReader, BamWriter
from lofreq_tpu.io.bgzf import BgzfWriter
from lofreq_tpu.io.fasta import write_fasta
from lofreq_tpu.io.tabix import build_tbi as ref_build_tbi
from lofreq_tpu_torch import __version__
from lofreq_tpu_torch.cli import build_parser
from lofreq_tpu_torch.cli import main as port_main
from lofreq_tpu_torch.io import tabix as port_tabix
from lofreq_tpu_torch.ops.viterbi import viterbi_align
from lofreq_tpu_torch.pileup.engine import ColumnBatch, IndelEvent
from lofreq_tpu_torch.pipelines.plp_summary import _print_batch
from lofreq_tpu_torch.pipelines.uniq import uniq_test_var
from lofreq_tpu_torch.io.vcf import Var
from simulate import simulate
from test_bias_differential import _mk_bam as _mk_bias_bam
from test_cli import _mini_bias_bam
from test_indelqual_differential import _mk_read as _mk_iq_read
from test_plpsum_golden import _Batch as _PlpBatch
from test_plpsum_golden import _Conf as _PlpConf
from test_somatic import make_pair
from test_tabix import _mk_records, _write_vcf_gz
from test_uniq_differential import _cases as _uniq_cases
from test_viterbi_driver_differential import _mk_read as _mk_vit_read

torch.set_num_threads(1)  # the test workers share the cores

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
RUN_LINES = ("##fileDate", "##source")


def _golden(name):
    with open(os.path.join(GOLDEN, name + ".json")) as fh:
        return json.load(fh)


FILTER = _golden("filter")
VCFSET = _golden("vcfset")
INDELQUAL = _golden("indelqual")
BIAS = _golden("bias")
TOOLS = _golden("tools")
PLPSUM = _golden("plpsum")
VITERBI = _golden("viterbi")
VITERBI_DRIVER = _golden("viterbi_driver")
UNIQ = _uniq_cases()


def _run(main, argv, capsys):
    """(exit code, stdout, stderr) of an in-process CLI run."""
    try:
        rc = main(list(argv))
    except SystemExit as e:  # argparse, and the reference's own exits
        rc = e.code
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def _read(path):
    with open(path, "rb") as fh:
        data = fh.read()
    return gzip.decompress(data) if data[:2] == b"\x1f\x8b" and \
        str(path).endswith(".gz") else data


def _vcf_body(path):
    return [ln for ln in _read(path).decode().splitlines()
            if not ln.startswith(RUN_LINES)]


def _both(tmp_path, capsys, argv_of, outputs=(), vcf=True):
    """Run `argv_of(dir)` through both CLIs, each in a directory of its
    own, and compare exit codes, stdout and the named outputs.  Returns
    the port's directory and (rc, stdout)."""
    got = {}
    for name, main in (("ref", ref_main), ("port", port_main)):
        d = tmp_path / name
        d.mkdir(parents=True)
        rc, out, _err = _run(main, argv_of(str(d)), capsys)
        got[name] = (rc, out, d)
    (rrc, rout, rdir), (prc, pout, pdir) = got["ref"], got["port"]
    assert (prc, pout) == (rrc, rout)
    for o in outputs:
        a, b = rdir / o, pdir / o
        assert a.exists() == b.exists(), o
        if not a.exists():
            continue
        if vcf:
            assert _vcf_body(b) == _vcf_body(a), o
        else:
            assert _read(b) == _read(a), o
    return pdir, (prc, pout)


# -- fixtures of tests/test_cli.py ----------------------------------------

@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("portclisim")
    return simulate(str(tmp), genome_len=3000, depth=300, seed=23,
                    snvs=((0.1, 3), (0.5, 3)))


@pytest.fixture(scope="module")
def calls(sim, tmp_path_factory):
    """The reference's calls on the simulated BAM, the input of the VCF
    subcommands below."""
    d = tmp_path_factory.mktemp("portclicalls")
    out = str(d / "a.vcf")
    assert ref_main(["call", "-f", sim["fa"], "-o", out, "-B", "-A",
                     sim["bam"]]) == 0
    raw = str(d / "raw.vcf")
    assert ref_main(["call", "-f", sim["fa"], "-o", raw, "-B", "-A",
                     "--no-default-filter", "-b", "1", sim["bam"]]) == 0
    return {"vcf": out, "raw": raw}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return make_pair(str(tmp_path_factory.mktemp("portclipair")))


@pytest.fixture(scope="module")
def indel_sim(tmp_path_factory):
    """A BAM whose reads carry planted insertions and deletions, for the
    realigner and the indel-quality subcommands."""
    tmp = tmp_path_factory.mktemp("portcliindel")
    return simulate(str(tmp), genome_len=2000, depth=60, seed=11,
                    snvs=((0.5, 2),),
                    indels=((0.3, 2, 2, "ins"), (0.3, 2, 3, "del")))


def test_version(capsys):
    rc, out, _ = _run(port_main, ["version"], capsys)
    assert rc == 0
    assert out == f"version: {__version__}\ncommit: lofreq_tpu_torch\n"


def test_every_reference_subcommand_but_call_distributed():
    """Every subcommand of the reference's CLI, call-distributed too (the
    name dates from before the port had it), and call-distributed with
    the reference's options plus the port's --device, as call has."""
    from lofreq_tpu.cli import build_parser as ref_parser

    def subparsers(ap):
        return next(a for a in ap._actions if a.dest == "cmd").choices

    def options(p):
        return {s for a in p._actions for s in a.option_strings}

    ref = subparsers(ref_parser())
    port = subparsers(build_parser())
    assert set(port) == set(ref)
    assert len(ref) == 25
    for cmd in ("call", "call-distributed"):
        assert options(port[cmd]) == options(ref[cmd]) | {"--device"}, cmd
    assert {"--num-processes", "--process-id", "--coordinator",
            "--threads-per-host"} <= options(port["call-distributed"])


@pytest.mark.parametrize("cmd", ["faidx", "index", "idxstats", "checkref",
                                 "checkref_fail", "sort"])
def test_index_and_stats_subcommands(sim, tmp_path, capsys, cmd):
    """faidx and index write the same index files; idxstats and checkref
    print the same lines; sort writes the same BAM."""
    def argv(d):
        fa, bam = os.path.join(d, "ref.fa"), os.path.join(d, "aln.bam")
        for src, dst in ((sim["fa"], fa), (sim["bam"], bam)):
            with open(src, "rb") as a, open(dst, "wb") as b:
                b.write(a.read())
        if cmd == "checkref_fail":
            write_fasta(fa, {"other": "ACGT" * 10})
            return ["checkref", fa, bam]
        return {"faidx": ["faidx", fa], "index": ["index", bam],
                "idxstats": ["idxstats", bam], "checkref": ["checkref", fa,
                                                             bam],
                "sort": ["sort", "-o", os.path.join(d, "s.bam"), bam]}[cmd]

    _d, (rc, out) = _both(tmp_path, capsys, argv,
                          ("ref.fa.fai", "aln.bam.bai", "s.bam"), vcf=False)
    assert rc == (1 if cmd == "checkref_fail" else 0)
    if cmd in ("idxstats", "checkref", "checkref_fail"):
        assert out


@pytest.mark.parametrize("flags", [[], ["--no-default-filter", "-B"],
                                   ["-s", "-S", "calls"]])
def test_call_and_plpsummary(sim, calls, tmp_path, capsys, flags):
    """call (the host engine on a host without a card) and plpsummary
    over a region: the reference's VCF and its summary lines."""
    flags = [calls["vcf"] if f == "calls" else f for f in flags]
    _both(tmp_path, capsys,
          lambda d: ["call", "-f", sim["fa"], "-o", f"{d}/c.vcf", *flags,
                     sim["bam"]], ("c.vcf",))
    _d, (_rc, out) = _both(
        tmp_path / "plp", capsys,
        lambda d: ["plpsummary", "-f", sim["fa"], "-B", "-A", "-r",
                   f"{sim['chrom']}:1-80", sim["bam"]])
    assert out.count(sim["chrom"]) >= 80


def test_call_refuses_overwrite(sim, calls, capsys):
    rc, _, err = _run(port_main, ["call", "-f", sim["fa"], "-o",
                                  calls["vcf"], sim["bam"]], capsys)
    assert rc == 1 and "Cowardly" in err


@pytest.mark.parametrize("case", ["cov", "print_all", "sb_mtc", "bad_mtc"])
def test_filter_cli(calls, tmp_path, capsys, case):
    args = {"cov": ["-v", "100000"], "print_all": ["--print-all", "-Q", "60"],
            "sb_mtc": ["-b", "fdr", "-c", "0.01"],
            "bad_mtc": ["-b", "nonsense"]}[case]
    _d, (rc, _out) = _both(
        tmp_path, capsys, lambda d: ["filter", "-i", calls["raw"], "-o",
                                     f"{d}/f.vcf", *args], ("f.vcf",))
    assert rc == (1 if case == "bad_mtc" else 0)


@pytest.mark.parametrize("ci", range(len(FILTER)))
def test_filter_goldens(ci, tmp_path, capsys):
    """tests/golden/filter.json through both CLIs: the same exit code and
    the reference binary's output."""
    case = FILTER[ci]
    vin = tmp_path / "in.vcf"
    vin.write_text(case["vcf"])
    pdir, (rc, _out) = _both(
        tmp_path, capsys,
        lambda d: ["filter", "-i", str(vin), "-o", f"{d}/out.vcf",
                   *case["args"]], ("out.vcf",))
    assert rc == case["rc"]
    if case["output"] is not None:
        assert (pdir / "out.vcf").read_text() == case["output"]


@pytest.mark.parametrize("ci", range(len(VCFSET)))
def test_vcfset_goldens(ci, tmp_path, capsys):
    case = VCFSET[ci]
    p1, p2 = tmp_path / "a.vcf", tmp_path / "b.vcf"
    p1.write_text(case["vcf1"])
    p2.write_text(case["vcf2"])

    def argv(d):
        if case.get("concat"):
            return ["vcfset", "-a", "concat", "-o", f"{d}/out.vcf", "-1",
                    str(p1), str(p2)]
        return ["vcfset", "-1", str(p1), "-2", str(p2), "-o",
                f"{d}/out.vcf", *case["args"]]

    pdir, (rc, out) = _both(tmp_path, capsys, argv, ("out.vcf",))
    assert rc == case["rc"]
    if "--count-only" in case["args"]:
        assert out == case["stdout"]
    elif case["output"] is not None:
        assert (pdir / "out.vcf").read_text() == case["output"]


def test_vcfset_reads_bgzf_through_tabix(calls, tmp_path, capsys):
    """vcfset over .vcf.gz inputs (io/tabix.py's random access), with a
    .gz output."""
    gz = str(tmp_path / "a.vcf.gz")
    with open(calls["vcf"], "rb") as fh:
        w = BgzfWriter(gz)
        w.write(fh.read())
        w.close()
    ref_build_tbi(gz)
    for action in ("intersect", "complement"):
        _both(tmp_path / action, capsys,
              lambda d: ["vcfset", "-a", action, "-1", gz, "-2",
                         calls["raw"], "-o", f"{d}/o.vcf.gz"],
              ("o.vcf.gz",))


@pytest.mark.parametrize("args", [["--ref", "fa"], ["--ref", "fa",
                                                    "--use-det-lim"],
                                  ["--output-all"], ["-f", "0.4"]],
                         ids=["binom", "det_lim", "no_ref_all", "uni_freq"])
def test_uniq_cli(sim, calls, tmp_path, capsys, args):
    args = [sim["fa"] if a == "fa" else a for a in args]
    _both(tmp_path, capsys,
          lambda d: ["uniq", "-v", calls["vcf"], "-o", f"{d}/u.vcf", *args,
                     sim["bam"]], ("u.vcf",))


def _uniq_batch(case):
    """tests/test_uniq_differential.py's column, built on the port's
    ColumnBatch and IndelEvent."""
    import test_uniq_differential as tud

    saved = tud.ColumnBatch, tud.IndelEvent
    tud.ColumnBatch, tud.IndelEvent = ColumnBatch, IndelEvent
    try:
        return tud._mk_batch(case)
    finally:
        tud.ColumnBatch, tud.IndelEvent = saved


@pytest.mark.parametrize("ci", range(len(UNIQ)))
def test_uniq_goldens(ci):
    """The port's uniq_test_var on tests/golden/uniq.json: the INFO of
    the reference's uniq_snv."""
    case = UNIQ[ci]
    var = Var(chrom=case["chrom"], pos=case["pos"], ref=case["ref"],
              alt=case["alt"],
              info=None if case["info"] == "-" else case["info"])
    uniq_test_var(_uniq_batch(case), var, case["uni_freq"],
                  bool(case["det_lim"]))
    assert (var.info if var.info else "-") == case["expected"]


@pytest.mark.parametrize("mode", ["uniform", "uniform_one", "dindel",
                                  "no_mode"])
def test_indelqual_cli(indel_sim, tmp_path, capsys, mode):
    args = {"uniform": ["-u", "20,25"], "uniform_one": ["-u", "33"],
            "dindel": ["--dindel", "-f", indel_sim["fa"]],
            "no_mode": []}[mode]
    _d, (rc, _) = _both(tmp_path, capsys,
                        lambda d: ["indelqual", *args, "-o", f"{d}/q.bam",
                                   indel_sim["bam"]], ("q.bam",), vcf=False)
    assert rc == (1 if mode == "no_mode" else 0)


@pytest.mark.parametrize("ci", range(len(INDELQUAL)))
def test_indelqual_goldens(ci, tmp_path, capsys):
    """tests/golden/indelqual.json through both CLIs: the same BAM, and
    the reference's BI/BD tags."""
    case = INDELQUAL[ci]
    fa = str(tmp_path / "ref.fa")
    write_fasta(fa, {"t": case["ref"]})
    bam = str(tmp_path / "in.bam")
    header = BamHeader("@HD\tVN:1.6\tSO:coordinate\n",
                       [("t", len(case["ref"]))])
    with BamWriter(bam, header) as w:
        for i, spec in enumerate(case["reads"]):
            w.write(_mk_iq_read(i, spec))
    args = (["--dindel", "-f", fa] if case["mode"] == "dindel"
            else [f"--uniform={case['iq']},{case['dq']}"])
    pdir, _ = _both(tmp_path, capsys,
                    lambda d: ["indelqual", *args, "-o", f"{d}/o.bam", bam],
                    ("o.bam",), vcf=False)
    got = []
    for r in BamReader(str(pdir / "o.bam")).fetch("t"):
        bi, bd = r.get_tag("BI"), r.get_tag("BD")
        got.append([bi if bi is not None else "-",
                    bd if bd is not None else "-"])
    assert got == case["expected"]


@pytest.mark.parametrize("args", [["-f", "fa"], ["-B", "-f", "fa"],
                                  ["-A", "-r", "-f", "fa"], ["pos"]],
                         ids=["baq_idaq", "no_baq", "redo", "ref_pos"])
def test_alnqual_cli(indel_sim, tmp_path, capsys, args):
    fa = indel_sim["fa"]
    if args == ["pos"]:
        argv = lambda d: ["alnqual", "-o", f"{d}/a.bam", indel_sim["bam"],
                          fa]  # noqa: E731
    else:
        args = [fa if a == "fa" else a for a in args]
        argv = lambda d: ["alnqual", *args, "-o", f"{d}/a.bam",
                          indel_sim["bam"]]  # noqa: E731
    _both(tmp_path, capsys, argv, ("a.bam",), vcf=False)


@pytest.mark.parametrize("args", [[], ["-k"], ["-r"], ["-q", "20"]])
def test_viterbi_cli(indel_sim, tmp_path, capsys, args):
    _both(tmp_path, capsys,
          lambda d: ["viterbi", "-f", indel_sim["fa"], "-o", f"{d}/v.bam",
                     *args, indel_sim["bam"]], ("v.bam",), vcf=False)


@pytest.mark.parametrize("ci", range(len(VITERBI_DRIVER)))
def test_viterbi_driver_goldens(ci, tmp_path, capsys):
    """tests/golden/viterbi_driver.json through both CLIs' `viterbi`: the
    same BAM, and the reference binary's reads."""
    case = VITERBI_DRIVER[ci]
    fa = str(tmp_path / "ref.fa")
    write_fasta(fa, {"t": case["ref"]})
    bam = str(tmp_path / "in.bam")
    header = BamHeader("@HD\tVN:1.6\tSO:coordinate\n",
                       [("t", len(case["ref"]))])
    with BamWriter(bam, header) as w:
        for i, spec in enumerate(case["reads"]):
            w.write(_mk_vit_read(i, spec))
    flags = ["-q", str(case["q2def"])]
    flags += ["-k"] if case["keepflags"] else []
    flags += ["-r"] if case["reclip"] else []
    pdir, _ = _both(tmp_path, capsys,
                    lambda d: ["viterbi", "-f", fa, "-o", f"{d}/o.bam",
                               *flags, bam], ("o.bam",), vcf=False)
    got = [dict(pos=r.pos, cigar=r.cigar_string(),
                qual="".join(chr(q + 33) for q in r.qual), flag=r.flag)
           for r in BamReader(str(pdir / "o.bam")).fetch("t")]
    assert got == case["expected"]


@pytest.mark.parametrize("idx", range(len(VITERBI)))
def test_viterbi_align_goldens(idx):
    """The port's copy of the C realigner's binding on
    tests/golden/viterbi.json (tests/test_viterbi.py's cases)."""
    c = VITERBI[idx]
    assert viterbi_align(c["ref"].encode(), c["query"].encode(),
                         c["bqual"].encode(), c["q2def"]) \
        == (c["shift"], c["aln"])


@pytest.mark.parametrize("ci", range(len(TOOLS["indel_ovlp"])))
def test_indel_ovlp_goldens(ci, tmp_path, capsys):
    case = TOOLS["indel_ovlp"][ci]
    vin = tmp_path / "in.vcf"
    vin.write_text(case["vcf"])
    _d, (rc, out) = _both(tmp_path, capsys,
                          lambda d: ["indel-ovlp", str(vin)])
    assert rc == 0 and out.splitlines() == case["output"].splitlines()


@pytest.mark.parametrize("cmd", ["indel-ovlp", "add-fake-gt", "add-sample",
                                 "cluster", "vcfplot_summary"])
def test_vcf_tools_cli(calls, tmp_path, capsys, cmd):
    vcf = calls["vcf"]
    argv = {"indel-ovlp": lambda d: ["indel-ovlp", vcf, "-o", f"{d}/o.vcf"],
            "add-fake-gt": lambda d: ["add-fake-gt", "-i", vcf, "-o",
                                      f"{d}/o.vcf", "-s", "s1", "s2"],
            "add-sample": lambda d: ["add-sample", "-i", vcf, "-o",
                                     f"{d}/o.vcf", "-s", "t"],
            "cluster": lambda d: ["cluster", vcf],
            "vcfplot_summary": lambda d: ["vcfplot", "-i", vcf, "-o",
                                          f"{d}/p.pdf", "--summary-only"],
            }[cmd]
    _d, (rc, out) = _both(tmp_path, capsys, argv, ("o.vcf",))
    assert rc == 0
    if cmd in ("cluster", "vcfplot_summary"):
        assert out


def test_vcfplot_pages(calls, tmp_path, capsys):
    """vcfplot's PDF: the same pages (the PDF's own creation date differs
    between runs)."""
    pdir, _ = _both(tmp_path, capsys,
                    lambda d: ["vcfplot", "-i", calls["vcf"], "-o",
                               f"{d}/p.pdf"])
    pages = []
    for name in ("ref", "port"):
        data = (tmp_path / name / "p.pdf").read_bytes()
        assert data[:5] == b"%PDF-"
        pages.append(data.count(b"/Type /Page ")
                     + data.count(b"/Type/Page"))
    assert pages[0] == pages[1] >= 5


def test_bias_cli(tmp_path, capsys):
    bam, vcf = _mini_bias_bam(tmp_path)
    _both(tmp_path, capsys,
          lambda d: ["bias", "-b", bam, "-i", vcf, "-o", f"{d}/b.vcf",
                     "--bq-filter", "3"], ("b.vcf",))


@pytest.mark.parametrize("ci", range(len(BIAS)),
                         ids=[c["name"] for c in BIAS])
def test_bias_goldens(ci, tmp_path, capsys):
    case = BIAS[ci]
    bam = str(tmp_path / "in.bam")
    _mk_bias_bam(bam, case["reads"])
    vin = tmp_path / "in.vcf"
    vin.write_text(case["vcf"])
    pdir, _ = _both(tmp_path, capsys,
                    lambda d: ["bias", "-b", bam, "-i", str(vin), "-o",
                               f"{d}/out.vcf", *case["args"]], ("out.vcf",))
    got = [ln.rstrip("\n") for ln in open(pdir / "out.vcf")
           if not ln.startswith("#")]
    assert got == case["expected"]


def test_somatic_filters_cli(pair, tmp_path, capsys):
    """alt-allele-in-normal and analyze-somatic-fn on tests/test_somatic.py's
    tumor/normal pair."""
    calls = str(tmp_path / "t.vcf")
    assert ref_main(["call", "-f", pair["fa"], "-o", calls, "-B", "-A",
                     pair["tumor"]]) == 0
    _both(tmp_path / "aan_all", capsys,
          lambda d: ["alt-allele-in-normal", "-i", calls, "-o", f"{d}/o.vcf",
                     "-b", pair["normal"], "--print-filtered"], ("o.vcf",))
    pdir, _ = _both(tmp_path / "aan", capsys,
                    lambda d: ["alt-allele-in-normal", "-i", calls, "-o",
                               f"{d}/o.vcf", "-b", pair["normal"]],
                    ("o.vcf",))
    kept = str(pdir / "o.vcf")
    _d, (rc, out) = _both(tmp_path / "fn", capsys,
                          lambda d: ["analyze-somatic-fn", "--truth", calls,
                                     "--calls", kept, "-t", pair["tumor"],
                                     "-n", pair["normal"]])
    assert rc == 0 and "present-in-normal" in out


@pytest.mark.parametrize("ci", range(len(PLPSUM)))
def test_plpsum_goldens(ci):
    """The port's plp_summary printer on tests/golden/plpsum.json."""
    import test_plpsum_golden as tpg

    entry = PLPSUM[ci]
    saved = tpg.IndelEvent
    tpg.IndelEvent = IndelEvent
    try:
        batch = _PlpBatch(entry["case"])
    finally:
        tpg.IndelEvent = saved
    buf = io.StringIO()
    _print_batch(batch, _PlpConf(**entry["case"]["conf"]), buf)
    assert buf.getvalue() == entry["text"]


def test_tabix_index_and_queries(tmp_path):
    """The port's io/tabix.py: the reference's .tbi byte for byte, and
    the same lines for random region queries (tests/test_tabix.py)."""
    rng = np.random.default_rng(7)
    recs = _mk_records(rng, ["chr1", "chr2"], 400)
    path = str(tmp_path / "x.vcf.gz")
    _write_vcf_gz(path, recs)
    idx = port_tabix.build_tbi(path)
    with open(path + ".tbi", "rb") as fh:
        port_bytes = fh.read()
    ref_build_tbi(path)
    with open(path + ".tbi", "rb") as fh:
        assert fh.read() == port_bytes
    assert idx.names == ["chr1", "chr2"]
    assert port_tabix.TbiIndex.load(path + ".tbi").names == idx.names
    tv = port_tabix.TabixVcf(path)
    for _ in range(50):
        chrom = ["chr1", "chr2"][int(rng.integers(2))]
        beg = int(rng.integers(0, 3_000_000))
        end = beg + int(rng.integers(1, 200_000))
        got = sorted(int(ln.split(b"\t")[1])
                     for ln in tv.fetch_lines(chrom, beg, end))
        assert got == sorted(p for c, p, _r, _a in recs
                             if c == chrom and beg < p <= end)
    tv.close()


def test_tabix_rejects_unsorted(tmp_path):
    path = str(tmp_path / "bad.vcf.gz")
    _write_vcf_gz(path, [("c1", 100, "A", "T"), ("c1", 50, "A", "T")])
    with pytest.raises(IOError):
        port_tabix.build_tbi(path)


def test_vcfset_tabix_matches_memory(tmp_path):
    """The port's vcfset gives the same counts whether vcf2 goes through
    its tabix index or the in-memory path, and the reference's counts."""
    from lofreq_tpu.pipelines.vcfset import run_vcfset as ref_vcfset
    from lofreq_tpu_torch.pipelines.vcfset import run_vcfset

    rng = np.random.default_rng(13)
    r1 = _mk_records(rng, ["chr1"], 300)
    r2 = r1[::3] + _mk_records(rng, ["chr1"], 50)
    v1 = str(tmp_path / "a.vcf.gz")
    v2 = str(tmp_path / "b.vcf.gz")
    _write_vcf_gz(v1, r1)
    _write_vcf_gz(v2, sorted(set(r2), key=lambda r: r[1]))
    counts = []
    for build in (False, True):
        if build:
            port_tabix.build_tbi(v2)
        counts.append([f(a, v1, v2, count_only=True)
                       for f in (run_vcfset, ref_vcfset)
                       for a in ("complement", "intersect")])
    assert counts[0] == counts[1]
    assert counts[0][:2] == counts[0][2:] and sum(counts[0][:2]) == 300
