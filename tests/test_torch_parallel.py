"""The port's call-parallel and somatic (lofreq_tpu_torch/pipelines/
parallel_call.py, a fork of the reference's, and pipelines/somatic.py, a
copy) against the reference's, with the device engines on the CPU
(--device cpu, or no card: the host engine); the start-method rule of the
workers; and, on a CUDA card, call-parallel from a process that already
holds a CUDA context."""

import gzip
import os

import pytest
import torch

from lofreq_tpu.cli import main as ref_main
from lofreq_tpu_torch.call.caller import VarcallConf
from lofreq_tpu_torch.cli import main as port_main
from lofreq_tpu_torch.pileup.engine import PileupConf
from lofreq_tpu_torch.pipelines import parallel_call as pc
from simulate import simulate
from test_orchestration_differential import multichrom  # noqa: F401
from test_somatic import make_pair

torch.set_num_threads(1)  # the test workers share the cores


def _text(path):
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as fh:
        return fh.read()


def _body(path):
    """A VCF's lines but ##fileDate and ##source, which name the run."""
    return [ln for ln in _text(path).splitlines()
            if not ln.startswith(("##fileDate", "##source"))]


def _records(path):
    return [ln for ln in _text(path).splitlines() if not ln.startswith("#")]


def _tests_line(err):
    return [ln for ln in err.splitlines() if "tests performed" in ln]


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parsim")
    return simulate(str(tmp), genome_len=3000, depth=300, seed=23,
                    snvs=((0.1, 3), (0.5, 3)))


@pytest.fixture(autouse=True)
def _fresh_stats():
    pc.reset_parallel_stats()


@pytest.mark.parametrize("threads", [2, 4])
def test_call_parallel_matches_reference_and_call(sim, tmp_path, capsys,
                                                  threads):
    """The port's call-parallel: the reference's VCF (bgzf bytes apart
    from ##fileDate/##source), its .tbi byte for byte, its test-count
    lines, and the port's own single-process call's records."""
    outs = {}
    for name, main in (("ref", ref_main), ("port", port_main)):
        out = str(tmp_path / f"{name}.vcf.gz")
        extra = ["--device", "cpu"] if name == "port" else []
        assert main(["call-parallel", "--pp-threads", str(threads), "-f",
                     sim["fa"], "-o", out, "-B", "-A", *extra,
                     sim["bam"]]) == 0
        outs[name] = (out, _tests_line(capsys.readouterr().err))
    (ref, ref_err), (port, port_err) = outs["ref"], outs["port"]
    assert _body(port) == _body(ref) and _records(port)
    assert ref_err == port_err and len(port_err) == 2
    with open(ref + ".tbi", "rb") as a, open(port + ".tbi", "rb") as b:
        assert a.read() == b.read()
    assert pc.POOL_STATS["start_method"] == "fork"
    single = str(tmp_path / "single.vcf")
    assert port_main(["call", "-f", sim["fa"], "-o", single, "-B", "-A",
                      "--device", "cpu", sim["bam"]]) == 0
    assert _records(single) == _records(port)


def test_call_parallel_multichrom_bed(multichrom, tmp_path):  # noqa: F811
    """A 3-chromosome BAM with a BED out of header order, at 4 threads
    (test_orchestration_differential.py's case): the port's records
    equal the reference's call-parallel and the port's call."""
    ref = str(tmp_path / "ref.vcf.gz")
    port = str(tmp_path / "port.vcf.gz")
    args = ["--pp-threads", "4", "-f", multichrom["fa"], "-l",
            multichrom["bed"]]
    assert ref_main(["call-parallel", *args, "-o", ref,
                     multichrom["bam"]]) == 0
    assert port_main(["call-parallel", *args, "--device", "cpu", "-o", port,
                      multichrom["bam"]]) == 0
    assert _body(port) == _body(ref)
    single = str(tmp_path / "single.vcf")
    assert port_main(["call", "-f", multichrom["fa"], "-l",
                      multichrom["bed"], "--device", "cpu", "-o", single,
                      multichrom["bam"]]) == 0
    recs = _records(port)
    assert recs == _records(single) and len(recs) >= 6
    assert {r.split("\t")[0] for r in recs} == {"chrA", "chrB", "chrC"}


def test_call_parallel_workers_run_the_screen(sim, tmp_path):
    """--device-screen --device cpu: every forked worker runs the screen
    (its plain version), its dispatches come back to the parent, and the
    records are the host engine's."""
    screen = str(tmp_path / "screen.vcf")
    host = str(tmp_path / "host.vcf")
    assert port_main(["call-parallel", "--pp-threads", "2", "-f", sim["fa"],
                      "-o", screen, "--device-screen", "--device", "cpu",
                      sim["bam"]]) == 0
    stats = dict(pc.PARALLEL_DISPATCH_STATS)
    assert stats["dispatched"] > 0 and stats["columns"] > 0
    # the plain version on the CPU launches no kernel
    assert stats["screen_codes"] == stats["baq_fwd"] == 0
    assert pc.POOL_STATS["start_method"] == "fork"
    # each worker process that took a job reports its start-up once
    assert 1 <= len(pc.POOL_STATS["ready_s"]) <= 2
    pc.reset_parallel_stats()
    assert port_main(["call-parallel", "--pp-threads", "2", "-f", sim["fa"],
                      "-o", host, "--no-device-screen", sim["bam"]]) == 0
    assert pc.PARALLEL_DISPATCH_STATS["dispatched"] == 0
    assert _records(screen) == _records(host) and _records(host)


def _kw(**vconf):
    v = VarcallConf(device="cpu", **vconf)
    return ({k: getattr(v, k) for k in v.__dataclass_fields__},
            {k: getattr(PileupConf(), k)
             for k in PileupConf.__dataclass_fields__ if k != "bed"})


def test_spawned_workers_give_the_forked_result(sim, monkeypatch):
    """The spawn start (the card's) on the CPU: the children take the
    environment and the job records, run the screen, and give the
    records, test counts and dispatches of forked workers."""
    vkw, pkw = _kw(use_device_screen=True, use_baq=False)
    pkw["use_baq"] = False
    got = {}
    for method in ("fork", "spawn"):
        pc.reset_parallel_stats()
        monkeypatch.setattr(pc, "start_method", lambda on_card: method)
        got[method] = (pc.run_parallel_regions(sim["bam"], sim["fa"], vkw,
                                               pkw, 2),
                       dict(pc.PARALLEL_DISPATCH_STATS))
        assert pc.POOL_STATS["start_method"] == method
        assert 1 <= len(pc.POOL_STATS["ready_s"]) <= 2
    assert got["spawn"] == got["fork"]
    (lines, n_snv, _), stats = got["spawn"]
    assert lines and n_snv > 0 and stats["dispatched"] > 0


@pytest.mark.parametrize("case,on_card", [
    ("default", True),                 # screen on where a card is present
    ("device_cpu", False),             # --device cpu
    ("no_screen", False),              # --no-device-screen: host engine
    ("env_off", False),                # LOFREQ_TPU_DEVICE_SCREEN=0
    ("device_baq_only", True),         # --no-device-screen --device-baq
    ("device_baq_cpu", False),
    ("no_card", False),                # no card: the host engine
])
def test_start_method_is_spawn_exactly_on_the_card(monkeypatch, case,
                                                   on_card):
    """spawn exactly when a worker will run the screen or the device BAQ
    on CUDA; nothing is launched (the card is faked)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: case != "no_card")
    monkeypatch.delenv("LOFREQ_TPU_DEVICE_SCREEN", raising=False)
    vconf = {"default": {}, "device_cpu": {"device": "cpu"},
             "no_screen": {"use_device_screen": False},
             "env_off": {},
             "device_baq_only": {"use_device_screen": False,
                                 "use_device_baq": True},
             "device_baq_cpu": {"use_device_screen": False,
                                "use_device_baq": True, "device": "cpu"},
             "no_card": {}}[case]
    if case == "env_off":
        monkeypatch.setenv("LOFREQ_TPU_DEVICE_SCREEN", "0")
    v = VarcallConf(**vconf)
    vkw = {k: getattr(v, k) for k in v.__dataclass_fields__}
    pkw = {k: getattr(PileupConf(), k)
           for k in PileupConf.__dataclass_fields__ if k != "bed"}
    resolved, got = pc.resolve_engines(vkw, pkw)
    assert got is on_card
    assert pc.start_method(got) == ("spawn" if on_card else "fork")
    # the workers get the screen resolved, and nothing else changed
    assert resolved["use_device_screen"] == (case in ("default",
                                                      "device_cpu"))
    assert {k: x for k, x in resolved.items() if k != "use_device_screen"} \
        == {k: x for k, x in vkw.items() if k != "use_device_screen"}


def test_fork_after_cuda_init_raises(monkeypatch):
    """A fork with workers on the card, once this process has initialised
    CUDA, raises before any worker starts; spawn, or a fork whose workers
    stay off the card, is allowed."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="spawn"):
        pc.pool_context("fork", on_card=True)
    assert pc.pool_context("spawn", on_card=True).get_start_method() \
        == "spawn"
    assert pc.pool_context("fork", on_card=False).get_start_method() \
        == "fork"
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert pc.pool_context("fork", on_card=True).get_start_method() \
        == "fork"


def test_run_parallel_regions_refuses_fork_onto_the_card(sim, monkeypatch):
    """run_parallel_regions asked to fork workers that would use the card
    from a process that has initialised CUDA raises, and starts none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    v = VarcallConf(use_device_screen=True)
    vkw = {k: getattr(v, k) for k in v.__dataclass_fields__}
    pkw = {k: getattr(PileupConf(), k)
           for k in PileupConf.__dataclass_fields__ if k != "bed"}
    monkeypatch.setattr(pc, "start_method", lambda on_card: "fork")
    with pytest.raises(RuntimeError, match="spawn"):
        pc.run_parallel_regions(sim["bam"], sim["fa"], vkw, pkw, 2)
    assert pc.POOL_STATS["start_method"] is None


def test_a_worker_without_the_card_fails_the_run(sim, tmp_path,
                                                 monkeypatch):
    """Workers that cannot reach the card (here: spawned on a host that
    has none, the parent told otherwise) fail the run with the screen's
    error; no bin runs on the CPU instead, and no VCF is written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    out = tmp_path / "out.vcf"
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_main(["call-parallel", "--pp-threads", "2", "-f", sim["fa"],
                   "-o", str(out), "--device-screen", sim["bam"]])
    assert not out.exists()
    assert pc.PARALLEL_DISPATCH_STATS["dispatched"] == 0


def _die(job):
    os._exit(3)


def test_a_worker_that_dies_fails_the_run(sim, monkeypatch):
    """A worker process that dies (as a spawned child that cannot start
    would) fails the run with BrokenProcessPool; it does not hang."""
    from concurrent.futures.process import BrokenProcessPool

    monkeypatch.setattr(pc, "_worker", _die)
    vkw, pkw = _kw(use_device_screen=False)
    with pytest.raises(BrokenProcessPool):
        pc.run_parallel_regions(sim["bam"], sim["fa"], vkw, pkw, 2)


# -- somatic -------------------------------------------------------------

@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return make_pair(str(tmp_path_factory.mktemp("tpair")))


def _somatic_outputs(prefix_dir):
    return sorted(n for n in os.listdir(prefix_dir)
                  if n.endswith((".vcf.gz", ".log")))


@pytest.mark.parametrize("flags", [["--baq-off"],
                                   ["--baq-off", "--threads", "3"],
                                   ["--threads", "2"]],
                         ids=["single", "threads3", "threads2_baq"])
def test_somatic_matches_reference(pair, tmp_path, flags):
    """Every stage file of the port's somatic (relaxed and stringent
    calls, somatic raw and final) equals the reference's, but for
    ##fileDate/##source; the final calls hold the planted somatic SNVs
    and no germline one (tests/test_somatic.py)."""
    dirs = {}
    for name, main in (("ref", ref_main), ("port", port_main)):
        d = tmp_path / name
        d.mkdir()
        assert main(["somatic", "-t", pair["tumor"], "-n", pair["normal"],
                     "-f", pair["fa"], "-o", str(d) + "/", *flags]) == 0
        dirs[name] = str(d)
    names = _somatic_outputs(dirs["ref"])
    assert names == _somatic_outputs(dirs["port"]) and len(names) >= 10
    for n in names:
        a, b = (os.path.join(dirs[k], n) for k in ("ref", "port"))
        if n.endswith(".log"):
            assert _text(a) == _text(b), n
        else:
            assert _body(a) == _body(b), n
    fin = os.path.join(dirs["port"], "somatic_final.snvs.vcf.gz")
    got = {(int(r.split("\t")[1]) - 1, r.split("\t")[3], r.split("\t")[4])
           for r in _records(fin)}
    assert set(pair["somatic"]) <= got
    assert not (got & set(pair["germline"]))


@pytest.fixture(scope="module")
def indel_pair(tmp_path_factory):
    """tests/test_somatic.py::test_somatic_indels's pair: a tumor-only 2 bp
    insertion after position 600 and a germline 3 bp deletion at 1400 in
    both samples, 300x of 100 bp reads, BI/BD from `indelqual -u 45`."""
    import numpy as np

    from lofreq_tpu.io.bai import build_bai
    from lofreq_tpu.io.bam import BamHeader, BamRead, BamWriter, FREVERSE
    from lofreq_tpu.io.fasta import write_fasta
    from test_somatic import BASES

    tmp = tmp_path_factory.mktemp("tindel")
    rng = np.random.default_rng(9)
    genome = BASES[rng.integers(0, 4, 2000)]
    fa = str(tmp / "si.fa")
    write_fasta(fa, {"chrI": genome.tobytes().decode()})
    out = {"fa": fa}
    for name, with_som in (("tumor", True), ("normal", False)):
        raw = str(tmp / f"{name}_raw.bam")
        header = BamHeader("@HD\tVN:1.6\tSO:coordinate\n", [("chrI", 2000)])
        starts = np.sort(rng.integers(0, 1900, 2000 * 300 // 100))
        with BamWriter(raw, header) as w:
            for i, start in enumerate(starts):
                r = BamRead()
                r.qname, r.tid, r.pos, r.mapq = f"s{i}", 0, int(start), 60
                r.flag = FREVERSE if rng.random() < 0.5 else 0
                base, cigar = genome[start:start + 100].copy(), "100M"
                at, gat = 600 - start, 1400 - start
                if with_som and 5 <= at < 90 and rng.random() < 0.3:
                    base = np.concatenate([base[:at + 1],
                                           np.frombuffer(b"AG", np.uint8),
                                           base[at + 1:98]])
                    cigar = f"{at + 1}M2I{97 - at}M"
                elif 5 <= gat < 90 and rng.random() < 0.5:
                    ext = genome[start + 100:start + 103]
                    base = np.concatenate([base[:gat + 1], base[gat + 4:],
                                           ext])[:100]
                    cigar = f"{gat + 1}M3D{len(base) - gat - 1}M"
                r.seq = base.tobytes()
                r.qual = np.full(len(base), 37, np.uint8)
                r.set_cigar_string(cigar)
                w.write(r)
        build_bai(raw)
        out[name] = str(tmp / f"{name}.bam")
        assert ref_main(["indelqual", "--uniform", "45,45", "-o", out[name],
                         raw]) == 0
        build_bai(out[name])
    return out


def test_somatic_indels_match_reference(indel_pair, tmp_path):
    """somatic --call-indels (tests/test_somatic.py::test_somatic_indels):
    every stage file equals the reference's; the tumor-only insertion is
    called, the germline deletion is not."""
    dirs = {}
    for name, main in (("ref", ref_main), ("port", port_main)):
        d = tmp_path / name
        d.mkdir()
        assert main(["somatic", "-t", indel_pair["tumor"], "-n",
                     indel_pair["normal"], "-f", indel_pair["fa"], "-o",
                     str(d) + "/", "--call-indels"]) == 0
        dirs[name] = str(d)
    names = _somatic_outputs(dirs["ref"])
    assert names == _somatic_outputs(dirs["port"]) and len(names) >= 10
    for n in names:
        a, b = (os.path.join(dirs[k], n) for k in ("ref", "port"))
        assert (_text(a) == _text(b)) if n.endswith(".log") \
            else (_body(a) == _body(b)), n
    fin = os.path.join(dirs["port"], "somatic_final.indels.vcf.gz")
    called = {int(r.split("\t")[1]) - 1 for r in _records(fin)}
    assert 600 in called and 1400 not in called


def test_somatic_continue_keeps_outputs(pair, tmp_path):
    prefix = str(tmp_path / "c_")
    args = ["somatic", "-t", pair["tumor"], "-n", pair["normal"], "-f",
            pair["fa"], "-o", prefix, "--baq-off"]
    assert port_main(args) == 0
    fin = prefix + "somatic_final.snvs.vcf.gz"
    with open(fin, "rb") as fh:
        before = fh.read()
    assert port_main(args) == 1
    assert port_main(args + ["--continue"]) == 0
    with open(fin, "rb") as fh:
        assert fh.read() == before


# -- on the card ---------------------------------------------------------

@pytest.mark.gpu
def test_call_parallel_on_the_card_after_cuda_init(sim, tmp_path):
    """call-parallel --pp-threads 2 from a process that already holds a
    CUDA context: the workers start by spawn, launch K1, and give the
    records of the single-process call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    torch.zeros(1, device="cuda")
    assert torch.cuda.is_initialized()
    par = str(tmp_path / "par.vcf")
    single = str(tmp_path / "single.vcf")
    assert port_main(["call-parallel", "--pp-threads", "2", "-f", sim["fa"],
                      "-o", par, "--device-screen", sim["bam"]]) == 0
    stats = dict(pc.PARALLEL_DISPATCH_STATS)
    assert pc.POOL_STATS["start_method"] == "spawn"
    assert stats["dispatched"] > 0
    assert stats["screen_codes"] == stats["dispatched"]
    assert port_main(["call", "-f", sim["fa"], "-o", single,
                      "--device-screen", sim["bam"]]) == 0
    assert _records(par) == _records(single) and _records(single)
