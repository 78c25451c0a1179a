"""The port stands on its own: its copies of the reference's host layers
keep the reference's bodies, it builds and loads its own native library,
its simulator writes the reference's files, and its device engines run on
the card unless the caller names the CPU."""

import os
import re

import numpy as np
import pytest
import torch

from lofreq_tpu import _native_build as ref_build
from lofreq_tpu_torch import _native_build as port_build
from lofreq_tpu_torch import cli as port_cli
from lofreq_tpu_torch.call.caller import VarcallConf
from lofreq_tpu_torch.ops import device_baq, engine_device
from lofreq_tpu_torch.pipelines.call_pipeline import run_call
from lofreq_tpu_torch.testing import simulate_fast as port_sim
from simulate_fast import simulate_fast

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(REPO, "lofreq_tpu")
PORT = os.path.join(REPO, "lofreq_tpu_torch")

# modules the port copies unchanged: the same bytes, relative imports
# resolving to the port's own package
VERBATIM = [
    "defaults.py", "native.py",
    "core/__init__.py", "core/phred.py", "core/poissbin.py",
    "core/quals.py", "core/fisher.py", "core/multtest.py",
    "io/__init__.py", "io/bgzf.py", "io/bam.py", "io/bai.py", "io/bed.py",
    "io/fasta.py", "io/vcf.py",
    "pileup/__init__.py", "pileup/engine.py", "pileup/sourcequal.py",
    "pileup/fast_columns.py", "pileup/native_ingest.py",
    "filt/__init__.py", "filt/filter.py",
    "pipelines/plp_summary.py", "ops/baq.py", "ops/baq_hmm.py",
    "core/binom.py", "io/tabix.py", "ops/viterbi.py",
    "pipelines/indelqual.py", "pipelines/vcfset.py", "pipelines/uniq.py",
    "pipelines/somatic.py",
    "tools/__init__.py", "tools/vcftools.py", "tools/somatic_filters.py",
    "tools/bias.py", "tools/vcfplot.py",
]
C_SOURCES = port_build.SRCS + port_build.DEPS
# a comment's absolute path to the LoFreq sources: the copies cite them
# from src/lofreq/ on
SRC_PATH = re.compile(rb"(?<=[\s(])/[\w/.-]*?/src/lofreq/")


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _same_body(port, ref):
    """The copy equals the reference byte for byte, but for where its
    comments cite the LoFreq sources."""
    assert _read(port) == SRC_PATH.sub(b"src/lofreq/", _read(ref))


@pytest.mark.parametrize("name", VERBATIM)
def test_copied_module_keeps_reference_body(name):
    _same_body(os.path.join(PORT, name), os.path.join(REF, name))


@pytest.mark.parametrize("name", C_SOURCES)
def test_native_sources_are_the_references(name):
    """The port builds the reference's C sources from its own copies."""
    _same_body(os.path.join(PORT, "csrc", "host", name),
               os.path.join(REPO, "csrc", name))


def test_native_build_uses_the_reference_flags():
    assert port_build.SRCS == ref_build.SRCS
    assert set(ref_build.DEPS) <= set(port_build.DEPS)
    assert port_build._CSRC == os.path.join(PORT, "csrc", "host")
    assert port_build._BUILD == os.path.join(PORT, "csrc", "build")
    src = _read(os.path.join(PORT, "_native_build.py")).decode()
    for flag in ('"-O3", "-march=native", "-ffp-contract=off"',
                 "-DLOFREQ_HAVE_LIBDEFLATE"):
        assert flag in src


def test_port_loads_its_own_native_library():
    """The port's native library, its native_ingest worker library and the
    reference's are separate files and separate handles in one process."""
    from lofreq_tpu.pileup import native_ingest as ref_ingest
    from lofreq_tpu_torch import native as port_native
    from lofreq_tpu_torch.pileup import native_ingest as port_ingest

    lib = port_build.get_native_lib()
    assert os.path.dirname(lib._name) == os.path.join(PORT, "csrc", "build")
    assert port_ingest.get_lib() is lib
    assert port_native.get_native_lib() is lib
    ref_lib = ref_build.get_native_lib()
    assert ref_lib is not lib and ref_lib._name != lib._name
    assert ref_ingest.get_lib() is ref_lib
    assert port_ingest.SlabPool is not ref_ingest.SlabPool


def test_simulate_fast_copy_writes_the_same_files(tmp_path):
    """The port's simulator (on the port's io) and tests/simulate_fast.py
    write byte-identical BAM, BAI and FASTA."""
    os.makedirs(tmp_path / "port")
    os.makedirs(tmp_path / "ref")
    a = port_sim.simulate_fast(str(tmp_path / "port"), genome_len=5_000,
                               depth=60, seed=7)
    b = simulate_fast(str(tmp_path / "ref"), genome_len=5_000, depth=60,
                      seed=7)
    for key in ("bam", "fa"):
        assert _read(a[key]) == _read(b[key]), key
    assert _read(a["bam"] + ".bai") == _read(b["bam"] + ".bai")
    assert a["truth"] == b["truth"] and a["genome"] == b["genome"]


@pytest.fixture(scope="module")
def small_bam(tmp_path_factory):
    d = tmp_path_factory.mktemp("standalone")
    return port_sim.simulate_fast(str(d), genome_len=4_000, depth=80, seed=5)


@pytest.mark.parametrize("flags", [["--device-screen"], ["--device-baq"],
                                   ["--device-screen", "--device-baq"]])
def test_cli_device_engine_without_card_raises(small_bam, tmp_path,
                                               monkeypatch, flags):
    """A device engine asked for on a host without a card raises, naming
    --device cpu, instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out.vcf"
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_cli.main(["call", *flags, "-f", small_bam["fa"], "-o",
                       str(out), small_bam["bam"]])


def test_cli_device_cpu_runs_the_plain_versions(small_bam, tmp_path,
                                                monkeypatch):
    """With --device cpu the same flags run, and the default call (no
    device engine asked for on a host without a card) runs the host
    engine: the same VCF records."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vcfs = []
    for i, flags in enumerate((["--device-screen", "--device-baq",
                                "--device", "cpu"], [])):
        out = tmp_path / f"out{i}.vcf"
        assert port_cli.main(["call", *flags, "-f", small_bam["fa"], "-o",
                              str(out), small_bam["bam"]]) == 0
        vcfs.append([ln for ln in out.read_text().splitlines()
                     if not ln.startswith("##")])
    assert vcfs[0] == vcfs[1] and len(vcfs[0]) > 1


def test_cli_device_argument():
    ap = port_cli.build_parser()
    args = ap.parse_args(["call", "x.bam"])
    assert args.device == "cuda"
    assert port_cli.confs_from_args(args)[0].device == "cuda"
    args = ap.parse_args(["call", "--device", "cpu", "x.bam"])
    assert port_cli.confs_from_args(args)[0].device == "cpu"
    with pytest.raises(SystemExit):
        ap.parse_args(["call", "--device", "tpu", "x.bam"])


def test_engine_device(monkeypatch):
    assert engine_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        engine_device("meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        engine_device("cuda")
    with pytest.raises(RuntimeError):
        engine_device()


def test_conf_and_runner_default_to_the_card(small_bam, monkeypatch):
    """VarcallConf, the device-BAQ runner and run_call name the card by
    default and raise without one; no path picks the CPU by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = VarcallConf(use_device_screen=True)
    assert conf.device == "cuda"
    with pytest.raises(RuntimeError, match="--device cpu"):
        conf.screen_device()
    with pytest.raises(RuntimeError, match="--device cpu"):
        device_baq.get_runner()
    with pytest.raises(RuntimeError, match="--device cpu"):
        run_call(small_bam["bam"], small_bam["fa"], vconf=conf)
    # the host engine needs no card
    res = run_call(small_bam["bam"], small_bam["fa"],
                   vconf=VarcallConf(use_device_screen=False))
    assert res.stats.num_snv_tests > 0


def test_from_reference_reads_fields_without_imports():
    """from_reference takes any object with the reference's dataclass
    fields and keeps the port's own device default."""
    from lofreq_tpu.call.caller import VarcallConf as RefConf

    ref = RefConf(min_cov=3, use_device_baq=True, sig=0.05)
    conf = VarcallConf.from_reference(ref)
    assert type(conf) is VarcallConf and conf.device == "cuda"
    assert (conf.min_cov, conf.use_device_baq) == (3, True)
    assert conf.sig == np.float32(0.05)
    assert not issubclass(VarcallConf, RefConf)
