"""The port's whole `call` (lofreq_tpu_torch) against the reference's.

1. run_call on the simulated 50 kb@800x workload, the port's device
   screen on the CPU (the plain PyTorch DP) vs lofreq_tpu's run_call with
   its JAX screen on and off: identical records and test counts, and the
   port's screen really ran.
2. The port's CLI `call` with the device screen forced on, on the CPU
   (--device=cpu, the plain PyTorch versions), on every case
   of the reference goldens (tests/golden/call_e2e.json): byte-identical
   VCF modulo ##fileDate and identical "Number of ... tests performed"
   lines, as tests/test_call_e2e_differential.py checks the reference
   CLI.  The screen is forced on through LOFREQ_TPU_DEVICE_SCREEN=1 (the
   auto gate's override), not --device-screen, because the ##source=
   header line carries the argument vector.
3. The device-BAQ engine (--device-baq): the port's run_call with its
   runner on the CPU (the plain PyTorch HMM) against the reference's
   exact path and the reference's own device-BAQ path, on the cases of
   tests/test_device_baq.py plus one without ext BAQ; and the CLI with
   --device-baq on every golden case.
"""

import numpy as np
import pytest
import torch

from lofreq_tpu.call.caller import VarcallConf as RefConf
from lofreq_tpu.defaults import BAQ_SCREEN_DELTA
from lofreq_tpu.pileup.engine import PileupConf
from lofreq_tpu.pipelines.call_pipeline import run_call as ref_run_call
from lofreq_tpu_torch import cli as port_cli
from lofreq_tpu_torch.call.caller import VarcallConf
from lofreq_tpu_torch.ops import cuda_poissbin, device_baq
from lofreq_tpu_torch.ops import screen as port_screen
from lofreq_tpu_torch.pipelines.call_pipeline import run_call
from simulate import simulate
from simulate_fast import simulate_fast
from test_call_e2e_differential import _CASES, _minisam_to_bam, _norm


def _records(res):
    return [(v.pos, v.ref, v.alt, v.qual, v.info) for v in res.vars]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small ops; with the test workers sharing
    the host's cores, one intra-op thread per worker avoids oversubscribing
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    d = tmp_path_factory.mktemp("sim50k")
    return simulate_fast(str(d), genome_len=50_000, depth=800, seed=3)


@pytest.fixture(scope="module")
def ref_host(workload):
    return ref_run_call(workload["bam"], workload["fa"],
                        vconf=RefConf(use_device_screen=False,
                                      use_device_baq=False))


def test_port_call_matches_reference(workload, ref_host):
    before = dict(port_screen.DISPATCH_STATS)
    launches = cuda_poissbin.launch_count()
    res = run_call(workload["bam"], workload["fa"],
                   vconf=VarcallConf(use_device_screen=True, device="cpu"))
    assert res.stats.num_snv_tests == ref_host.stats.num_snv_tests > 0
    assert _records(res) == _records(ref_host)
    assert len(res.vars) > 0
    # the port's sub-screen ran (on the CPU: the plain version, which is
    # not a kernel launch)
    assert port_screen.DISPATCH_STATS["dispatched"] > before["dispatched"]
    assert port_screen.DISPATCH_STATS["columns"] > before["columns"]
    assert cuda_poissbin.launch_count() == launches


def test_reference_device_screen_agrees(workload, ref_host):
    """The reference with its own (JAX) screen forced on gives the same
    output as its host path, so the port matches both."""
    res = ref_run_call(workload["bam"], workload["fa"],
                       vconf=RefConf(use_device_screen=True,
                                     use_device_baq=False))
    assert res.stats.num_snv_tests == ref_host.stats.num_snv_tests
    assert _records(res) == _records(ref_host)


def test_port_call_screen_off_matches_reference(workload, ref_host):
    """Device screen off: the host f64 sub-screen, as in the reference."""
    before = port_screen.DISPATCH_STATS["dispatched"]
    res = run_call(workload["bam"], workload["fa"],
                   vconf=VarcallConf(use_device_screen=False))
    assert port_screen.DISPATCH_STATS["dispatched"] == before
    assert res.stats.num_snv_tests == ref_host.stats.num_snv_tests
    assert _records(res) == _records(ref_host)


def test_from_reference_copies_every_field():
    ref = RefConf(min_bq=9, sig=0.05, use_device_screen=True,
                  bonf_dynamic=False, bonf_subst=77)
    conf = VarcallConf.from_reference(ref, device="cpu")
    for name in ("min_bq", "sig", "use_device_screen", "bonf_dynamic",
                 "bonf_subst"):
        assert getattr(conf, name) == getattr(ref, name)
    assert conf.device == "cpu" and conf.screen_device().type == "cpu"
    assert conf.device_baq_on(None) is False
    assert np.float32(conf.sig) == conf.sig


def test_run_call_refuses_reference_conf(workload):
    with pytest.raises(TypeError):
        run_call(workload["bam"], workload["fa"], vconf=RefConf())


def _cli_case(case, tmp_path, monkeypatch, capsys, extra):
    for fn, content in case["files"].items():
        if fn == "in.bam":
            _minisam_to_bam(content, str(tmp_path / fn))
        else:
            (tmp_path / fn).write_text(content)
    monkeypatch.chdir(tmp_path)
    rc = port_cli.main(["call"] + extra + case["args"])
    return rc, capsys.readouterr().err


@pytest.mark.parametrize(
    "ci", range(len(_CASES)), ids=[c["name"] for c in _CASES])
def test_cli_call_golden(ci, tmp_path, monkeypatch, capsys):
    _check_golden(_CASES[ci], tmp_path, monkeypatch, capsys,
                  ["--device=cpu"])


def _check_golden(case, tmp_path, monkeypatch, capsys, extra):
    """The port's CLI with `extra` arguments gives the case's golden VCF
    (the ##source= line without the extra arguments) and test counts."""
    monkeypatch.setenv("LOFREQ_TPU_DEVICE_SCREEN", "1")
    rc, err = _cli_case(case, tmp_path, monkeypatch, capsys, extra)
    assert rc == 0, f"{case['name']}: rc={rc}\n{err}"
    got = (tmp_path / "out.vcf").read_text()
    for arg in extra:
        got = got.replace(f" {arg} ", " ", 1)
    assert _norm(got) == _norm(case["expected_vcf"]), case["name"]
    counts = [None, None]
    for line in err.splitlines():
        if "substitution tests performed" in line:
            counts[0] = int(line.rsplit(":", 1)[1])
        elif "indel tests performed" in line:
            counts[1] = int(line.rsplit(":", 1)[1])
    exp = case["expected_counts"]
    assert counts[0] == exp[0], case["name"]
    if exp[1] is not None:
        assert counts[1] == exp[1], case["name"]


@pytest.mark.parametrize(
    "ci", range(len(_CASES)), ids=[c["name"] for c in _CASES])
def test_cli_device_baq_golden(ci, tmp_path, monkeypatch, capsys):
    """--device-baq gives the VCF of the call without it: the device BAQ
    only screens, and candidates are confirmed with the exact C BAQ."""
    _check_golden(_CASES[ci], tmp_path, monkeypatch, capsys,
                  ["--device-baq", "--device=cpu"])


def _indelqual_bam(art, tmp_path):
    """BI/BD tags by the dindel model, so planted indels reach
    significance (tests/test_device_baq.py:73-79)."""
    from lofreq_tpu.io.bai import build_bai
    from lofreq_tpu.pipelines.indelqual import run_indelqual

    iq_bam = str(tmp_path / "iq.bam")
    run_indelqual(art["bam"], iq_bam, dindel=True, ref_path=art["fa"])
    build_bai(iq_bam)
    return iq_bam


_INDELS = ((0.5, 2, 3, "ins"), (0.4, 2, 4, "del"))
# the cases of tests/test_device_baq.py, and one without ext BAQ
DEVICE_BAQ_CASES = {
    "snv_only": dict(sim=dict(genome_len=25000, depth=90, seed=23)),
    "indel_reads": dict(sim=dict(genome_len=20000, depth=80, seed=5,
                                 indels=_INDELS)),
    "region": dict(sim=dict(genome_len=20000, depth=70, seed=9),
                   region=(2001, 15000)),
    "call_indels": dict(sim=dict(genome_len=20000, depth=80, seed=3,
                                 indels=_INDELS),
                        indelqual=True, vconf=dict(no_indels=False),
                        pconf=dict(collect_indels=True, use_idaq=True)),
    "no_ext_baq": dict(sim=dict(genome_len=20000, depth=80, seed=31),
                       pconf=dict(ext_baq=False)),
}


@pytest.mark.parametrize("name", list(DEVICE_BAQ_CASES))
def test_port_device_baq_matches_reference(name, tmp_path):
    """The port's device-BAQ engine (runner on the CPU: the plain HMM)
    gives the records and test counts of the reference's exact path and
    of the reference's own device-BAQ path, and every eligible read went
    through the runner."""
    spec = DEVICE_BAQ_CASES[name]
    art = simulate(str(tmp_path), **spec["sim"])
    if spec.get("indelqual"):
        art["bam"] = _indelqual_bam(art, tmp_path)
    kw = {}
    if "region" in spec:
        kw["region"] = "%s:%d-%d" % ((art["chrom"],) + spec["region"])
    vkw = spec.get("vconf", {})

    def pconf():
        return PileupConf(**spec.get("pconf", {}))

    exact = ref_run_call(art["bam"], art["fa"], pconf=pconf(), **kw,
                         vconf=RefConf(use_device_screen=False,
                                       use_device_baq=False, **vkw))
    ref_dev = ref_run_call(art["bam"], art["fa"], pconf=pconf(), **kw,
                           vconf=RefConf(use_device_screen=True,
                                         use_device_baq=True, **vkw))
    conf = VarcallConf(use_device_screen=True, use_device_baq=True,
                       device="cpu", **vkw)
    assert conf.device_baq_on(pconf())
    before = device_baq.RUN_STATS["reads"]
    with device_baq.count_extracted_reads() as extracted:
        res = run_call(art["bam"], art["fa"], vconf=conf, pconf=pconf(),
                       **kw)
    # every eligible read of every window went through the runner
    assert device_baq.RUN_STATS["reads"] - before == extracted["eligible"]
    assert extracted["eligible"] > 0
    assert conf.baq_screen_bias == BAQ_SCREEN_DELTA
    assert not conf.baq_screen_null
    assert len(exact.vars) > 0
    for other in (exact, ref_dev):
        assert _records(res) == _records(other)
        assert res.stats.num_snv_tests == other.stats.num_snv_tests
        assert res.stats.num_indel_tests == other.stats.num_indel_tests
    if vkw:
        assert any("INDEL" in (v.info or "") for v in res.vars)


def test_cli_profile_writes_trace(tmp_path, monkeypatch, capsys):
    prof = tmp_path / "prof"
    rc, err = _cli_case(_CASES[0], tmp_path, monkeypatch, capsys,
                        ["--device-screen", "--device=cpu", "--profile",
                         str(prof)])
    assert rc == 0, err
    assert any(p.name.endswith(".json") for p in prof.iterdir())
