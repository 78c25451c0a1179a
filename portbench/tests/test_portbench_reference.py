"""The plain reference against the port's host-screen `call`, and its
control against the reference."""

import numpy as np
import pytest
import torch

from portbench.gen import inputs, simulate as S
from portbench.reference import baq as BAQ, lofreq as REF

from bench_small import small_configs

CASES = [("ecoli-800x", 0, 3), ("ecoli-800x", 0, 2 ** 33 + 5),
         ("sarscov2-cohort", 0, 4), ("sarscov2-cohort", 1, 2 ** 31 + 9)]


def port_call(tmp_path, cfg, reads):
    from lofreq_tpu_torch.call.caller import VarcallConf
    from lofreq_tpu_torch.pipelines.call_pipeline import call_and_filter

    S.write_sample(str(tmp_path), cfg["chrom"], reads, threads=2)
    out = str(tmp_path / "out.vcf")
    res = call_and_filter(str(tmp_path / "reads.bam"),
                          str(tmp_path / "ref.fa"), out,
                          vconf=VarcallConf(device="cpu",
                                            use_device_screen=False))
    with open(out) as fh:
        lines = [ln.rstrip("\n") for ln in fh if not ln.startswith("#")]
    return lines, res.stats.num_snv_tests


@pytest.mark.parametrize("config,sample,seed", CASES)
def test_reference_records_and_tests_equal_the_port(tmp_path, config,
                                                    sample, seed):
    cfg = small_configs()[config]
    reads = inputs.draw(cfg, seed, sample)
    want, want_tests = port_call(tmp_path, cfg, reads)
    got, got_tests = REF.call(reads, cfg["chrom"])
    assert want, "the port called nothing: the case proves nothing"
    assert got == want
    assert got_tests == want_tests


@pytest.mark.parametrize("config,sample,seed", CASES[:1] + CASES[2:3])
def test_reference_baq_equals_the_ports_c_baq(tmp_path, config, sample,
                                              seed):
    from lofreq_tpu_torch.io.bam import BamReader
    from lofreq_tpu_torch.ops.baq import add_alnqual_tags

    cfg = small_configs()[config]
    reads = inputs.draw(cfg, seed, sample)
    keep = np.arange(0, len(reads["starts"]), 7)[:600]
    S.write_sample(str(tmp_path), "c", dict(
        reads, starts=reads["starts"][keep], seqs=reads["seqs"][keep],
        quals=reads["quals"][keep], flags=reads["flags"][keep]), threads=1)
    recs = list(BamReader(str(tmp_path / "reads.bam")))
    add_alnqual_tags(recs, reads["genome"].tobytes(), baq=True,
                     ext_baq=True, idaq=False)
    want = np.array([np.frombuffer(r.get_tag("lb").encode(), np.uint8) - 33
                     for r in recs])
    code = REF._CODE
    got = BAQ.read_baq_many([(torch.from_numpy(code[reads["genome"]]),
                              torch.from_numpy(reads["starts"][keep]),
                              torch.from_numpy(code[reads["seqs"][keep]]),
                              torch.from_numpy(reads["quals"][keep]))])[0]
    got = got.numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", [5, 6, 2 ** 31 + 1])
def test_the_control_fails_the_comparison(seed):
    """The reference one precision down (float32 DP, merge and BAQ;
    double p-values), put in the program's place, comes out not correct
    through run.py's own comparison: its records differ."""
    from portbench.control import readings

    r = readings(small_configs()["ecoli-800x"], seed, "cpu")
    assert r["correct"] is False
    assert r["checks"]["records_differing"]["value"] > 0
    assert r["failed"] == 1


def test_fisher_two_sided_against_scipy():
    from scipy.stats import fisher_exact

    rng = np.random.default_rng(1)
    for _ in range(50):
        t = rng.integers(0, 40, 4)
        want = fisher_exact([[t[0], t[1]], [t[2], t[3]]])[1]
        assert REF.fisher_two_sided(*map(int, t)) == pytest.approx(
            min(want, 1.0), rel=1e-9)


def test_tail_dp_against_direct_enumeration():
    rng = np.random.default_rng(2)
    p = rng.uniform(0.001, 0.3, (3, 9))
    depths = torch.tensor([9, 7, 4])
    tails = REF.tail_dp(torch.from_numpy(p), depths, 4, torch.float64)
    for b in range(3):
        n = int(depths[b])
        dist = np.zeros(n + 1)
        dist[0] = 1.0
        for x in p[b, :n]:
            dist[1:] = dist[1:] * (1 - x) + dist[:-1] * x
            dist[0] *= 1 - x
        for k in range(5):
            assert np.exp(tails[b, k].item()) == pytest.approx(
                dist[k:].sum(), rel=1e-12)


@pytest.mark.gpu
def test_reference_on_the_card_equals_the_cpu(cuda):
    cfg = small_configs()["sarscov2-cohort"]
    reads = inputs.draw(cfg, 7, 1)
    assert REF.call(reads, cfg["chrom"], device="cuda") == \
        REF.call(reads, cfg["chrom"], device="cpu")


@pytest.mark.gpu
def test_reference_on_the_card_equals_the_cpu_ecoli(cuda):
    cfg = small_configs()["ecoli-800x"]
    reads = inputs.draw(cfg, 8, 0)
    assert REF.call(reads, cfg["chrom"], device="cuda") == \
        REF.call(reads, cfg["chrom"], device="cpu")


def test_class_tail_equals_the_dp_on_one_probability_per_class():
    rng = np.random.default_rng(3)
    p_q = torch.tensor([0.02, 0.001, 0.0004], dtype=torch.float64)
    hist = torch.from_numpy(rng.integers(0, 300, (6, 3)))
    K = torch.tensor([1, 2, 3, 5, 9, 20])
    got = REF.tail_by_class(hist, p_q, K)
    for b in range(6):
        probs = torch.repeat_interleave(p_q, hist[b])[None, :]
        want = REF.tail_dp(probs, torch.tensor([probs.shape[1]]),
                           int(K[b]), torch.float64)[0, int(K[b])]
        assert got[b].item() == pytest.approx(np.exp(want.item()),
                                              rel=1e-9, abs=1e-13)


def test_many_samples_together_equal_each_alone():
    cfg = small_configs()["sarscov2-cohort"]
    samples = inputs.draw_all(cfg, 21)
    together = REF.call_many(samples, cfg["chrom"])
    assert together == [REF.call(s, cfg["chrom"]) for s in samples]
