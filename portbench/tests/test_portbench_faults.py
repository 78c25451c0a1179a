"""A whole run on the CPU (the look for a card skipped, the port on its
plain CPU paths) with the timed path broken underneath: `correct` has to
come out false for each fault a cell can have, and true without one."""

import pytest

from portbench import run as R

from bench_small import bench_root


def _no_vcf(orig):
    """The call returns without writing: its output stays as it was."""
    def write_vcf(path, vars_, header):
        return None
    return write_vcf


def _altered(orig):
    """One answer altered where it is produced: a record's QUAL."""
    def write_vcf(path, vars_, header):
        if vars_:
            vars_[0].qual += 1
        return orig(path, vars_, header)
    return write_vcf


def _half(orig):
    """Half of the work left out: only the first half of the contig."""
    def run_call(bam_path, ref_path, **kw):
        from lofreq_tpu_torch.io.bam import BamReader

        name, length = BamReader(bam_path).header.references[0]
        kw["region"] = f"{name}:1-{length // 2}"
        return orig(bam_path, ref_path, **kw)
    return run_call


FAULTS = {"none": None, "no_vcf": ("write_vcf", _no_vcf),
          "altered": ("write_vcf", _altered), "half": ("run_call", _half)}


@pytest.mark.parametrize("workload", ["ecoli-800x.call",
                                      "sarscov2-cohort.call"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_correct_is_false_under_each_fault(tmp_path, monkeypatch, workload,
                                           fault):
    from lofreq_tpu_torch.pipelines import call_pipeline

    if FAULTS[fault]:
        attr, make = FAULTS[fault]
        monkeypatch.setattr(call_pipeline, attr,
                            make(getattr(call_pipeline, attr)))
    code, res = R.run(workload, 2 ** 31 + 3, 0.3, False, device="cpu",
                      root=bench_root(tmp_path), out=lambda s: None)
    assert code == 0
    assert res["attempted"] >= 1
    assert res["correct"] is (fault == "none"), res["checks"]
    assert (res["failed"] == 0) is (fault == "none")
    assert list(res)[-1] == "checks"


def test_traced_run_reads_the_per_layer_metrics_it_can_on_the_cpu(tmp_path):
    code, res = R.run("ecoli-800x.call", 5, 0.3, True, device="cpu",
                      root=bench_root(tmp_path), out=lambda s: None)
    assert code == 0 and res["correct"]
    m = res["metrics"]
    assert m["ingest_busy_s"]["value"] > 0 and m["confirm_busy_s"]["value"] > 0
    # no card: no device time, so no roofline is read
    assert "k1_roofline" not in m
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
