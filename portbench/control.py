"""The comparison's control: the plain reference one precision down put
in the program's place, read against the reference at full precision.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 \
        [--device cuda]

The configuration states float64 for the BAQ HMM, the quality merge and
the Poisson-binomial DP, and x87 long double for the p-values; the
control runs them in float32 and double.  For each seed it hands one
call per sample of the cell, with the control's records and SNV tests,
to run.py's own comparison and prints the numbers that decide `correct`
beside their limits, and `correct`; the control has to come out not
correct.  The benchmark's own runs never run it.
"""

import os
import sys

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from portbench import run as R  # noqa: E402
from portbench.gen import inputs  # noqa: E402
from portbench.reference import lofreq as REF  # noqa: E402


def readings(cfg: dict, seed: int, device: str) -> dict:
    """run.compare's result for the control's calls of every sample of
    the configuration, with `correct` as run.py decides it."""
    samples = inputs.draw_all(cfg, seed)
    got = REF.call_many(samples, cfg["chrom"], device=device,
                        dtype=torch.float32, p_floor="double")
    calls = [dict(sample=j, records=records, tests=tests)
             for j, (records, tests) in enumerate(got)]
    cmp = R.compare(calls, cfg, seed, device, drawn=samples)
    return dict(cmp, correct=R.verdict(cmp["checks"]),
                records=sum(len(c["records"]) for c in calls))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    _cell, cfg, _traffic = R.find_cell(R.load_benchmark(), a.workload)
    failed_all = True
    for seed in a.seeds:
        r = readings(cfg, seed, a.device)
        print(json.dumps(dict(seed=seed, **r)), flush=True)
        failed_all &= not r["correct"]
    print(f"control is not correct on every seed: {failed_all}")
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
