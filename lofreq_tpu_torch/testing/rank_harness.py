"""One rank of the port's CLI `call-distributed`, with its
run_distributed_call result written to a JSON file:

    python -m lofreq_tpu_torch.testing.rank_harness OUT.json \\
        call-distributed --num-processes 2 --process-id 0 ...

It runs lofreq_tpu_torch.cli as `python -m lofreq_tpu_torch.cli` would,
with the same arguments and exit code, and writes OUT.json once the rank's
shard is written and its counters all-reduced: the shard, the global test
counts, the rank's record count, its screen dispatches and kernel launches
and the wall-clock time its set-up was done (run_distributed_call's dict),
with its rank.  The tests and chip_smoke.py read each rank's launches
from it.
"""

from __future__ import annotations

import json
import runpy
import sys


def main(argv) -> None:
    from ..parallel import distributed

    out_path, cli_args = argv[0], argv[1:]
    run = distributed.run_distributed_call

    def recorded(*args, **kw):
        info = run(*args, **kw)
        with open(out_path, "w") as fh:
            json.dump(dict(info, rank=distributed.world()[0]), fh)
        return info

    distributed.run_distributed_call = recorded
    sys.argv = ["lofreq_tpu_torch.cli", *cli_args]
    runpy.run_module("lofreq_tpu_torch.cli", run_name="__main__")


if __name__ == "__main__":
    main(sys.argv[1:])
