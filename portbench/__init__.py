"""The benchmark of lofreq_tpu_torch (see portbench/run.py)."""
