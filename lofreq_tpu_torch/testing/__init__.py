"""Test-data helpers of the port (the simulated BAM of chip_smoke.py)."""
