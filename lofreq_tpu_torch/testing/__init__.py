"""Test helpers of the port: the simulated BAM of chip_smoke.py, the g++
shims of the kernel bodies, and a harness that records one
call-distributed rank's result."""
