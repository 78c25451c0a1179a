"""Distributed execution: device lists, multi-process initialization and
region scheduling across processes.

Counterpart of lofreq_tpu/parallel.  Single-host parallelism lives in
pipelines/parallel_call.py (a process pool over greedy-bisection region
bins, like the reference's wrapper).  This package adds the layer across
processes and cards on torch.distributed: process-group initialization,
the cards a process drives, the counter all-reduce, and the cross-process
variant of the region scheduler.
"""
