"""Exact (float64/longdouble) host-side statistical core.

These are the correctness oracles: the TPU kernels in ``lofreq_tpu.ops``
screen in f32 and defer borderline columns to these exact routines, so final
VCF output is identical to an all-exact evaluation.
"""
