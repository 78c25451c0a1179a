"""Columnar pileup engine.

The reference's callback-driven mpileup (plp.c:1293) is inverted here into a
batch design: reads are filtered and expanded into flat per-base "row"
arrays once, then grouped by reference position into dense column tensors
that feed the device kernels.
"""
