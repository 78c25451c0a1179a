"""Host I/O layer: BGZF, BAM/SAM, FASTA/FAI, VCF, BED.

The reference links htslib for all of this (src/lofreq/Makefile.am:35-43);
this package implements the needed subset natively (pure Python + optional
C acceleration) since the compute engine only needs a columnar ingest path.
"""
