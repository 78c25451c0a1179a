"""lofreq_tpu_torch — the PyTorch/CUDA port of lofreq_tpu.

A second package beside the JAX reference `lofreq_tpu`.  It imports the
reference's JAX-free host layers (BAM/FASTA/VCF I/O, the native C ingest,
pileup, exact statistics, filters) unchanged and rewrites only the modules
that reach the device: the Poisson-binomial screen and the device-BAQ
runner (ops/), the caller functions that name the screen (call/), the
`call` pipeline (pipelines/) and the CLI.  It imports torch and never
jax.
"""

__version__ = "0.1.0"
