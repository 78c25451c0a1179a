"""lofreq_tpu_torch — the PyTorch/CUDA port of lofreq_tpu.

A second package beside the JAX reference `lofreq_tpu`, and one that stands
on its own: it imports torch, never jax, and nothing of `lofreq_tpu`.  It
keeps its own copies of the reference's host layers (BAM/FASTA/VCF I/O,
the native C library in csrc/host/, pileup, exact statistics, filters),
with the reference's bodies, and rewrites the modules that reach the
device: the Poisson-binomial screen and the device-BAQ runner (ops/), the
device column step and its fused kernel (ops/device_call.py,
ops/fused_call.py, entry.py), the caller's conf and screen dispatch
(call/), the `call` pipeline (pipelines/), the layer across processes and
cards on torch.distributed (parallel/) and the CLI.  Its device engines
run on the CUDA card unless the caller names the CPU.
"""

__version__ = "0.1.0"
