"""Device kernels on PyTorch: the Poisson-binomial screen (cuda_poissbin,
hand-written CUDA for Hopper) and its dispatch layer (screen); the BAQ
HMM (cuda_baq, hand-written CUDA; plain version baq_torch) and the
device-BAQ runner (device_baq).  Exact confirmation happens on host
(lofreq_tpu.core / lofreq_tpu.native)."""
