"""Hand-written CUDA kernels (sources in ``srcgan_tpu_torch/csrc``), each
beside its plain PyTorch version."""
