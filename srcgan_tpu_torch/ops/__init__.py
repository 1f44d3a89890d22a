"""Tensor ops of the port: NHWC tensors and HWIO weights at the function
boundary, as in ``srcgan_tpu.ops``."""
