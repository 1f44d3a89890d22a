"""Tensor ops of the port: NHWC tensors and HWIO weights at the function
boundary, as in ``srcgan_tpu.ops``."""
from srcgan_tpu_torch.ops.conv import (conv2d, conv_transpose2d, pixel_shuffle,  # noqa: F401
                                       pixel_unshuffle)
