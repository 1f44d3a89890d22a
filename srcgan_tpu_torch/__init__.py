"""PyTorch / CUDA port of srcgan_tpu for NVIDIA Hopper (H100).

The package mirrors the JAX package's module paths (``config``, ``ops``,
``models``, ``interop``, ``train.state``, ``serving``) and imports neither
jax nor ``srcgan_tpu``.  The x4 serving cascade (RDDBNet -> ResDeconv) runs
end to end; its one TPU kernel, the x4 upsample tail, is the hand-written
sm_90a kernel in ``csrc/tail_x4.cu`` (``ops.kernels.tail_kernel``).
"""
