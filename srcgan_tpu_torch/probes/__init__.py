"""Tensor-core and data-movement probes for one NVIDIA card.

    python -m srcgan_tpu_torch.probes [matmul|mxu|layout ...] [abcd] [--device cpu]

The entry points of ``ops.kernels.probe_kernels``: the shape sweeps of the
JAX package's ``scripts/pallas_matmul_probe.py``, ``pallas_mxu_probe.py`` and
``pallas_layout_probe3.py`` with the same printed columns (microseconds per
dot, TFLOP/s or TOP/s, GB/s for the roll), each beside the PyTorch call that
computes the same function where there is one.  They run on the card and
raise without one; ``--device cpu`` runs the plain versions at a small M and
prints no rate.
"""
