"""Evaluation metrics (MSE / PSNR / AE / SSIM) over NHWC tensors, as in
``srcgan_tpu.metrics``, on the device of the inputs.

  - AE: per-pixel angular error in degrees between channel vectors, eps 1e-6
    in the denominator, the cosine clipped to [-1, 1], mean over H, W ->
    one value per sample.
  - MSE / PSNR: the plain mean, and 10 log10(1 / mse) for images in [0, 1].
  - SSIM: 11x11 Gaussian window (sigma 1.5), *valid* per-channel filter, and
    the protocol's automatic dynamic range (max > 128 -> 255 else 1;
    min < -0.5 -> -1 else 0), detected on the device without a branch.  A
    CUDA tensor goes through the hand-written kernel
    (``ops.kernels.ssim_kernel``), a CPU tensor through its plain version
    ``ssim_reference``.

Each metric is a callable object whose repr() is its Performs.csv column.
"""
from __future__ import annotations

import math

import torch

from srcgan_tpu_torch.ops.kernels.ssim_kernel import ssim_fused, ssim_reference

EPS = 1e-6

__all__ = ["EPS", "mse", "psnr", "angular_error", "ssim", "ssim_reference", "MSE", "PSNR",
           "AE", "SSIM", "default_evaluators", "mse_per_sample", "psnr_per_sample",
           "ae_per_sample", "ssim_per_sample", "per_sample_evaluators"]


def mse(y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    return torch.mean((y_pred - y_true) ** 2)


def psnr(y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    return 10.0 * torch.log10(1.0 / mse(y_pred, y_true))


def angular_error(y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    """Mean angular error (degrees) between channel vectors; (N,) per sample."""
    dot = torch.sum(y_pred * y_true, dim=-1)
    n_pred = torch.sqrt(torch.sum(y_pred * y_pred, dim=-1))
    n_true = torch.sqrt(torch.sum(y_true * y_true, dim=-1))
    cos = dot / (n_pred * n_true + EPS)
    ae = 180.0 / math.pi * torch.acos(torch.clamp(cos, -1.0, 1.0))
    return ae.mean(dim=(1, 2))


def ssim(y_pred: torch.Tensor, y_true: torch.Tensor, w_size: int = 11,
         size_average: bool = True, full: bool = False):
    """SSIM with the dynamic range detected over the whole batch: a scalar,
    or (N,) with ``size_average=False``; with ``full`` also the
    contrast-structure mean."""
    return ssim_fused(y_pred, y_true, w_size=w_size, size_average=size_average, full=full)


class _Metric:
    def __init__(self, name: str, fn):
        self._name, self._fn = name, fn

    def __repr__(self):
        return self._name

    def __call__(self, y_pred, y_true, **kw):
        return self._fn(y_pred, y_true, **kw)


class MSE(_Metric):
    def __init__(self):
        super().__init__("MSE", mse)


class PSNR(_Metric):
    def __init__(self):
        super().__init__("PSNR", psnr)


class AE(_Metric):
    def __init__(self):
        super().__init__("AE", angular_error)


class SSIM(_Metric):
    def __init__(self):
        super().__init__("SSIM", ssim)


def default_evaluators():
    """The evaluation battery, in Performs.csv column order."""
    return [MSE(), PSNR(), AE(), SSIM()]


# ---------------------------------------------------------------------------
# Per-sample forms: a batched evaluation whose mean over the samples equals
# the protocol's one-sample-at-a-time average.
# ---------------------------------------------------------------------------

def mse_per_sample(y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    return torch.mean((y_pred - y_true) ** 2, dim=(1, 2, 3))


def psnr_per_sample(y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    return 10.0 * torch.log10(1.0 / mse_per_sample(y_pred, y_true))


def ae_per_sample(y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    """angular_error already returns per-sample values."""
    return angular_error(y_pred, y_true)


def ssim_per_sample(y_pred: torch.Tensor, y_true: torch.Tensor, w_size: int = 11):
    """Per-sample SSIM with the dynamic range detected PER SAMPLE: what the
    protocol computes when it is fed one sample at a time."""
    return ssim_fused(y_pred, y_true, w_size=w_size, size_average=False,
                      per_sample_range=True)


def per_sample_evaluators():
    """[(csv_name, fn)] matching default_evaluators() under a batch-1 replay."""
    return [("MSE", mse_per_sample), ("PSNR", psnr_per_sample),
            ("AE", ae_per_sample), ("SSIM", ssim_per_sample)]
