"""Utilities: logging, visualization, image IO, the live dashboard."""
from srcgan_tpu_torch.utils import vis
from srcgan_tpu_torch.utils.logging import Logger, StepTimer, profile_trace

__all__ = ["Logger", "StepTimer", "profile_trace", "vis"]
