"""Trainers of the port: the cascade (CasSRC), the CycleGAN and the multi-task
GAN; optim and state."""
from srcgan_tpu_torch.train.cas import CasState, CasTrainer
from srcgan_tpu_torch.train.cyclegan import CycleGANTrainer, CycleState, ImagePool
from srcgan_tpu_torch.train.multitask import MultiTaskTrainer
from srcgan_tpu_torch.train import optim, state
from srcgan_tpu_torch.train.state import (
    TrainState,
    checkpoint_name,
    load_params,
    parse_checkpoint_name,
    save_params,
)

__all__ = [
    "CasState", "CasTrainer", "CycleGANTrainer", "CycleState", "ImagePool", "MultiTaskTrainer",
    "optim", "state", "TrainState", "checkpoint_name", "load_params",
    "parse_checkpoint_name", "save_params",
]
