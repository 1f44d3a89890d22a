"""Serving the SR -> colorize cascade on one device, as in ``srcgan_tpu.serving``.

    pred = CascadePredictor.from_checkpoints(
        "checkpoints/RDDBNet_A2C_x4_0050.npz",
        "checkpoints/ResDeconv_C2B_x4_0050.npz", bf16=True, device="cuda")
    sr_u8 = pred.predict(gray_u8_batch)   # (N,h,w,{1|3}) -> (N,h*up,w*up,3)

uint8 in, uint8 out: the input is divided by 255 (an RGB input is turned to
luma first), runs through the SR generator and the colorizer, and the result
is clipped to [0, 1], scaled by 255, rounded half to even and cast.  bf16 mode
runs both networks in bf16; fp32 mode runs them in fp32 with TF32 off
(``config.precision``).  ``lab=True`` serves a G2LAB cascade: the SR output
is L, the colorizer's two channels are ab, and L (+) ab goes through
``lab_norm_to_rgb`` in fp32 after the cascade.  ``pad_batch_to`` pads a ragged batch with copies of
its last row up to a multiple of the bucket.  ``int8=True`` serves the
post-training quantized cascade (``srcgan_tpu_torch.quant``): fp32 between
the convolutions, ``calibrate()`` before the first ``predict``.
"""
from __future__ import annotations

import contextlib
import copy
from collections import deque

import numpy as np
import torch

from srcgan_tpu_torch import config, models, quant
from srcgan_tpu_torch.interop import load_params_any
from srcgan_tpu_torch.ops.color import lab_norm_to_rgb, rgb_to_gray
from srcgan_tpu_torch.train.state import parse_checkpoint_name


class CascadePredictor:
    """SR -> colorize cascade.  Takes ownership of the two models: they are
    moved to ``device`` (default: the card; raises without one unless the
    caller passes ``device="cpu"``), their parameters cast to the compute
    dtype (buffers, BatchNorm's running statistics, stay fp32), put in channels_last memory and in eval mode."""

    def __init__(self, sr_model, c_model, up: int, *, lab: bool = False,
                 bf16: bool = False, pad_batch_to: int = 0, int8: bool = False,
                 self_ensemble: bool = False, device=None):
        if self_ensemble:
            raise NotImplementedError("self-ensemble comes with the serving extras (ROADMAP A12)")
        # int8: per-channel weight scales + calibrated activation scales;
        # needs calibrate() before predict
        self.int8 = int8
        self.int8_scales = {}
        if int8:
            bf16 = False  # the dequantized values run fp32 between the convolutions
        self.up, self.lab, self.bf16 = up, lab, bf16
        self.pad = pad_batch_to
        self.device = config.resolve_device(device)
        self.dtype = config.DTYPES["bf16" if bf16 else "fp32"]
        self.sr_model = self._adopt(sr_model)
        self.c_model = self._adopt(c_model)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    def _adopt(self, model):
        model.to(device=self.device, memory_format=torch.channels_last)
        # parameters only: BatchNorm's running statistics stay fp32
        return config.cast_parameters(model, self.dtype).eval().requires_grad_(False)

    # -- constructors --------------------------------------------------------

    @classmethod
    def from_checkpoints(cls, netGA: str, netGB: str, bf16: bool = False,
                         device=None, **kw) -> "CascadePredictor":
        """Build from name-encoded checkpoints (.npz from the JAX package, or
        reference .pth)."""
        infoA = parse_checkpoint_name(netGA)
        infoB = parse_checkpoint_name(netGB)
        lab = infoA["ver"] == "G2LAB"
        up = infoA["up"]
        sr = load_params_any(models.create(infoA["model"], 1, 1, up), netGA)
        c = load_params_any(models.create(infoB["model"], 1, 2 if lab else 3), netGB)
        return cls(sr, c, up, lab=lab, bf16=bf16, device=device, **kw)

    def reload_checkpoints(self, netGA: str, netGB: str):
        """Hot-reload weights for this predictor's exact architecture.

        Loading, the dtype cast and the host-to-device copy happen on the
        calling thread, into copies of the models; the returned ``install()``
        only rebinds them, so callers serialise it with in-flight ``predict``
        calls however they like."""
        if self.int8:
            raise ValueError("int8 predictors cannot hot-reload: the calibrated "
                             "activation scales belong to the old weights; build a "
                             "new predictor and calibrate it")
        infoA = parse_checkpoint_name(netGA)
        infoB = parse_checkpoint_name(netGB)
        if infoA["role"] != "A2C" or infoB["role"] != "C2B":
            raise ValueError(f"reload needs an (A2C, C2B) checkpoint pair; got "
                             f"{infoA['role']} + {infoB['role']}")
        if infoA["up"] != self.up:
            raise ValueError(f"checkpoint is x{infoA['up']} but this predictor "
                             f"serves x{self.up}")
        if (infoA["ver"] == "G2LAB") != self.lab:
            raise ValueError(f"checkpoint is {infoA['ver']} but this predictor "
                             f"serves {'G2LAB' if self.lab else 'G2RGB'}")
        sr = load_params_any(copy.deepcopy(self.sr_model), netGA)
        c = load_params_any(copy.deepcopy(self.c_model), netGB)

        def install():
            self.sr_model, self.c_model = sr, c

        return install

    # -- the forward -----------------------------------------------------------

    def _run(self, gray_u8: torch.Tensor) -> torch.Tensor:
        """(N,h,w,1|3) uint8 on the device -> (N,h*up,w*up,3) uint8."""
        with torch.no_grad(), config.precision("bf16" if self.bf16 else "fp32"):
            x = gray_u8.float() / 255.0
            if x.shape[-1] == 3:
                x = rgb_to_gray(x)
            x = x.permute(0, 3, 1, 2).to(self.dtype, memory_format=torch.channels_last)
            fake_c = self.sr_model(x)
            out = self.c_model(fake_c).float()
            if self.lab:
                # L (+) ab, NHWC, back to RGB in fp32 (clipped to [0, 1] there)
                lab_img = torch.cat([fake_c.float(), out], dim=1).permute(0, 2, 3, 1)
                rgb = lab_norm_to_rgb(lab_img)
            else:
                rgb = out.clamp(0.0, 1.0).permute(0, 2, 3, 1)
            return torch.round(rgb * 255.0).to(torch.uint8)

    @property
    def int8_scales(self):
        """The calibration table: callsite index -> per-channel absmax (numpy)."""
        return self._int8_scales

    @int8_scales.setter
    def int8_scales(self, scales) -> None:
        self._int8_scales = scales
        self._int8_prepared = {}          # device operands per callsite belong to one table

    def calibrate(self, gray_u8_batches) -> None:
        """int8 mode: record per-callsite activation scales from representative
        uint8 batches (a float pass over each; the absmax over all of them).
        Waits for the device; a handful of batches is enough."""
        if not self.int8:
            raise ValueError("calibrate() only applies to int8 predictors")
        self.int8_scales = quant.calibrate_fn(
            lambda b: self._run(torch.from_numpy(np.ascontiguousarray(b)).to(self.device)),
            gray_u8_batches)

    def _stream_scope(self):
        return (torch.cuda.stream(self._stream) if self._stream is not None
                else contextlib.nullcontext())

    def _predict_async(self, gray_u8: np.ndarray):
        """Enqueue one batch and the copy of its result to the host, without
        waiting for either.  Returns (host tensor, event): the host tensor
        holds the result once the event (None on the CPU) has completed."""
        n = gray_u8.shape[0]
        if self.int8 and not self.int8_scales:
            raise RuntimeError("int8 predictor needs calibrate() first")
        if self.pad and n % self.pad:
            reps = self.pad - n % self.pad
            gray_u8 = np.concatenate(
                [gray_u8, np.repeat(gray_u8[-1:], reps, axis=0)], axis=0)
        cuda = self._stream is not None
        if cuda:
            # weights moved, cast or reloaded on the caller's stream must be
            # in place before this stream reads them
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with self._stream_scope():
            x = torch.from_numpy(np.ascontiguousarray(gray_u8))
            if cuda:
                x = x.pin_memory()
            with (quant.quant_mode("int8", self.int8_scales, self._int8_prepared)
                  if self.int8 else contextlib.nullcontext()):
                out = self._run(x.to(self.device, non_blocking=True))[:n]
            host = torch.empty(out.shape, dtype=torch.uint8, pin_memory=cuda)
            host.copy_(out, non_blocking=True)
            done = None
            if cuda:
                done = torch.cuda.Event()
                done.record(self._stream)
        return host, done

    @staticmethod
    def _collect(host: torch.Tensor, done) -> np.ndarray:
        if done is not None:
            done.synchronize()
        return host.numpy()

    def predict(self, gray_u8: np.ndarray) -> np.ndarray:
        """(N, h, w, 1|3) uint8 LR gray (or RGB, luma taken) -> SR RGB uint8."""
        return self._collect(*self._predict_async(gray_u8))

    def predict_stream(self, batches, lookahead: int = 2):
        """Serve an iterator of uint8 batches with ``lookahead`` batches in
        flight on the predictor's CUDA stream: the host prepares and enqueues
        batches k+1..k+lookahead while the device runs batch k.  Yields the
        uint8 outputs in order."""
        q = deque()
        for b in batches:
            q.append(self._predict_async(b))
            if len(q) > lookahead:
                yield self._collect(*q.popleft())
        while q:
            yield self._collect(*q.popleft())
