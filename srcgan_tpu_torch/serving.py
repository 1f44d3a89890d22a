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
``self_ensemble=True`` averages the x8 dihedral self-ensemble
(``ops.ensemble``): the copies run as one batch of 8N rows (4N for a
non-square input) and their inverted fp32 RGB outputs are averaged.

``TiledPredictor`` serves scenes of any size through one tile shape: the
scene is cut into overlapping windows, run in batches, and the cores of the
output tiles are stitched.

``SpatialShardedPredictor`` runs each batch over the ``space`` ranks of a
mesh, a row strip each (``parallel.spatial``); ``SpatialShardedTiledPredictor``
is the tiled form over it.  Space rank 0 drives: its ``predict`` sends each
call's header and batch to the other ranks, which run ``follow()``.

``predict_scene`` adds each scene's output pixels to the counters
``tiler.kept_px`` (the canvas) and ``tiler.computed_px`` (every row run, the
last batch's padding included; ``utils.trace``): their ratio is the share of
the device's tiled work that the stitch keeps.
"""
from __future__ import annotations

import contextlib
import copy
import threading
from collections import deque

import numpy as np
import torch

from srcgan_tpu_torch import config, models, quant
from srcgan_tpu_torch.interop import load_params_any
from srcgan_tpu_torch.ops import ensemble
from srcgan_tpu_torch.ops.color import lab_norm_to_rgb, rgb_to_gray
from srcgan_tpu_torch.train.state import parse_checkpoint_name
from srcgan_tpu_torch.utils import trace


class CascadePredictor:
    """SR -> colorize cascade.  Takes ownership of the two models: they are
    moved to ``device`` (default: the card; raises without one unless the
    caller passes ``device="cpu"``), their parameters cast to the compute
    dtype (buffers, BatchNorm's running statistics, stay fp32), put in channels_last memory and in eval mode.

    On the card every batch is enqueued on the predictor's own side stream,
    also when several threads call it: the models' cached operands (the
    folded tail weights, the RDB5 kernel's packed weights) are built by the
    first forward, on that stream, and read by every later one."""

    def __init__(self, sr_model, c_model, up: int, *, lab: bool = False,
                 bf16: bool = False, pad_batch_to: int = 0, int8: bool = False,
                 self_ensemble: bool = False, device=None):
        # geometric self-ensemble: the D4 copies run as ONE 8N-row batch and
        # the inverted outputs average in fp32 (~8x the FLOPs of a request)
        self.self_ensemble = self_ensemble
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
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

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
            if self.self_ensemble:
                rgb = ensemble.self_ensemble_apply(self._rgb_of, x).clamp(0.0, 1.0)
            else:
                rgb = self._rgb_of(x)
            return torch.round(rgb * 255.0).to(torch.uint8)

    def _rgb_of(self, x: torch.Tensor) -> torch.Tensor:
        """(N,h,w,1) fp32 gray -> (N,h*up,w*up,3) fp32 RGB in [0, 1]."""
        # channels_last, the layout the models run in, also for the batch the
        # ensemble concatenated: the kernels then read it without a copy
        x = x.permute(0, 3, 1, 2).to(self.dtype, memory_format=torch.channels_last)
        fake_c = self.sr_model(x)
        out = self.c_model(fake_c).float()
        if self.lab:
            # L (+) ab, NHWC, back to RGB in fp32 (clipped to [0, 1] there)
            lab_img = torch.cat([fake_c.float(), out], dim=1).permute(0, 2, 3, 1)
            return lab_norm_to_rgb(lab_img)
        return out.clamp(0.0, 1.0).permute(0, 2, 3, 1)

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
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())

    def _predict_async(self, gray_u8: np.ndarray, pad: int | None = None):
        """Enqueue one batch and the copy of its result to the host, without
        waiting for either.  Returns (host tensor, event): the host tensor
        holds the result once the event (None on the CPU) has completed.
        ``pad`` overrides the batch-padding bucket (0 disables) for a caller
        that enqueues a shape the bucket would only waste work on."""
        n = gray_u8.shape[0]
        if self.int8 and not self.int8_scales:
            raise RuntimeError("int8 predictor needs calibrate() first")
        pad = self.pad if pad is None else pad
        if pad and n % pad:
            reps = pad - n % pad
            gray_u8 = np.concatenate(
                [gray_u8, np.repeat(gray_u8[-1:], reps, axis=0)], axis=0)
        cuda = self.stream is not None
        if cuda:
            # weights moved, cast or reloaded on the caller's stream must be
            # in place before this stream reads them
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with self._stream_scope():
            x = torch.from_numpy(np.require(gray_u8, requirements=("C", "W")))
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
                done.record(self.stream)
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


class TiledPredictor(CascadePredictor):
    """Whole-scene inference for images of any size through one tile shape.

    The scene is cut into overlapping ``tile`` x ``tile`` windows, run
    through the cascade in ``max_batch`` chunks (at most two in flight, so
    the host crops and stitches while the card runs), and each output tile's
    ``overlap`` halo is discarded before the cores are stitched.

    Exactness: the cascade's ops are local (convs, deconvs, pixel shuffle,
    per-pixel colour math), so with ``overlap`` >= the network's receptive
    field radius the stitched scene equals the whole image run in one call.
    Edge windows are laid flush with the scene border, never zero-padded:
    the convolutions' own zero padding then applies at the true border as
    in the whole-image call, where explicit zero pixels would become nonzero
    activations after the first bias.  Overhead grows as
    (tile / (tile - 2*overlap))^2.  Models with a global spatial reduction
    (RCAN's channel attention, GroupNorm's statistics in ResDeconv) are
    never tile-exact.

    The output scale is inferred from the first output tile, so
    resolution-preserving cascades stitch too.  Tile batches are padded to
    ``max_batch`` (one batch shape for ragged chunks); ``predict`` keeps the
    ``pad_batch_to`` bucket, so one TiledPredictor serves single requests
    and scenes.  A scene smaller than one tile in either dimension runs as
    one call of its own shape, unpadded.
    With ``self_ensemble=True`` each tile is ensembled on its own: a valid
    estimator, not equal to ensembling the whole scene.
    """

    def __init__(self, sr_model, c_model, up: int, *, tile: int = 256,
                 overlap: int = 32, max_batch: int = 8, **kw):
        if tile <= 2 * overlap:
            raise ValueError(f"tile ({tile}) must exceed 2*overlap ({2 * overlap}) "
                             "to leave a core")
        super().__init__(sr_model, c_model, up, **kw)
        self.tile, self.overlap, self.max_batch = tile, overlap, max_batch

    @staticmethod
    def _axis_windows(n: int, t: int, ov: int):
        """Per-axis window plan: (win_start, keep_off_in_win, keep_start,
        keep_len) covering [0, n) with tile windows clamped inside it."""
        core = t - 2 * ov
        plan = []
        for i in range(-(-n // core)):
            c0, c1 = i * core, min((i + 1) * core, n)
            w = min(max(c0 - ov, 0), n - t)
            plan.append((w, c0 - w, c0, c1 - c0))
        return plan

    def predict_scene(self, scene_u8: np.ndarray) -> np.ndarray:
        """(H, W) / (H, W, 1|3) uint8 -> (H*scale, W*scale, 3) uint8."""
        if scene_u8.ndim == 2:
            scene_u8 = scene_u8[..., None]
        H, W, _ = scene_u8.shape
        t = self.tile
        if H < t or W < t:
            # one call at the scene's own shape, a batch of 1: padding it to
            # max_batch would run copies of the whole scene for nothing
            out = self._collect(*self._predict_async(scene_u8[None], pad=0))[0]
            _count_pixels(out.shape[0] * out.shape[1], out.shape[0] * out.shape[1])
            return out
        rows = self._axis_windows(H, t, self.overlap)
        cols = self._axis_windows(W, t, self.overlap)
        tiles = np.stack([scene_u8[wy:wy + t, wx:wx + t]
                          for wy, _, _, _ in rows for wx, _, _, _ in cols])

        outs, pending = [], deque()
        for k in range(0, len(tiles), self.max_batch):
            pending.append(self._predict_async(tiles[k:k + self.max_batch],
                                               pad=self.max_batch))
            if len(pending) > 2:          # at most two batches in flight
                outs.append(self._collect(*pending.popleft()))
        while pending:
            outs.append(self._collect(*pending.popleft()))
        out_tiles = np.concatenate(outs, axis=0)

        s = out_tiles.shape[1] // t       # the output scale, inferred
        canvas = np.empty((H * s, W * s, 3), dtype=np.uint8)
        for idx in range(len(rows) * len(cols)):
            i, j = divmod(idx, len(cols))
            _, ky, cy, ly = rows[i]
            _, kx, cx, lx = cols[j]
            canvas[cy * s:(cy + ly) * s, cx * s:(cx + lx) * s] = \
                out_tiles[idx, ky * s:(ky + ly) * s, kx * s:(kx + lx) * s]
        rows_run = -(-len(tiles) // self.max_batch) * self.max_batch
        _count_pixels(H * s * W * s, rows_run * (t * s) ** 2)
        return canvas


def _count_pixels(kept: int, computed: int) -> None:
    """A scene's output pixels: those its canvas kept, and those the device
    computed (every row run, the last batch's padding included)."""
    trace.count("tiler.kept_px", kept)
    trace.count("tiler.computed_px", computed)


# the followers' headers: what the next broadcast holds
_STOP, _U8, _GRAY, _RELOAD = 0, 1, 2, 3
_HEADER = 8


class SpatialShardedPredictor(CascadePredictor):
    """The cascade over the ``space`` ranks of ``mesh`` (a 1-D space mesh of
    every rank by default), for images beyond one card's memory.

    Each call's batch crosses to every rank; each runs ``/255``, the SR net
    (the RDDBNet x4's RDB5 and tail kernels on its strip plus their halos in
    bf16 on the card) and the colorizer under ``spatial.space_scope`` on its
    row strip of ``spatial.cascade_geometry``'s plan, and space rank 0
    gathers the uint8 strips.  With ``self_ensemble`` rank 0 transforms the
    whole batch and the copies cross as fp32 gray, their fp32 RGB strips
    gathered.  Rank 0 drives, one call at a time; every other rank runs
    ``follow()`` until rank 0's ``stop()``.  Results match the unsharded
    predictor within uint8 rounding.  ``followers``: an object whose
    ``alive()`` rank 0 checks before each call (the serve tool's child
    processes), so that a dead follower raises instead of hanging.  Nets
    with a reduction over the whole image that the strips do not all-reduce
    (RCAN's channel attention) are refused (``spatial.refuse_global_reductions``).
    Each call adds the halo bytes its strip received to the counter
    ``space.halo_bytes`` (``utils.trace``)."""

    def __init__(self, sr_model, c_model, *args, mesh=None, followers=None, **kw):
        from srcgan_tpu_torch.parallel import spatial

        spatial.refuse_global_reductions(sr_model, "SR net")
        spatial.refuse_global_reductions(c_model, "colorizer")
        super().__init__(sr_model, c_model, *args, **kw)
        if self.int8:
            raise ValueError("the space-sharded cascade runs bf16 or fp32, not int8")
        from srcgan_tpu_torch import parallel

        self.mesh = mesh or parallel.make_mesh(None, ("space",), device=self.device)
        self.followers = followers
        self._spatial = spatial
        self._lock = threading.Lock()
        self._src = self.mesh.peer("space", 0)
        self.align, self.min_rows = spatial.cascade_geometry(self.sr_model, self.c_model,
                                                             self.up)

    @property
    def is_leader(self) -> bool:
        return self.mesh.coord("space") == 0

    def plan(self, h: int):
        """The strips of an input of h rows."""
        return self._spatial.plan_strips(h, self.mesh.size("space"), self.align,
                                         self.min_rows)

    # -- the collectives -----------------------------------------------------------

    def _broadcast(self, t: torch.Tensor) -> torch.Tensor:
        torch.distributed.broadcast(t, self._src, group=self.mesh.group("space"))
        return t

    def _send(self, kind: int, t: torch.Tensor | None = None) -> None:
        if self.followers is not None and not self.followers.alive():
            raise RuntimeError("a follower rank of the space-sharded cascade has died")
        head = torch.zeros(_HEADER, dtype=torch.int64, device=self.device)
        head[0] = kind
        if t is not None:
            head[1] = t.dim()
            head[2:2 + t.dim()] = torch.tensor(t.shape)
        self._broadcast(head)
        if t is not None:
            self._broadcast(t)

    def _strip(self, kind: int, x: torch.Tensor) -> torch.Tensor:
        """This rank's output strip of the batch x (NHWC)."""
        plan = self.plan(x.shape[1])
        xs = plan.cut(x, self.mesh.coord("space"))
        with torch.no_grad(), config.precision("bf16" if self.bf16 else "fp32"), \
                self._spatial.space_scope(self.mesh, plan) as scope:
            out = self._rgb_of(xs) if kind == _GRAY else CascadePredictor._run(self, xs)
        trace.count("space.halo_bytes", scope.halo_bytes)
        return out

    def _sharded(self, kind: int, x: torch.Tensor) -> torch.Tensor:
        self._send(kind, x)
        return self._spatial.gather_strips(self._strip(kind, x), self.mesh, dim=1)

    # -- rank 0 ----------------------------------------------------------------------

    def _run(self, gray_u8: torch.Tensor) -> torch.Tensor:
        if not self.is_leader:
            raise RuntimeError("only space rank 0 drives the sharded cascade; the others "
                               "run follow()")
        with self._lock:
            if not self.self_ensemble:
                return self._sharded(_U8, gray_u8.contiguous())
            with torch.no_grad(), config.precision("bf16" if self.bf16 else "fp32"):
                x = gray_u8.float() / 255.0
                if x.shape[-1] == 3:
                    x = rgb_to_gray(x)
                rgb = ensemble.self_ensemble_apply(
                    lambda v: self._sharded(_GRAY, v.contiguous()), x).clamp(0.0, 1.0)
                return torch.round(rgb * 255.0).to(torch.uint8)

    def reload_checkpoints(self, netGA: str, netGB: str):
        """As ``CascadePredictor.reload_checkpoints``; ``install()`` also
        sends the paths to the followers, which load and install them."""
        install_here = super().reload_checkpoints(netGA, netGB)

        def install():
            with self._lock:
                self._send(_RELOAD)
                torch.distributed.broadcast_object_list([netGA, netGB], self._src,
                                                        group=self.mesh.group("space"))
                install_here()

        return install

    def stop(self) -> None:
        """Rank 0: end the followers' loops."""
        with self._lock:
            self._send(_STOP)

    # -- the other ranks ----------------------------------------------------------

    def follow(self) -> None:
        """Serve rank 0's calls until its ``stop()``."""
        dtypes = {_U8: torch.uint8, _GRAY: torch.float32}
        while True:
            head = self._broadcast(torch.zeros(_HEADER, dtype=torch.int64,
                                               device=self.device)).tolist()
            kind = head[0]
            if kind == _STOP:
                return
            if kind == _RELOAD:
                paths = [None, None]
                torch.distributed.broadcast_object_list(paths, self._src,
                                                        group=self.mesh.group("space"))
                super().reload_checkpoints(*paths)()
                continue
            x = torch.empty(head[2:2 + head[1]], dtype=dtypes[kind], device=self.device)
            self._spatial.gather_strips(self._strip(kind, self._broadcast(x)), self.mesh,
                                        dim=1)


class SpatialShardedTiledPredictor(SpatialShardedPredictor, TiledPredictor):
    """Scenes of any size over the space ranks: ``TiledPredictor``'s window
    plan and stitching on rank 0, every tile batch (and a sub-tile scene at
    its own shape) through ``SpatialShardedPredictor._run``.  The serve
    tool's ``--mesh-size`` with ``--tile``.  Cooperative ``__init__``:
    SpatialShardedPredictor takes ``mesh`` and ``followers``, TiledPredictor
    ``tile`` / ``overlap`` / ``max_batch``, CascadePredictor the rest.
    Heights smaller than the mesh, or not divisible by it, leave ranks
    empty or ragged (``spatial.plan_strips``)."""
