"""SRCycleGAN trainer, adversarial SR with cycle consistency, as in
``srcgan_tpu.train.cyclegan``.

  g_step: the six generator passes (fake / recl / iden), the GAN losses
          against frozen discriminators, the cycle (x lambda x 0.5) and
          identity terms, one Adam update over the joint G_A + G_B
          parameters;
  d_step: each discriminator on real images and on pooled fakes,
          0.5 x (real + fake), one Adam update over the joint D_A + D_B
          parameters (lr 1e-5).

Networks, by ``net``: '1' RDDBNetB(3,3) up / RDDBNetD(3,3) down (realA is
the nearest 1/scale downsample of the RGB target); 'SRdens'
SRDenseNetA(1,3) / SRDenseNetB(3,1); anything else RDDBNetB(1,3) /
RDDBNetD(3,1).  Both discriminators are NLayerDiscriminator(c, 64, 2).

The math is the JAX trainer's; the form is PyTorch's, as in ``train.cas``:

- **State, updated in place.**  ``CycleState(g, d)`` holds two
  ``TrainState``s over an ``nn.ModuleDict`` each ({G_A, G_B} and {D_A, D_B},
  one Adam over each dict, as the reference chains the parameters); the
  discriminators' buffers (BatchNorm running statistics) are the model
  state, ``CycleState.d_model_state``.  The step methods update the modules
  and optimizers in place and return a ``CycleState`` over the same objects
  with the step advanced.  ``g_grads`` and ``d_grads`` change nothing.
- **Frozen discriminators in the G step**: they run in train mode
  (BatchNorm on the batch's statistics) through
  ``torch.func.functional_call`` on detached parameters and on copies of
  their buffers, which are dropped, as JAX discards the returned state.  The
  D step threads the BatchNorm state real -> fake and keeps it.
- **act_dtype=torch.bfloat16** runs the generators on a working copy of
  their parameters at that dtype, refreshed from the fp32 masters every
  step, and on inputs cast to it; the copy's gradients, cast to fp32, are
  the masters' (as JAX's gradient flows back through its cast).  The
  discriminators run in fp32, their inputs and parameters cast as the JAX
  convolution casts them.  No autocast.
- **remat**: each generator pass under ``torch.utils.checkpoint``
  (non-reentrant), and per-RRDB remat on this trainer's generators
  (``blocks.set_trunk_remat``).  The generators stay in train mode, so no
  pass reaches the eval-only RDB5 kernel.
- **Pools.**  ``ImagePool`` is the reference's pool, its draws from
  ``random.Random(seed)`` exactly as the JAX one's; the images it holds may
  be device tensors, which stay on the device.  The device pool
  (``device_pool_init``, ``gd_step_pooled``) has the same semantics with no
  host round trip, its draws from a ``torch.Generator`` on the device: a
  different random stream, as the JAX package's device pool differs from
  its host pool.
- **K steps per call** (``gd_steps_u8``, ``gd_steps_pooled_u8``) are Python
  loops with the JAX scan's return protocol.
"""
from __future__ import annotations

import copy
import random as _random
from typing import Dict, List, NamedTuple, Tuple

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from srcgan_tpu_torch import config, losses, losses_vgg, models
from srcgan_tpu_torch.data import preprocess
from srcgan_tpu_torch.models.blocks import set_trunk_remat
from srcgan_tpu_torch.ops.conv import to_nchw, to_nhwc
from srcgan_tpu_torch.ops.resize import interpolate
from srcgan_tpu_torch.train import optim
from srcgan_tpu_torch.train.state import TrainState

Aux = Dict[str, torch.Tensor]


class ImagePool:
    """History buffer of generated images with the reference's 50% replace
    policy.  Stateful, its draws on the host; the images stay on their
    device."""

    def __init__(self, pool_size: int, seed: int = 0):
        self.pool_size = pool_size
        self.num_imgs = 0
        self.images: List = []
        self._rng = _random.Random(seed)

    def query(self, images: torch.Tensor) -> torch.Tensor:
        if self.pool_size == 0:
            return images
        out = []
        for image in images:
            image = image[None]
            if self.num_imgs < self.pool_size:
                self.num_imgs += 1
                self.images.append(image)
                out.append(image)
            elif self._rng.uniform(0, 1) > 0.5:
                rid = self._rng.randint(0, self.pool_size - 1)
                tmp = self.images[rid].clone()
                self.images[rid] = image
                out.append(tmp)
            else:
                out.append(image)
        return torch.cat(out, 0)


class CycleState(NamedTuple):
    g: TrainState          # ModuleDict {G_A, G_B}
    d: TrainState          # ModuleDict {D_A, D_B}; its buffers are the model state

    @property
    def d_model_state(self) -> Dict[str, torch.Tensor]:
        """The discriminators' BatchNorm running statistics, by buffer name."""
        return dict(self.d.model.named_buffers())


def _sub(named: Dict[str, torch.Tensor], role: str) -> Dict[str, torch.Tensor]:
    """The entries of one network of a ModuleDict, its prefix stripped."""
    cut = len(role) + 1
    return {k[cut:]: v for k, v in named.items() if k.startswith(role + ".")}


@torch.no_grad()
def _adam_update(ts: TrainState, grads: Dict[str, torch.Tensor], lr) -> TrainState:
    optim.set_lr(ts.opt, float(lr))
    for name, p in ts.model.named_parameters():
        p.grad = grads[name]
    ts.opt.step()
    ts.opt.zero_grad(set_to_none=True)
    return ts._replace(step=ts.step + 1)


class _GANTrainer:
    """What the two adversarial trainers share: the schedule, the generator
    passes (remat, the act_dtype working copy), the frozen and the trained
    discriminators, the D step and the device pool's query.  A subclass
    sets ``remat``, ``act_dtype``, ``device``, ``gan_mode``, ``lr``,
    ``d_lr``, ``lr_policy``, ``num_epochs`` and ``_work`` (None)."""

    def lr_at_epoch(self, epoch: int) -> Tuple[float, float]:
        f = optim.reference_lr(self.lr_policy, 1.0, self.num_epochs, epoch)
        return self.lr * f, self.d_lr * f

    def _update(self, ts: TrainState, grads: Dict[str, torch.Tensor], lr) -> TrainState:
        """The Adam update of the G and D steps; the data-parallel wrappers
        (``parallel.dp``, ``parallel.zero``) replace it on their copy of the
        trainer to reduce the gradients first."""
        return _adam_update(ts, grads, lr)

    def _tensor(self, x):
        return torch.as_tensor(x, device=self.device)

    def _gen_pass(self, net: nn.Module):
        """NHWC v -> NHWC net(v), checkpointed with remat."""
        def run(v):
            return to_nhwc(net(to_nchw(v)))

        if self.remat:
            return lambda v: checkpoint(run, v, use_reentrant=False)
        return run

    def _working_generators(self, gnet: nn.ModuleDict) -> nn.ModuleDict:
        """The generators a G step runs: ``gnet`` itself, or with act_dtype
        a copy whose parameters hold the masters' values at that dtype
        (made once per ``gnet``, refreshed every step).  The gradient of a
        cast is the cast of the gradient, so the copy's gradients, cast to
        fp32, are the masters'.  A module (not ``functional_call``) runs the
        passes because a checkpointed RRDB recomputes with the parameters its
        module holds at backward time."""
        if self.act_dtype is None:
            return gnet
        if self._work is None or self._work[0] is not gnet:
            work = config.cast_parameters(copy.deepcopy(gnet), self.act_dtype)
            self._work = (gnet, work)
        work = self._work[1].train()
        with torch.no_grad():
            for w, m in zip(work.parameters(), gnet.parameters()):
                w.copy_(m)
        return work

    @staticmethod
    def _disc(dnet: nn.ModuleDict, role: str, params, buffers, x):
        """NHWC prediction map of discriminator ``role`` (train mode) on x,
        with ``params`` and ``buffers`` (BatchNorm writes its running
        statistics into these)."""
        tensors = {**_sub(params, role), **_sub(buffers, role)}
        return to_nhwc(functional_call(dnet[role], tensors, (to_nchw(x),)))

    def _frozen_gan_losses(self, dnet: nn.ModuleDict, fake_B, fake_A):
        """The G step's GAN terms (D_A on fake_B, D_B on fake_A, both
        labelled real) through the frozen discriminators: fp32, detached
        parameters, copies of the buffers that are dropped."""
        f32 = torch.float32
        d_params = {k: p.detach().to(f32) for k, p in dnet.named_parameters()}
        d_bufs = {k: b.clone() for k, b in dnet.named_buffers()}
        pred_fake_B = self._disc(dnet, "D_A", d_params, d_bufs, fake_B.to(f32))
        pred_fake_A = self._disc(dnet, "D_B", d_params, d_bufs, fake_A.to(f32))
        return (losses.gan_loss(pred_fake_B, True, self.gan_mode),
                losses.gan_loss(pred_fake_A, True, self.gan_mode))

    def d_grads(self, state: CycleState, realA, realB, fake_A_pooled, fake_B_pooled):
        """(gradients by parameter name of state.d.model, (loss_D_A, loss_D_B,
        the updated BatchNorm state by buffer name)), with no update.  D_A
        judges realB against fake_B, D_B ``realA`` (the multi-task trainer's
        real_C) against fake_A; the fakes are cast to the reals' dtype."""
        realA, realB = self._tensor(realA), self._tensor(realB)
        dnet = state.d.model.train()
        names, params = zip(*dnet.named_parameters())
        named = dict(zip(names, params))
        bufs = {k: b.clone() for k, b in dnet.named_buffers()}

        def d_losses(role, real, fake):
            fake = self._tensor(fake).detach().to(real.dtype)
            # the first forward moves the statistics (st1), the second on from there (st2)
            l_real = losses.gan_loss(self._disc(dnet, role, named, bufs, real), True,
                                     self.gan_mode)
            l_fake = losses.gan_loss(self._disc(dnet, role, named, bufs, fake), False,
                                     self.gan_mode)
            return (l_real + l_fake) * 0.5

        loss_d_a = d_losses("D_A", realB, fake_B_pooled)
        loss_d_b = d_losses("D_B", realA, fake_A_pooled)
        grads = torch.autograd.grad(loss_d_a + loss_d_b, params)
        return dict(zip(names, grads)), (loss_d_a.detach(), loss_d_b.detach(), bufs)

    def d_step(self, state: CycleState, realA, realB, fake_A_pooled, fake_B_pooled, lr
               ) -> Tuple[CycleState, Aux]:
        """Discriminator update on pooled fakes; the BatchNorm state moves on."""
        grads, (l_da, l_db, bufs) = self.d_grads(state, realA, realB, fake_A_pooled,
                                                 fake_B_pooled)
        d = self._update(state.d, grads, lr)
        with torch.no_grad():
            for name, b in d.model.named_buffers():
                b.copy_(bufs[name])
        return state._replace(d=d), {"loss_D_A": l_da, "loss_D_B": l_db}

    def _new_pools(self, shape_a, shape_b, dtype, seed: int):
        """Empty device pools for fakes of ``shape_a`` and ``shape_b`` (one
        image each, batch first): per pool an image buffer (pool_size, H, W,
        C) and a fill count, and the torch.Generator on the device that draws
        the replace policy."""
        size = self.fake_A_pool.pool_size

        def buf(shape):
            return {"buf": torch.zeros((size,) + tuple(shape[1:]), dtype=dtype,
                                       device=self.device),
                    "n": torch.zeros((), dtype=torch.int64, device=self.device)}

        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        return {"A": buf(shape_a), "B": buf(shape_b), "gen": gen}

    @staticmethod
    def _device_pool_query(pool, images, gen: torch.Generator):
        """The reference's pool semantics on the device, with no host sync:
        the first pool_size images insert and pass through; after that each
        image replaces a uniformly drawn entry with p = 0.5 (and the evicted
        image is returned) or passes through.  Sequential over the batch.
        Returns (the new pool, the pooled batch)."""
        buf, n = pool["buf"], pool["n"]
        size = buf.shape[0]
        outs = []
        for img in images:
            u = torch.rand((), generator=gen, device=buf.device)
            rid = torch.randint(0, size, (1,), generator=gen, device=buf.device)
            not_full = n < size
            buf_ins = buf.index_copy(0, n.clamp(max=size - 1).view(1), img[None])
            old = buf.index_select(0, rid)[0]
            take = u > 0.5
            buf_rep = torch.where(take, buf.index_copy(0, rid, img[None]), buf)
            out_rep = torch.where(take, old, img)
            buf = torch.where(not_full, buf_ins, buf_rep)
            outs.append(torch.where(not_full, img, out_rep))
            n = torch.where(not_full, n + 1, n)
        return {"buf": buf, "n": n}, torch.stack(outs)


class CycleGANTrainer(_GANTrainer):
    """Owns the configuration; ``init`` makes the four networks and their
    optimizers, the step methods train them."""

    # The logged image set of an iteration.
    _IMAGE_KEYS = ("fake_A", "fake_B", "recl_A", "recl_B",
                   "iden_A", "iden_B", "B2Gry", "A2RGB")

    def __init__(self, net: str = "1", mode: str = "x2", lr: float = 1e-4,
                 d_lr: float = 1e-5, beta1: float = 0.5, pool_size: int = 4,
                 lambda_identity: float = 1.0, lambda_a: float = 10.0,
                 lambda_b: float = 10.0, gan_mode: str = "lsgan",
                 lr_policy: str = "cosine", num_epochs: int = 25,
                 remat: bool = True, act_dtype=None,
                 perceptual_params=None, perceptual_weight: float = 1.0,
                 pack_passes: bool = False, *, device=None):
        self.remat = remat
        # pack_passes batches the independent passes of the same generator
        # into one forward (6 passes -> 3); the generators are conv-only, so
        # the per-sample math is the same.
        self.pack_passes = pack_passes
        self.act_dtype = act_dtype
        self.net, self.mode = net, mode
        self.scale = 2 if mode == "x2" else 4
        self.lr, self.d_lr = lr, d_lr
        self.beta1 = beta1
        self.lambda_identity = lambda_identity
        self.lambda_a, self.lambda_b = lambda_a, lambda_b
        self.gan_mode = gan_mode
        self.lr_policy, self.num_epochs = lr_policy, num_epochs
        # the optional VGG16 perceptual term on the cycle reconstructions
        self.perceptual_params = perceptual_params
        self.perceptual_weight = perceptual_weight
        self.fake_A_pool = ImagePool(pool_size)
        self.fake_B_pool = ImagePool(pool_size)
        # (b1, b2, eps) of both optimizers
        self.adam_hparams = (beta1, optim.ADAM_HPARAMS[1], optim.ADAM_HPARAMS[2])
        self.device = config.resolve_device(device)
        if perceptual_params is not None:
            self.perceptual_params = {k: {n: t.to(self.device) for n, t in p.items()}
                                      for k, p in perceptual_params.items()}
        self._work = None            # (generators, their act_dtype working copy)

    # -- setup ---------------------------------------------------------------

    def make_generators(self, generator: torch.Generator | None = None) -> nn.ModuleDict:
        """{G_A: up, G_B: down} for ``net``, fresh from ``generator``, on the
        trainer's device, with this trainer's remat setting on their RRDBs."""
        kw = dict(mode=self.mode, device=self.device, generator=generator)
        if self.net == "SRdens":
            g_a = models.create("SRDenseNetA", 1, 3, num_blocks=2, num_layers=2, **kw)
            g_b = models.create("SRDenseNetB", 3, 1, num_blocks=2, num_layers=2, **kw)
        elif self.net == "1":
            g_a = models.create("RDDBNetB", 3, 3, 64, nb=3, **kw)
            g_b = models.create("RDDBNetD", 3, 3, 64, nb=3, **kw)
        else:
            g_a = models.create("RDDBNetB", 1, 3, 64, nb=3, **kw)
            g_b = models.create("RDDBNetD", 3, 1, 64, nb=3, **kw)
        gens = nn.ModuleDict({"G_A": g_a, "G_B": g_b})
        set_trunk_remat(gens, self.remat)
        return gens

    def make_discriminators(self, generator: torch.Generator | None = None) -> nn.ModuleDict:
        """{D_A: judges B-domain images, D_B: judges A-domain images}."""
        d_b_ch = 3 if self.net == "1" else 1
        kw = dict(device=self.device, generator=generator)
        return nn.ModuleDict({"D_A": models.create("NLayerDiscriminator", 3, 64, 2, **kw),
                              "D_B": models.create("NLayerDiscriminator", d_b_ch, 64, 2, **kw)})

    def init(self, seed) -> CycleState:
        """Fresh networks (train mode) and Adam optimizers; ``seed`` is an int
        or a torch.Generator, drawn from for G_A, G_B, D_A, D_B in turn."""
        gen = seed if isinstance(seed, torch.Generator) else (
            torch.Generator().manual_seed(int(seed)))
        g = self.make_generators(gen).train()
        d = self.make_discriminators(gen).train()
        b1 = self.beta1
        return CycleState(TrainState(g, optim.adam(g.parameters(), self.lr, b1=b1), 0),
                          TrainState(d, optim.adam(d.parameters(), self.d_lr, b1=b1), 0))

    def inputs_u8(self, src_u8, tar_u8):
        """(realA, realB) of a uint8 (src, tar) RGB batch: realB the /255
        target; realA the gray source, or with net='1' the nearest 1/scale
        downsample of realB."""
        srcA, realB = preprocess.convert_pair(self._tensor(src_u8), self._tensor(tar_u8),
                                              "G2RGB")
        if self.net == "1":
            return interpolate(realB, scale_factor=1.0 / self.scale, mode="nearest"), realB
        return srcA, realB

    # -- identity-path inputs ------------------------------------------------

    def _identity_inputs(self, realA, realB):
        sf = self.scale
        if self.net == "1":
            real_b_gray = preprocess.degrade_nearest(realB, sf)
            real_a_rgb = interpolate(realA, scale_factor=float(sf), mode="nearest")
        else:
            real_b_gray = preprocess.degrade_nearest(preprocess.luma(realB), sf)
            real_a_rgb = interpolate(torch.cat([realA] * 3, -1), scale_factor=float(sf),
                                     mode="nearest")
        return real_b_gray, real_a_rgb

    # -- G step --------------------------------------------------------------

    def g_grads(self, state: CycleState, realA, realB) -> Tuple[Dict[str, torch.Tensor], Aux]:
        """(gradients by parameter name of state.g.model, aux): the G loss
        and its backward, with no update.  aux holds the logged images and
        the scalar losses, detached."""
        realA, realB = self._tensor(realA), self._tensor(realB)
        if self.act_dtype is not None:
            realA, realB = realA.to(self.act_dtype), realB.to(self.act_dtype)
        real_b_gray, real_a_rgb = self._identity_inputs(realA, realB)
        gnet, dnet = state.g.model.train(), state.d.model.train()
        work = self._working_generators(gnet)
        names, params = zip(*work.named_parameters())
        g_a, g_b = self._gen_pass(work["G_A"]), self._gen_pass(work["G_B"])
        if self.pack_passes:
            n = realA.shape[0]
            fake_A, iden_B = g_b(torch.cat([realB, real_a_rgb], 0)).split(n)
            fake_B, iden_A, recl_B = g_a(torch.cat([realA, real_b_gray, fake_A], 0)).split(n)
            recl_A = g_b(fake_B)
        else:
            fake_B = g_a(realA)
            recl_A = g_b(fake_B)
            fake_A = g_b(realB)
            recl_B = g_a(fake_A)
            iden_A = g_a(real_b_gray)
            iden_B = g_b(real_a_rgb)

        loss_g_a, loss_g_b = self._frozen_gan_losses(dnet, fake_B, fake_A)
        loss_cycle_a = losses.l1(recl_A, realA) * self.lambda_a * 0.5
        loss_cycle_b = losses.l1(recl_B, realB) * self.lambda_b * 0.5
        if self.lambda_identity > 0:
            loss_iden_a = losses.l1(iden_A, realB) * self.lambda_b / 2 * self.lambda_identity
            loss_iden_b = losses.l1(iden_B, realA) * self.lambda_a / 2 * self.lambda_identity
        else:
            loss_iden_a = loss_iden_b = torch.zeros((), device=realA.device)
        loss_g = (loss_g_a + loss_g_b + loss_cycle_a + loss_cycle_b
                  + loss_iden_a + loss_iden_b)
        if self.perceptual_params is not None:
            f32 = torch.float32
            loss_g = loss_g + self.perceptual_weight * (
                losses_vgg.vgg16_loss(self.perceptual_params, recl_A.to(f32), realA.to(f32))
                + losses_vgg.vgg16_loss(self.perceptual_params, recl_B.to(f32),
                                        realB.to(f32)))
        grads = [g.float() if self.act_dtype is not None else g
                 for g in torch.autograd.grad(loss_g, params, allow_unused=True,
                                              materialize_grads=True)]
        aux = {"fake_A": fake_A, "fake_B": fake_B, "recl_A": recl_A, "recl_B": recl_B,
               "iden_A": iden_A, "iden_B": iden_B, "B2Gry": real_b_gray, "A2RGB": real_a_rgb,
               "loss_G": loss_g, "loss_G_A": loss_g_a, "loss_G_B": loss_g_b,
               "loss_cycle_A": loss_cycle_a, "loss_cycle_B": loss_cycle_b,
               "loss_iden_A": loss_iden_a, "loss_iden_B": loss_iden_b}
        return dict(zip(names, grads)), {k: v.detach() for k, v in aux.items()}

    def g_step(self, state: CycleState, realA, realB, lr) -> Tuple[CycleState, Aux]:
        """Generator update against frozen discriminators; aux carries the
        generated images for the pools."""
        grads, aux = self.g_grads(state, realA, realB)
        return state._replace(g=self._update(state.g, grads, lr)), aux

    # -- one iteration, pool passing through ---------------------------------

    def _gd(self, state, realA, realB, g_lr, d_lr, ema=None, decay=None, pools=None):
        """G update, the EMA axpy when ``ema`` is given, the device pools'
        queries when ``pools`` is, then the D update."""
        state, aux = self.g_step(state, realA, realB, g_lr)
        if ema is not None:
            self._ema_only(ema, state.g.model, decay)
        fake_A, fake_B = aux["fake_A"], aux["fake_B"]
        if pools is not None:
            pools["A"], fake_A = self._device_pool_query(pools["A"], fake_A, pools["gen"])
            pools["B"], fake_B = self._device_pool_query(pools["B"], fake_B, pools["gen"])
        state, d_metrics = self.d_step(state, realA, realB, fake_A, fake_B, d_lr)
        aux.update(d_metrics)
        return state, aux

    def gd_step(self, state: CycleState, realA, realB, g_lr, d_lr) -> Tuple[CycleState, Aux]:
        """G update, then D update on THIS step's fakes: exactly one
        reference iteration when pool_size == 0 (the pool passes through)."""
        return self._gd(state, realA, realB, g_lr, d_lr)

    # -- device-side ImagePool -----------------------------------------------

    def device_pool_init(self, state: CycleState, realA, realB, seed: int = 0):
        """The device pools of ``gd_step_pooled`` (``_new_pools``).  The
        fakes have realA's and realB's shapes (the discriminators compare
        them so), at the activation dtype; nothing is computed here."""
        realA, realB = self._tensor(realA), self._tensor(realB)
        return self._new_pools(realA.shape, realB.shape, self.act_dtype or realB.dtype, seed)

    def gd_step_pooled(self, state: CycleState, pools, realA, realB, g_lr, d_lr):
        """G update, both device-pool queries, D update on the pooled fakes.
        Returns (state, pools, aux)."""
        pools = dict(pools)
        state, aux = self._gd(state, realA, realB, g_lr, d_lr, pools=pools)
        return state, pools, aux

    def gd_step_pooled_ema(self, state: CycleState, pools, ema, realA, realB, g_lr, d_lr,
                           decay):
        """``gd_step_pooled`` with the generator EMA update.
        Returns (state, pools, ema, aux)."""
        pools = dict(pools)
        state, aux = self._gd(state, realA, realB, g_lr, d_lr, ema, decay, pools)
        return state, pools, ema, aux

    # -- K iterations per call -----------------------------------------------

    def _steps_u8(self, state, src_u8_k, tar_u8_k, g_lr, d_lr, pools=None):
        src_u8_k, tar_u8_k = self._tensor(src_u8_k), self._tensor(tar_u8_k)
        rows, imgs = [], None
        for s, t in zip(src_u8_k, tar_u8_k):
            a, b = self.inputs_u8(s, t)
            state, aux = self._gd(state, a, b, g_lr, d_lr, pools=pools)
            imgs = {k: aux[k] for k in self._IMAGE_KEYS}
            rows.append({k: v for k, v in aux.items() if v.dim() == 0})
        return state, imgs, {k: torch.stack([r[k] for r in rows]) for k in rows[0]}

    def gd_steps_u8(self, state: CycleState, src_u8_k, tar_u8_k, g_lr, d_lr):
        """K ``gd_step`` iterations over (K, N, H, W, 3) uint8 stacks, for
        pool_size == 0.  Returns (state, the last step's images, every scalar
        loss stacked per step, shape (K,))."""
        return self._steps_u8(state, src_u8_k, tar_u8_k, g_lr, d_lr)

    def gd_steps_pooled_u8(self, state: CycleState, pools, src_u8_k, tar_u8_k, g_lr, d_lr):
        """K ``gd_step_pooled`` iterations; returns (state, pools, images,
        scalars) with ``gd_steps_u8``'s protocol."""
        pools = dict(pools)
        state, imgs, scalars = self._steps_u8(state, src_u8_k, tar_u8_k, g_lr, d_lr, pools)
        return state, pools, imgs, scalars

    # -- EMA of the generator weights ----------------------------------------

    def ema_init(self, state: CycleState) -> Dict[str, torch.Tensor]:
        """A fresh EMA tree by parameter name, seeded from the generators."""
        return {n: p.detach().clone() for n, p in state.g.model.named_parameters()}

    @staticmethod
    @torch.no_grad()
    def _ema_only(ema, g_model: nn.Module, decay):
        for name, p in g_model.named_parameters():
            ema[name].mul_(decay).add_(p, alpha=1.0 - decay)
        return ema

    def gd_step_ema(self, state: CycleState, ema, realA, realB, g_lr, d_lr, decay):
        """``gd_step`` with ema <- decay * ema + (1 - decay) * G after the G
        update, in place.  Returns (state, ema, aux)."""
        state, aux = self._gd(state, realA, realB, g_lr, d_lr, ema, decay)
        return state, ema, aux

    # -- full iteration ------------------------------------------------------

    def optimize_parameters(self, state: CycleState, realA, realB, g_lr=None, d_lr=None,
                            ema=None, ema_decay=0.999):
        """One reference iteration through the pools: returns (state, aux),
        or (state, ema, aux) when ``ema`` (from ``ema_init``) is given."""
        g_lr = self.lr if g_lr is None else g_lr
        d_lr = self.d_lr if d_lr is None else d_lr
        state, aux = self.g_step(state, realA, realB, g_lr)
        if ema is not None:
            self._ema_only(ema, state.g.model, ema_decay)
        fake_A = self.fake_A_pool.query(aux["fake_A"])
        fake_B = self.fake_B_pool.query(aux["fake_B"])
        state, d_metrics = self.d_step(state, realA, realB, fake_A, fake_B, d_lr)
        aux.update(d_metrics)
        if ema is not None:
            return state, ema, aux
        return state, aux
