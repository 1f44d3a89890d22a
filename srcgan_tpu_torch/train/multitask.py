"""Multi-task CycleGAN trainer, as ``srcgan_tpu.train.multitask``.

A third generator G_C (SRDenseNetA 1 -> 1, the gray SR) in front of a
pix2pix colorization cycle (``define_G``, resnet_9blocks with instance norm
by default):

  real_C = G_C(realA)            the SR'd gray, at the target's size
  fake_B = G_A(real_C)           colorize
  recl_A = G_B(fake_B)           back to gray
  fake_A = G_B(realB); recl_B = G_A(fake_A)

The reference's quirks are kept, as the JAX trainer keeps them:

- ``loss_G_C`` = MSE(real_C broadcast to realB's 3 channels, realB in fp32)
  is computed and reported but left out of ``loss_G``; G_C still trains,
  through the cycle path (one Adam over G_A, G_B and G_C);
- ``cycle_A`` is anchored at real_C, not realA, and D_B judges real_C
  against the pooled fake_A;
- the identity terms are off (the trainer has no ``lambda_identity``);
- ``realB1`` of ``optimize_parameters`` is accepted and ignored.

The form is ``train.cyclegan``'s, whose machinery this trainer shares
(``_GANTrainer``): state updated in place (``CycleState`` over
{G_A, G_B, G_C} and {D_A, D_B}), discriminators in fp32 through
``functional_call``, the bf16 working copy of the generators under
``act_dtype``, each generator pass checkpointed with ``remat`` (the pix2pix
nets hold no RRDB, so that is all remat does here), the host and the device
pools.  With ``norm="batch"`` the generators normalize with the batch's
statistics, as the JAX step (which runs them with fresh state and drops
it); their running statistics are put back after every G step, so they
never drift.  ``pack_passes`` (G_A's two independent inputs in one forward)
is forced off for ``norm="batch"``, whose statistics would couple them.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from srcgan_tpu_torch import config, losses, models
from srcgan_tpu_torch.train import optim
from srcgan_tpu_torch.train.cyclegan import Aux, CycleState, ImagePool, _GANTrainer
from srcgan_tpu_torch.train.state import TrainState


class MultiTaskTrainer(_GANTrainer):
    """Owns the configuration; ``init`` makes the five networks and the two
    optimizers, the step methods train them."""

    # The logged image set of an iteration.
    _IMAGE_KEYS = ("real_C", "fake_A", "fake_B", "recl_A", "recl_B")

    def __init__(self, mode: str = "x2", lr: float = 1e-4, d_lr: float = 1e-5,
                 beta1: float = 0.5, pool_size: int = 4, lambda_a: float = 10.0,
                 lambda_b: float = 10.0, ngf: int = 64,
                 netG: str = "resnet_9blocks", norm: str = "instance",
                 gan_mode: str = "lsgan", lr_policy: str = "cosine", num_epochs: int = 25,
                 remat: bool = True, act_dtype=None, pack_passes: bool = False, *,
                 device=None):
        self.remat = remat
        self.pack_passes = pack_passes and norm != "batch"
        self.act_dtype = act_dtype
        self.mode = mode
        self.lr, self.d_lr = lr, d_lr
        self.beta1 = beta1
        self.lambda_a, self.lambda_b = lambda_a, lambda_b
        self.ngf, self.netG, self.norm = ngf, netG, norm
        self.gan_mode = gan_mode
        self.lr_policy, self.num_epochs = lr_policy, num_epochs
        self.fake_A_pool = ImagePool(pool_size)
        self.fake_B_pool = ImagePool(pool_size)
        self.device = config.resolve_device(device)
        self._work = None

    # -- setup ---------------------------------------------------------------

    def make_generators(self, generator: torch.Generator | None = None) -> nn.ModuleDict:
        """{G_A: gray -> RGB, G_B: RGB -> gray, G_C: gray SR}, fresh from
        ``generator`` in that order, on the trainer's device."""
        kw = dict(device=self.device, generator=generator)
        g_a = models.define_G(1, 3, self.ngf, self.netG, self.norm, **kw)
        g_b = models.define_G(3, 1, self.ngf, self.netG, self.norm, **kw)
        g_c = models.create("SRDenseNetA", 1, 1, mode=self.mode, num_blocks=2, num_layers=2,
                            **kw)
        return nn.ModuleDict({"G_A": g_a, "G_B": g_b, "G_C": g_c})

    def make_discriminators(self, generator: torch.Generator | None = None) -> nn.ModuleDict:
        """{D_A: judges RGB images, D_B: judges gray ones}."""
        kw = dict(device=self.device, generator=generator)
        return nn.ModuleDict({"D_A": models.create("NLayerDiscriminator", 3, 64, 2, **kw),
                              "D_B": models.create("NLayerDiscriminator", 1, 64, 2, **kw)})

    def init(self, seed) -> CycleState:
        """Fresh networks (train mode) and Adam optimizers; ``seed`` is an int
        or a torch.Generator, drawn from for G_A, G_B, G_C, D_A, D_B in turn."""
        gen = seed if isinstance(seed, torch.Generator) else (
            torch.Generator().manual_seed(int(seed)))
        g = self.make_generators(gen).train()
        d = self.make_discriminators(gen).train()
        b1 = self.beta1
        return CycleState(TrainState(g, optim.adam(g.parameters(), self.lr, b1=b1), 0),
                          TrainState(d, optim.adam(d.parameters(), self.d_lr, b1=b1), 0))

    # -- G step --------------------------------------------------------------

    def g_grads(self, state: CycleState, realA, realB) -> Tuple[Dict[str, torch.Tensor], Aux]:
        """(gradients by parameter name of state.g.model, aux): the G loss
        and its backward, with no update.  aux holds the five images and
        the scalar losses, detached."""
        realA, realB = self._tensor(realA), self._tensor(realB)
        realB32 = realB
        if self.act_dtype is not None:
            realA, realB = realA.to(self.act_dtype), realB.to(self.act_dtype)
        gnet, dnet = state.g.model.train(), state.d.model.train()
        work = self._working_generators(gnet)
        stats = {k: b.clone() for k, b in work.named_buffers()}
        names, params = zip(*work.named_parameters())
        g_a, g_b, g_c = (self._gen_pass(work[r]) for r in ("G_A", "G_B", "G_C"))
        real_C = g_c(realA)
        if self.pack_passes:
            fake_A = g_b(realB)
            fake_B, recl_B = g_a(torch.cat([real_C, fake_A], 0)).split(realA.shape[0])
            recl_A = g_b(fake_B)
        else:
            fake_B = g_a(real_C)
            recl_A = g_b(fake_B)
            fake_A = g_b(realB)
            recl_B = g_a(fake_A)

        loss_g_a, loss_g_b = self._frozen_gan_losses(dnet, fake_B, fake_A)
        loss_cycle_a = losses.l1(recl_A, real_C) * self.lambda_a * 0.5
        loss_cycle_b = losses.l1(recl_B, realB) * self.lambda_b * 0.5
        # reported, not trained on
        loss_g_c = losses.mse(real_C.expand(realB32.shape).float(), realB32)
        loss_g = loss_g_a + loss_g_b + loss_cycle_a + loss_cycle_b
        grads = [g.float() if self.act_dtype is not None else g
                 for g in torch.autograd.grad(loss_g, params, allow_unused=True,
                                              materialize_grads=True)]
        with torch.no_grad():            # batch-norm generators: the statistics stay
            for k, b in work.named_buffers():
                b.copy_(stats[k])
        aux = {"real_C": real_C, "fake_A": fake_A, "fake_B": fake_B, "recl_A": recl_A,
               "recl_B": recl_B, "loss_G": loss_g, "loss_G_A": loss_g_a, "loss_G_B": loss_g_b,
               "loss_G_C": loss_g_c, "loss_cycle_A": loss_cycle_a,
               "loss_cycle_B": loss_cycle_b}
        return dict(zip(names, grads)), {k: v.detach() for k, v in aux.items()}

    def g_step(self, state: CycleState, realA, realB, lr) -> Tuple[CycleState, Aux]:
        """Generator update (G_A, G_B, G_C) against frozen discriminators."""
        grads, aux = self.g_grads(state, realA, realB)
        return state._replace(g=self._update(state.g, grads, lr)), aux

    # -- D step --------------------------------------------------------------

    def d_step(self, state: CycleState, real_C, realB, fake_A_pooled, fake_B_pooled, lr
               ) -> Tuple[CycleState, Aux]:
        """D_A: realB against the pooled fake_B; D_B: real_C against the
        pooled fake_A; all in fp32."""
        f32 = torch.float32
        return super().d_step(state, self._tensor(real_C).detach().to(f32),
                              self._tensor(realB).to(f32), fake_A_pooled, fake_B_pooled, lr)

    # -- the device pool -----------------------------------------------------

    def device_pool_init(self, state: CycleState, realA, realB, seed: int = 0):
        """The device pools of ``gd_step_pooled`` (``_new_pools``): fake_A
        is gray at realB's size, fake_B has realB's shape, both at the
        activation dtype; nothing is computed here."""
        realB = self._tensor(realB)
        return self._new_pools(realB.shape[:-1] + (1,), realB.shape,
                               self.act_dtype or realB.dtype, seed)

    def gd_step_pooled(self, state: CycleState, pools, realA, realB, g_lr, d_lr):
        """G update, both device-pool queries, D update on (real_C, the
        pooled fakes), with no host round trip.  Returns (state, pools, aux)."""
        pools = dict(pools)
        state, aux = self.g_step(state, realA, realB, g_lr)
        pools["A"], fake_A = self._device_pool_query(pools["A"], aux["fake_A"], pools["gen"])
        pools["B"], fake_B = self._device_pool_query(pools["B"], aux["fake_B"], pools["gen"])
        state, d_metrics = self.d_step(state, aux["real_C"], realB, fake_A, fake_B, d_lr)
        aux.update(d_metrics)
        return state, pools, aux

    # -- full iteration ------------------------------------------------------

    def optimize_parameters(self, state: CycleState, realA, realB, realB1=None, g_lr=None,
                            d_lr=None) -> Tuple[CycleState, Aux]:
        """One reference iteration through the host pools; ``realB1`` is
        accepted and ignored."""
        del realB1
        g_lr = self.lr if g_lr is None else g_lr
        d_lr = self.d_lr if d_lr is None else d_lr
        state, aux = self.g_step(state, realA, realB, g_lr)
        fake_A = self.fake_A_pool.query(aux["fake_A"])
        fake_B = self.fake_B_pool.query(aux["fake_B"])
        state, d_metrics = self.d_step(state, aux["real_C"], realB, fake_A, fake_B, d_lr)
        aux.update(d_metrics)
        return state, aux
