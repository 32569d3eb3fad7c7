"""cGAN discriminator wrapper and plateau LR scheduler: the counterparts of
``nind_denoise_tpu/train/gan.py``.

The reference's Discriminator (nn_common.py:275-361): Hul112Disc by
default, conditional 6-channel input, Adam without amsgrad, MSE against
fuzzy targets, scalar loss (sqrt(fake) + sqrt(real)) / 2,
ReduceLROnPlateau (factor 0.75, threshold 1e-8). Checkpoints are the JAX
trainer's ``<keyword>_<epoch>.npz`` (params, BN state, Adam leaves, the
scheduler's state): either trainer resumes from the other's.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..models import get_network, params_io
from . import steps


class ReduceLROnPlateau:
    """torch-equivalent plateau scheduler (mode=min)."""

    def __init__(self, lr: float, factor: float = 0.75, patience: int = 3,
                 threshold: float = 1e-8):
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.best = float("inf")
        self.num_bad = 0

    def step(self, metric: float) -> float:
        if metric < self.best - self.threshold:
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr *= self.factor
                self.num_bad = 0
        return self.lr


def init_disc(network: str, input_channels: int, funit: int, seed: int):
    """A Hul discriminator with torch's default init, drawn on the CPU from
    a generator seeded with ``seed`` (the same weights whatever the
    device; JAX's PRNG init cannot be reproduced)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return get_network(network)(network, input_channels, funit)


class DiscriminatorWrapper:
    """One discriminator, its Adam, its plateau scheduler and its step.
    The module stays in train mode, as the JAX package applies it with
    ``train=True`` everywhere."""

    def __init__(self, args, network: str, funit: int, lr: Optional[float],
                 conditional: bool, seed: int, advantage: float = 0.0,
                 patience: int = 3, model_path: Optional[str] = None,
                 keyword: str = "discriminator", device="cpu"):
        self.network = network
        self.keyword = keyword
        # the generator-loss weight this discriminator's fooling term feeds
        self.wname = "D2" if keyword == "discriminator2" else "D1"
        self.conditional = conditional
        self.advantage = advantage
        self.lr = lr if lr is not None else 1e-4
        model = init_disc(network, 6 if conditional else 3, funit, seed)
        opt_leaves = sched = None
        if model_path:
            loaded = params_io.load_discriminator(model_path, network, args.models_dpath,
                                                  keyword)
            sd = params_io.hul_state_dict_from_jax(loaded["params"], loaded["state"], network)
            cin, f = model.shape_of(sd)
            model = init_disc(network, cin, f, seed)
            # a checkpoint without BN state keeps the fresh running stats
            model.load_state_dict({**model.state_dict(), **sd}, strict=True)
            opt_leaves, sched, params = loaded["opt"], loaded["sched"], loaded["params"]
        self.model = model.to(device).train()
        self.optimizer = steps.make_optimizer(self.model, self.lr, args.beta1, amsgrad=False)
        if opt_leaves is not None:
            self.restore_opt(opt_leaves, params)
        self._step = steps.make_discriminator_train_step(self.model, self.optimizer,
                                                         conditional=conditional)
        self.scheduler = ReduceLROnPlateau(self.lr, factor=0.75, patience=patience)
        if sched is not None:  # exact plateau-scheduler resume
            self.scheduler.lr = self.lr = float(sched["lr"])
            self.scheduler.best = float(sched["best"])
            self.scheduler.num_bad = int(sched["num_bad"])
            self.optimizer.set_hyper(learning_rate=self.lr)
        self.loss = 1.0
        self.predictions_range = None

    def restore_opt(self, leaves, params) -> None:
        """Load a checkpoint's Adam ``leaves`` (its params tree ``params``)."""
        count, hyper, inner, moments = params_io.opt_from_leaves(
            leaves, params, names=params_io.ADAM_MOMENTS,
            from_jax=lambda t: params_io.hul_state_dict_from_jax(t, None, self.network))
        opt = self.optimizer
        opt.set_hyper(**hyper)
        opt.count, opt.inner_count = count, inner
        names = [k for k, _ in self.model.named_parameters()]
        for name, sd in moments.items():
            for key, buf in zip(names, opt.moments(name)):
                buf.copy_(sd[key].reshape(buf.shape))

    def pred_fn(self, generated_c: torch.Tensor, noisy_c: torch.Tensor) -> torch.Tensor:
        """Predictions for the generator's fooling term: the batch's BN
        statistics, and no change to this discriminator."""
        batch = torch.cat([noisy_c, generated_c], dim=1) if self.conditional else generated_c
        return self.model(batch, frozen=True)

    def learn(self, clean: torch.Tensor, noisy: torch.Tensor, gen, loss_cs: int,
              generator: Optional[torch.Generator] = None, draws=None) -> None:
        """One discriminator step on an NCHW batch: the generator's forward
        on ``noisy`` (``gen.infer``, no autograd), clipped and cropped, then
        the step; one host read of its losses and prediction ranges."""
        clean_c = steps.center_crop(clean, loss_cs)
        noisy_c = steps.center_crop(noisy, loss_cs)
        generated_c = steps.center_crop(torch.clamp(gen.infer(noisy), 0, 1), loss_cs)
        fake_is_noisy = self.loss < 0.25  # nn_common.py:349-353
        loss_real, loss_fake, ranges = self._step(clean_c, generated_c, noisy_c, fake_is_noisy,
                                                  generator=generator, draws=draws)
        vals = torch.cat([torch.stack([loss_real, loss_fake]), ranges]).tolist()
        self.loss = steps.discriminator_scalar_loss(vals[1], vals[0])
        self.predictions_range = ", ".join(f"{v:.2}" for v in vals[2:])

    def update_learning_rate(self, avg_loss: float) -> float:
        new_lr = self.scheduler.step(avg_loss)
        if new_lr != self.optimizer.hyper["learning_rate"]:
            self.optimizer.set_hyper(learning_rate=new_lr)
        self.lr = new_lr
        return new_lr

    def checkpoint(self):
        """The JAX trainer's discriminator checkpoint tree (numpy leaves)."""
        sd = {k: v.detach().cpu() for k, v in self.model.state_dict().items()}
        params, state = params_io.hul_jax_from_state_dict(sd, self.network)
        opt = self.optimizer
        names = [k for k, _ in self.model.named_parameters()]
        moments = {m: {k: t.detach().cpu() for k, t in zip(names, opt.moments(m))}
                   for m in params_io.ADAM_MOMENTS}
        leaves = params_io.opt_leaves(
            opt.count, opt.hyper, opt.inner_count, moments, names=params_io.ADAM_MOMENTS,
            to_jax=lambda m: params_io.hul_jax_from_state_dict(m, self.network)[0])
        return {"params": params, "state": state, "opt": leaves,
                "sched": {"lr": self.scheduler.lr, "best": self.scheduler.best,
                          "num_bad": self.scheduler.num_bad}}

    def save_model(self, model_dir: str, epoch: int, name: str) -> None:
        """Params + BN state + Adam leaves + plateau-scheduler state, so a
        cGAN resume is exact (the reference saved only the state_dict,
        nn_common.py:300-305)."""
        params_io.save(self.checkpoint(), os.path.join(model_dir, f"{name}_{epoch}.npz"))
