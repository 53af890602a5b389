"""Training state: the generator, the discriminator and their Adam states.

Port of `uncltmo_tpu/training/state.py` (reference `main_train.py:29-34`,
`utils/params.py:61`): two Adam optimizers with beta1 = 0.5, beta2 = 0.999,
eps = 1e-8.  The learning rate is supplied per step, so the epoch-decay
schedule (`lr_schedule`) is a host-side scalar and no optimizer is rebuilt.
`torch.optim.Adam` with the rate set before each step is the JAX package's
`scale_by_adam` followed by `-lr * u`: both divide the bias-corrected first
moment by the root of the bias-corrected second moment plus eps.

Where the JAX state is an immutable tree that each step replaces, this one
holds the two modules and is updated in place.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from uncltmo_tpu_torch import params as P


def make_optimizer(module: nn.Module) -> torch.optim.Adam:
    """Adam(beta1=0.5, beta2=0.999, eps=1e-8) over the module's parameters;
    the learning rate is set by `apply_updates` at every step."""
    return torch.optim.Adam(module.parameters(), lr=0.0,
                            betas=(P.BETA1, 0.999), eps=1e-8)


@dataclasses.dataclass
class TrainState:
    gen: nn.Module
    disc: nn.Module
    opt_G: torch.optim.Adam
    opt_D: torch.optim.Adam
    step: int = 0

    @classmethod
    def create(cls, gen: nn.Module, disc: nn.Module) -> "TrainState":
        """Fresh optimizers over the two modules as they are placed now:
        Adam allocates its moments beside the parameters at the first step,
        so move the modules to their device first (`make_train_step` does)."""
        return cls(gen=gen, disc=disc, opt_G=make_optimizer(gen),
                   opt_D=make_optimizer(disc))


def apply_updates(opt: torch.optim.Adam, lr: float) -> None:
    """One Adam step on the `.grad`s at hand, with a runtime learning rate."""
    for group in opt.param_groups:
        group["lr"] = float(lr)
    opt.step()


def lr_schedule(base_lr: float, epoch: int, lr_decay_step: float) -> float:
    """StepLR(step_size=1, gamma=0.5^(1/decay)) applied after each epoch
    (`main_train.py:32-34`, `GanTrainer.py:164-166`)."""
    gamma = 0.5 ** (1.0 / lr_decay_step)
    return base_lr * (gamma ** epoch)
