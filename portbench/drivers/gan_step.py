"""The published GAN training step in a closed loop: `make_train_step`'s
step (the D update, then the G update against the updated D, both Adam
states) on a ring of batches preloaded on the card, with drop-path masks
drawn from the seed.

Traffic keys: `batch`, `frames` (a sample's), `size`, `ring` (batches on
the card, cycled), `stage`, `g_lr`, `d_lr`, `checked_steps` (the first
steps, which the reference follows), `traced_items` (steps of the traced
stretch), `limits`.

Set-up builds one training state from the seeded weights (TF32 off, as
`GanTrainer` sets it), drives it through the first `checked_steps` steps
by the window's own call on batches that all differ, and keeps what the
check compares: each step's losses, the first gradient as Adam holds it
(exp_avg / (1 - beta1) after one step) and the parameters after the
checked steps.  The window then goes on with the same state.  The check
runs the reference from the same weights, batches and masks through the
same steps and compares, leaf by leaf, the norms of the first gradient
and of the parameters' change (`leaf_gaps`)."""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench import inputs, weights
from portbench.harness import Check, Window
from portbench.reference import gan, unet
from portbench.serving import stream

LOGS = ("errD", "errG_d", "errG_struct")


class Driver:

    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: str = "cuda", control: bool = False):
        self.config, self.traffic = config, traffic
        self.device = torch.device(device)
        self.control = control
        self.attempted = self.failed = 0
        t = traffic
        self.grid = unet.bottleneck(t["size"])
        self.g0 = weights.generator_state(stream(seed, 3), self.device,
                                          self.grid)
        self.d0 = weights.discriminator_state(stream(seed, 4), self.device,
                                              t["size"])
        gen = torch.Generator(device=self.device).manual_seed(
            stream(seed, 2))
        self.batches = inputs.gan_batches(gen, t["ring"], t["batch"],
                                          t["frames"], t["size"])
        self.masks = torch.rand((t["ring"], 4, t["batch"] * t["frames"]),
                                generator=gen, device=self.device) < gan.KEEP
        self.step_fn = self.state = None
        self._flops = None

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _build(self) -> None:
        from uncltmo_tpu_torch.inference.engine import disable_tf32
        from uncltmo_tpu_torch.models.discriminator import SimpleDiscriminator
        from uncltmo_tpu_torch.models.unet import UNetTMO
        from uncltmo_tpu_torch.training.state import TrainState
        from uncltmo_tpu_torch.training.train_step import (LossConfig,
                                                           make_train_step)
        from uncltmo_tpu_torch.utils.convert import load_state
        disable_tf32(self.device)
        g = load_state(UNetTMO(gcn_grid=self.grid),
                       {k: v.clone() for k, v in self.g0.items()})
        d = load_state(SimpleDiscriminator(input_size=self.traffic["size"]),
                       {k: v.clone() for k, v in self.d0.items()})
        self.step_fn = make_train_step(g, d, LossConfig(video=bool(
            self.config["video"])), device=self.device)
        self.state = TrainState.create(g, d)

    def step(self, i: int) -> dict:
        k = i % len(self.batches)
        _, logs = self.step_fn(self.state, self.batches[k], None,
                               self.traffic["g_lr"], self.traffic["d_lr"],
                               stage=self.traffic["stage"],
                               drop_masks=iter(self.masks[k]))
        return logs

    def _params(self) -> dict:
        return {"G": {k: v.detach().clone() for k, v in
                      self.state.gen.named_parameters()},
                "D": {k: v.detach().clone() for k, v in
                      self.state.disc.named_parameters()}}

    def _first_grads(self) -> dict:
        out = {}
        for key, module, opt in (("G", self.state.gen, self.state.opt_G),
                                 ("D", self.state.disc, self.state.opt_D)):
            # nothing in the state: the optimizer got no gradient
            out[key] = {k: opt.state[p].get("exp_avg", torch.zeros_like(p))
                        / (1 - gan.BETAS[0])
                        for k, p in module.named_parameters()}
        return out

    def setup(self) -> None:
        n = int(self.traffic["checked_steps"])
        if self.control:
            self.got = _reference_steps(self, unet.Precision(True), n)
            return
        self._build()
        logs, grads = [], None
        for i in range(n):
            out = self.step(i)
            logs.append({k: float(out[k]) for k in LOGS})
            if i == 0:
                grads = self._first_grads()
        self.got = {"logs": logs, "grads": grads, "after": self._params()}
        self.sync()

    def window(self, seconds: float) -> Window:
        self.sync()
        start = time.perf_counter()
        i = n0 = int(self.traffic["checked_steps"])
        while True:
            self.attempted += 1
            self.step(i)
            i += 1
            if time.perf_counter() - start >= seconds:
                break
        self.sync()
        return Window(start, time.perf_counter(), i - n0)

    def traced(self, spans):
        from portbench import tracing
        n = int(self.traffic["traced_items"])
        trace = tracing.profile(lambda: [self.step(i) for i in range(n)],
                                self.device.type == "cuda")
        return trace, n

    def step_flops(self) -> float:
        """Operations of one published step (FlopCounterMode over the
        reference's step on the run's first batch)."""
        if self._flops is None:
            from portbench import roofline
            ref = gan.Step(self.g0, self.d0)
            self._flops = roofline.counted_flops(
                ref, self.batches[0], list(self.masks[0]),
                self.traffic["g_lr"], self.traffic["d_lr"])
        return self._flops

    def release(self) -> None:
        self.step_fn = self.state = None

    def close(self) -> None:
        pass

    def check(self):
        n = int(self.traffic["checked_steps"])
        want = _reference_steps(self, unet.Precision(False), n)
        gaps = compare(self.got, want, self.g0, self.d0)
        lim = self.traffic["limits"]
        return [Check(k, gaps[k], lim[k]) for k in NUMBERS]


def _reference_steps(drv, prec, n: int) -> dict:
    ref = gan.Step(drv.g0, drv.d0, prec)
    logs, grads = [], None
    for i in range(n):
        k = i % len(drv.batches)
        out = ref(drv.batches[k], list(drv.masks[k]), drv.traffic["g_lr"],
                  drv.traffic["d_lr"])
        logs.append({key: out[key] for key in LOGS})
        if i == 0:
            grads = out["grads"]
    return {"logs": logs, "grads": grads, "after": {"G": ref.g, "D": ref.d}}


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def leaf_gaps(got: dict, want: dict, skip=()) -> dict:
    """Each leaf's |‖got‖ - ‖want‖| over the larger of its reference norm
    and the median leaf's."""
    ref = {k: _norm(want[k]) for k in want if k not in skip}
    median = float(np.median(list(ref.values())))
    return {k: abs(_norm(got[k]) - r) / max(r, median)
            for k, r in ref.items()}


NUMBERS = ("loss_gap", "grad_gap", "grad_median_gap", "change_gap")


def compare(got: dict, want: dict, g0: dict, d0: dict) -> dict:
    """The numbers of the training check: the worst relative gap of a
    checked step's loss; of the first gradient, the worst leaf's gap and
    the median leaf's (the larger of G's and D's); of the parameters'
    change over the checked steps, the worst leaf's gap.  Leaves whose
    reference first gradient is below a thousandth of the median leaf's
    (they move under Adam by round-off alone) are left out of the
    change."""
    out = {"loss_gap": max(abs(g[k] - w[k]) / abs(w[k])
                           for g, w in zip(got["logs"], want["logs"])
                           for k in LOGS),
           "grad_gap": 0.0, "grad_median_gap": 0.0, "change_gap": 0.0}
    for m, p0 in (("G", g0), ("D", d0)):
        grads = leaf_gaps(got["grads"][m], want["grads"][m])
        out["grad_gap"] = max(out["grad_gap"], max(grads.values()))
        out["grad_median_gap"] = max(out["grad_median_gap"],
                                     float(np.median(list(grads.values()))))
        norms = {k: _norm(v) for k, v in want["grads"][m].items()}
        floor = 1e-3 * float(np.median(list(norms.values())))
        skip = {k for k, v in norms.items() if v < floor}
        dg = {k: got["after"][m][k] - p0[k] for k in norms}
        dw = {k: want["after"][m][k] - p0[k] for k in norms}
        out["change_gap"] = max(out["change_gap"],
                                max(leaf_gaps(dg, dw, skip).values()))
    if not all(math.isfinite(v) for v in out.values()):
        out = {k: math.inf for k in out}
    return out
