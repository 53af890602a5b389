"""Faults planted in the program underneath a run, for the output check's
tests: each `plant(setattr)` replaces one function of the program through
`setattr(owner, name, value)` (pytest's `monkeypatch.setattr`, or plain
`setattr` in a throwaway process).

    python3 -m portbench.tests.faults --workload W --fault F --seeds 1 2 3

runs W on the card at its own size with F planted, a short window a seed,
and prints each run's result line: the readings of the numbers compared
under that fault."""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import time

import torch


def altered_answer(setattr):
    """Every frame one level brighter where it is produced."""
    from uncltmo_tpu_torch.inference import runner
    post = runner.postprocess_device
    setattr(runner, "postprocess_device", lambda *a: post(*a) + 1.0 / 255.0)


def half_batch_tiles(setattr):
    """Half of every generator batch left out, the mean of the rest in its
    place."""
    from uncltmo_tpu_torch.inference.engine import TileEngine
    forward = TileEngine._forward

    def half(self, tiles):
        n = max(1, tiles.shape[0] // 2)
        out = forward(self, tiles[:n])
        rest = out.mean(0, keepdim=True).expand(
            (tiles.shape[0] - n,) + tuple(out.shape[1:]))
        return torch.cat([out, rest])
    setattr(TileEngine, "_forward", half)


def state_unchanged_carry(setattr):
    """A frame step that hands on the carry it was given."""
    from uncltmo_tpu_torch.models.unet import UNetTMO
    frame = UNetTMO.frame

    def stuck(self, x, carry=None, *a, **k):
        out, up_x, new = frame(self, x, carry, *a, **k)
        return out, up_x, carry if carry is not None else [
            torch.zeros_like(c) for c in new]
    setattr(UNetTMO, "frame", stuck)


def state_unchanged_step(setattr):
    """A training step whose optimizers leave the parameters as they
    were."""
    from uncltmo_tpu_torch.training import train_step
    setattr(train_step, "apply_updates", lambda opt, lr: None)


def half_batch_losses(setattr):
    """Every loss of the training step over the first half of the batch's
    rows alone, the mean taken over them."""
    from uncltmo_tpu_torch.losses import adversarial
    from uncltmo_tpu_torch.training import train_step

    def halve(x):
        return x[:max(1, x.shape[0] // 2)] if torch.is_tensor(x) else x

    def on_half(fn):
        return lambda *a, **k: fn(*[halve(x) for x in a], **k)
    setattr(adversarial, "contrastive_d_loss",
            on_half(adversarial.contrastive_d_loss))
    setattr(train_step, "generator_loss_terms",
            on_half(train_step.generator_loss_terms))
    setattr(train_step, "struct_loss_pyramid",
            on_half(train_step.struct_loss_pyramid))


SERVING = {"altered_answer": altered_answer,
           "half_batch": half_batch_tiles}
FAULTS = {
    "image_1080p": SERVING,
    "image_files_hdr": SERVING,
    "video_1080p_sb2": dict(SERVING, state_unchanged=state_unchanged_carry),
    "train_image_b8": {"half_batch": half_batch_losses,
                       "state_unchanged": state_unchanged_step},
}


def main(argv=None) -> int:
    from portbench import harness
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--fault", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    harness.cache_env()
    FAULTS[args.workload][args.fault](setattr)
    for seed in args.seeds:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = harness.main(["--workload", args.workload, "--seed",
                               str(seed), "--seconds", str(args.seconds)],
                              time.perf_counter())
        line = out.getvalue().strip().splitlines()[-1] if rc == 0 else "{}"
        print(json.dumps({"workload": args.workload, "fault": args.fault,
                          "seed": seed, "rc": rc,
                          "checks": json.loads(line).get("checks")}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
