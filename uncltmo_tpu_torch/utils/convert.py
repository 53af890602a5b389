"""Checkpoints into the port.

* `state_dict_from_flax`: the JAX package's flax generator param tree (as
  numpy arrays) -> the port's state dict, which is the reference `.pth`
  layout.  The port's own copy of the transposes of
  `uncltmo_tpu/utils/export_torch.py`.
* `load_generator`: a reference `.pth` checkpoint -> a `UNetTMO` loaded
  with `strict=True`.
* `discriminator_state_dict_from_flax`: the flax `SimpleDiscriminator`
  param tree -> the reference layout `model.0`, `model.2`, `model.4`,
  `tail.1` (the port's copy of `export_torch.py:export_discriminator`).
* `train_state_from_flax`: a whole JAX training state -- both param trees
  and both Adam states -- into a `TrainState`, so that a run begun in the
  JAX package continues in the port.

A `.msgpack` training checkpoint of the JAX package needs flax to read; it
reaches the port by way of `python cli/export_checkpoint.py --checkpoint
X.msgpack --output X.pth` (JAX package CLI), then `load_generator`.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from uncltmo_tpu_torch.models.gcn import relative_pos_bias
from uncltmo_tpu_torch.models.unet import UNetTMO
from uncltmo_tpu_torch.training.state import TrainState


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _conv(p: Dict, out: Dict, name: str) -> None:
    # HWIO -> OIHW
    out[name + ".weight"] = _np(p["kernel"]).transpose(3, 2, 0, 1).copy()
    out[name + ".bias"] = _np(p["bias"])


def _convt3(p: Dict, out: Dict, name: str) -> None:
    # the flax kernel is the flipped kernel of a full-pad conv; the torch
    # ConvTranspose2d(k=3) weight is (I, O, 3, 3)
    w = np.flip(_np(p["kernel"]), axis=(0, 1)).transpose(2, 3, 0, 1).copy()
    out[name + ".weight"] = w
    out[name + ".bias"] = _np(p["bias"])


def _convt2(p: Dict, out: Dict, name: str) -> None:
    # (2, 2, I, O) -> ConvTranspose2d(k=2, s=2) weight (I, O, 2, 2)
    out[name + ".weight"] = _np(p["kernel"]).transpose(2, 3, 0, 1).copy()
    out[name + ".bias"] = _np(p["bias"])


def _dense_1x1(p: Dict, out: Dict, name: str) -> None:
    # Dense (I, O) -> Conv2d 1x1 (O, I, 1, 1)
    out[name + ".weight"] = _np(p["kernel"]).T[:, :, None, None].copy()
    out[name + ".bias"] = _np(p["bias"])


def _grouped_1x1(p: Dict, out: Dict, name: str) -> None:
    # (g, I/g, O/g) -> grouped Conv2d 1x1 (O, I/g, 1, 1)
    kern = _np(p["kernel"])
    g, ig, og = kern.shape
    w = kern.transpose(0, 2, 1).reshape(g * og, ig)
    out[name + ".weight"] = w[:, :, None, None].copy()
    out[name + ".bias"] = _np(p["bias"])


def gcn_state_from_flax(params: Dict, prefix: str = ""
                        ) -> Dict[str, np.ndarray]:
    """Flax `GCNBlock` params -> the port's `GCNBlock` state dict, keys
    under `prefix`."""
    sd: Dict[str, np.ndarray] = {}
    pos = _np(params["pos_embed"])                       # (1, g, g, C)
    sd[prefix + "pos_embed"] = pos.transpose(0, 3, 1, 2).copy()
    ch, grid = pos.shape[3], pos.shape[1]
    sd[prefix + "module.0.0.relative_pos"] = relative_pos_bias(ch, grid)[None]
    gr = params["grapher"]
    _dense_1x1(gr["fc1"], sd, prefix + "module.0.0.fc1.0")
    _grouped_1x1(gr["gconv"], sd, prefix + "module.0.0.graph_conv.gconv.nn.0")
    _dense_1x1(gr["fc2"], sd, prefix + "module.0.0.fc2.0")
    _dense_1x1(gr["ffn_fc1"], sd, prefix + "module.0.1.fc1.0")
    _dense_1x1(gr["ffn_fc2"], sd, prefix + "module.0.1.fc2.0")
    return sd


def state_dict_from_flax(params: Dict, depth: int = 4
                         ) -> Dict[str, np.ndarray]:
    """Flax generator params (numpy leaves) -> the port's / the reference
    `.pth` state dict (numpy values).  Norm-free checkpoints only."""
    def has_norm(tree) -> bool:
        return isinstance(tree, dict) and any(
            k.startswith("norm") or has_norm(v) for k, v in tree.items())

    if has_norm(params):
        raise NotImplementedError("batch_norm generators are not ported yet "
                                  "(ROADMAP Queue 1 item 2)")
    sd: Dict[str, np.ndarray] = {}
    _conv(params["inc"]["conv0"]["Conv_0"], sd, "inc.conv.conv")
    _conv(params["inc"]["conv1"]["Conv_0"], sd, "inc.conv.conv1")
    for i in range(depth - 1):
        base = f"down_path.{i}.mpconv.1"
        _conv(params[f"down{i}"]["conv0"]["Conv_0"], sd, base + ".conv")
        _conv(params[f"down{i}"]["conv1"]["Conv_0"], sd, base + ".conv1")
    base = f"down_path.{depth - 1}.mpconv.1"
    _conv(params["last_down"]["conv"]["Conv_0"], sd, base + ".conv")
    _convt3(params["last_down"]["convt"]["Conv_0"], sd, base + ".conv1")

    sd.update(gcn_state_from_flax(params["gcn"], "gcn."))
    for i in range(depth):
        base = f"up_path.{i}"
        _convt2(params[f"up{i}"]["up"], sd, base + ".up")
        _convt3(params[f"up{i}"]["conv"]["convt0"]["Conv_0"], sd,
                base + ".conv.conv")
        _convt3(params[f"up{i}"]["conv"]["convt1"]["Conv_0"], sd,
                base + ".conv.conv1")
    _conv(params["outc"]["Conv_0"], sd, "outc.conv")
    return sd


def discriminator_state_dict_from_flax(params: Dict) -> Dict[str, np.ndarray]:
    """Flax `SimpleDiscriminator` params (numpy leaves) -> the port's / the
    reference state dict (numpy values)."""
    sd: Dict[str, np.ndarray] = {}
    _conv(params["conv0"], sd, "model.0")
    _conv(params["conv1"], sd, "model.2")
    if "conv2" in params:
        _conv(params["conv2"], sd, "model.4")
    sd["tail.1.weight"] = _np(params["tail"]["kernel"]).T.copy()
    return sd


def _load_adam(opt: torch.optim.Adam, module: torch.nn.Module, adam,
               to_state_dict) -> None:
    """optax `ScaleByAdamState(count, mu, nu)` -> the optimizer's per-
    parameter `step`, `exp_avg`, `exp_avg_sq`.  The moment trees have the
    parameters' structure and the layout change is a permutation, so they
    cross over through the same converter as the parameters."""
    mu, nu = to_state_dict(adam.mu), to_state_dict(adam.nu)
    count = float(np.asarray(adam.count))
    for name, p in module.named_parameters():
        opt.state[p] = {
            "step": torch.tensor(count, dtype=torch.float32),
            "exp_avg": torch.tensor(mu[name]).to(p.device),
            "exp_avg_sq": torch.tensor(nu[name]).to(p.device)}


def train_state_from_flax(state, gen: UNetTMO,
                          disc: torch.nn.Module) -> TrainState:
    """The JAX package's `TrainState` (`params_G`, `params_D`,
    `opt_state_G`, `opt_state_D`, `step`; leaves readable by `np.asarray`)
    loaded into `gen` and `disc` where they lie, with both Adam states.
    Norm-free models only (`stats_G` must be empty)."""
    if getattr(state, "stats_G", None):
        raise NotImplementedError("batch_norm generators are not ported yet "
                                  "(ROADMAP Queue 1 item 2)")

    def to_g(tree):
        return state_dict_from_flax(tree, gen.depth)

    load_state(gen, to_g(state.params_G))
    load_state(disc, discriminator_state_dict_from_flax(state.params_D))
    out = TrainState.create(gen, disc)
    _load_adam(out.opt_G, gen, state.opt_state_G, to_g)
    _load_adam(out.opt_D, disc, state.opt_state_D,
               discriminator_state_dict_from_flax)
    out.step = int(np.asarray(state.step))
    return out


def load_state(model: torch.nn.Module, sd: Dict) -> torch.nn.Module:
    """Load a state dict (numpy or torch values) with strict=True."""
    model.load_state_dict({k: torch.tensor(np.asarray(v))
                           if not isinstance(v, torch.Tensor) else v
                           for k, v in sd.items()}, strict=True)
    return model


def read_generator_state(path: str) -> Dict[str, torch.Tensor]:
    """The generator state dict of a reference `.pth` checkpoint
    (`model_save_util.py:121-131`: {'epoch', 'modelG_state_dict', ...}),
    without DataParallel's 'module.' prefix."""
    if path.endswith(".msgpack"):
        raise ValueError(
            f"{path}: .msgpack checkpoints need flax; convert with "
            "`python cli/export_checkpoint.py --checkpoint X.msgpack "
            "--output X.pth` first")
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("modelG_state_dict", ckpt)
    if next(iter(sd)).startswith("module."):
        sd = {k[len("module."):]: v for k, v in sd.items()}
    return sd


def load_generator(path: str, model: UNetTMO | None = None) -> UNetTMO:
    """A reference `.pth` checkpoint -> `UNetTMO` (the published
    configuration unless `model` is given), loaded strict=True on the CPU.
    `.msgpack` files are refused with a pointer to
    `cli/export_checkpoint.py`."""
    return load_state(model if model is not None else UNetTMO(),
                      read_generator_state(path))
