"""Checkpoints into the port.

* `state_dict_from_flax`: the JAX package's flax generator param tree (as
  numpy arrays) -> the port's state dict, which is the reference `.pth`
  layout.  The port's own copy of the transposes of
  `uncltmo_tpu/utils/export_torch.py`.
* `load_generator`: a reference `.pth` checkpoint -> a `UNetTMO` loaded
  with `strict=True`.
* `discriminator_state_dict_from_flax`: a flax discriminator param tree ->
  the port's layout; for `SimpleDiscriminator` the reference layout
  `model.0`, `model.2`, `model.4`, `tail.1` (the port's copy of
  `export_torch.py:export_discriminator`).
* `train_state_from_flax`: a whole JAX training state -- both param trees,
  both Adam states and the generator's batch-norm statistics -- into a
  `TrainState`, so that a run begun in the JAX package continues in the
  port.

A `.msgpack` training checkpoint of the JAX package needs flax to read; it
reaches the port by way of `python cli/export_checkpoint.py --checkpoint
X.msgpack --output X.pth` (JAX package CLI), then `load_generator`.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from uncltmo_tpu_torch.models.gcn import relative_pos_bias
from uncltmo_tpu_torch.models.unet import UNetTMO
from uncltmo_tpu_torch.training.state import TrainState


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _conv(p: Dict, out: Dict, name: str) -> None:
    # HWIO -> OIHW; the bias where the conv has one
    out[name + ".weight"] = _np(p["kernel"]).transpose(3, 2, 0, 1).copy()
    if "bias" in p:
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


def _bn(p: Dict, s, out: Dict, name: str) -> None:
    """`TorchBatchNorm` -> torch `BatchNorm2d` state (the port's copy of
    `export_torch.py:_bn_inv`): the affine parameters, and with `s` the
    running statistics and torch's `num_batches_tracked` counter (0; it only
    matters for momentum=None, which the reference never uses)."""
    out[name + ".weight"] = _np(p["scale"])
    out[name + ".bias"] = _np(p["bias"])
    if s is not None:
        out[name + ".running_mean"] = _np(s["mean"])
        out[name + ".running_var"] = _np(s["var"])
        out[name + ".num_batches_tracked"] = np.zeros((), np.int64)


def _norms(params: Dict, stats, out: Dict, base: str,
           pairs=(("norm0", "norm"), ("norm1", "norm1"))) -> None:
    """The batch norms of one cell, flax name -> torch name, where the cell
    has them (batch_norm models only)."""
    for flax_name, torch_name in pairs:
        if flax_name in params:
            _bn(params[flax_name],
                None if stats is None else stats[flax_name], out,
                f"{base}.{torch_name}")


def _double_conv(params: Dict, stats, out: Dict, base: str,
                 conv=_conv) -> None:
    """A DoubleConv (`conv0`/`conv1`, or a DoubleConvT's `convt0`/`convt1`
    with `conv=_convt3`) -> `conv`, `conv1`, `norm`, `norm1` at `base`."""
    prefix = "convt" if conv is _convt3 else "conv"
    conv(params[prefix + "0"]["Conv_0"], out, base + ".conv")
    conv(params[prefix + "1"]["Conv_0"], out, base + ".conv1")
    _norms(params, stats, out, base)


def state_dict_from_flax(params: Dict, depth: int = 4,
                         stats: Optional[Dict] = None
                         ) -> Dict[str, np.ndarray]:
    """Flax generator params (numpy leaves) -> the port's / the reference
    `.pth` state dict (numpy values), every option of `UNetTMO`.  For a
    batch_norm model pass its `batch_stats` collection as `stats`, so the
    running statistics come along (`export_torch.py:63-84`); without it
    only the norms' affine parameters are written (an Adam moment tree has
    no statistics).

    Layouts the JAX exporter has too: the cells' `conv`, `conv1`, `norm`,
    `norm1`, the 2x2 upsample `up`.  Layouts only the port writes (no
    reference file checks them): the bilinear upsample's 1x1 conv as
    `up_path.{i}.up.1` and a DoubleConv decoder cell as
    `up_path.{i}.conv.{conv,conv1}`, both as plain `Conv2d`s."""
    def sub(*keys):
        node = stats
        for k in keys:
            node = None if node is None else node.get(k, {})
        return node

    sd: Dict[str, np.ndarray] = {}
    _double_conv(params["inc"], sub("inc"), sd, "inc.conv")
    for i in range(depth - 1):
        _double_conv(params[f"down{i}"], sub(f"down{i}"), sd,
                     f"down_path.{i}.mpconv.1")
    last = params["last_down"]
    base = f"down_path.{depth - 1}.mpconv.1"
    _conv(last["conv"]["Conv_0"], sd, base + ".conv")
    if "convt" in last:
        _convt3(last["convt"]["Conv_0"], sd, base + ".conv1")
    _norms(last, sub("last_down"), sd, base)

    sd.update(gcn_state_from_flax(params["gcn"], "gcn."))
    for i in range(depth):
        base = f"up_path.{i}"
        up = params[f"up{i}"]
        if "up" in up:
            _convt2(up["up"], sd, base + ".up")
        elif "up1x1" in up:
            _conv(up["up1x1"], sd, base + ".up.1")
        dec = up["conv"]
        _double_conv(dec, sub(f"up{i}", "conv"), sd, base + ".conv",
                     conv=_convt3 if "convt0" in dec else _conv)
    _conv(params["outc"]["Conv_0"], sd, "outc.conv")
    return sd


def _dcgan_state(params: Dict, stats, prefix: str, sd: Dict) -> None:
    """Flax `DCGANDiscriminator` -> `model` indices (conv_in 0, then conv /
    norm / LReLU triples from 2, conv_out after them) and `fc`."""
    _conv(params["conv_in"], sd, prefix + "model.0")
    n = sum(1 for k in params if k.startswith("down"))
    for i in range(n):
        _conv(params[f"down{i}"], sd, f"{prefix}model.{2 + 3 * i}")
        _norms(params, stats, sd, f"{prefix}model",
               ((f"norm{i}", str(3 + 3 * i)),))
    _conv(params["conv_out"], sd, f"{prefix}model.{2 + 3 * n}")
    if "fc" in params:
        sd[prefix + "fc.weight"] = _np(params["fc"]["kernel"]).T.copy()


def _nlayer_state(params: Dict, stats, prefix: str, sd: Dict) -> None:
    """Flax `NLayerDiscriminator` (`Conv_0` .. `Conv_{L+1}`, `norm{n-1}`,
    `norm_pre`) -> `model` indices: Conv_0 at 0, the conv / norm / LReLU
    triples from 2, the final conv after them."""
    n_conv = sum(1 for k in params if k.startswith("Conv_"))
    _conv(params["Conv_0"], sd, prefix + "model.0")
    for j in range(1, n_conv - 1):
        idx = 2 + 3 * (j - 1)
        _conv(params[f"Conv_{j}"], sd, f"{prefix}model.{idx}")
        norm = "norm_pre" if j == n_conv - 2 else f"norm{j - 1}"
        _norms(params, stats, sd, f"{prefix}model", ((norm, str(idx + 1)),))
    _conv(params[f"Conv_{n_conv - 1}"], sd,
                 f"{prefix}model.{2 + 3 * (n_conv - 2)}")


def _simple_trunk_state(params: Dict, prefix: str, sd: Dict) -> None:
    _conv(params["conv0"], sd, prefix + "0")
    _conv(params["conv1"], sd, prefix + "2")
    if "conv2" in params:
        _conv(params["conv2"], sd, prefix + "4")


def discriminator_state_dict_from_flax(params: Dict,
                                       stats: Optional[Dict] = None
                                       ) -> Dict[str, np.ndarray]:
    """Flax discriminator params (numpy leaves) -> the port's state dict
    (numpy values), the variant read from the tree: `SimpleDiscriminator`
    (the reference layout, the port's copy of
    `export_torch.py:export_discriminator`), DCGAN, PatchGAN or multiscale
    (the port's layouts, `models/discriminator.py`).  `stats`: the
    variant's `batch_stats` collection, for batch-norm running
    statistics."""
    sd: Dict[str, np.ndarray] = {}
    if "layer0" in params:
        for i in range(sum(1 for k in params if k.startswith("layer"))):
            p, s = params[f"layer{i}"], None if stats is None else stats.get(
                f"layer{i}", {})
            prefix = f"layer{i}."
            if "conv_in" in p:
                _dcgan_state(p, s, prefix, sd)
            elif "Conv_0" in p:
                _nlayer_state(p, s, prefix, sd)
            else:
                _simple_trunk_state(p, prefix, sd)
    elif "conv_in" in params:
        _dcgan_state(params, stats, "", sd)
    elif "Conv_0" in params:
        _nlayer_state(params, stats, "", sd)
    else:
        _simple_trunk_state(params, "model.", sd)
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
    `opt_state_G`, `opt_state_D`, `stats_G`, `step`; leaves readable by
    `np.asarray`) loaded into `gen` and `disc` where they lie, with both
    Adam states and the generator's batch-norm running statistics."""
    stats = getattr(state, "stats_G", None) or None

    def to_g(tree, with_stats=None):
        return state_dict_from_flax(tree, gen.depth, stats=with_stats)

    load_state(gen, to_g(state.params_G, stats))
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
