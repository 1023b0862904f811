"""Generator, discriminator and GAN training snapshots in and out of the
port.

The port's generator uses the reference StyleGAN2 state-dict layout, so
three sources load into it:

* `generator_params_from_jax(variables)`: a flax variable tree of the JAX
  package's generator ({"params": ..., "noises": ...}, leaves as numpy) ->
  port state dict. This keeps its own copy of the key mapping of
  `flax_generator_to_torch` in synthesis_in_style_tpu/utils/checkpoint.py.
* an `.npz` written by the JAX package's `save_pytree_npz` ('/'-joined
  keys), either of such variables or of a GAN snapshot tree with `g_ema`
  (bare params) and `g_noises`;
* a reference-layout torch `.pt`: a state dict, or a dict of them keyed by
  network name (`g_ema`, `generator`), such as a GAN snapshot of the port.

The discriminator's state dict follows the reference layout as well
(`discriminator_params_from_jax` carries the JAX discriminator across, the
inverse of `torch_discriminator_to_flax` in the JAX package). A GAN training
snapshot (`save_gan_snapshot` / `load_gan_snapshot`) is a `.pt` in the
reference layout: `generator`, `discriminator` and `g_ema` state dicts,
`generator_optimizer` and `discriminator_optimizer` torch optimizer states,
and `training_state` with `mean_path_length`.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np
import torch


def _lin(prefix: str, p: Dict[str, Any], out: Dict[str, np.ndarray]) -> None:
    out[f"{prefix}.weight"] = np.asarray(p["weight"]).T  # (in, out) -> (out, in)
    if "bias" in p:
        out[f"{prefix}.bias"] = np.asarray(p["bias"])


def _modconv(prefix: str, p: Dict[str, Any], out: Dict[str, np.ndarray]) -> None:
    w = np.asarray(p["weight"])  # (kh, kw, in, out)
    out[f"{prefix}.weight"] = w.transpose(3, 2, 0, 1)[None]  # (1, out, in, kh, kw)
    _lin(f"{prefix}.modulation", p["modulation"], out)


def generator_params_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax generator variables (numpy leaves) -> port generator state dict."""
    params = variables["params"]
    sd: Dict[str, np.ndarray] = {}
    for name, p in params.items():
        if name.startswith("style_"):
            _lin(f"style.{name.rsplit('_', 1)[1]}", p, sd)
        elif name == "input":
            sd["input.input"] = np.asarray(p).transpose(0, 3, 1, 2)
        elif name == "conv1" or name.startswith("convs_"):
            t_name = "conv1" if name == "conv1" else f"convs.{name.rsplit('_', 1)[1]}"
            _modconv(f"{t_name}.conv", p["conv"], sd)
            sd[f"{t_name}.noise.weight"] = np.asarray(p["noise"]["weight"]).reshape(1)
            sd[f"{t_name}.activate.bias"] = np.asarray(p["bias"])
        elif name == "to_rgb1" or name.startswith("to_rgbs_"):
            t_name = "to_rgb1" if name == "to_rgb1" else f"to_rgbs.{name.rsplit('_', 1)[1]}"
            _modconv(f"{t_name}.conv", p["conv"], sd)
            sd[f"{t_name}.bias"] = np.asarray(p["bias"]).reshape(1, -1, 1, 1)
        else:
            raise KeyError(f"unexpected generator parameter {name!r}")
    for name, buf in variables.get("noises", {}).items():
        sd[f"noises.{name}"] = np.asarray(buf).transpose(0, 3, 1, 2)  # (1,H,W,1) -> (1,1,H,W)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def _conv_layer(prefix: str, p: Dict[str, Any], conv_idx: int,
                out: Dict[str, np.ndarray]) -> None:
    """A JAX ConvLayer -> the reference Sequential [Blur,] conv [, act]: the
    conv at index `conv_idx`, its activation's bias at the next index."""
    w = np.asarray(p["conv"]["weight"])  # (kh, kw, in, out); the conv has no bias
    out[f"{prefix}.{conv_idx}.weight"] = w.transpose(3, 2, 0, 1)
    if "bias" in p:
        out[f"{prefix}.{conv_idx + 1}.bias"] = np.asarray(p["bias"])


def discriminator_params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax discriminator params (numpy leaves; the bare tree or
    {"params": tree}) -> port discriminator state dict."""
    params = params.get("params", params)
    sd: Dict[str, np.ndarray] = {}
    _conv_layer("convs.0", params["conv_in"], 0, sd)
    n_blocks = sum(1 for name in params if name.startswith("blocks_"))
    for i in range(n_blocks):
        block, t = params[f"blocks_{i}"], f"convs.{i + 1}"
        _conv_layer(f"{t}.conv1", block["conv1"], 0, sd)
        _conv_layer(f"{t}.conv2", block["conv2"], 1, sd)  # index 0 is the blur
        _conv_layer(f"{t}.skip", block["skip"], 1, sd)
    _conv_layer("final_conv", params["final_conv"], 0, sd)
    # JAX flattens the (4, 4, C) map NHWC; the reference (and the port) NCHW
    w0 = np.asarray(params["final_linear_0"]["weight"]).T  # (out, 16 C), (y, x, c) columns
    out_dim, in_dim = w0.shape
    w0 = w0.reshape(out_dim, 4, 4, in_dim // 16).transpose(0, 3, 1, 2).reshape(out_dim, in_dim)
    sd["final_linear.0.weight"] = w0
    sd["final_linear.0.bias"] = np.asarray(params["final_linear_0"]["bias"])
    _lin("final_linear.1", params["final_linear_1"], sd)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def unflatten_npz(data) -> Dict[str, Any]:
    """An npz (or dict) with '/'-joined keys -> nested dict."""
    tree: Dict[str, Any] = {}
    for key in getattr(data, "files", None) or list(data):
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(data[key])
    return tree


def load_jax_npz(path: Union[str, Path]) -> Dict[str, torch.Tensor]:
    """Port state dict from an npz written by the JAX package's
    `save_pytree_npz`. Noise buffers are absent from the result when the file
    has none."""
    with np.load(str(path)) as data:
        tree = unflatten_npz(data)
    if "g_ema" in tree:
        variables = {"params": tree["g_ema"]}
        if "g_noises" in tree:
            variables["noises"] = tree["g_noises"]
    elif "params" in tree:
        variables = tree
    else:
        raise KeyError(f"{path}: no 'params' or 'g_ema' tree; found {sorted(tree)}")
    return generator_params_from_jax(variables)


def strip_blur_kernels(state: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Drop the reference's fixed FIR buffers (`*.kernel` of its Blur and
    Upsample modules): the port rebuilds them and does not store them."""
    return {k: torch.as_tensor(v) for k, v in state.items() if not k.endswith(".kernel")}


def load_reference_pt(path: Union[str, Path], key: str = "g_ema") -> Dict[str, torch.Tensor]:
    """Port state dict from a reference-layout torch checkpoint."""
    ckpt = torch.load(str(path), map_location="cpu", weights_only=True)
    if key in ckpt and isinstance(ckpt[key], dict):
        ckpt = ckpt[key]
    if "input.input" not in ckpt:
        raise KeyError(f"{path}: no generator state dict (no {key!r}, no 'input.input')")
    return strip_blur_kernels(ckpt)


def load_generator_state(path: Union[str, Path], key: str = "g_ema") -> Dict[str, torch.Tensor]:
    """State dict from an `.npz` (JAX `save_pytree_npz`) or a torch `.pt`."""
    path = Path(path)
    if path.is_dir():
        raise NotImplementedError(
            f"{path} is a directory (an orbax snapshot of the JAX package); the "
            "port loads .npz (save_pytree_npz) and reference .pt files, see ROADMAP.md"
        )
    if path.suffix == ".npz":
        return load_jax_npz(path)
    return load_reference_pt(path, key)


def save_gan_snapshot(
    path: Union[str, Path],
    generator: torch.nn.Module,
    discriminator: torch.nn.Module,
    g_ema: torch.nn.Module,
    generator_optimizer: torch.optim.Optimizer,
    discriminator_optimizer: torch.optim.Optimizer,
    mean_path_length: float,
) -> None:
    """Write a GAN training snapshot (reference `.pt` layout, module
    docstring) to `path`, through a temporary file so a crash mid-write
    leaves no half snapshot under the final name."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    torch.save({
        "generator": generator.state_dict(),
        "discriminator": discriminator.state_dict(),
        "g_ema": g_ema.state_dict(),
        "generator_optimizer": generator_optimizer.state_dict(),
        "discriminator_optimizer": discriminator_optimizer.state_dict(),
        "training_state": {"mean_path_length": float(mean_path_length)},
    }, tmp)
    os.replace(tmp, path)


def load_gan_snapshot(path: Union[str, Path]) -> Dict[str, Any]:
    """A GAN snapshot of the port or a reference `.pt` -> {key: value} for
    the keys it has of `generator`, `discriminator`, `g_ema` (state dicts,
    without the reference's blur buffers), the two optimizer states and
    `mean_path_length` (None when absent). Raises when it has none of the
    three networks."""
    ckpt = torch.load(str(path), map_location="cpu", weights_only=True)
    out: Dict[str, Any] = {}
    for key in ("generator", "discriminator", "g_ema"):
        if isinstance(ckpt.get(key), dict):
            out[key] = strip_blur_kernels(ckpt[key])
    if not out:
        raise KeyError(
            f"{path}: none of generator/discriminator/g_ema; found {sorted(ckpt)}"
        )
    for key in ("generator_optimizer", "discriminator_optimizer"):
        if key in ckpt:
            out[key] = ckpt[key]
    mpl: Optional[float] = (ckpt.get("training_state") or {}).get("mean_path_length")
    out["mean_path_length"] = None if mpl is None else float(mpl)
    return out


def _conv_bn_from_jax(prefix: str, p: Dict[str, Any], s: Dict[str, Any],
                      out: Dict[str, np.ndarray], transpose: bool = False,
                      channel_order: Optional[np.ndarray] = None) -> None:
    """One JAX ConvBNActDrop ({conv, bn} params and bn batch_stats) -> the
    reference's `{prefix}.conv.*`, `{prefix}.bn.*` keys. `channel_order`
    reorders the output channels (port channel i <- JAX channel order[i])."""
    k = np.asarray(p["conv"]["kernel"])
    if transpose:
        # flax ConvTranspose correlates the zero-inserted input with the
        # kernel as stored; torch stamps the kernel at each input pixel: the
        # spatial axes flip. (kh, kw, in, out) -> (in, out, kh, kw)
        w = k[::-1, ::-1].transpose(2, 3, 0, 1)
    else:
        w = k.transpose(3, 2, 0, 1)  # (kh, kw, in, out) -> (out, in, kh, kw)
    leaves = {"conv.weight": w, "conv.bias": p["conv"]["bias"],
              "bn.weight": p["bn"]["scale"], "bn.bias": p["bn"]["bias"],
              "bn.running_mean": s["bn"]["mean"], "bn.running_var": s["bn"]["var"]}
    for name, value in leaves.items():
        value = np.asarray(value)
        if channel_order is not None:
            value = value[channel_order]
        out[f"{prefix}.{name}"] = value
    out[f"{prefix}.bn.num_batches_tracked"] = np.zeros((), np.int64)


def doc_ufcn_params_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's DocUFCN variables ({"params", "batch_stats"},
    numpy leaves) -> the port's DocUFCN state dict, in the reference's key
    layout (the inverse of `torch_doc_ufcn_to_flax` in the JAX package).

    A pixel-shuffle decoder block's conv orders its 4C output channels as
    (parity, channel) in the JAX package and as (channel, parity) for
    `nn.PixelShuffle`; the channels are permuted to match."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, np.ndarray] = {}
    n_enc = sum(1 for name in params if name.startswith("encoder_"))
    for b in range(n_enc):
        block_p, block_s = params[f"encoder_{b}"], stats[f"encoder_{b}"]
        for i in range(len(block_p)):
            _conv_bn_from_jax(f"encoder_blocks.{b}.{i}", block_p[f"conv_{i}"],
                              block_s[f"conv_{i}"], sd)
    n_dec = sum(1 for name in params if name.startswith("decoder_"))
    for d in range(n_dec):
        block_p, block_s = params[f"decoder_{d}"], stats[f"decoder_{d}"]
        if "upsample" in block_p:
            _conv_bn_from_jax(f"decoder_blocks.{d}.conv", block_p["conv"], block_s["conv"], sd)
            _conv_bn_from_jax(f"decoder_blocks.{d}.upsample", block_p["upsample"],
                              block_s["upsample"], sd, transpose=True)
        else:
            c4 = np.asarray(block_p["conv"]["conv"]["bias"]).shape[0]
            c = c4 // 4
            # port channel ch * 4 + parity <- JAX channel parity * C + ch
            order = np.array([parity * c + ch for ch in range(c) for parity in range(4)])
            _conv_bn_from_jax(f"decoder_blocks.{d}.conv", block_p["conv"], block_s["conv"], sd,
                              channel_order=order)
    sd["classifier.weight"] = np.asarray(params["classifier"]["kernel"]).transpose(3, 2, 0, 1)
    sd["classifier.bias"] = np.asarray(params["classifier"]["bias"])
    return {k: torch.from_numpy(np.ascontiguousarray(v)) if v.dtype == np.int64
            else torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


SEGMENTATION_NETWORK_KEY = "segmentation_network"


def save_segmenter_snapshot(path: Union[str, Path], network: torch.nn.Module,
                            optimizer: Optional[torch.optim.Optimizer] = None,
                            iteration: Optional[int] = None) -> None:
    """Write a segmenter training snapshot: `segmentation_network` (the
    network's state dict, reference layout) and `main_optimizer` (torch
    optimizer state), through a temporary file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    snap: Dict[str, Any] = {SEGMENTATION_NETWORK_KEY: network.state_dict()}
    if optimizer is not None:
        snap["main_optimizer"] = optimizer.state_dict()
    if iteration is not None:
        snap["iteration"] = int(iteration)
    torch.save(snap, tmp)
    os.replace(tmp, path)


def load_segmenter_snapshot(path: Union[str, Path]) -> Dict[str, Any]:
    """{"segmentation_network": state dict[, "main_optimizer": ...,
    "iteration": ...]} from a snapshot of the port, or from a reference
    `.pt` (the same key, or a bare DocUFCN state dict)."""
    path = Path(path)
    if path.is_dir():
        raise NotImplementedError(
            f"{path} is a directory (an orbax snapshot of the JAX package); the "
            "port loads .pt snapshots, see ROADMAP.md"
        )
    ckpt = torch.load(str(path), map_location="cpu", weights_only=True)
    if SEGMENTATION_NETWORK_KEY in ckpt:
        return ckpt
    if "classifier.weight" in ckpt:
        return {SEGMENTATION_NETWORK_KEY: ckpt}
    raise KeyError(f"{path}: no {SEGMENTATION_NETWORK_KEY!r} state dict; found {sorted(ckpt)}")


def snapshot_iteration(path: Union[str, Path]) -> int:
    """`.../iter_<N>.pt` -> N; 0 for a name without one (a reference
    checkpoint)."""
    stem = Path(path).stem
    digits = stem[len("iter_"):]
    return int(digits) if stem.startswith("iter_") and digits.isdigit() else 0
