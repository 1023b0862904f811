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

`doc_ufcn_params_from_jax`, `transunet_params_from_jax` and
`ema_net_params_from_jax` carry the JAX package's segmenters across in the
reference torch layout (so do bare DocUFCN, TransUNet and EMANet `.pt` state
dicts, through `load_segmenter_snapshot`). `swagan_generator_params_from_jax`
and `swagan_discriminator_params_from_jax` do the same for SWAGAN, whose
snapshots are GAN snapshots like StyleGAN2's.
`discover_latest_snapshot` finds the newest `iter_<N>.pt` across a run's
timestamped attempts (`--resume-ckpt latest`); `upscale_gan_snapshot_tree`
and `merge_matching_leaves` warm-start a larger GAN from a smaller one's
state dicts (`--init-ckpt`); `vgg16_features_params_from_jax` and
`inception_v3_params_from_jax` carry the FID backbones' weights across.
`pixel_ensemble_params_from_jax` carries a JAX DatasetGAN ensemble across
(stacked members); `save_pixel_ensemble_snapshot` /
`load_pixel_ensemble_state` write and read ensemble snapshots in the
reference layout (`network_<i>`, `optimizer_<i>`), and read the JAX
package's `save_pytree_npz` ensembles.

Autoencoders: `encoder_params_from_jax` carries a JAX encoder's parameters
and BatchNorm statistics across (the statistics become buffers), and
`autoencoder_params_from_jax` a whole JAX composition (its decoder through
`generator_params_from_jax`, or `stylegan1_generator_params_from_jax` for a
StyleGAN1 decoder). `save_autoencoder_snapshot` writes a `.pt` holding
`autoencoder` (the composition's state dict) and `g_ema` (its decoder's),
and `load_autoencoder_snapshot` reads it, or an `.npz` of the JAX
package's `save_pytree_npz` with an `autoencoder` tree. The StyleGAN1
networks and the LPIPS backbones (`alexnet_features_params_from_jax`,
`squeezenet_features_params_from_jax`) come across the same way.
"""

from __future__ import annotations

import math
import os
import re
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

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
    _final_layers(params, sd)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def swagan_generator_params_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's SWAGAN generator variables -> port state dict. SWAGAN
    shares StyleGAN2's keys (its ToRGB has 12 output channels), so this is
    `generator_params_from_jax`, the inverse of `torch_generator_to_flax`."""
    return generator_params_from_jax(variables)


def _final_layers(params: Dict[str, Any], sd: Dict[str, np.ndarray]) -> None:
    """A discriminator's final conv and two linears, JAX -> reference keys."""
    _conv_layer("final_conv", params["final_conv"], 0, sd)
    # JAX flattens the (4, 4, C) map NHWC; the reference (and the port) NCHW
    w0 = np.asarray(params["final_linear_0"]["weight"]).T  # (out, 16 C), (y, x, c) columns
    out_dim, in_dim = w0.shape
    w0 = w0.reshape(out_dim, 4, 4, in_dim // 16).transpose(0, 3, 1, 2).reshape(out_dim, in_dim)
    sd["final_linear.0.weight"] = w0
    sd["final_linear.0.bias"] = np.asarray(params["final_linear_0"]["bias"])
    _lin("final_linear.1", params["final_linear_1"], sd)


def swagan_discriminator_params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax SWAGAN discriminator params (numpy leaves; the bare tree or
    {"params": tree}) -> port state dict (the inverse of
    `torch_swagan_discriminator_to_flax` in the JAX package):
    `from_rgbs.{i}.conv.*`, `convs.{i}.conv1/conv2.*`, `final_conv.*`,
    `final_linear.{0,1}.*`."""
    params = params.get("params", params)
    sd: Dict[str, np.ndarray] = {}
    for i in range(sum(1 for name in params if name.startswith("from_rgbs_"))):
        _conv_layer(f"from_rgbs.{i}.conv", params[f"from_rgbs_{i}"]["conv"], 0, sd)
    for i in range(sum(1 for name in params if name.startswith("convs_"))):
        block = params[f"convs_{i}"]
        _conv_layer(f"convs.{i}.conv1", block["conv1"], 0, sd)
        _conv_layer(f"convs.{i}.conv2", block["conv2"], 1, sd)  # index 0 is the blur
    _final_layers(params, sd)
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


_FIXED_BUFFERS = ("kernel", "ll", "lh", "hl", "hh")


def strip_blur_kernels(state: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Drop the reference's fixed filter buffers (`*.kernel` of its Blur,
    Upsample and Downsample modules, and the `ll` / `lh` / `hl` / `hh` Haar
    kernels of SWAGAN's wavelet transforms): the port does not store them."""
    return {k: torch.as_tensor(v) for k, v in state.items()
            if k.rsplit(".", 1)[-1] not in _FIXED_BUFFERS}


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


def transunet_params_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's TransUNet variables ({"params", "batch_stats"},
    numpy leaves) -> the port's VisionTransformer state dict, in the
    reference's key layout (the inverse of `torch_transunet_to_flax` in the
    JAX package)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, np.ndarray] = {}

    def conv(t: str, p: Dict[str, Any]) -> None:
        sd[f"{t}.weight"] = _hwio_to_oihw(p["kernel"])
        if "bias" in p:
            sd[f"{t}.bias"] = np.asarray(p["bias"])

    def affine(t: str, p: Dict[str, Any]) -> None:  # GroupNorm / LayerNorm
        sd[f"{t}.weight"], sd[f"{t}.bias"] = np.asarray(p["scale"]), np.asarray(p["bias"])

    def lin(t: str, p: Dict[str, Any]) -> None:
        sd[f"{t}.weight"], sd[f"{t}.bias"] = np.asarray(p["kernel"]).T, np.asarray(p["bias"])

    def conv_bn_relu(t: str, p: Dict[str, Any], s: Dict[str, Any]) -> None:
        conv(f"{t}.0", p["conv"])
        affine(f"{t}.1", p["bn"])
        sd[f"{t}.1.running_mean"] = np.asarray(s["bn"]["mean"])
        sd[f"{t}.1.running_var"] = np.asarray(s["bn"]["var"])
        sd[f"{t}.1.num_batches_tracked"] = np.zeros((), np.int64)

    emb = "transformer.embeddings"
    if "hybrid_model" in params:
        hybrid = params["hybrid_model"]
        conv(f"{emb}.hybrid_model.root.conv", hybrid["root_conv"])
        affine(f"{emb}.hybrid_model.root.gn", hybrid["root_gn"])
        for name, unit in hybrid.items():
            if not name.startswith("block"):
                continue
            block, unit_name = name.split("_")
            t = f"{emb}.hybrid_model.body.{block}.{unit_name}"
            for j in (1, 2, 3):
                conv(f"{t}.conv{j}", unit[f"conv{j}"])
                affine(f"{t}.gn{j}", unit[f"gn{j}"])
            if "downsample" in unit:
                conv(f"{t}.downsample", unit["downsample"])
                affine(f"{t}.gn_proj", unit["gn_proj"])
    conv(f"{emb}.patch_embeddings", params["patch_embeddings"])
    sd[f"{emb}.position_embeddings"] = np.asarray(params["position_embeddings"])
    n_layers = sum(1 for name in params if name.startswith("encoderblock_"))
    for i in range(n_layers):
        t, p = f"transformer.encoder.layer.{i}", params[f"encoderblock_{i}"]
        affine(f"{t}.attention_norm", p["attention_norm"])
        affine(f"{t}.ffn_norm", p["ffn_norm"])
        for name in ("query", "key", "value", "out"):
            lin(f"{t}.attn.{name}", p["attn"][name])
        lin(f"{t}.ffn.fc1", p["ffn"]["fc1"])
        lin(f"{t}.ffn.fc2", p["ffn"]["fc2"])
    affine("transformer.encoder.encoder_norm", params["encoder_norm"])
    conv_bn_relu("decoder.conv_more", params["conv_more"], stats["conv_more"])
    n_blocks = sum(1 for name in params if name.startswith("decoder_block_"))
    for i in range(n_blocks):
        for c in ("conv1", "conv2"):
            conv_bn_relu(f"decoder.blocks.{i}.{c}", params[f"decoder_block_{i}"][c],
                         stats[f"decoder_block_{i}"][c])
    conv("segmentation_head.0", params["segmentation_head"])
    return {k: torch.from_numpy(np.ascontiguousarray(v)) if v.dtype == np.int64
            else torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def ema_net_params_from_jax(variables: Dict[str, Any], mu) -> Dict[str, torch.Tensor]:
    """The JAX package's EMANet variables ({"params", "batch_stats"}, numpy
    leaves) and its µ bases (1, C, K) -> the port's EMANet state dict, in the
    reference's key layout (the inverse of `torch_emanet_to_flax` in the JAX
    package; µ becomes the `emau.mu` buffer)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, np.ndarray] = {}

    def node(tree: Dict[str, Any], path: str) -> Dict[str, Any]:
        for part in path.split("/"):
            tree = tree[part]
        return tree

    def conv(t: str, path: str) -> None:
        p = node(params, path)
        sd[f"{t}.weight"] = _hwio_to_oihw(p["kernel"])
        if "bias" in p:
            sd[f"{t}.bias"] = np.asarray(p["bias"])

    def bn(t: str, path: str) -> None:
        p, s = node(params, path), node(stats, path)
        sd[f"{t}.weight"], sd[f"{t}.bias"] = np.asarray(p["scale"]), np.asarray(p["bias"])
        sd[f"{t}.running_mean"] = np.asarray(s["mean"])
        sd[f"{t}.running_var"] = np.asarray(s["var"])
        sd[f"{t}.num_batches_tracked"] = np.zeros((), np.int64)

    for t, path in (("extractor.0.0", "stem_conv1"), ("extractor.0.3", "stem_conv2"),
                    ("extractor.0.6", "stem_conv3")):
        conv(t, f"extractor/{path}")
    for t, path in (("extractor.0.1", "stem_bn1"), ("extractor.0.4", "stem_bn2"),
                    ("extractor.1", "bn1")):
        bn(t, f"extractor/{path}")
    for li in range(1, 5):
        layer = params["extractor"][f"layer{li}"]
        for i in range(len(layer)):
            t, f = f"extractor.{li + 3}.{i}", f"extractor/layer{li}/block_{i}"
            for j in (1, 2, 3):
                conv(f"{t}.conv{j}", f"{f}/conv{j}")
                bn(f"{t}.bn{j}", f"{f}/bn{j}")
            if "downsample_conv" in layer[f"block_{i}"]:
                conv(f"{t}.downsample.0", f"{f}/downsample_conv")
                bn(f"{t}.downsample.1", f"{f}/downsample_bn")
    conv("fc0.conv", "fc0_conv")
    bn("fc0.bn", "fc0_bn")
    conv("emau.conv1", "emau/conv1")
    conv("emau.conv2.0", "emau/conv2_conv")
    bn("emau.conv2.1", "emau/conv2_bn")
    conv("fc1.0.conv", "fc1_conv")
    bn("fc1.0.bn", "fc1_bn")
    conv("fc2", "fc2")
    sd["emau.mu"] = np.asarray(mu)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) if v.dtype == np.int64
            else torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


SEGMENTATION_NETWORK_KEY = "segmentation_network"


def save_segmenter_snapshot(path: Union[str, Path], network: torch.nn.Module,
                            optimizer=None, iteration: Optional[int] = None) -> None:
    """Write a segmenter training snapshot: `segmentation_network` (the
    network's state dict, reference layout) and `main_optimizer` (the
    optimizer's `state_dict()`: a torch Adam's or SGD's), through a
    temporary file."""
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
    `.pt` (the same key, or a bare DocUFCN, TransUNet or EMANet state
    dict)."""
    path = Path(path)
    if path.is_dir():
        raise NotImplementedError(
            f"{path} is a directory (an orbax snapshot of the JAX package); the "
            "port loads .pt snapshots, see ROADMAP.md"
        )
    ckpt = torch.load(str(path), map_location="cpu", weights_only=True)
    if SEGMENTATION_NETWORK_KEY in ckpt:
        return ckpt
    # DocUFCN, TransUNet, EMANet
    if any(key in ckpt for key in ("classifier.weight", "segmentation_head.0.weight",
                                   "emau.mu")):
        return {SEGMENTATION_NETWORK_KEY: ckpt}
    raise KeyError(f"{path}: no {SEGMENTATION_NETWORK_KEY!r} state dict; found {sorted(ckpt)}")


def snapshot_iteration(path: Union[str, Path]) -> int:
    """`.../iter_<N>.pt` -> N; 0 for a name without one (a reference
    checkpoint)."""
    stem = Path(path).stem
    digits = stem[len("iter_"):]
    return int(digits) if stem.startswith("iter_") and digits.isdigit() else 0


# ---------------------------------------------------------------------------
# snapshot discovery (`--resume-ckpt latest`)


def _is_snapshot_file(path: Path) -> bool:
    """A finished snapshot: an `iter_<N>.pt` file (never a `.tmp` that a
    crash left mid-write)."""
    return path.is_file() and path.suffix == ".pt" and path.stem.startswith("iter_")


def latest_snapshot(checkpoint_dir: Union[str, Path]) -> Optional[Path]:
    """Newest `iter_<N>.pt` snapshot in a checkpoints directory, or None."""
    checkpoint_dir = Path(checkpoint_dir)
    snaps = sorted(p for p in checkpoint_dir.glob("iter_*.pt") if _is_snapshot_file(p))
    return snaps[-1] if snaps else None


def discover_latest_snapshot(run_root: Union[str, Path]) -> Optional[Path]:
    """`--resume-ckpt latest`: the highest-iteration snapshot across every
    timestamped attempt under a `logs/<log_dir>/<log_name>` root (a restarted
    run gets a fresh timestamp directory, so the previous attempt's snapshots
    live in a sibling). Also accepts one run directory or a bare checkpoints
    directory; ties break toward the newest mtime."""
    run_root = Path(run_root)
    candidates = [*run_root.glob("*/checkpoints/iter_*.pt"),
                  *run_root.glob("checkpoints/iter_*.pt"), *run_root.glob("iter_*.pt")]
    candidates = [c for c in candidates if _is_snapshot_file(c)]
    if not candidates:
        return None
    return max(candidates, key=lambda c: (snapshot_iteration(c), c.stat().st_mtime))


# ---------------------------------------------------------------------------
# shape-tolerant warm start (`--init-ckpt`)


def merge_matching_leaves(fresh: Dict[str, torch.Tensor], loaded: Dict[str, Any]):
    """Copy every tensor of `loaded` whose key is in `fresh` with the same
    shape and dtype; keep `fresh`'s init for every other key (missing, another
    shape or dtype, or not a tensor at all). Returns (merged state dict,
    copied count, fresh count)."""
    merged, copied = {}, 0
    for key, value in fresh.items():
        src = loaded.get(key)
        if (isinstance(src, torch.Tensor) and src.shape == value.shape
                and src.dtype == value.dtype):
            merged[key] = src.detach().clone()
            copied += 1
        else:
            merged[key] = value
    return merged, copied, len(fresh) - copied


def upscale_gan_snapshot_tree(snapshot: Dict[str, Any], source_size: int,
                              target_size: int) -> Dict[str, Any]:
    """Re-key a smaller-resolution GAN snapshot ({"generator",
    "discriminator", "g_ema": state dict, ...}) so its tensors land on the
    matching stages of a larger-resolution model (the 128px -> 256px warm
    start).

    The generator's and g_ema's `convs.i`, `to_rgbs.i` and `noises.noise_i`
    count from the 4px end, so they already line up by name. The
    discriminator's blocks count from the input resolution down: `convs.0` is
    its input layer (another channel count at the new size, dropped) and
    `convs.{i+1}` its i-th block, which becomes `convs.{i+1+shift}` with
    shift = log2(target) - log2(source). Apply with `merge_matching_leaves`:
    any shape that still differs keeps its fresh init."""
    shift = int(math.log2(target_size)) - int(math.log2(source_size))
    if shift < 0:
        raise ValueError(f"cannot warm-start a {target_size}px model from a larger "
                         f"{source_size}px snapshot")
    out = dict(snapshot)
    disc = snapshot.get("discriminator")
    if isinstance(disc, dict) and shift > 0:
        renamed = {}
        for key, value in disc.items():
            parts = key.split(".")
            if parts[0] == "convs" and len(parts) > 1 and parts[1].isdigit():
                index = int(parts[1])
                if index == 0:
                    continue
                key = ".".join(["convs", str(index + shift), *parts[2:]])
            renamed[key] = value
        out["discriminator"] = renamed
    return out


# ---------------------------------------------------------------------------
# metric backbones carried across from the JAX package


def _hwio_to_oihw(kernel) -> np.ndarray:
    return np.asarray(kernel).transpose(3, 2, 0, 1)


def vgg16_features_params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's VGG16Features params (`conv_<i>` with `kernel` HWIO
    and `bias`; the bare tree or {"params": tree}) -> the port's VGG16Features
    state dict (`convs.<i>.weight` OIHW, `convs.<i>.bias`)."""
    params = params.get("params", params)
    sd = {}
    for name, p in params.items():
        i = int(name.rsplit("_", 1)[1])
        sd[f"convs.{i}.weight"] = _hwio_to_oihw(p["kernel"])
        sd[f"convs.{i}.bias"] = np.asarray(p["bias"])
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def inception_v3_params_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's InceptionV3Features variables ({"params",
    "batch_stats"}; each BasicConv is {"conv": {"kernel"}, "bn": {"scale",
    "bias"}} with {"bn": {"mean", "var"}} statistics) -> the port's state dict
    in torchvision's key layout (`<path>.conv.weight`, `<path>.bn.weight`,
    `.bias`, `.running_mean`, `.running_var`, `.num_batches_tracked`)."""
    sd: Dict[str, np.ndarray] = {}

    def visit(p: Dict[str, Any], s: Dict[str, Any], path: Tuple[str, ...]) -> None:
        if "conv" in p and "bn" in p:
            prefix = ".".join(path)
            sd[f"{prefix}.conv.weight"] = _hwio_to_oihw(p["conv"]["kernel"])
            sd[f"{prefix}.bn.weight"] = np.asarray(p["bn"]["scale"])
            sd[f"{prefix}.bn.bias"] = np.asarray(p["bn"]["bias"])
            sd[f"{prefix}.bn.running_mean"] = np.asarray(s["bn"]["mean"])
            sd[f"{prefix}.bn.running_var"] = np.asarray(s["bn"]["var"])
            sd[f"{prefix}.bn.num_batches_tracked"] = np.zeros((), np.int64)
            return
        for name, sub in p.items():
            visit(sub, s[name], path + (name,))

    visit(variables["params"], variables["batch_stats"], ())
    return {k: torch.from_numpy(np.array(v, dtype=np.int64 if v.dtype == np.int64
                                         else np.float32)) for k, v in sd.items()}


# ---------------------------------------------------------------------------
# DatasetGAN pixel ensembles

_ENSEMBLE_LAYERS = ("fc1", "bn1", "fc2", "bn2", "fc3")


def pixel_ensemble_params_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's stacked PixelEnsembleClassifier variables
    ({"params": {fc1: {kernel (M, in, out), bias}, bn1: {scale, bias}, ...},
    "batch_stats": {bn1: {mean, var}, ...}}, leaves numpy) -> the port's
    stacked state dict (`fc1.weight` (M, out, in), `bn1.running_var`, ...)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, np.ndarray] = {}
    for name in _ENSEMBLE_LAYERS:
        p = params[name]
        if name.startswith("fc"):
            sd[f"{name}.weight"] = np.swapaxes(np.asarray(p["kernel"]), 1, 2)
            sd[f"{name}.bias"] = np.asarray(p["bias"])
        else:
            sd[f"{name}.weight"] = np.asarray(p["scale"])
            sd[f"{name}.bias"] = np.asarray(p["bias"])
            sd[f"{name}.running_mean"] = np.asarray(stats[name]["mean"])
            sd[f"{name}.running_var"] = np.asarray(stats[name]["var"])
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def _member_keys(ckpt: Dict[str, Any], prefix: str) -> list:
    """`<prefix>_<i>` keys in member order."""
    keys = [k for k in ckpt if k.startswith(prefix + "_") and k[len(prefix) + 1:].isdigit()]
    return sorted(keys, key=lambda k: int(k[len(prefix) + 1:]))


def load_pixel_ensemble_state(path: Union[str, Path]) -> Dict[str, Any]:
    """{"ensemble": stacked state dict[, "optimizers": per-member torch
    optimizer states, "iteration": N]} from
    * a `.pt` with reference-layout members `network_<i>` (and
      `optimizer_<i>`): the port's snapshot or the reference's;
    * an `.npz` from the JAX package's `save_pytree_npz`: a stacked
      `pixel_ensemble` tree, or members `network_<i>`."""
    path = Path(path)
    if path.is_dir():
        raise NotImplementedError(
            f"{path} is a directory (an orbax snapshot of the JAX package); the "
            "port loads .pt snapshots and save_pytree_npz .npz files, see ROADMAP.md"
        )
    if path.suffix == ".npz":
        with np.load(str(path)) as data:
            tree = unflatten_npz(data)
        variables = tree.get("pixel_ensemble")
        if variables is None:
            members = [tree[k] for k in _member_keys(tree, "network")]
            if not members:
                raise KeyError(
                    f"{path}: no 'pixel_ensemble' or 'network_<i>'; found {sorted(tree)}")
            variables = _stack_trees(members)
        return {"ensemble": pixel_ensemble_params_from_jax(variables)}
    from synthesis_in_style_tpu_torch.models.pixel_classifier import stack_member_state_dicts

    ckpt = torch.load(str(path), map_location="cpu", weights_only=True)
    names = _member_keys(ckpt, "network")
    if not names:
        raise KeyError(f"{path}: no 'network_<i>' members; found {sorted(ckpt)}")
    out: Dict[str, Any] = {"ensemble": stack_member_state_dicts([ckpt[k] for k in names])}
    optimizers = [ckpt[k] for k in _member_keys(ckpt, "optimizer")]
    if optimizers:
        out["optimizers"] = optimizers
    if "iteration" in ckpt:
        out["iteration"] = int(ckpt["iteration"])
    return out


def _stack_trees(trees: list) -> Any:
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return np.stack([np.asarray(t) for t in trees])


def save_pixel_ensemble_snapshot(path: Union[str, Path], members: list, optimizers: list,
                                 iteration: int) -> None:
    """Write an ensemble snapshot in the reference layout: `network_<i>`
    (reference-layout member state dicts), `optimizer_<i>` (each member's
    torch Adam state) and `iteration`, through a temporary file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    snap: Dict[str, Any] = {f"network_{i}": m for i, m in enumerate(members)}
    snap.update({f"optimizer_{i}": o for i, o in enumerate(optimizers)})
    snap["iteration"] = int(iteration)
    torch.save(snap, tmp)
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# encoders and autoencoders

# the JAX encoders' numbered submodules -> the port's ModuleLists
_ENCODER_LISTS = {"resnet_blocks": "resnet_blocks", "intermediate_blocks": "intermediate_blocks",
                  "to_latent": "to_latents", "intermediate_to_latent": "intermediate_to_latents",
                  "to_noise": "to_noises", "intermediate_to_noise": "intermediate_to_noises"}


def _encoder_key(name: str) -> str:
    m = re.fullmatch(r"(.*)_(\d+)", name)
    if m and m.group(1) in _ENCODER_LISTS:
        return f"{_ENCODER_LISTS[m.group(1)]}.{m.group(2)}"
    return name


def _float32(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """float32 tensors, int64 counters kept (with their shape: 0-d stays 0-d)."""
    return {k: torch.from_numpy(np.array(v, dtype=np.int64 if v.dtype == np.int64
                                         else np.float32)) for k, v in sd.items()}


def encoder_params_from_jax(params: Dict[str, Any],
                            batch_stats: Optional[Dict[str, Any]] = None
                            ) -> Dict[str, torch.Tensor]:
    """A JAX encoder's params and batch_stats trees (numpy leaves) -> the
    port encoder's state dict (models/encoder.py): conv kernels HWIO ->
    OIHW, BatchNorm scale / bias -> weight / bias, its mean / var ->
    running_mean / running_var buffers."""
    sd: Dict[str, np.ndarray] = {}

    def walk(p: Dict[str, Any], st: Dict[str, Any], prefix: str) -> None:
        if "kernel" in p:
            sd[f"{prefix}weight"] = _hwio_to_oihw(p["kernel"])
            if "bias" in p:
                sd[f"{prefix}bias"] = np.asarray(p["bias"])
            return
        if "scale" in p:
            sd[f"{prefix}weight"] = np.asarray(p["scale"])
            sd[f"{prefix}bias"] = np.asarray(p["bias"])
            sd[f"{prefix}running_mean"] = np.asarray(st["mean"])
            sd[f"{prefix}running_var"] = np.asarray(st["var"])
            sd[f"{prefix}num_batches_tracked"] = np.zeros((), np.int64)
            return
        for name, sub in p.items():
            walk(sub, (st or {}).get(name, {}), f"{prefix}{_encoder_key(name)}.")

    walk(params, batch_stats or {}, "")
    return _float32(sd)


def autoencoder_params_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX autoencoder composition's variables ({"params", "batch_stats",
    "noises"}, numpy leaves) -> the port composition's state dict: each
    encoder (`encoder`, `latent_encoder`, `noise_encoder`) through
    `encoder_params_from_jax`, the decoder through the generator
    converters, each under its name."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}
    for name, sub in params.items():
        if name == "decoder":
            if "generator" in sub:
                dec = stylegan1_generator_params_from_jax({"params": sub})
            else:
                dec_vars = {"params": sub}
                noises = variables.get("noises", {}).get("decoder")
                if noises:
                    dec_vars["noises"] = noises
                dec = generator_params_from_jax(dec_vars)
        else:
            dec = encoder_params_from_jax(sub, stats.get(name, {}))
        sd.update({f"{name}.{k}": v for k, v in dec.items()})
    return sd


AUTOENCODER_KEY = "autoencoder"


def save_autoencoder_snapshot(path: Union[str, Path], autoencoder: torch.nn.Module,
                              **extra: Any) -> None:
    """Write `autoencoder` (the composition's state dict) and `g_ema` (its
    decoder's), plus any `extra` entries (optimizer states, iteration), to a
    `.pt`, through a temporary file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    torch.save({AUTOENCODER_KEY: autoencoder.state_dict(),
                "g_ema": autoencoder.decoder.state_dict(), **extra}, tmp)
    os.replace(tmp, path)


def load_autoencoder_snapshot(path: Union[str, Path]) -> Optional[Dict[str, Any]]:
    """{"autoencoder": state dict[, "g_ema": the decoder's state dict, other
    entries]} from a `.pt` of `save_autoencoder_snapshot`, or from an `.npz`
    of the JAX package's `save_pytree_npz` with an `autoencoder` variables
    tree; None when the checkpoint holds no autoencoder (a generator)."""
    path = Path(path)
    if path.is_dir():
        raise NotImplementedError(
            f"{path} is a directory (an orbax snapshot of the JAX package); the "
            "port loads .pt snapshots and save_pytree_npz .npz files, see ROADMAP.md"
        )
    if path.suffix == ".npz":
        with np.load(str(path)) as data:
            tree = unflatten_npz(data)
        if AUTOENCODER_KEY not in tree:
            return None
        state = autoencoder_params_from_jax(tree[AUTOENCODER_KEY])
        out = {AUTOENCODER_KEY: state,
               "g_ema": {k[len("decoder."):]: v for k, v in state.items()
                         if k.startswith("decoder.")}}
        return out
    ckpt = torch.load(str(path), map_location="cpu", weights_only=True)
    if not isinstance(ckpt.get(AUTOENCODER_KEY), dict):
        return None
    return ckpt


# ---------------------------------------------------------------------------
# StyleGAN1


def _equal(prefix: str, p: Dict[str, Any], out: Dict[str, np.ndarray], kind: str) -> None:
    """A JAX StyleGAN1 weight + bias -> the port's layout: `linear` (in, out)
    -> (out, in); `conv` HWIO -> OIHW; `up` (FusedUpsample) HWIO -> (in,
    out, kh, kw)."""
    w = np.asarray(p["weight"])
    out[f"{prefix}.weight"] = {"linear": lambda a: a.T,
                               "conv": lambda a: a.transpose(3, 2, 0, 1),
                               "up": lambda a: a.transpose(2, 3, 0, 1)}[kind](w)
    out[f"{prefix}.bias"] = np.asarray(p["bias"])


def stylegan1_generator_params_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's StyledGenerator variables -> the port's
    StyledGenerator state dict (models/stylegan1.py)."""
    params = variables.get("params", variables)
    sd: Dict[str, np.ndarray] = {}
    for name, p in params.items():
        if name.startswith("style_"):
            _equal(f"style_layers.{name.rsplit('_', 1)[1]}", p, sd, "linear")
    for name, block in params["generator"].items():
        index = name.rsplit("_", 1)[1]
        if name.startswith("to_rgb_"):
            _equal(f"generator.to_rgb.{index}", block, sd, "conv")
            continue
        t = f"generator.progression.{index}"
        if "input" in block:
            sd[f"{t}.input"] = np.asarray(block["input"]).transpose(0, 3, 1, 2)
        if "conv1_fused" in block:
            _equal(f"{t}.conv1_fused", block["conv1_fused"], sd, "up")
        if "conv1" in block:
            _equal(f"{t}.conv1", block["conv1"], sd, "conv")
        _equal(f"{t}.conv2", block["conv2"], sd, "conv")
        for j in (1, 2):
            sd[f"{t}.noise{j}.weight"] = np.asarray(
                block[f"noise{j}"]["weight"]).transpose(0, 3, 1, 2)
            _equal(f"{t}.adain{j}.style", block[f"adain{j}"]["style"], sd, "linear")
    return _float32(sd)


def stylegan1_discriminator_params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ProgressiveDiscriminator params (the bare tree or
    {"params": tree}) -> the port's state dict."""
    params = params.get("params", params)
    sd: Dict[str, np.ndarray] = {}
    for name, p in params.items():
        if name.startswith("from_rgb_"):
            _equal(f"from_rgb.{name.rsplit('_', 1)[1]}", p, sd, "conv")
        elif m := re.fullmatch(r"conv_(\d+)_(\d)", name):
            _equal(f"blocks.{m.group(1)}.conv{m.group(2)}", p, sd, "conv")
        elif name == "linear":
            _equal("linear", p, sd, "linear")
        else:
            _equal(name, p, sd, "conv")
    return _float32(sd)


def load_stylegan1_generator_state(path: Union[str, Path], key: str = "g_ema"
                                   ) -> Dict[str, torch.Tensor]:
    """A StyledGenerator state dict from an `.npz` (JAX `save_pytree_npz` of
    its variables, or of a snapshot with `g_ema`) or a `.pt` (the port's
    state dict, bare or under `key` / `generator`)."""
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(str(path)) as data:
            tree = unflatten_npz(data)
        return stylegan1_generator_params_from_jax(tree.get(key, tree))
    ckpt = torch.load(str(path), map_location="cpu", weights_only=True)
    for name in (key, "generator"):
        if isinstance(ckpt.get(name), dict):
            return ckpt[name]
    return ckpt


# ---------------------------------------------------------------------------
# LPIPS backbones


def alexnet_features_params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's AlexNetFeatures params (`conv_<i>`) -> the port's
    AlexNetFeatures state dict (`convs.<i>.*`); the same layout as VGG16's."""
    return vgg16_features_params_from_jax(params)


def squeezenet_features_params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's SqueezeNetFeatures params (`conv_0`, `fire_<i>`
    with `squeeze`, `expand1x1`, `expand3x3`) -> the port's state dict."""
    params = params.get("params", params)
    sd: Dict[str, np.ndarray] = {}

    def conv(t: str, p: Dict[str, Any]) -> None:
        sd[f"{t}.weight"] = _hwio_to_oihw(p["kernel"])
        sd[f"{t}.bias"] = np.asarray(p["bias"])

    conv("conv_0", params["conv_0"])
    for name, fire in params.items():
        if name.startswith("fire_"):
            for sub in ("squeeze", "expand1x1", "expand3x3"):
                conv(f"fires.{name.rsplit('_', 1)[1]}.{sub}", fire[sub])
    return _float32(sd)
