"""Generator weights in and out of the port.

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
  network name (`g_ema`, `generator`).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Union

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


def load_reference_pt(path: Union[str, Path], key: str = "g_ema") -> Dict[str, torch.Tensor]:
    """Port state dict from a reference-layout torch checkpoint."""
    ckpt = torch.load(str(path), map_location="cpu", weights_only=True)
    if key in ckpt and isinstance(ckpt[key], dict):
        ckpt = ckpt[key]
    if "input.input" not in ckpt:
        raise KeyError(f"{path}: no generator state dict (no {key!r}, no 'input.input')")
    return {k: torch.as_tensor(v) for k, v in ckpt.items()}


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
