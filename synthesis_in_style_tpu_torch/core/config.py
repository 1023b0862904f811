"""Config loading (counterpart of synthesis_in_style_tpu/core/config.py).

Configs are JSON. A YAML config needs PyYAML, which the port does not
require: without it, loading one raises a clear error.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Any, Dict, Optional, Union


def load_json_config(path: Union[str, Path]) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_yaml_config(path: Union[str, Path]) -> Dict[str, Any]:
    try:
        import yaml
    except ImportError as e:
        raise RuntimeError(
            f"{path} is a YAML config and PyYAML is not installed; "
            "give the port a JSON config instead"
        ) from e
    with open(path) as f:
        return yaml.safe_load(f)


def load_config_file(path: Union[str, Path]) -> Dict[str, Any]:
    path = Path(path)
    if path.suffix in (".yaml", ".yml"):
        return load_yaml_config(path)
    return load_json_config(path)


def merge_config_and_args(config: Dict[str, Any], args: argparse.Namespace) -> Dict[str, Any]:
    """Args win over config keys when the arg value is not None."""
    merged = dict(config)
    for key, value in vars(args).items():
        if value is not None:
            merged[key] = value
    return merged


def save_run_config(log_dir: Union[str, Path], config: Dict[str, Any],
                    args: Optional[argparse.Namespace] = None) -> None:
    """Write `<log_dir>/config/config.json` (and `args.json`), where
    `load_config_from_checkpoint` finds them from a snapshot."""
    config_dir = Path(log_dir) / "config"
    config_dir.mkdir(parents=True, exist_ok=True)
    with open(config_dir / "config.json", "w") as f:
        json.dump(config, f, indent=2, default=str)
    if args is not None:
        with open(config_dir / "args.json", "w") as f:
            json.dump(vars(args), f, indent=2, default=str)


def get_config_dir_from_checkpoint(checkpoint_path: Union[str, Path]) -> Path:
    """`<run_dir>/checkpoints/<ckpt>` -> `<run_dir>/config`."""
    return Path(checkpoint_path).resolve().parent.parent / "config"


def load_config_from_checkpoint(
    checkpoint_path: Union[str, Path],
    original_config_path: Optional[Union[str, Path]] = None,
) -> Dict[str, Any]:
    """The training config stored beside a checkpoint (`config.json` or
    `config.yaml`, merged under `args.json`), else `original_config_path`."""
    config_dir = get_config_dir_from_checkpoint(checkpoint_path)
    for cand in (config_dir / "config.json", config_dir / "config.yaml"):
        if cand.exists():
            config = load_config_file(cand)
            args_file = config_dir / "args.json"
            if args_file.exists():
                config = {**load_json_config(args_file), **config}
            return config
    if original_config_path is not None:
        return load_config_file(original_config_path)
    raise FileNotFoundError(
        f"no config found at {config_dir} and no --original-config-path given"
    )
