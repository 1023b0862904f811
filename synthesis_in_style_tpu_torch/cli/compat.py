"""The reference's torch-era launch flags (counterpart of
synthesis_in_style_tpu/cli/compat.py).

The reference CLIs take `-d/--device`, `--local_rank` and `--mpi-backend`,
and reference launch scripts pass them. In the port `-d/--device` is a torch
device (default `cuda`). `launch` opens the process group of a
multi-process run that the environment announces (torchrun, or
torch.distributed.launch with `--local_rank`: WORLD_SIZE, RANK, MASTER_ADDR,
MASTER_PORT; parallel/distributed.py) on the `--mpi-backend` it names or
NCCL on the card, gloo on the CPU, and returns the process's device
(`cuda:LOCAL_RANK` on the card). Without such a launch it is the single
process: `--local_rank` unset or 0 stays silent and `--mpi-backend` is
ignored with a warning.
"""

from __future__ import annotations

import argparse
import os
import warnings

import torch

from synthesis_in_style_tpu_torch.parallel import distributed


def add_torch_compat_args(parser: argparse.ArgumentParser) -> None:
    """Register `-d/--device` (default `cuda`), `--local_rank` and
    `--mpi-backend` (both default None, so that `merge_config_and_args`
    copies no value the user did not give)."""
    parser.add_argument("-d", "--device", default="cuda",
                        help="torch device to run on (default cuda)")
    parser.add_argument("--local_rank", type=int, default=None,
                        help="this process's local rank in a torch.distributed.launch "
                        "run (torchrun sets LOCAL_RANK); unset or 0 without a launch "
                        "is the single-process run")
    parser.add_argument("--mpi-backend", default=None, choices=["nccl", "gloo"],
                        help="process-group backend of a launched run (default nccl on "
                        "the card, gloo on the CPU); ignored in a single process")


def launch_indicated() -> bool:
    """Does the environment announce a multi-process launch?"""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def launch(args) -> torch.device:
    """Open the process group of an announced launch (idempotent) and return
    this process's device; a single process gets `device` as given. `args`
    is a namespace or a config dict with `device`, `local_rank` and
    `mpi_backend`. A positive `--local_rank` without the launcher's
    environment raises."""
    get = args.get if isinstance(args, dict) else (lambda k, d=None: getattr(args, k, d))
    device = get("device", "cuda") or "cuda"
    distributed.maybe_initialize_distributed(get("local_rank"), get("mpi_backend"), device)
    return distributed.process_device(device)


def warn_ignored_torch_args(args) -> None:
    """One warning when `--mpi-backend` was passed to a single-process run
    (`args` a namespace or a config dict)."""
    backend = (args.get("mpi_backend") if isinstance(args, dict)
               else getattr(args, "mpi_backend", None))
    if backend is not None and not launch_indicated():
        warnings.warn(f"ignoring --mpi-backend {backend}: a single process opens no "
                      "process group", stacklevel=2)
