"""The reference's torch-era launch flags (counterpart of
synthesis_in_style_tpu/cli/compat.py).

The reference CLIs take `-d/--device`, `--local_rank` and `--mpi-backend`,
and reference launch scripts pass them. In the port `-d/--device` is real
(a torch device, default `cuda`). One process is the only run the port has:
`--local_rank` unset or 0 is that run and stays silent, `--mpi-backend`
there selects nothing and is ignored with a warning, and a positive rank or
a `WORLD_SIZE` above 1 raises (multi-GPU is ROADMAP.md Queue 1 item 11).
"""

from __future__ import annotations

import argparse
import os
import warnings


def add_torch_compat_args(parser: argparse.ArgumentParser) -> None:
    """Register `-d/--device` (default `cuda`), `--local_rank` and
    `--mpi-backend` (both default None, so that `merge_config_and_args`
    copies no value the user did not give)."""
    parser.add_argument("-d", "--device", default="cuda",
                        help="torch device to run on (default cuda)")
    parser.add_argument("--local_rank", type=int, default=None,
                        help="this process's rank: unset or 0 is the single-process "
                        "run; more than one process is not ported yet")
    parser.add_argument("--mpi-backend", default=None, choices=["nccl", "gloo"],
                        help="ignored in a single process (no process group)")


def check_single_process(local_rank=None) -> None:
    """Raise NotImplementedError where the launch asks for more than one
    process: a positive `local_rank` or a `WORLD_SIZE` above 1."""
    if (local_rank or 0) > 0 or int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError(
            "training in more than one process is not ported to synthesis_in_style_tpu_torch "
            "yet (see ROADMAP.md, Queue 1 item 11)")


def warn_ignored_torch_args(args) -> None:
    """One warning when `--mpi-backend` was passed to a single-process run
    (`args` a namespace or a config dict)."""
    backend = (args.get("mpi_backend") if isinstance(args, dict)
               else getattr(args, "mpi_backend", None))
    if backend is not None:
        warnings.warn(f"ignoring --mpi-backend {backend}: a single process opens no "
                      "process group", stacklevel=2)
