"""Run jax's Pallas TPU flash attention in interpret mode on the CPU, in a
child process whose JAX dispatches synchronously.

Executed op by op (outside jit), an interpreted `pallas_call` runs its
kernel through io_callbacks on a runtime thread, and those callbacks
dispatch JAX ops of their own (they iterate device arrays). With async
dispatch the caller's thread goes on dispatching the next op meanwhile, and
the two dispatches deadlocked now and then (every thread idle, the test
stuck in `jax.grad`); waiting for each `pallas_call`'s outputs made that
rarer, not impossible. With `jax_cpu_enable_async_dispatch` off, every op
returns only once it has run, so the callbacks never meet a second
dispatching thread. JAX reads that setting only when it creates the CPU
client, which a test process has long done, hence the child process:
`run_in_sync_child(fn, tmp_path, **arrays)` calls `fn(**arrays)` there, in
TPU interpret mode, and hands the arrays both ways through .npz files. The
arithmetic is the same as in the test's own process.
"""

import faulthandler
import importlib
import os
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 600


def run_in_sync_child(fn: Callable[..., Dict[str, np.ndarray]], tmp_path: Path,
                      **arrays: np.ndarray) -> Dict[str, np.ndarray]:
    """fn(**arrays) in a child process with synchronous CPU dispatch and
    Pallas in TPU interpret mode. fn is a module-level function of a module
    in tests/ that returns a flat dict of arrays. A child that has not
    finished after TIMEOUT_S is killed and its stacks reported: the test
    then fails instead of holding the lane."""
    inp, out = tmp_path / f"{fn.__name__}_in.npz", tmp_path / f"{fn.__name__}_out.npz"
    np.savez(inp, **arrays)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(p for p in (str(ROOT), os.environ.get("PYTHONPATH"))
                                         if p)}
    cmd = [sys.executable, __file__, fn.__module__, fn.__name__, str(inp), str(out)]
    try:
        proc = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True,
                              timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired as exc:
        raise AssertionError(f"{fn.__name__} did not finish in {TIMEOUT_S} s; its stacks:\n"
                             f"{exc.stderr}") from None
    if proc.returncode != 0:
        raise AssertionError(f"{fn.__name__} failed in the child process:\n{proc.stderr}")
    with np.load(out) as result:
        return dict(result)


def _child(module: str, name: str, inp: str, out: str) -> None:
    faulthandler.dump_traceback_later(TIMEOUT_S - 30, exit=True)
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    import jax.experimental.pallas.tpu as pltpu

    fn = getattr(importlib.import_module(module), name)
    with np.load(inp) as f:
        arrays = dict(f)
    with pltpu.force_tpu_interpret_mode():
        result = fn(**arrays)
    np.savez(out, **{key: np.asarray(value) for key, value in result.items()})


if __name__ == "__main__":
    _child(*sys.argv[1:])
