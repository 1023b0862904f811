"""Build and load the port's CUDA kernels (plain C interface, ctypes).

Each `csrc/<name>.cu` compiles with `nvcc` for `sm_90a` into its own shared
library. All sources build at once, one `nvcc` process each started together,
at the first kernel call of the process, into `_kernel_build/<hash>/` inside
the package (listed in `.gitignore`); the hash covers every source, header and
flag, so an edited source rebuilds and an unchanged one is reused.

Nothing here runs at import time: this module imports on a machine without
`nvcc` or a GPU, and only a kernel launch on a CUDA tensor reaches `load`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence, Tuple

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_kernel_build"
KERNEL_SOURCES = ("fused_bias_act", "fused_blur", "segmented_cc")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# Loaded libraries, one per source, and their resolved C entries. A shared
# library is loaded once per process, so these caches are process-wide by
# nature.
_LIBS: Dict[str, ctypes.CDLL] = {}
_ENTRIES: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc",
        Path("/usr/local/cuda/bin/nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (looked at $CUDA_HOME/bin, /usr/local/cuda/bin, PATH): "
        "the CUDA kernels of synthesis_in_style_tpu_torch cannot be built"
    )


def source_digest() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_all() -> Dict[str, Path]:
    """Compile every kernel library that is not built yet, in parallel.
    Returns {name: path of the .so}. Raises with nvcc's output on failure."""
    out_dir = BUILD_ROOT / source_digest()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {name: out_dir / f"lib{name}.so" for name in KERNEL_SOURCES}
    todo = [name for name, p in paths.items() if not p.exists()]
    if not todo:
        return paths
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
        )
    failures = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        (out_dir / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, paths[name])
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return paths


def load(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry `symbol` of kernel library `name`, with its argument
    types declared (every entry returns a cudaError_t as int). Resolved once
    per process: later calls are one dictionary lookup, no lock."""
    fn = _ENTRIES.get((name, symbol))
    if fn is not None:
        return fn
    with _LOCK:
        if name not in _LIBS:
            for lib_name, path in build_all().items():
                if lib_name not in _LIBS:
                    _LIBS[lib_name] = ctypes.CDLL(str(path))
        fn = getattr(_LIBS[name], symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _ENTRIES[(name, symbol)] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (refused or failed launch)."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed: cudaError_t {err}")
