"""The float32 flash attention kernels' design steps, timed side by side on
one card.

  python3 -m synthesis_in_style_tpu_torch.scripts.flash_f32_variants [--json PATH]

Builds csrc/flash_attention.cu as shipped and as each variant below (a
textual patch of a copy of csrc/, one nvcc each, all started together),
then times the forward and the backward of every build at the TransUNet
shape (8, 12, 1024, 64) with CUDA events, in two rounds of turns, and
reports each one's largest error against the plain float32 version (TF32
off) relative to max|ref|. Variants:

  cvt_rna         hi rounded by the cvt.rna.tf32.f32 instruction
  lo_rounded      lo = x - hi rounded to TF32 too, before the mma reads it
  bwd_tile_32     backward tiles of 32 query rows / keys at d <= 64
  tf32_floor      lo = 0: the kernels' loads, splits and products with the
                  small products fed zeros; a timing floor of the structure,
                  not float32-accurate

Prints one JSON object (per variant: forward and backward ms of each round,
errors, and the forward kernel's most frequent SASS opcodes) and the card's
name and power limit. Needs nvcc and one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from synthesis_in_style_tpu_torch.ops.cuda import build
from synthesis_in_style_tpu_torch.ops.cuda import flash_attention as fa

SHAPE = (8, 12, 1024, 64)
TO_TF32 = "  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;"
LO = "  lo = __float_as_uint(x - __uint_as_float(hi));"
VARIANTS = {
    "shipped": (),
    "cvt_rna": (("hopper.cuh", TO_TF32, '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" : '
                 '"=r"(r) : "f"(x));\n  return r;'),),
    "lo_rounded": (("flash_attention_f32.cuh", LO,
                    "  lo = hopper::to_tf32(x - __uint_as_float(hi));"),),
    "bwd_tile_32": (("flash_attention_f32.cuh", "kBwdTile = DP <= 64 ? 64 : 32;",
                     "kBwdTile = 32;"),),
    "tf32_floor": (("flash_attention_f32.cuh", LO, "  lo = 0u;"),),
}


def build_variants(root: Path) -> dict:
    """{variant: path of its library}, compiled in parallel."""
    procs = {}
    for name, patches in VARIANTS.items():
        src = root / name
        shutil.copytree(build.CSRC, src)
        for file, old, new in patches:
            text = (src / file).read_text()
            if old not in text:
                raise SystemExit(f"{name}: {file} no longer holds {old!r}")
            (src / file).write_text(text.replace(old, new))
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(src / "lib.so"),
               str(src / "flash_attention.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc {name} failed:\n{log[-4000:]}")
    return {name: root / name / "lib.so" for name in VARIANTS}


def sass_ops(lib: Path, kernel: str = "flash_fwd_split_kernelILi64", top: int = 10) -> dict:
    """The most frequent opcodes in one kernel's SASS (cuobjdump beside nvcc)."""
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                         check=True).stdout
    for block in out.split("Function : ")[1:]:
        if kernel in block.splitlines()[0]:
            counts = {}
            for op in re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", block):
                counts[op] = counts.get(op, 0) + 1
            return dict(sorted(counts.items(), key=lambda kv: -kv[1])[:top])
    return {}


def event_ms(fn, iters: int = 30) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", type=Path, default=None, help="also write the result here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_f32_variants: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    root = Path(tempfile.mkdtemp(prefix="flash_f32_variants_"))
    try:
        libs = build_variants(root)
        b, h, n, d = SHAPE
        g = torch.Generator(device="cuda").manual_seed(13)
        q, k, v, do = (torch.randn(SHAPE, generator=g, device="cuda") for _ in range(4))
        scale = d ** -0.5
        ref_o, ref_lse = fa.flash_attention_fwd_plain(q, k, v, scale)
        ref_grads = fa.flash_attention_bwd_plain(q, k, v, ref_o, ref_lse, do, scale)
        o, dq, dk, dv = (torch.empty_like(q) for _ in range(4))
        lse, delta = (torch.empty((b, h, n), device="cuda") for _ in range(2))
        stream = torch.cuda.current_stream().cuda_stream
        result = {name: {"fwd_ms": [], "bwd_ms": []} for name in libs}
        for _ in range(2):
            for name, path in libs.items():
                lib = ctypes.CDLL(str(path))
                fwd_fn, bwd_fn = lib.sis_flash_attention_fwd, lib.sis_flash_attention_bwd
                fwd_fn.argtypes, bwd_fn.argtypes = fa._FWD_ARGTYPES, fa._BWD_ARGTYPES

                def fwd():
                    build.check(fwd_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                       lse.data_ptr(), b * h, n, d, scale, 0, stream), name)

                def bwd():
                    build.check(bwd_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                       ref_o.data_ptr(), ref_lse.data_ptr(), do.data_ptr(),
                                       delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                                       dv.data_ptr(), b * h, n, d, scale, 0, stream), name)

                result[name]["fwd_ms"].append(event_ms(fwd))
                result[name]["bwd_ms"].append(event_ms(bwd))
                result[name]["fwd_err"] = ((o - ref_o).abs().max() / ref_o.abs().max()).item()
                result[name]["bwd_err"] = max(((x - r).abs().max() / r.abs().max()).item()
                                              for x, r in zip((dq, dk, dv), ref_grads))
        for name, path in libs.items():
            result[name]["fwd_sass_ops"] = sass_ops(path)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    out = {"shape": list(SHAPE), "card": card, "variants": result}
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    print(card)


if __name__ == "__main__":
    main()
