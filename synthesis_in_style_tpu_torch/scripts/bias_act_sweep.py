"""Sweep the fused bias-act forward kernel's launch geometry on one GPU.

  python -m synthesis_in_style_tpu_torch.scripts.bias_act_sweep [--out PATH]

Builds csrc/fused_bias_act.cu once for every (threads per block, unroll)
pair (`-DSIS_BIAS_ACT_THREADS`, `-DSIS_BIAS_ACT_UNROLL`; one nvcc process per
pair, all started together), then, for each dtype and shape, holds every
build against the plain version and times its C entry directly (CUDA events
over back-to-back launches, no wrapper) at each grid size of
`--blocks-per-sm`, `--repeat` times in turn; a row's `ms` is the median.
Beside them, in the same turns, `copy_ms`: a device copy of x into another
tensor (`Tensor.copy_`), the same bytes read and written, as a yardstick
of the rate the card reaches for such a stream.
Prints one line per geometry and the fastest geometry per (dtype, shape);
with --out, writes every row and each build's register count as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import subprocess
import sys
from pathlib import Path

import torch

from synthesis_in_style_tpu_torch.ops.cuda import build
from synthesis_in_style_tpu_torch.ops.cuda.fused_bias_act import (
    _FWD_ARGTYPES,
    DTYPE_CODES,
    bias_act_geometry,
    fused_leaky_relu_plain,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
SHAPES = ((16, 256, 256, 128), (16, 64, 64, 512), (16, 512))


def build_variants(threads, unrolls):
    """({(threads, unroll): ctypes entry}, {(threads, unroll): ptxas lines}),
    one shared library each."""
    out_dir = build.BUILD_ROOT / "sweep" / build.source_digest()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build.nvcc_path()
    procs = {}
    for t, u in itertools.product(threads, unrolls):
        lib = out_dir / f"libfused_bias_act_t{t}_u{u}.so"
        cmd = [nvcc, *build.NVCC_FLAGS, f"-DSIS_BIAS_ACT_THREADS={t}",
               f"-DSIS_BIAS_ACT_UNROLL={u}", "-o", str(lib),
               str(build.CSRC / "fused_bias_act.cu")]
        procs[t, u] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    entries, ptxas = {}, {}
    for key, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc threads={key[0]} unroll={key[1]} failed:\n{log}")
        regs = [line.strip() for line in log.splitlines() if "registers" in line]
        print(f"built threads={key[0]} unroll={key[1]}: {regs}", flush=True)
        ptxas[key] = regs
        fn = getattr(ctypes.CDLL(str(lib)), "sis_bias_act_fwd")
        fn.argtypes = _FWD_ARGTYPES
        fn.restype = ctypes.c_int
        entries[key] = fn
    return entries, ptxas


def time_ms(launch, iters: int) -> float:
    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--threads", type=int, nargs="+", default=[128, 256, 512, 1024])
    parser.add_argument("--unroll", type=int, nargs="+", default=[1, 2, 4, 8])
    parser.add_argument("--blocks-per-sm", type=int, nargs="+", default=[1, 2, 4, 8, 16])
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--repeat", type=int, default=1)
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("bias_act_sweep: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    entries, ptxas = build_variants(args.threads, args.unroll)
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device="cuda").manual_seed(0)
    rows, best = [], {}
    for dtype, shape in itertools.product((torch.bfloat16, torch.float32), SHAPES):
        x = torch.randn(shape, generator=g, device="cuda").to(dtype)
        b = torch.randn(shape[-1], generator=g, device="cuda").to(dtype)
        y = torch.empty_like(x)
        ref = fused_leaky_relu_plain(x, b)
        c = shape[-1]
        bound_ms = (2 * x.numel() + c) * x.element_size() / HBM_BYTES_PER_S * 1e3
        iters = args.iters if x.numel() >= 1 << 22 else 20 * args.iters
        name = str(dtype).split(".")[-1]
        launches = {}
        for (t, u), fn in entries.items():
            for bps in args.blocks_per_sm:
                geo = bias_act_geometry(x.numel(), c, x.element_size(), x.data_ptr(),
                                        y.data_ptr(), threads=t, blocks_per_sm=bps)

                def launch(fn=fn, geo=geo):
                    err = fn(x.data_ptr(), b.data_ptr(), y.data_ptr(), x.numel(), c,
                             DTYPE_CODES[dtype], 0.2, 2**0.5, *geo, stream)
                    build.check(err, "sis_bias_act_fwd")

                y.fill_(float("nan"))
                launch()
                torch.cuda.synchronize()
                if not torch.equal(y, ref):
                    raise AssertionError(f"{name} {shape} threads={t} unroll={u} "
                                         f"blocks/SM={bps}: differs from the plain version")
                launches[t, u, bps] = (launch, geo)
        samples = {key: [] for key in launches}
        copies = []
        for _ in range(args.repeat):  # every geometry in turn, so drifts hit all alike
            copies.append(time_ms(lambda: y.copy_(x), iters))
            for key, (launch, _) in launches.items():
                samples[key].append(time_ms(launch, iters))
        copy_ms = sorted(copies)[len(copies) // 2]
        for (t, u, bps), times in samples.items():
            ms = sorted(times)[len(times) // 2]
            row = {"dtype": name, "shape": list(shape), "threads": t, "unroll": u,
                   "blocks_per_sm": bps, "geometry": list(launches[t, u, bps][1]), "ms": ms,
                   "ms_samples": times, "bound_ms": bound_ms, "over_bound": ms / bound_ms,
                   "copy_ms": copy_ms}
            rows.append(row)
            key = (name, tuple(shape))
            if key not in best or ms < best[key]["ms"]:
                best[key] = row
            print(json.dumps(row), flush=True)
    for (name, shape), row in best.items():
        print(f"fastest {name} {shape}: threads {row['threads']} unroll {row['unroll']} "
              f"blocks/SM {row['blocks_per_sm']}: {row['ms']:.4f} ms, "
              f"{row['over_bound']:.3f}x bound; copy of x {row['copy_ms']:.4f} ms", flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(
            {"card": card, "torch": torch.__version__, "rows": rows,
             "ptxas": {f"threads={t} unroll={u}": v for (t, u), v in ptxas.items()}},
            indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
