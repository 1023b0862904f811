"""Sustained labelled-synthesis run (counterpart of
synthesis_in_style_tpu/scripts/sustained_synthesis.py).

Runs the port's dataset CLI (`cli.create_dataset_for_segmentation`, on the
card unless its `-d` says otherwise) for N images as a subprocess and
samples, every `--interval` seconds, the PNG pairs written, the CLI's host
RSS and its open file handles (from /proc) into a JSONL series: what a short
benchmark cannot show (memory or handle growth, writer backpressure, the
steady rate against a warm burst). Records have the JAX script's keys:
`t`, `pairs_written`, `window_pairs_per_s`, `rss_mb`, `fds`.

    python -m synthesis_in_style_tpu_torch.scripts.sustained_synthesis \\
        <checkpoint> <creation_config.json> -n 50000 [--monitor-out m.jsonl] \\
        [-- <more CLI arguments>]

Pairs already in the image directory (`generated_images` beside the
checkpoint's run) are counted first and the series reports deltas.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional, Tuple

CLI_MODULE = "synthesis_in_style_tpu_torch.cli.create_dataset_for_segmentation"


def count_outputs(image_dir: Path) -> int:
    """PNG pairs under the CLI's sharded layout (two directory levels)."""
    if not image_dir.exists():
        return 0
    n = 0
    for sub in image_dir.iterdir():
        if sub.is_dir():
            for sub2 in sub.iterdir():
                if sub2.is_dir():
                    n += sum(1 for f in sub2.iterdir() if f.suffix == ".png")
            n += sum(1 for f in sub.iterdir() if f.suffix == ".png")
    return n


def proc_stats(pid: int) -> Tuple[Optional[float], Optional[int]]:
    """(resident set in MiB, open file descriptors) of a live process."""
    try:
        rss_kb = 0
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    rss_kb = int(line.split()[1])
                    break
        return rss_kb / 1024.0, len(os.listdir(f"/proc/{pid}/fd"))
    except OSError:
        return None, None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("checkpoint")
    parser.add_argument("config")
    parser.add_argument("-n", "--num-images", type=int, default=50000)
    parser.add_argument("--interval", type=float, default=30.0)
    parser.add_argument("--monitor-out", default="sustained_monitor.jsonl")
    parser.add_argument("cli_args", nargs="*", default=[])
    # what follows `--` goes to the CLI as it is (split here: argparse
    # versions differ on a `--` after optional arguments)
    argv = list(sys.argv[1:] if argv is None else argv)
    passed = []
    if "--" in argv:
        split = argv.index("--")
        argv, passed = argv[:split], argv[split + 1:]
    args = parser.parse_args(argv)
    args.cli_args = [*args.cli_args, *passed]

    ckpt = Path(args.checkpoint)
    image_dir = ckpt.parent.parent / "generated_images"
    baseline = count_outputs(image_dir)
    if baseline:
        print(f"warning: {image_dir} already holds {baseline} pairs from a previous run; "
              "reporting deltas against that baseline", flush=True)
    cmd = [sys.executable, "-m", CLI_MODULE, str(ckpt), args.config,
           "-n", str(args.num_images), *args.cli_args]
    print("launching:", " ".join(cmd), flush=True)
    proc = subprocess.Popen(cmd)
    t0 = time.time()
    last_n, last_t = 0, t0
    try:
        with open(args.monitor_out, "a") as out:
            while proc.poll() is None:
                time.sleep(args.interval)
                now = time.time()
                n = count_outputs(image_dir) - baseline
                rss_mb, n_fds = proc_stats(proc.pid)
                row = {"t": round(now - t0, 1), "pairs_written": n,
                       "window_pairs_per_s": round((n - last_n) / max(1e-9, now - last_t), 3),
                       "rss_mb": rss_mb, "fds": n_fds}
                out.write(json.dumps(row) + "\n")
                out.flush()
                print(row, flush=True)
                last_n, last_t = n, now
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    dt = time.time() - t0
    n = count_outputs(image_dir) - baseline
    print(f"CLI exit {proc.returncode}; {n} pairs in {dt:.1f}s = {n / dt:.2f} pairs/s overall",
          flush=True)
    return proc.returncode or 0


if __name__ == "__main__":
    raise SystemExit(main())
