"""Relative FID across a training run's checkpoints with one fixed
embedding (counterpart of synthesis_in_style_tpu/scripts/fid_trend.py).

Without calibrated InceptionV3 weights FID runs on the seeded random VGG16
of `evaluation/fid.py`: its numbers are relative distances, not FID. With
the same embedding, the same real images and the same z stream for every
checkpoint, FID(trained late) < FID(trained early) < FID(random init) is a
reproducible trend.

  python -m synthesis_in_style_tpu_torch.scripts.fid_trend \\
      <run>/checkpoints --images <pages_dir_or_json> \\
      [--num-samples 256] [--batch 16] [--json out.json] [--skip-init] [-d cuda|cpu]

Writes {"image_size", "num_samples", "embedding", "checkpoints": {"init":
F, "iter_...": F, ...}}: `init` is the config's generator from the port's
seeded init (torch.Generator seeded 0), then every `iter_*` snapshot in
name order.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("checkpoints_dir",
                        help="a run's checkpoints/ dir holding iter_* snapshots")
    parser.add_argument("--images", required=True, help="real page dir (PNGs) or files.json")
    parser.add_argument("--num-samples", type=int, default=256)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--json", default=None)
    parser.add_argument("--skip-init", action="store_true")
    parser.add_argument("-d", "--device", default="cuda",
                        help="torch device to evaluate on (default cuda)")
    return parser


def main(argv=None, report: Optional[dict] = None) -> int:
    """With `report`, each checkpoint's seconds go under
    `report["seconds"]`."""
    args = build_parser().parse_args(argv)

    from PIL import Image

    from synthesis_in_style_tpu_torch.core.config import load_config_from_checkpoint
    from synthesis_in_style_tpu_torch.evaluation.fid import GenerativeFID
    from synthesis_in_style_tpu_torch.models.factory import get_generator, load_generator

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available")
    ckpt_dir = Path(args.checkpoints_dir)
    snapshots = sorted(p for p in ckpt_dir.glob("iter_*") if not p.name.endswith(".tmp"))
    assert snapshots, f"no iter_* snapshots under {ckpt_dir}"
    config = load_config_from_checkpoint(snapshots[-1], None)
    size = config["image_size"]

    image_dir = Path(args.images)
    if image_dir.suffix == ".json":
        entries = json.loads(image_dir.read_text())
        paths = [image_dir.parent / (e["file_name"] if isinstance(e, dict) else e)
                 for e in entries]
    else:
        paths = sorted(image_dir.glob("*.png"))
    paths = paths[: args.num_samples]

    class RealLoader:
        """One pass over the real images, {"images": (B, size, size, 3)}."""

        def __iter__(self):
            for i in range(0, len(paths), args.batch):
                imgs = [np.asarray(Image.open(p).convert("RGB").resize((size, size))
                                   ).astype(np.float32) / 127.5 - 1.0
                        for p in paths[i: i + args.batch]]
                yield {"images": np.stack(imgs)}

    # one embedding for every checkpoint: the trend needs fixed features
    # and fixed real statistics
    fid = GenerativeFID(num_samples=args.num_samples, latent_size=config.get("latent_size", 512),
                        batch_size=args.batch, seed=42, batch_image_key="images", device=device)
    results = {}

    def evaluate(tag: str, gen) -> None:
        start = time.perf_counter()

        @torch.no_grad()
        def model_fn(z: torch.Tensor) -> torch.Tensor:
            img, _ = gen([z], randomize_noise=False)
            return img.clamp(-1.0, 1.0)

        score = fid(model_fn, RealLoader())
        results[tag] = float(score)
        seconds = time.perf_counter() - start
        if report is not None:
            report.setdefault("seconds", {})[tag] = seconds
        print(f"{tag}: relative FID {score:.3f} ({seconds:.2f} s)", flush=True)

    if not args.skip_init:  # random-init baseline: the same architecture, a pinned seed
        gen = get_generator(config).init_weights(torch.Generator().manual_seed(0))
        evaluate("init", gen.to(device).eval())
    for snap in snapshots:
        evaluate(snap.stem, load_generator(snap, config, device))

    out = {"image_size": size, "num_samples": args.num_samples,
           "embedding": "pinned-seed pooled VGG (relative, uncalibrated)",
           "checkpoints": results}
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=2))
        print("wrote", args.json, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
