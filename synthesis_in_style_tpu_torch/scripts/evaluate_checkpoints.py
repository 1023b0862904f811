"""Evaluate generator and autoencoder checkpoints with PSNR / SSIM and FID
over one or more datasets (counterpart of
synthesis_in_style_tpu/scripts/evaluate_checkpoints.py): one result JSON
per (checkpoint, dataset, evaluation) under `--evaluation-root`, and a
combination already evaluated is skipped before anything is loaded.

  python -m synthesis_in_style_tpu_torch.scripts.evaluate_checkpoints \\
      checkpoints.txt datasets.json [--skip-fid] [--skip-reconstruction] \\
      [-b 8] [--num-fid-samples 1000] [-d cuda|cpu]

`checkpoints.txt` lists one checkpoint a line (a `.pt` of the port or of
the reference, or a JAX `save_pytree_npz` `.npz`); `datasets.json` is
`[{"name": ..., "images": <val.json>}, ...]`.

- Reconstruction: PSNR and SSIM of an autoencoder checkpoint's
  reconstructions of the dataset's images (`load_autoencoder_or_generator`),
  one image at a time at any `-b`, averaged over the images. A generator
  checkpoint records `{"skipped": ...}`.
- FID: the checkpoint's `g_ema` (an autoencoder snapshot's decoder) with
  its stored noise against the dataset's images (`GenerativeFID`, z from a
  CPU generator seeded 42). A JAX `.npz` without a `g_ema` tree (an
  autoencoder that only decoded w+ has no mapping network to sample z
  with) records `{"skipped": ...}`; a checkpoint that holds one but does
  not load fails.

A combination that raises is reported in the closing FAILED list and does
not stop the sweep.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from synthesis_in_style_tpu_torch.core.config import load_config_from_checkpoint
from synthesis_in_style_tpu_torch.data.loader import make_loader, shutdown_workers
from synthesis_in_style_tpu_torch.evaluation.fid import GenerativeFID
from synthesis_in_style_tpu_torch.evaluation.psnr_ssim import PSNRSSIMEvaluator
from synthesis_in_style_tpu_torch.models.factory import (
    load_autoencoder_or_generator,
    load_generator,
)

EVAL_TYPES = ("reconstruction", "fid")


def save_eval_result(result: dict, eval_type: str, dest_dir: Path, dataset_name: str,
                     checkpoint_name: str) -> None:
    dest = Path(dest_dir) / dataset_name / f"{checkpoint_name}_{eval_type}.json"
    dest.parent.mkdir(parents=True, exist_ok=True)
    with dest.open("w") as f:
        json.dump(result, f, indent=2)


def has_not_been_evaluated(checkpoint_name: str, dataset_name: str,
                           evaluation_root: Path) -> Dict[str, bool]:
    return {eval_type: not (Path(evaluation_root) / dataset_name
                            / f"{checkpoint_name}_{eval_type}.json").exists()
            for eval_type in EVAL_TYPES}


@torch.no_grad()
def reconstruction_scores(model, loader, device: torch.device) -> dict:
    """Mean PSNR and SSIM of the model's reconstructions, image by image;
    a model without `encode` (a generator) is skipped. Batch i's noise
    draws, where the composition makes any, come from a torch.Generator
    seeded i."""
    if not hasattr(model, "encode"):
        return {"skipped": "generator-only checkpoint has no reconstruction path"}
    evaluator = PSNRSSIMEvaluator()
    psnrs, ssims = [], []
    for i, batch in enumerate(loader):
        images = torch.as_tensor(batch["images"]).to(device)
        recon = model(images, generator=torch.Generator(device=device).manual_seed(i))
        for got, want in zip(recon, images):
            p, s = evaluator.psnr_and_ssim(got[None], want[None])
            psnrs.append(p)
            ssims.append(s)
    return {"psnr": torch.stack(psnrs).double().mean().item(),
            "ssim": torch.stack(ssims).double().mean().item()}


def holds_g_ema(checkpoint: str) -> bool:
    """False for a JAX `save_pytree_npz` `.npz` with neither a `g_ema` nor
    a bare `params` tree (an autoencoder's alone); True for every other
    checkpoint, which goes to `load_generator` and raises there if it
    cannot be read."""
    path = Path(checkpoint)
    if path.suffix != ".npz":
        return True
    with np.load(str(path)) as data:
        return any(name.split("/", 1)[0] in ("g_ema", "params") for name in data.files)


def fid_score(checkpoint: str, config: dict, loader, val_json: Path, args,
              device: torch.device) -> dict:
    if not holds_g_ema(checkpoint):
        return {"skipped": "the checkpoint holds no g_ema generator"}
    gen = load_generator(checkpoint, config, device)
    fid = GenerativeFID(latent_size=gen.style_dim, batch_size=args.batch_size,
                        num_samples=args.num_fid_samples, batch_image_key="images",
                        device=device)

    @torch.no_grad()
    def sample(z: torch.Tensor) -> torch.Tensor:
        images, _ = gen([z], randomize_noise=False)
        return images

    return {"fid": fid(sample, loader, dataset_path=val_json)}


def evaluate_checkpoint(checkpoint: str, dataset: dict, args) -> Dict[str, float]:
    """Evaluate one combination; returns the seconds of each evaluation run
    (none where everything was evaluated already)."""
    checkpoint_name = Path(checkpoint).stem
    dataset_name = dataset["name"]
    evaluation_root = Path(args.evaluation_root)
    todo = has_not_been_evaluated(checkpoint_name, dataset_name, evaluation_root)
    todo = {"reconstruction": args.reconstruction and todo["reconstruction"],
            "fid": args.fid and todo["fid"]}
    if not any(todo.values()):
        return {}  # skip before loading anything

    from synthesis_in_style_tpu_torch.cli.train_stylegan_2 import GANImageDataset

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available")
    config = load_config_from_checkpoint(checkpoint, args.original_config_path)
    config.setdefault("batch_size", args.batch_size)
    val_json = Path(dataset["images"])
    data = GANImageDataset(val_json, root=val_json.parent, image_size=config["image_size"],
                           num_channels=config.get("input_dim", 3))
    loader = make_loader(data, args.batch_size, shuffle=False, drop_last=False, num_workers=2)
    seconds = {}
    try:
        if todo["reconstruction"]:
            start = time.perf_counter()
            model = load_autoencoder_or_generator(checkpoint, config, device)
            result = reconstruction_scores(model, loader, device)
            del model
            save_eval_result(result, "reconstruction", evaluation_root, dataset_name,
                             checkpoint_name)
            seconds["reconstruction"] = time.perf_counter() - start
        if todo["fid"]:
            start = time.perf_counter()
            result = fid_score(checkpoint, config, loader, val_json, args, device)
            save_eval_result(result, "fid", evaluation_root, dataset_name, checkpoint_name)
            seconds["fid"] = time.perf_counter() - start
    finally:
        shutdown_workers(loader)
    return seconds


def main(args: argparse.Namespace, report: Optional[dict] = None) -> list:
    """Every checkpoint on every dataset; returns the failed combinations
    as (checkpoint, dataset name, error). With `report`, each combination's
    seconds by evaluation go under `report["seconds"]`."""
    with open(args.checkpoint_list) as f:
        checkpoints = [line.strip() for line in f if line.strip()]
    with open(args.dataset_file) as f:
        datasets = json.load(f)
    failed = []
    for checkpoint in checkpoints:
        for dataset in datasets:
            print(f"evaluating {checkpoint} on {dataset['name']}")
            try:
                seconds = evaluate_checkpoint(checkpoint, dataset, args)
            except Exception as e:  # noqa: BLE001 - one bad combination must not stop the sweep
                print(f"  FAILED: {e}")
                failed.append((checkpoint, dataset["name"], str(e)))
                continue
            if report is not None:
                report.setdefault("seconds", []).append(
                    {"checkpoint": checkpoint, "dataset": dataset["name"], **seconds})
    if failed:
        print("failed combinations:")
        for checkpoint, name, err in failed:
            print(f"  {checkpoint} on {name}: {err}")
    return failed


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Evaluate trained checkpoints with PSNR/SSIM and FID")
    parser.add_argument("checkpoint_list", help="file with one checkpoint path per line")
    parser.add_argument("dataset_file", help='json: [{"name": ..., "images": val.json}, ...]')
    parser.add_argument("--skip-fid", dest="fid", action="store_false", default=True)
    parser.add_argument("--skip-reconstruction", dest="reconstruction", action="store_false",
                        default=True)
    parser.add_argument("--evaluation-root", default="evaluation_results")
    parser.add_argument("-op", "--original-config-path", type=Path, default=None)
    parser.add_argument("-b", "--batch-size", type=int, default=8)
    parser.add_argument("--num-fid-samples", type=int, default=1000)
    parser.add_argument("-d", "--device", default="cuda",
                        help="torch device to evaluate on (default cuda)")
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
