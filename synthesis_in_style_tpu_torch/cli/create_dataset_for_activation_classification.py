"""Create a DatasetGAN training set (counterpart of
synthesis_in_style_tpu/cli/create_dataset_for_activation_classification.py):
generated images to hand-label, with their latent codes and / or
activations.

The same flags and files as the JAX CLI, plus `-d/--device` (default cuda):
`generated_image_<id>.png`, with `-ge` an empty (black) label image
`generated_image_label_<id>.png` beside each, `full_data.json` /
`train.json` / `test.json` (an 80/20 split of {"image", "label", "latent",
"activations"} entries) and `tensors.npz` with `latent_codes` (N, D) and
`activations`, an object array of per-image {str(layer): (h, w, C)} dicts.
The generator runs with its stored noise, truncation 0.7 with --truncate;
z comes from a torch.Generator seeded with --seed (the JAX package's stream
differs).

Usage:
  python -m synthesis_in_style_tpu_torch.cli.create_dataset_for_activation_classification \\
      <checkpoint> <image_save_dir> -n 30 --save-latents --save-activations -ge [-d cuda]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from synthesis_in_style_tpu_torch.core.config import load_config_from_checkpoint
from synthesis_in_style_tpu_torch.models.factory import load_generator
from synthesis_in_style_tpu_torch.utils.dataset_creation import (
    build_latent_and_noise_generator,
    compute_mean_latent,
    make_generate_fn,
    make_image,
)
from synthesis_in_style_tpu_torch.utils.png import write_png


def main(args: argparse.Namespace) -> None:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available")
    config = load_config_from_checkpoint(args.checkpoint, args.original_config_path)
    config["batch_size"] = args.batch_size
    image_save_base_dir = Path(args.image_save_dir)
    image_save_base_dir.mkdir(parents=True, exist_ok=True)

    gen = load_generator(args.checkpoint, config, device=device)
    mean_latent = compute_mean_latent(gen) if args.truncate else None
    generate = make_generate_fn(gen, truncation_latent=mean_latent)
    latent_stream = build_latent_and_noise_generator(config, seed=args.seed, device=device)

    data, latent_codes, save_activations = [], [], []
    generated = 0
    while generated < args.num_images:
        z = next(latent_stream)
        activations, images = generate(z)
        images = make_image(images)
        activations = {k: v.cpu().numpy() for k, v in activations.items()}
        z = z.cpu().numpy()
        for idx in range(len(images)):
            image_name = f"generated_image_{generated:03d}.png"
            write_png(image_save_base_dir / image_name, images[idx])
            label_name = f"generated_image_label_{generated:03d}.png"
            if args.generate_empty_label_images:
                write_png(image_save_base_dir / label_name, np.zeros_like(images[idx]))
            item = {"image": image_name, "label": label_name}
            if args.save_activations:
                save_activations.append({str(k): v[idx] for k, v in activations.items()})
                item["activations"] = len(save_activations) - 1
            if args.save_latents:
                latent_codes.append(z[idx])
                item["latent"] = len(latent_codes) - 1
            data.append(item)
            generated += 1
            if generated >= args.num_images:
                break
        print(f"\r{generated}/{args.num_images}", end="", flush=True)
    print()

    with (image_save_base_dir / "full_data.json").open("w") as f:
        json.dump(data, f)
    split_index = int(len(data) * 0.8)
    with (image_save_base_dir / "train.json").open("w") as f:
        json.dump(data[:split_index], f)
    with (image_save_base_dir / "test.json").open("w") as f:
        json.dump(data[split_index:], f)
    np.savez_compressed(image_save_base_dir / "tensors",
                        latent_codes=np.asarray(latent_codes),
                        activations=np.asarray(save_activations, dtype=object))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Creates a dataset based on StyleGAN, which can be used to train a "
        "DatasetGAN-like classifier")
    parser.add_argument("checkpoint")
    parser.add_argument("image_save_dir", type=Path)
    parser.add_argument("-op", "--original-config-path", type=Path, default=None)
    parser.add_argument("-n", "--num-images", type=int, default=100)
    parser.add_argument("-s", "--save-to", default=None)
    parser.add_argument("-b", "--batch-size", default=10, type=int)
    parser.add_argument("--debug", action="store_true", default=False)
    parser.add_argument("--truncate", action="store_true", default=False)
    parser.add_argument("--save-latents", action="store_true", default=False)
    parser.add_argument("--save-activations", action="store_true", default=False)
    parser.add_argument("-ge", "--generate-empty-label-images", action="store_true",
                        default=False)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("-d", "--device", default="cuda",
                        help="torch device to generate on (default cuda)")
    return parser


if __name__ == "__main__":
    parsed = build_parser().parse_args()
    if not (parsed.save_activations or parsed.save_latents):
        print("Neither --save-latents nor save-activations have been used. Thus, the "
              "resulting npz file will likely be empty.")
    main(parsed)
