"""The DatasetGAN branch's three CLIs end to end on the CPU (`-d cpu`, a
32px generator of style 32 from the JAX package's init, in a reference-layout
`.pt` that both packages read), their files held against the JAX CLIs'.

* `create_dataset_for_activation_classification`: the JAX CLI's file
  names, manifests (80/20 split) and `tensors.npz` layout; the JAX
  package's `DatasetGANDataset` reads the port's `tensors.npz` into the
  same pixel activations as the port's.
* `train` with `network: PixelEnsemble`, `dataset: dataset_gan`, with
  `generate: true` and `false`, an epoch crossing forced by the batch size:
  losses, the dice evaluation and the learning rate logged, sample grids,
  snapshots with `network_<i>` / `optimizer_<i>` that the JAX
  `load_ensemble` reads into the same predictions; the generation dataset
  regenerated at the crossing; `--resume-ckpt` continues from a snapshot.
* `create_dataset_for_segmentation` with the shipped
  stylegan2_dataset_gan_bw_hwp_wpi.json and that snapshot: the JAX CLI's
  layout ([image|label] pairs, train.json / val.json, coco_gt.json).
* The shipped dataset_gan_wpi_*.yaml raise KeyError('num_classes') in both
  packages (they carry no num_classes).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from synthesis_in_style_tpu.cli import create_dataset_for_activation_classification as jax_cdac
from synthesis_in_style_tpu.cli import train as jax_train
from synthesis_in_style_tpu.data.dataset_gan_dataset import DatasetGANDataset as JaxDataset
from synthesis_in_style_tpu.evaluation.coco_gt import COCOGtCreator
from synthesis_in_style_tpu.models.stylegan2 import Generator as JaxGenerator
from synthesis_in_style_tpu.segmentation.dataset_gan_segmenter import (
    load_ensemble as jax_load_ensemble,
)
from synthesis_in_style_tpu_torch.cli import create_dataset_for_activation_classification as cdac
from synthesis_in_style_tpu_torch.cli import create_dataset_for_segmentation as cds
from synthesis_in_style_tpu_torch.cli import train
from synthesis_in_style_tpu_torch.data import dataset_gan_dataset as data
from synthesis_in_style_tpu_torch.segmentation.dataset_gan_segmenter import load_ensemble
from synthesis_in_style_tpu_torch.utils.checkpoint import generator_params_from_jax
from synthesis_in_style_tpu_torch.utils.png import read_png
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parents[1]
SIZE, STYLE = 32, 32
FEATURES = 512 * 8  # the 32px generator's eight layers
COLORS = {"background": "#000000", "printed_text": "#0000FF", "handwritten_text": "#FF0000"}
NUM_IMAGES = 5  # 4 train, 1 test
CKPT = "g_ema.pt"


def _paint_labels(directory: Path, entries, rng) -> None:
    """Seeded rectangles of the three class colours as hand labels."""
    palette = [(0, 0, 255), (255, 0, 0)]
    for entry in entries:
        label = np.zeros((SIZE, SIZE, 3), np.uint8)
        for color in palette:
            y, x = rng.integers(0, SIZE - 8, 2)
            h, w = rng.integers(4, 12, 2)
            label[y:y + h, x:x + w] = color
        Image.fromarray(label).save(directory / entry["label"])


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("dataset_gan_cli")
    gen = JaxGenerator(size=SIZE, style_dim=STYLE, n_mlp=2)
    variables = jax.jit(gen.init)({"params": jax.random.PRNGKey(0),
                                   "noise": jax.random.PRNGKey(1)}, [jnp.zeros((1, STYLE))])
    variables = jax.tree_util.tree_map(np.asarray, variables)
    run = root / "run"
    (run / "config").mkdir(parents=True)
    (run / "config" / "config.json").write_text(json.dumps(
        {"image_size": SIZE, "latent_size": STYLE, "n_mlp": 2, "stylegan_variant": 2,
         "batch_size": 4}))
    (run / "checkpoints").mkdir()
    torch.save({"g_ema": generator_params_from_jax(variables)}, run / "checkpoints" / CKPT)
    (root / "colors.json").write_text(json.dumps(COLORS))
    acts = root / "acts"
    cdac.main(cdac.build_parser().parse_args(
        [str(run / "checkpoints" / CKPT), str(acts), "-n", str(NUM_IMAGES), "-b", "3",
         "--save-latents", "--save-activations", "-ge", "-d", "cpu"]))
    _paint_labels(acts, json.loads((acts / "full_data.json").read_text()),
                  np.random.default_rng(0))
    return root


def _files(directory: Path):
    return sorted(p.name for p in directory.iterdir())


def test_activation_cli_matches_jax_layout(root):
    acts, jax_acts = root / "acts", root / "jax_acts"
    jax_cdac.main(jax_cdac.build_parser().parse_args(
        [str(root / "run" / "checkpoints" / CKPT), str(jax_acts), "-n",
         str(NUM_IMAGES), "-b", "3", "--save-latents", "--save-activations", "-ge"]))
    assert _files(acts) == _files(jax_acts)
    for name in ("full_data.json", "train.json", "test.json"):
        assert json.loads((acts / name).read_text()) == json.loads((jax_acts / name).read_text())
    assert len(json.loads((acts / "train.json").read_text())) == 4
    ours, ref = np.load(acts / "tensors.npz", allow_pickle=True), \
        np.load(jax_acts / "tensors.npz", allow_pickle=True)
    assert sorted(ours.files) == sorted(ref.files) == ["activations", "latent_codes"]
    assert ours["latent_codes"].shape == ref["latent_codes"].shape == (NUM_IMAGES, STYLE)
    assert ours["activations"].dtype == ref["activations"].dtype == object
    for a, b in zip(ours["activations"], ref["activations"]):
        assert {k: (v.shape, v.dtype) for k, v in a.items()} == \
            {k: (v.shape, v.dtype) for k, v in b.items()}
    image = read_png(acts / "generated_image_000.png")
    assert image.shape == (SIZE, SIZE, 3) and image.dtype == np.uint8
    # the JAX package's dataset reads the port's tensors.npz
    common = dict(json_path=acts / "train.json", tensor_path=acts / "tensors.npz",
                  class_to_color_map_path=root / "colors.json", image_size=SIZE)
    jax_ds, port_ds = JaxDataset(**common), data.DatasetGANDataset(device="cpu", **common)
    assert port_ds.pixel_activations.shape == (4, SIZE, SIZE, FEATURES)
    np.testing.assert_allclose(port_ds.pixel_activations.numpy(), jax_ds.pixel_activations,
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(port_ds.pixel_labels, jax_ds.pixel_labels)


def _train_config(root: Path, generate: bool, **extra) -> Path:
    config = {"network": "PixelEnsemble", "dataset": "dataset_gan", "num_classes": 3,
              "numpy_class": 3, "num_models": 2, "image_size": SIZE,
              # 4 images x 1024 pixels: 4 batches an epoch, a crossing at 4
              "batch_size": 1024, "tensor_path": str(root / "acts" / "tensors.npz"),
              "generate": generate, "checkpoint": str(root / "run" / "checkpoints" / CKPT),
              "upsample_mode": "bilinear", "class_probability": [0.34, 0.33, 0.33],
              "random_sampling": True, "lr": 1e-3, "end_lr": 1e-6, "weight_decay": 1e-4,
              "beta1": 0.5, "max_iter": 6, "snapshot_save_iter": 3, "image_save_iter": 3,
              "log_iter": 1, "display_size": 2, "epochs": 3, "num_workers": 0, **extra}
    path = root / f"train_{generate}_{len(extra)}.yaml"
    path.write_text(yaml.dump(config))
    return path


def _train(root: Path, config: Path, log_dir: Path, *extra):
    args = train.build_parser().parse_args(
        [str(config), "--images", str(root / "acts" / "train.json"), "--val-images",
         str(root / "acts" / "test.json"), "--class-to-color-map", str(root / "colors.json"),
         "-d", "cpu", *extra])
    args.log_dir = str(log_dir)
    return train.main(args)


@pytest.fixture(scope="module")
def trained(root):
    resets = []
    original = data.DatasetGANGenerationDataset.reset_dataset

    def counted(self):
        resets.append(self.json_path.name)
        original(self)

    data.DatasetGANGenerationDataset.reset_dataset = counted
    try:
        runs = {generate: _train(root, _train_config(root, generate), root / f"logs_{generate}")
                for generate in (True, False)}
    finally:
        data.DatasetGANGenerationDataset.reset_dataset = original
    return runs, resets


@pytest.mark.parametrize("generate", [True, False])
def test_train_cli_trains_the_ensemble(root, trained, generate):
    runs, resets = trained
    trainer, log_dir = runs[generate], root / f"logs_{generate}"
    assert trainer.updater.iteration == 6
    lines = [json.loads(line) for line in (log_dir / "log.jsonl").read_text().splitlines()]
    keys = set().union(*lines)
    assert {"loss/CrossEntropyLoss_network_0", "loss/CrossEntropyLoss_network_1", "lr/main",
            "evaluation/Dice Score"} <= keys
    dice = [line["evaluation/Dice Score"] for line in lines if "evaluation/Dice Score" in line]
    assert len(dice) == 2 and all(0.0 <= d <= 1.0 for d in dice)  # the crossing, the end
    assert all(np.isfinite(line["loss/CrossEntropyLoss_network_0"]) for line in lines
               if "loss/CrossEntropyLoss_network_0" in line)
    assert _files(log_dir / "images") == ["iter_00000003.png", "iter_00000006.png"]
    grid = read_png(log_dir / "images" / "iter_00000003.png")
    assert grid.shape == (2 * SIZE, 3 * SIZE, 3)
    if generate:  # at construction (train, test), then at the crossing (train)
        assert resets == ["train.json", "test.json", "train.json"]
    snapshot = log_dir / "checkpoints" / "iter_00000006.pt"
    snap = torch.load(snapshot, weights_only=True)
    assert sorted(snap) == ["iteration", "network_0", "network_1", "optimizer_0", "optimizer_1"]
    assert int(snap["iteration"]) == 6 and "layers.6.weight" in snap["network_1"]
    # the JAX package reads the snapshot into the same ensemble
    x = np.random.default_rng(1).normal(size=(64, FEATURES)).astype(np.float32)
    ours = load_ensemble(snapshot, 3, "cpu")
    with torch.no_grad():
        got = ours(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax_load_ensemble(snapshot, 3).forward_all(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_train_cli_resumes(root, trained):
    """--resume-ckpt starts at the snapshot's iteration with its members and
    optimizer states (the pixel stream restarts, as in the JAX package)."""
    log_dir = root / "logs_resumed"
    snapshot = root / "logs_False" / "checkpoints" / "iter_00000003.pt"
    trainer = _train(root, _train_config(root, False, max_iter=4), log_dir,
                     "--resume-ckpt", str(snapshot))
    assert trainer.updater.iteration == 4
    steps = {int(s["step"]) for s in trainer.updater.optimizer.adam.state_dict()["state"].values()}
    assert steps == {4}
    assert (log_dir / "checkpoints" / "iter_00000004.pt").exists()


def test_dataset_cli_with_the_ensemble(root, trained):
    snapshot = root / "logs_True" / "checkpoints" / "iter_00000006.pt"
    creation = REPO / "configs" / "dataset_creation" / "stylegan2_dataset_gan_bw_hwp_wpi.json"
    out = root / "synth"
    cds.main(cds.build_parser().parse_args(
        [str(root / "run" / "checkpoints" / CKPT), str(creation), "-n", "5", "-b", "2",
         "--classifier-path", str(snapshot), "-s", str(out), "-d", "cpu"]))
    pngs = sorted(out.glob("**/*.png"))
    assert len(pngs) == 6  # three batches of 2, none dropped
    assert pngs[0].relative_to(out).parts[:2] == ("0", "0")
    allowed = {(0, 0, 0), (0, 0, 255), (255, 0, 0)}
    for png in pngs:
        pair = read_png(png)
        assert pair.shape == (SIZE, 2 * SIZE, 3)
        assert {tuple(c) for c in np.unique(pair[:, SIZE:].reshape(-1, 3), axis=0)} <= allowed
    train_json = json.loads((out / "train.json").read_text())
    val = json.loads((out / "val.json").read_text())
    assert len(train_json) == 5 and len(val) == 1
    assert set(val[0]) == {"file_name", "has_printed_text", "has_handwritten_text"}
    # the JAX package's ground truth of the same validation image
    ref = COCOGtCreator(COLORS, image_root=out).create_coco_gt_from_image_paths(
        [out / val[0]["file_name"]])
    ours, ref = json.loads((out / "coco_gt.json").read_text()), json.loads(json.dumps(ref))
    for image in ours["images"] + ref["images"]:
        image.pop("date_captured")  # the time of writing
    assert ours == ref and ours["annotations"]


@pytest.mark.parametrize("name", ["dataset_gan_wpi_stylegan2.yaml", "dataset_gan_wpi_swagan.yaml"])
def test_shipped_configs_raise_on_num_classes(root, name):
    """The shipped configs carry no num_classes: both CLIs raise KeyError in
    their config check, before any dataset is read."""
    config = REPO / "configs" / "dataset_creation" / name
    argv = [str(config), "--images", str(root / "acts" / "train.json"),
            "--class-to-color-map", str(root / "colors.json")]
    args = train.build_parser().parse_args(argv + ["-d", "cpu"])
    args.log_dir = str(root / "never")
    with pytest.raises(KeyError, match="num_classes"):
        train.main(args)
    jax_args = jax_train.build_parser().parse_args(argv)
    jax_args.log_dir = str(root / "never_jax")
    with pytest.raises(KeyError, match="num_classes"):
        jax_train.main(jax_args)
