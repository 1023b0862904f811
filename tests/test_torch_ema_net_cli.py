"""The port's segmenter CLIs with an EMANet end to end on the CPU (`-d cpu`,
a tiny dataset, the shipped configs/segmenter/swagan_ema_net_segmenter.yaml:
ResNet-50 at output stride 8, bfloat16, cut to 64px, batch 2 and 2
iterations). `train` writes log, config and a snapshot with the three-group
SGD state and the moved µ bases; `analyze_image_segments` loads the
snapshot through the builder and sweeps two pages with the device
component filter, unfused, fused (a page a program) and in bfloat16; the
snapshot's µ is the one the pages run on (the JAX package's page path drops
it, see tests/test_torch_ema_net.py)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from synthesis_in_style_tpu_torch.cli import analyze_image_segments as analyze
from synthesis_in_style_tpu_torch.cli import train
from synthesis_in_style_tpu_torch.models.ema_net import EMANet
from synthesis_in_style_tpu_torch.segmentation.analysis_segmenter import AnalysisSegmenter
from synthesis_in_style_tpu_torch.utils.checkpoint import load_segmenter_snapshot
from test_torch_segmenter_cli import COLORS, _assert_results_match, _page
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parents[1]
SHIPPED = REPO / "configs" / "segmenter" / "swagan_ema_net_segmenter.yaml"
OVERRIDES = {"image_size": 64, "batch_size": 2, "max_iter": 2, "snapshot_save_iter": 2,
             "image_save_iter": 2, "display_size": 2, "log_iter": 1, "num_workers": 0,
             "num_augmentations": 1}
SNAPSHOT = Path("logs") / "run" / "checkpoints" / "iter_00000002.pt"


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("emanet_cli")
    rs = np.random.default_rng(0)
    data = root / "data"
    data.mkdir()
    names = []
    for i in range(6):
        img, mask = _page(rs, 64, 64)
        Image.fromarray(np.concatenate([img, mask], axis=1)).save(data / f"p{i}.png")
        names.append(f"p{i}.png")
    (data / "train.json").write_text(json.dumps(names[:4]))
    (data / "val.json").write_text(json.dumps(names[4:]))
    (root / "colors.json").write_text(json.dumps(COLORS))
    config = {**yaml.safe_load(SHIPPED.read_text()), **OVERRIDES}
    (root / "config.json").write_text(json.dumps(config))
    pages, gt = root / "pages", root / "gt"
    pages.mkdir()
    gt.mkdir()
    for i in range(2):
        img, mask = _page(rs, 100, 90)
        Image.fromarray(img).save(pages / f"q{i}.png")
        Image.fromarray(mask).save(gt / f"q{i}_gt.png")
    args = train.build_parser().parse_args([
        str(root / "config.json"), "--images", str(data / "train.json"),
        "--val-images", str(data / "val.json"), "--class-to-color-map",
        str(root / "colors.json"), "-l", str(root / "logs"), "-ln", "emanet", "-d", "cpu",
        "--debug"])
    args.log_dir = str(root / "logs" / "run")
    return root, train.main(args)


def _analyze(root, out, *extra):
    (root / "eval.json").write_text(json.dumps(
        {"checkpoint": str(root / SNAPSHOT), "class_to_color_map": str(root / "colors.json")}))
    analyze.main(analyze.parse_and_check_arguments(
        [str(root / "pages"), "-f", str(root / "eval.json"), "-gt", str(root / "gt"),
         "-o", str(root / out), "-cds", "-cio", "-cpr", "-cre",
         "--min-confidence", "0.0", "0.7", "--min-contour-area", "0", "5",
         "--use-device-component-filter", "-d", "cpu", *extra]))
    return json.loads((root / out / "results.json").read_text())


def test_train_cli_writes_a_run(trained):
    root, trainer = trained
    run = root / "logs" / "run"
    assert trainer.updater.iteration == 2
    assert isinstance(trainer.updater.network, EMANet)
    lines = [json.loads(line) for line in (run / "log.jsonl").read_text().splitlines()]
    losses = [line["loss/softmax"] for line in lines if "loss/softmax" in line]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert any("evaluation/dice_weighted_avg" in line for line in lines)
    snap = load_segmenter_snapshot(root / SNAPSHOT)
    network = snap["segmentation_network"]
    fresh = EMANet(3).init_weights(torch.Generator().manual_seed(0))
    assert network["emau.mu"].shape == (1, 512, 64)
    assert not torch.equal(network["emau.mu"], fresh.emau.mu)  # two µ updates
    groups = snap["main_optimizer"]["param_groups"]
    assert [(g["weight_decay"], g["lr_scale"], g["update_count"]) for g in groups] == [
        (0.0001, 1.0, 2), (0.0, 1.0, 2), (0.0, 2.0, 2)]
    assert all(g["momentum"] == 0.9 for g in groups)
    # a bare reference-layout state dict loads as a snapshot too
    torch.save(network, root / "bare.pt")
    assert set(load_segmenter_snapshot(root / "bare.pt")) == {"segmentation_network"}


def test_fused_and_bfloat16_pages_match_the_unfused_cli(trained):
    root, _ = trained
    unfused = _analyze(root, "unfused")
    _assert_results_match(_analyze(root, "fused", "--fused-page-inference"), unfused)
    runs = _analyze(root, "bf16", "--fused-page-inference", "--serving-dtype", "bfloat16")["runs"]
    assert len(runs) == 4 and all(len(run["confusion_matrices"]) == 2 for run in runs)


def test_the_snapshot_mu_reaches_the_page_path(trained):
    """Every EMA unit call of a page reads the snapshot's µ. (Its effect on
    the page is small here: three EM iterations from nearly uniform
    responsibilities land on much the same bases from any start.)"""
    root, _ = trained
    config = json.loads((root / "logs" / "run" / "config" / "config.json").read_text())
    mu = load_segmenter_snapshot(root / SNAPSHOT)["segmentation_network"]["emau.mu"]
    segmenter = AnalysisSegmenter(root / SNAPSHOT, COLORS, config=config, device="cpu")
    read = []
    segmenter.network.emau.register_forward_pre_hook(
        lambda module, args: read.append(module.mu.clone()))
    segmenter.segment_image(Image.open(root / "pages" / "q0.png"))
    assert read
    for value in read:
        torch.testing.assert_close(value, mu, rtol=0, atol=0)
