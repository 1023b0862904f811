"""The port's two segmenter CLIs end to end on the CPU (`-d cpu`, a tiny
dataset, the shipped DocUFCN config with 32px patches and 3 iterations):
`train` writes log, sample grid, config and a snapshot; `--resume-ckpt`
continues from it; `analyze_image_segments` loads the snapshot and sweeps
two pages with the device component filter. Its `results.json` matches the
JAX CLI's, run on the same weights (converted with `torch_doc_ufcn_to_flax`
into an orbax snapshot) and pages, within 1e-3 per score (argmax near-ties
may flip a pixel). Without the device filter an area above 0 runs the host
contour filter. Options that are not ported raise."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from synthesis_in_style_tpu.cli import analyze_image_segments as jax_analyze
from synthesis_in_style_tpu.utils.checkpoint import save_pytree, torch_doc_ufcn_to_flax
from synthesis_in_style_tpu_torch.cli import analyze_image_segments as analyze
from synthesis_in_style_tpu_torch.cli import train
from synthesis_in_style_tpu_torch.utils.checkpoint import load_segmenter_snapshot
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parents[1]
SHIPPED = REPO / "configs" / "segmenter" / "stylegan2_doc_ufcn_segmenter.yaml"
COLORS = {"background": "#000000", "printed_text": "#0000FF", "handwritten_text": "#FF0000"}
OVERRIDES = {"image_size": 32, "batch_size": 2, "max_iter": 3, "snapshot_save_iter": 3,
             "image_save_iter": 2, "display_size": 2, "log_iter": 1, "num_workers": 0,
             "num_augmentations": 2}


def _page(rs, h, w):
    img = np.full((h, w, 3), 225, np.uint8) + rs.integers(0, 25, (h, w, 1), dtype=np.uint8)
    mask = np.zeros((h, w, 3), np.uint8)
    for _ in range(max(3, h * w // 200)):
        y, x = rs.integers(0, h - 4), rs.integers(0, w - 10)
        length, cls = rs.integers(3, 20), rs.integers(0, 2)
        img[y:y + 3, x:x + length] = 20 if cls == 0 else 90
        mask[y:y + 3, x:x + length] = [(0, 0, 255), (255, 0, 0)][cls]
    return img, mask


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("segmenter_cli")
    rs = np.random.default_rng(0)
    data = root / "data"
    data.mkdir()
    names = []
    for i in range(6):
        img, mask = _page(rs, 32, 32)
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
        img, mask = _page(rs, 70, 60)
        Image.fromarray(img).save(pages / f"q{i}.png")
        Image.fromarray(mask).save(gt / f"q{i}_gt.png")
    trainer = _train(root, "run")
    return root, trainer


def _train(root: Path, run: str, *extra):
    args = train.build_parser().parse_args([
        str(root / "config.json"), "--images", str(root / "data" / "train.json"),
        "--val-images", str(root / "data" / "val.json"),
        "--class-to-color-map", str(root / "colors.json"), "-l", str(root / "logs"),
        "-ln", "docufcn", "-d", "cpu", "--debug", *extra])
    args.log_dir = str(root / "logs" / run)
    return train.main(args)


def _analyze_argv(root, checkpoint, out, *extra):
    (root / f"{out}.json").write_text(json.dumps(
        {"checkpoint": str(checkpoint), "class_to_color_map": str(root / "colors.json")}))
    return [str(root / "pages"), "-f", str(root / f"{out}.json"), "-gt", str(root / "gt"),
            "-o", str(root / out), "-cds", "-cio", "-cpr", "-cre",
            "--min-confidence", "0.0", "0.7", "--min-contour-area", "0", "5",
            "--use-device-component-filter", *extra]


def test_train_cli_writes_a_run(trained):
    root, trainer = trained
    run = root / "logs" / "run"
    assert trainer.updater.iteration == 3
    lines = [json.loads(line) for line in (run / "log.jsonl").read_text().splitlines()]
    losses = [line["loss/softmax"] for line in lines if "loss/softmax" in line]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert any("evaluation/dice_weighted_avg" in line for line in lines)
    assert any("lr/main" in line for line in lines)
    assert (run / "images" / "iter_00000002.png").exists()
    assert json.loads((run / "config" / "config.json").read_text())["compute_dtype"] == "bfloat16"
    snap = torch.load(run / "checkpoints" / "iter_00000003.pt", weights_only=True)
    assert set(snap) >= {"segmentation_network", "main_optimizer"}
    assert "encoder_blocks.0.0.conv.weight" in snap["segmentation_network"]


def test_resume_continues_the_run(trained):
    root, _ = trained
    snapshot = root / "logs" / "run" / "checkpoints" / "iter_00000003.pt"
    config = json.loads((root / "config.json").read_text())
    (root / "config.json").write_text(json.dumps({**config, "max_iter": 4}))
    try:
        trainer = _train(root, "resumed", "--resume-ckpt", str(snapshot))
    finally:
        (root / "config.json").write_text(json.dumps(config))
    assert trainer.updater.iteration == 4
    assert trainer.updater.optimizer.count == 4  # Adam's steps went on from 3
    assert (root / "logs" / "resumed" / "checkpoints" / "iter_00000004.pt").exists()


def test_fine_tune_loads_the_network(trained):
    root, _ = trained
    snapshot = root / "logs" / "run" / "checkpoints" / "iter_00000003.pt"
    from synthesis_in_style_tpu_torch.training_builder import DocUFCNTrainBuilder

    config = {**json.loads((root / "config.json").read_text()), "fine_tune": str(snapshot)}
    builder = DocUFCNTrainBuilder(config, device="cpu")
    want = load_segmenter_snapshot(snapshot)["segmentation_network"]
    for name, value in builder.network.state_dict().items():
        assert torch.equal(value, want[name]), name


def test_analyze_results_match_the_jax_cli(trained):
    root, _ = trained
    run = root / "logs" / "run"
    snapshot = run / "checkpoints" / "iter_00000003.pt"
    analyze.main(analyze.parse_and_check_arguments(
        _analyze_argv(root, snapshot, "port", "-d", "cpu")))
    ours = json.loads((root / "port" / "results.json").read_text())

    # the same weights as an orbax snapshot of the JAX package
    jax_run = root / "jax_run"
    (jax_run / "config").mkdir(parents=True)
    (jax_run / "config" / "config.json").write_text((run / "config" / "config.json").read_text())
    state = load_segmenter_snapshot(snapshot)["segmentation_network"]
    variables = torch_doc_ufcn_to_flax({k: v.numpy() for k, v in state.items()})
    save_pytree(jax_run / "checkpoints" / "iter_00000003", {"segmentation_network": variables})
    jax_analyze.main(jax_analyze.build_parser().parse_args(
        _analyze_argv(root, jax_run / "checkpoints" / "iter_00000003", "jax")))
    ref = json.loads((root / "jax" / "results.json").read_text())

    assert len(ours["runs"]) == len(ref["runs"]) == 4
    compared = 0
    for mine, theirs in zip(ours["runs"], ref["runs"]):
        assert mine["hyperparams"]["min_confidence"] == theirs["hyperparams"]["min_confidence"]
        assert mine["hyperparams"]["min_contour_area"] == theirs["hyperparams"]["min_contour_area"]
        for metric in ("dice", "iou", "precision", "recall"):
            for key in (f"average_{metric}_scores",):
                for name, score in theirs[key].items():
                    assert abs(mine[key][name]["score"] - score["score"]) <= 1e-3, (key, name)
                    compared += 1
            detailed = f"detailed_{metric}_scores"
            for page, scores in theirs[detailed].items():
                for name, score in scores.items():
                    assert abs(mine[detailed][page][name]["score"] - score["score"]) <= 1e-3
                    compared += 1
    assert compared == 4 * 4 * 5 * 3


@pytest.mark.parametrize("extra", [["--fused-page-inference"], ["--quantize"],
                                   ["--serving-dtype", "bfloat16"], ["--pages-per-batch", "4"],
                                   ["--bucket-quantum", "8"], ["-vis", "--quantize"]])
def test_analyze_not_ported_flags_raise(trained, extra):
    root, _ = trained
    snapshot = root / "logs" / "run" / "checkpoints" / "iter_00000003.pt"
    args = analyze.parse_and_check_arguments(_analyze_argv(root, snapshot, "x", "-d", "cpu", *extra))
    with pytest.raises(NotImplementedError):
        analyze.main(args)


def test_area_filter_needs_the_device_filter(trained, monkeypatch):
    """An area above 0 without --use-device-component-filter no longer
    needs the device filter: it runs the host contour filter (its results
    against the JAX CLI's: tests/test_torch_page_host_filter.py)."""
    from synthesis_in_style_tpu_torch.segmentation import analysis_segmenter

    root, _ = trained
    snapshot = root / "logs" / "run" / "checkpoints" / "iter_00000003.pt"
    argv = [a for a in _analyze_argv(root, snapshot, "y", "-d", "cpu")
            if a != "--use-device-component-filter"]
    calls = []
    original = analysis_segmenter.remove_too_small_contours

    def counted(probs, area, background):
        calls.append(area)
        return original(probs, area, background)

    monkeypatch.setattr(analysis_segmenter, "remove_too_small_contours", counted)
    analyze.main(analyze.parse_and_check_arguments(argv))
    assert calls and set(calls) == {5}
    assert len(json.loads((root / "y" / "results.json").read_text())["runs"]) == 4


@pytest.mark.parametrize("extra", [["--resume-ckpt", "latest"], ["--cache-root", "/x"],
                                   ["--profile-dir", "/x"], ["--local_rank", "0"]])
def test_train_not_ported_flags_raise(trained, extra):
    root, _ = trained
    with pytest.raises(NotImplementedError):
        _train(root, "never", *extra)


def test_both_clis_default_to_cuda():
    assert train.build_parser().parse_args(["c.yaml", "--images", "t.json"]).device == "cuda"
    assert analyze.build_parser().parse_args(["pages"]).device == "cuda"
