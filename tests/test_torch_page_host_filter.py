"""Page inference's host small-contour filter and drawing flags, port
against the JAX package on the CPU:

* `get_contours_from_prediction` and `remove_too_small_contours` on seeded
  probability maps (several areas): identical contours and probabilities;
* the analyze CLI with --min-contour-area 0 5 and no device filter against
  the JAX CLI's `results.json` on the same weights and pages: every score
  within 1e-3 (the two networks' float32 confidences differ by rounding,
  which may flip an argmax near-tie or a threshold cut);
* `visualize_segmentation` with every drawing flag (-vis with
  --extract-bboxes, --draw-patches, --draw-bboxes-on-segmentation, -b, -c,
  --overlay-segmentation, with and without --show-confidence), fed the same
  assembled prediction and page: the same files, pixel for pixel; and the
  CLI writes the same file names as the JAX CLI.
"""

import argparse
import json
from pathlib import Path

import numpy as np
import pytest
from PIL import Image
from scipy import ndimage

from synthesis_in_style_tpu.cli import analyze_image_segments as jax_analyze
from synthesis_in_style_tpu.models import base_segmenter as jax_base
from synthesis_in_style_tpu.utils.checkpoint import save_pytree, torch_doc_ufcn_to_flax
from synthesis_in_style_tpu_torch.cli import analyze_image_segments as analyze
from synthesis_in_style_tpu_torch.models import base_segmenter as port_base
from synthesis_in_style_tpu_torch.segmentation.analysis_segmenter import (
    calculate_bboxes_for_patches,
)
from synthesis_in_style_tpu_torch.utils.checkpoint import load_segmenter_snapshot
from synthesis_in_style_tpu_torch.utils.png import read_png
from test_torch_segmenter_cli import COLORS, _analyze_argv, trained  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


def _probabilities(seed, b=3, h=40, w=48, c=3):
    rng = np.random.default_rng(seed)
    logits = ndimage.gaussian_filter(rng.normal(size=(b, h, w, c)) * 4, (0, 1.2, 1.2, 0))
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    probs[probs < 0.5] = 0  # the confidence threshold
    return probs.astype(np.float32)


@pytest.mark.parametrize("seed", range(3))
def test_get_contours_from_prediction_matches_jax(seed):
    probs = _probabilities(seed)
    for image in probs:
        for k in range(probs.shape[-1]):
            got = port_base.get_contours_from_prediction(image[..., k])
            ref = jax_base.get_contours_from_prediction(image[..., k])
            if ref is None:
                assert got is None
                continue
            assert len(got) == len(ref)
            for g, r in zip(got, ref):
                np.testing.assert_array_equal(g, r)
    assert port_base.get_contours_from_prediction(np.zeros((8, 8), np.float32)) is None


@pytest.mark.parametrize("min_area", [0, 1, 5, 30, 200])
@pytest.mark.parametrize("seed", range(3))
def test_remove_too_small_contours_matches_jax(seed, min_area):
    probs = _probabilities(seed)
    got = port_base.remove_too_small_contours(probs, min_area, 0)
    ref = jax_base.remove_too_small_contours(probs, min_area, 0)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    if min_area == 30:
        assert (ref != probs).any()  # regions were removed
    np.testing.assert_array_equal(port_base.remove_too_small_contours(probs, min_area, 1),
                                  jax_base.remove_too_small_contours(probs, min_area, 1))


def _jax_snapshot(root):
    run = root / "logs" / "run"
    jax_run = root / "jax_host_run"
    if not jax_run.exists():
        (jax_run / "config").mkdir(parents=True)
        (jax_run / "config" / "config.json").write_text(
            (run / "config" / "config.json").read_text())
        state = load_segmenter_snapshot(run / "checkpoints" / "iter_00000003.pt")[
            "segmentation_network"]
        variables = torch_doc_ufcn_to_flax({k: v.numpy() for k, v in state.items()})
        save_pytree(jax_run / "checkpoints" / "iter_00000003", {"segmentation_network": variables})
    return jax_run / "checkpoints" / "iter_00000003"


def _host_argv(root, checkpoint, out, *extra):
    return [a for a in _analyze_argv(root, checkpoint, out, *extra)
            if a != "--use-device-component-filter"]


def test_analyze_cli_host_filter_matches_jax(trained):  # noqa: F811
    root, _ = trained
    snapshot = root / "logs" / "run" / "checkpoints" / "iter_00000003.pt"
    analyze.main(analyze.parse_and_check_arguments(
        _host_argv(root, snapshot, "port_host", "-d", "cpu")))
    jax_analyze.main(jax_analyze.build_parser().parse_args(
        _host_argv(root, _jax_snapshot(root), "jax_host")))
    ours = json.loads((root / "port_host" / "results.json").read_text())
    ref = json.loads((root / "jax_host" / "results.json").read_text())
    assert len(ours["runs"]) == len(ref["runs"]) == 4
    compared = 0
    for mine, theirs in zip(ours["runs"], ref["runs"]):
        assert mine["hyperparams"] == theirs["hyperparams"]
        for metric in ("dice", "iou", "precision", "recall"):
            for name, score in theirs[f"average_{metric}_scores"].items():
                assert abs(mine[f"average_{metric}_scores"][name]["score"]
                           - score["score"]) <= 1e-3
                compared += 1
            for page, scores in theirs[f"detailed_{metric}_scores"].items():
                for name, score in scores.items():
                    assert abs(mine[f"detailed_{metric}_scores"][page][name]["score"]
                               - score["score"]) <= 1e-3
                    compared += 1
    assert compared == 4 * 4 * 5 * 3


DRAW_FLAGS = ["-vis", "--extract-bboxes", "--draw-patches", "--draw-bboxes-on-segmentation",
              "-b", "-c", "--overlay-segmentation"]


class _Tiling:
    def calculate_bboxes_for_patches(self, width, height):
        return calculate_bboxes_for_patches(width, height, 16, 4)


@pytest.mark.parametrize("show_confidence", [False, True])
def test_visualize_segmentation_matches_jax(tmp_path, show_confidence):
    rng = np.random.default_rng(5)
    h, w = 45, 61
    probs = ndimage.gaussian_filter(rng.random((h, w, 3)), (2, 2, 0)).astype(np.float32)
    probs[..., 0] += 0.05
    probs /= probs.sum(-1, keepdims=True)
    page = Image.fromarray(rng.integers(0, 255, (h, w), dtype=np.uint8)).convert("L")
    written = {}
    for name, module in (("port", analyze), ("jax", jax_analyze)):
        out = tmp_path / name
        out.mkdir()
        args = argparse.Namespace(show_confidence=show_confidence, output_dir=out,
                                  overlay_segmentation=True, draw_patches=True,
                                  extract_bboxes=True, save_bboxes=True, save_contours=True,
                                  draw_bboxes_on_segmentation=True)
        module.visualize_segmentation(probs, page, _Tiling(), args, COLORS, "page_x")
        written[name] = sorted(p.name for p in out.glob("*.png"))
    assert written["port"] == written["jax"]
    assert {"page_x_segmentation.png", "page_x_overlay.png", "page_x_bboxes.png",
            "page_x_bbox_0000.png", "page_x_contour_0000.png"} <= set(written["jax"])
    for name in written["jax"]:
        ref = np.asarray(Image.open(tmp_path / "jax" / name))
        np.testing.assert_array_equal(read_png(tmp_path / "port" / name), ref, err_msg=name)


def test_analyze_cli_drawing_flags_write_the_jax_files(trained):  # noqa: F811
    root, _ = trained
    snapshot = root / "logs" / "run" / "checkpoints" / "iter_00000003.pt"
    sweep = ["--min-confidence", "0.0", "--min-contour-area", "5"]
    argv = [a for a in _host_argv(root, snapshot, "port_vis", "-d", "cpu")]
    argv = argv[:argv.index("--min-confidence")] + argv[argv.index("-d"):] + sweep
    analyze.main(analyze.parse_and_check_arguments(argv + DRAW_FLAGS))
    jax_argv = _host_argv(root, _jax_snapshot(root), "jax_vis")
    jax_argv = jax_argv[:jax_argv.index("--min-confidence")] + sweep
    jax_analyze.main(jax_analyze.build_parser().parse_args(jax_argv + DRAW_FLAGS))
    ours = sorted(p.name for p in (root / "port_vis").glob("*.png"))
    ref = sorted(p.name for p in (root / "jax_vis").glob("*.png"))
    assert ours == ref and len(ref) >= 2 * 3
    for name in ref:
        got, want = read_png(root / "port_vis" / name), np.asarray(Image.open(root / "jax_vis" / name))
        assert got.shape == want.shape
        assert (got == want).all(axis=-1).mean() >= 0.999, name
