"""The port's OpenCV-free augmentation and segmentation datasets against the
JAX package's (which uses OpenCV) on the CPU.

One `numpy.random.Generator` seed gives one program in both: over 60 seeds
the generators end in the same state (the same draws, in the same order),
the augmented masks agree on >= 99 % of pixels and the images differ by <=
1.0 grey level on average (OpenCV computes coordinates and weights in fixed
point, the port in float). The OpenCV primitives the port reproduces are
held one by one, and the port's augmentation leaves no `cv2` in
`sys.modules`."""

import json
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from synthesis_in_style_tpu.data.segmentation_dataset import (
    AugmentedSegmentationDataset as JaxAugmentedDataset,
)
from synthesis_in_style_tpu.utils.augmentation import PairedAugmenter as JaxAugmenter
from synthesis_in_style_tpu_torch.data.segmentation_dataset import AugmentedSegmentationDataset
from synthesis_in_style_tpu_torch.utils import augmentation as aug

COLORS = {"background": "#000000", "printed_text": "#0000FF", "handwritten_text": "#FF0000"}


def text_page(seed: int, h: int = 96, w: int = 96):
    """A light page with dark text-like bars, a brightness ramp, and the
    bars' colour-coded mask."""
    rs = np.random.default_rng(seed)
    img = np.full((h, w, 3), 225, np.uint8) + rs.integers(0, 25, (h, w, 1), dtype=np.uint8)
    mask = np.zeros((h, w, 3), np.uint8)
    for _ in range(10):
        y, x = rs.integers(0, h - 6), rs.integers(0, w - 20)
        length, cls = rs.integers(8, 40), rs.integers(0, 2)
        img[y:y + 5, x:x + length] = rs.integers(0, 80)
        mask[y:y + 5, x:x + length] = [(0, 0, 255), (255, 0, 0)][cls]
    ramp = np.linspace(0, 20, w)[None, :, None]
    return (img.astype(np.float32) + ramp).clip(0, 255).astype(np.uint8), mask


def test_same_program_as_jax_over_60_seeds():
    worst_mask, worst_image = 1.0, 0.0
    for seed in range(60):
        img, mask = text_page(seed)
        r_ref, r_port = np.random.default_rng(seed), np.random.default_rng(seed)
        ref_img, ref_mask = JaxAugmenter()(img, mask, r_ref)
        got_img, got_mask = aug.PairedAugmenter()(img, mask, r_port)
        assert r_ref.bit_generator.state == r_port.bit_generator.state, seed
        assert got_img.shape == ref_img.shape and got_mask.shape == ref_mask.shape
        assert got_img.dtype == np.uint8 and got_mask.dtype == np.uint8
        worst_mask = min(worst_mask, float((got_mask == ref_mask).all(-1).mean()))
        worst_image = max(worst_image, float(np.abs(got_img.astype(float) - ref_img).mean()))
    assert worst_mask >= 0.99, worst_mask
    assert worst_image <= 1.0, worst_image


@pytest.mark.parametrize("ksize,sigma", [(21, 5.3), (37, 9.0), (29, 7.2)])
def test_gaussian_blur_matches_cv2(ksize, sigma):
    field = np.random.default_rng(1).uniform(-1, 1, (64, 80)).astype(np.float32)
    ref = cv2.GaussianBlur(field, (ksize, ksize), sigma)
    np.testing.assert_allclose(aug.gaussian_blur(field, ksize, sigma), ref, atol=1e-5)


@pytest.mark.parametrize("nearest", [False, True])
@pytest.mark.parametrize("kind", ["shear", "translate", "rotate"])
def test_warp_affine_matches_cv2(kind, nearest):
    img, mask = text_page(3, 64, 80)
    src = mask if nearest else img
    h, w = src.shape[:2]
    if kind == "shear":
        m = np.array([[1, 0.36, -0.36 * h / 2], [0, 1, 0]], np.float32)
    elif kind == "translate":
        m = np.array([[1, 0, 7.3], [0, 1, -4.6]], np.float32)
    else:
        m = cv2.getRotationMatrix2D((w / 2, h / 2), 11.5, 1.0).astype(np.float32)
        np.testing.assert_allclose(aug.rotation_matrix_2d((w / 2, h / 2), 11.5), m, atol=1e-6)
    flags = cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR
    ref = cv2.warpAffine(src, m, (w, h), flags=flags, borderMode=cv2.BORDER_CONSTANT,
                         borderValue=0)
    got = aug.warp_affine(src, m, nearest)
    if nearest:
        assert (got == ref).all(-1).mean() >= 0.99
    else:
        assert np.abs(got.astype(float) - ref).mean() <= 0.5
        assert np.abs(got.astype(int) - ref).max() <= 3


@pytest.mark.parametrize("nearest", [False, True])
@pytest.mark.parametrize("size", [(50, 44), (120, 97)])
def test_resize_matches_cv2(size, nearest):
    img, mask = text_page(4, 64, 80)
    src = mask if nearest else img
    w, h = size
    ref = cv2.resize(src, (w, h), interpolation=cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR)
    got = aug.resize(src, w, h, nearest)
    if nearest:
        np.testing.assert_array_equal(got, ref)
    else:
        assert np.abs(got.astype(int) - ref).max() <= 1


def test_no_cv2_after_the_port_augments():
    script = (
        "import sys, numpy as np\n"
        "from synthesis_in_style_tpu_torch.utils.augmentation import PairedAugmenter\n"
        "img = np.zeros((40, 40, 3), np.uint8); img[10:20] = 200\n"
        "for s in range(20):\n"
        "    PairedAugmenter()(img, img.copy(), np.random.default_rng(s))\n"
        "assert 'cv2' not in sys.modules\n"
    )
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", script], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_augmented_dataset_matches_jax(tmp_path):
    names = []
    for i in range(3):
        img, mask = text_page(10 + i, 48, 48)
        Image.fromarray(np.concatenate([img, mask], axis=1)).save(tmp_path / f"p{i}.png")
        names.append(f"p{i}.png")
    (tmp_path / "train.json").write_text(json.dumps(names))
    (tmp_path / "colors.json").write_text(json.dumps(COLORS))
    kwargs = dict(class_to_color_map_path=tmp_path / "colors.json", root=tmp_path,
                  image_size=48, num_augmentations=3, seed=5)
    ours = AugmentedSegmentationDataset(tmp_path / "train.json", **kwargs)
    ref = JaxAugmentedDataset(tmp_path / "train.json", **kwargs)
    assert len(ours) == len(ref) == 9
    for index in range(len(ref)):
        r, o = ref[index], ours[index]
        assert o["images"].dtype == torch.float32 and o["segmented"].dtype == torch.int64
        labels_agree = float((o["segmented"].numpy() == r["segmented"]).mean())
        image_diff = float(np.abs(o["images"].numpy() - r["images"]).mean())
        if index < 3:  # the originals
            assert labels_agree == 1.0 and image_diff <= 1e-7
            assert int(o["segmented"].max()) == 2
        else:
            assert labels_agree >= 0.99 and image_diff <= 2.0 / 255 * 1.0
