"""The port's segmentation/contours.py against the JAX module's functions
on the same contours (traced by cv2 from seeded masks): overlap counts,
merges (fixpoint, pairwise, both cross-image variants), the area filter,
classification and rendering with and without clip masks — contour lists
identical point for point and in order, rasters bit-identical."""

import cv2
import numpy as np
import pytest
from scipy import ndimage

from synthesis_in_style_tpu.segmentation import contours as jax_contours
from synthesis_in_style_tpu_torch.segmentation import contours as port_contours
from synthesis_in_style_tpu_torch.utils import contour_ops

CLASS_IDS = {"background": 0, "printed_text": 1, "handwritten_text": 2}
COLORS = {"background": (0, 0, 0), "printed_text": (0, 0, 255), "handwritten_text": (255, 0, 0)}


def _blobs(rng, n, size, quantile=0.7, sigma=1.5):
    noise = ndimage.gaussian_filter(rng.random((n, size, size)), (0, sigma, sigma))
    return (noise > np.quantile(noise, quantile)).astype(np.uint8)


def _cv2_contours(mask, approx=cv2.CHAIN_APPROX_SIMPLE):
    return list(cv2.findContours(mask, cv2.RETR_EXTERNAL, approx)[0])


def _same(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _same_class_contours(a, b):
    assert list(a) == list(b)
    for name in a:
        assert len(a[name]) == len(b[name])
        for x, y in zip(a[name], b[name]):
            _same(x, y)


@pytest.mark.parametrize("seed", range(3))
def test_cluster_image_to_contours_matches_jax(seed):
    masks = _blobs(np.random.default_rng(seed), 4, 40, 0.6, 1.0)
    got = port_contours.cluster_image_to_contours(masks)
    ref = jax_contours.cluster_image_to_contours(masks)
    for g, r in zip(got, ref):
        _same(g, r)
    np.testing.assert_array_equal(port_contours.dilate_image(masks[0]),
                                  jax_contours.dilate_image(masks[0]))


@pytest.mark.parametrize("seed", range(4))
def test_overlap_and_pairwise_merge_match_jax(seed):
    rng = np.random.default_rng(seed)
    contours = [c for m in _blobs(rng, 3, 32, 0.6) for c in _cv2_contours(m)]
    for i in range(len(contours)):
        for j in range(len(contours)):
            a, b = contours[i], contours[j]
            assert port_contours.contour_overlap(a, b) == jax_contours.contour_overlap(a, b)
            _same(port_contours.merge_two_contours_if_overlapping(a, b),
                  jax_contours.merge_two_contours_if_overlapping(a, b))
    # boxes that only touch never overlap
    left = np.array([[[0, 0]], [[0, 4]], [[4, 4]], [[4, 0]]], np.int32)
    right = left + np.array([4, 0], np.int32)
    assert port_contours.contour_overlap(left, right) == 0 == \
        jax_contours.contour_overlap(left, right)


@pytest.mark.parametrize("only_keep_overlapping", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_merge_contours_matches_jax(seed, only_keep_overlapping):
    rng = np.random.default_rng(seed)
    layers = _blobs(rng, 3, 48, 0.65)
    contours = [c for m in layers for c in _cv2_contours(m)]
    got = port_contours.merge_contours(contours, only_keep_overlapping)
    ref = jax_contours.merge_contours(contours, only_keep_overlapping)
    assert len(ref) > 0
    _same(got, ref)


def _class_contours_for_sub_images(rng, batch, size, layers, empty_share=0.2):
    out = {}
    for layer in layers:
        per_class = {}
        for name in ("printed_text", "handwritten_text"):
            masks = _blobs(rng, batch, size, 0.7)
            masks[rng.random(batch) < empty_share] = 0
            per_class[name] = [_cv2_contours(m) for m in masks]
        out[layer] = per_class
    return out


@pytest.mark.parametrize("kwargs", [
    {}, {"only_keep_overlapping": True}, {"drop_if_size_of_contours_zero": True},
    {"only_keep_overlapping": True, "drop_if_size_of_contours_zero": True,
     "class_names_to_merge": ("printed_text",)},
], ids=["plain", "only_overlapping", "drop_if_empty", "one_class"])
@pytest.mark.parametrize("seed", range(2))
def test_cross_image_merges_match_jax(seed, kwargs):
    rng = np.random.default_rng(10 + seed)
    subs = _class_contours_for_sub_images(rng, 5, 40, ["8", "9"])
    got = port_contours.merge_contours_of_same_class_from_different_images(subs, 5, **kwargs)
    ref = jax_contours.merge_contours_of_same_class_from_different_images(subs, 5, **kwargs)
    _same_class_contours(dict(got), dict(ref))
    _same_class_contours(port_contours.merge_contours_of_same_class_from_same_image(dict(ref)),
                         jax_contours.merge_contours_of_same_class_from_same_image(dict(ref)))


@pytest.mark.parametrize("min_area", [0, 2, 12.5, 50])
def test_drop_too_small_contours_matches_jax(min_area):
    rng = np.random.default_rng(3)
    class_contours = {"printed_text": [_cv2_contours(m) for m in _blobs(rng, 4, 40, 0.8)]
                      + [None]}
    _same_class_contours(port_contours.drop_too_small_contours(class_contours, min_area),
                         jax_contours.drop_too_small_contours(class_contours, min_area))
    for contours in class_contours["printed_text"][:-1]:
        for c in contours:
            assert contour_ops.contour_area(c) == cv2.contourArea(c)


def _classification_inputs(seed, batch=4, size=40):
    rng = np.random.default_rng(seed)
    regions = {name: [_cv2_contours(m) or None for m in _blobs(rng, batch, size, 0.5, 3.0)]
               for name in ("printed_text", "handwritten_text")}
    fine_masks = _blobs(rng, batch, size, 0.75, 0.8)
    fine = {"printed_text": [_cv2_contours(m) or None for m in fine_masks],
            "handwritten_text": [None] * batch}
    return regions, fine, fine_masks


@pytest.mark.parametrize("seed", range(3))
def test_classify_fine_grained_contours_matches_jax(seed):
    regions, fine, _ = _classification_inputs(seed)
    got = port_contours.classify_fine_grained_contours(regions, fine, CLASS_IDS)
    ref = jax_contours.classify_fine_grained_contours(regions, fine, CLASS_IDS)
    _same_class_contours(got, ref)


def test_classification_ties_go_to_first_class_id():
    square = np.array([[[2, 2]], [[2, 9]], [[9, 9]], [[9, 2]]], np.int32)
    regions = {"handwritten_text": [[square]], "printed_text": [[square.copy()]]}
    fine = {"printed_text": [[square.copy()]], "handwritten_text": [None]}
    got = port_contours.classify_fine_grained_contours(regions, fine, CLASS_IDS)
    ref = jax_contours.classify_fine_grained_contours(regions, fine, CLASS_IDS)
    _same_class_contours(got, ref)
    assert got["printed_text"][0] is not None and got["handwritten_text"][0] is None


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_render_segmentation_image_matches_jax(seed, clip):
    regions, fine, fine_masks = _classification_inputs(seed)
    classified = jax_contours.classify_fine_grained_contours(regions, fine, CLASS_IDS)
    batch, size = fine_masks.shape[:2]
    prediction = {"background": ~fine_masks.astype(bool), "printed_text": fine_masks.astype(bool),
                  "handwritten_text": np.zeros_like(fine_masks, bool)}
    clip_masks = None
    if clip:
        rng = np.random.default_rng(100 + seed)
        clip_masks = {name: _blobs(rng, batch, size, 0.4, 4.0).astype(bool)
                      for name in ("printed_text", "handwritten_text")}
    got = port_contours.render_segmentation_image(prediction, classified, batch, size, COLORS,
                                                  class_clip_masks=clip_masks)
    ref = jax_contours.render_segmentation_image(prediction, classified, batch, size, COLORS,
                                                 class_clip_masks=clip_masks)
    assert got.dtype == np.uint8 and (got != 0).any()
    np.testing.assert_array_equal(got, ref)
