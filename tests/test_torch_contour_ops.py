"""The port's OpenCV-free contour primitives (utils/contour_ops.py) against
OpenCV itself, point for point and in order:

* `find_contours` == `cv2.findContours(..., RETR_EXTERNAL, CHAIN_APPROX_SIMPLE
  | CHAIN_APPROX_NONE)`: the same contours, the same points in the same
  order, the same contour order, int32 (N, 1, 2) — on random masks at
  several densities from 1x1 to 64x64, masks touching the border, 1-px
  lines, a lone pixel, diagonal-only links, rings with a component in the
  hole, all-ones and empty; values other than 1 count as foreground;
* the pinned conventions, read off cv2: start point, direction of travel,
  reverse raster order of the contours;
* `contour_area` == cv2.contourArea, `bounding_rect` == cv2.boundingRect,
  `draw_contour_filled` == cv2.drawContours(FILLED) and cv2.fillPoly on the
  tracer's own contours;
* `dilate` (3x3 cross, 5x5 and 3x3 ones, iterated), `morph_close` and
  `draw_rectangle` == their cv2 calls.
"""

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from synthesis_in_style_tpu_torch.utils import contour_ops

APPROX = {"simple": cv2.CHAIN_APPROX_SIMPLE, "none": cv2.CHAIN_APPROX_NONE}


def _cv2_contours(mask, approx):
    contours, _ = cv2.findContours(np.ascontiguousarray(mask, np.uint8), cv2.RETR_EXTERNAL,
                                   APPROX[approx])
    return list(contours)


def _assert_same(mask, approx):
    ref = _cv2_contours(mask, approx)
    got = contour_ops.find_contours(mask, approx)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == np.int32 and g.shape == r.shape
        np.testing.assert_array_equal(g, r)
    return got


def _ring(size=12, thickness=2, inner=True):
    m = np.zeros((size, size), np.uint8)
    m[1:size - 1, 1:size - 1] = 1
    m[1 + thickness:size - 1 - thickness, 1 + thickness:size - 1 - thickness] = 0
    if inner:
        m[size // 2, size // 2] = 1
    return m


def _families():
    rng = np.random.default_rng(0)
    out = {}
    for h, w in ((1, 1), (1, 7), (7, 1), (3, 3), (8, 13), (17, 17), (32, 24), (64, 64)):
        for d in (0.05, 0.3, 0.5, 0.8):
            out[f"random_{h}x{w}_{d}"] = (rng.random((h, w)) < d).astype(np.uint8)
    border = np.zeros((10, 10), np.uint8)
    border[0, :] = border[:, 0] = border[-1, 3:7] = border[4:8, -1] = 1
    out["touching_border"] = border
    lines = np.zeros((16, 16), np.uint8)
    lines[2, 1:12] = 1
    lines[5:14, 3] = 1
    for i in range(6):
        lines[6 + i, 6 + i] = lines[13 - i, 9 + i] = 1
    out["one_px_lines"] = lines
    lone = np.zeros((9, 9), np.uint8)
    lone[4, 4] = 1
    out["lone_pixel"] = lone
    diag = np.zeros((12, 12), np.uint8)
    for i in range(0, 10, 2):  # a zigzag linked only through corners
        diag[i, i] = diag[i + 1, i + 1] = 1
    diag[2, 8] = diag[3, 7] = diag[4, 8] = 1
    out["diagonal_links"] = diag
    diamond = np.zeros((7, 7), np.uint8)
    for y, x in ((0, 3), (1, 2), (2, 1), (3, 0), (4, 1), (5, 2), (6, 3), (5, 4), (4, 5),
                 (3, 6), (2, 5), (1, 4)):
        diamond[y, x] = 1
    diamond[3, 3] = 1
    out["diagonal_ring_with_inner"] = diamond
    out["thick_ring_with_inner"] = _ring(12, 2)
    out["thin_ring_with_inner"] = _ring(9, 1)
    nested = _ring(20, 1)
    nested[5:15, 5:15] = _ring(10, 1, inner=True)
    out["nested_rings"] = nested
    out["all_ones"] = np.ones((6, 9), np.uint8)
    out["empty"] = np.zeros((5, 4), np.uint8)
    out["values_not_one"] = (rng.random((20, 20)) < 0.4).astype(np.uint8) * rng.integers(
        1, 255, (20, 20), dtype=np.uint8)
    return out


FAMILIES = _families()


@pytest.mark.parametrize("approx", ["simple", "none"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_find_contours_matches_cv2(family, approx):
    _assert_same(FAMILIES[family], approx)


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(st.integers(1, 40), st.integers(1, 40), st.floats(0.02, 0.98), st.integers(0, 2**31),
       st.sampled_from(["simple", "none"]))
def test_find_contours_matches_cv2_random(h, w, density, seed, approx):
    mask = (np.random.default_rng(seed).random((h, w)) < density).astype(np.uint8)
    _assert_same(mask, approx)


def test_find_contours_batch_equals_per_mask():
    rng = np.random.default_rng(1)
    masks = rng.random((5, 21, 19)) < 0.35
    masks[2] = False
    for approx in ("simple", "none"):
        batch = contour_ops.find_contours_batch(masks, approx)
        for mask, got in zip(masks, batch):
            ref = contour_ops.find_contours(mask, approx)
            assert len(got) == len(ref)
            for g, r in zip(got, ref):
                np.testing.assert_array_equal(g, r)


def test_pinned_conventions():
    """Read off cv2: the start point is the component's first pixel in
    raster order, travel goes down its left side first (counter-clockwise
    on screen), contours come in reverse raster order of their starts, a
    lone pixel is one point and a straight run two under SIMPLE, and a
    component inside a hole is dropped."""
    m = np.zeros((6, 12), np.uint8)
    m[0, 0] = 1
    m[2, 3:6] = 1
    m[1:4, 8:11] = 1
    got = _assert_same(m, "simple")
    assert [c.reshape(-1, 2).tolist() for c in got] == [
        [[3, 2], [5, 2]], [[8, 1], [8, 3], [10, 3], [10, 1]], [[0, 0]]]
    none = _assert_same(m, "none")
    assert none[0].reshape(-1, 2).tolist() == [[3, 2], [4, 2], [5, 2], [4, 2]]
    assert len(_assert_same(_ring(12, 2), "simple")) == 1


@pytest.mark.parametrize("approx", ["simple", "none"])
@pytest.mark.parametrize("family", ["random_32x24_0.3", "random_32x24_0.5", "random_64x64_0.5",
                                    "random_64x64_0.8", "nested_rings", "one_px_lines",
                                    "diagonal_ring_with_inner", "touching_border"])
def test_area_rect_and_filled_drawing_match_cv2(family, approx):
    mask = FAMILIES[family]
    h, w = mask.shape
    for contour in contour_ops.find_contours(mask, approx):
        assert contour_ops.contour_area(contour) == cv2.contourArea(contour)
        assert contour_ops.bounding_rect(contour) == cv2.boundingRect(contour)
        for value in (1, 255):
            ref = cv2.drawContours(np.zeros((h, w), np.uint8), [contour], 0, value, cv2.FILLED)
            got = contour_ops.draw_contour_filled(np.zeros((h, w), np.uint8), contour, value)
            np.testing.assert_array_equal(got, ref)
            ref_poly = cv2.fillPoly(np.zeros((h, w), np.uint8), [contour], value)
            np.testing.assert_array_equal(got, ref_poly)


def test_area_same_under_both_approximations():
    mask = FAMILIES["random_64x64_0.5"]
    simple = contour_ops.find_contours(mask, "simple")
    none = contour_ops.find_contours(mask, "none")
    assert [contour_ops.contour_area(c) for c in simple] == \
        [contour_ops.contour_area(c) for c in none]


@pytest.mark.parametrize("kernel_name,kernel,iterations", [
    ("cross3", cv2.getStructuringElement(cv2.MORPH_CROSS, (3, 3)), 1),
    ("ones5_x2", np.ones((5, 5), np.uint8), 2),
    ("ones3_x3", np.ones((3, 3), np.uint8), 3),
])
def test_dilate_matches_cv2(kernel_name, kernel, iterations):
    np.testing.assert_array_equal(contour_ops.cross_kernel(3),
                                  cv2.getStructuringElement(cv2.MORPH_CROSS, (3, 3)))
    rng = np.random.default_rng(2)
    for shape, d in (((17, 23), 0.05), ((32, 32), 0.3), ((5, 5), 0.9)):
        m = (rng.random(shape) < d).astype(np.uint8)
        m[0, :] = m[:, -1] = 1  # touches the border
        ref = cv2.dilate(m, kernel, iterations=iterations)
        np.testing.assert_array_equal(contour_ops.dilate(m, kernel, iterations), ref)
        if kernel_name == "cross3":
            ref = cv2.morphologyEx(m, cv2.MORPH_DILATE, kernel)
            np.testing.assert_array_equal(contour_ops.dilate(m, kernel), ref)
    stack = (rng.random((3, 16, 16)) < 0.2).astype(np.uint8)
    np.testing.assert_array_equal(
        contour_ops.dilate(stack, kernel, iterations),
        np.stack([cv2.dilate(s, kernel, iterations=iterations) for s in stack]))


def test_morph_close_matches_cv2():
    rng = np.random.default_rng(3)
    for shape in ((40, 37), (6, 6)):
        img = (rng.random(shape) * 255).astype(np.uint8)
        img[rng.random(shape) < 0.5] = 0
        ref = cv2.morphologyEx(img, cv2.MORPH_CLOSE, np.ones((5, 5), np.uint8))
        np.testing.assert_array_equal(contour_ops.morph_close(img, 5), ref)


@pytest.mark.parametrize("p0,p1", [((2, 3), (9, 7)), ((9, 7), (2, 3)), ((0, 0), (19, 14)),
                                   ((5, 5), (5, 5)), ((-3, 4), (25, 20)), ((12, 2), (30, 9)),
                                   ((4, 9), (11, 9))])
def test_draw_rectangle_matches_cv2(p0, p1):
    for channels in (1, 3):
        shape = (15, 20, 3) if channels == 3 else (15, 20)
        color = (255, 0, 0) if channels == 3 else 200
        base = np.random.default_rng(4).integers(0, 50, shape, dtype=np.uint8)
        ref = cv2.rectangle(base.copy(), p0, p1, color, 1)
        got = contour_ops.draw_rectangle(base.copy(), p0, p1, color)
        np.testing.assert_array_equal(got, ref)
