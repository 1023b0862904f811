"""The port's capstone fixture (no OpenCV) against the JAX script's (cv2) on
the CPU. Both draw every random number from the same generator in the same
order, so the manifests, the file names, the block layout and the class mix
are identical; only the rasterisers differ:

* `train.json`, `val.json` and every file name: identical;
* GT class masks (the eval pages' colour masks): >= 99 % of pixels equal
  (thick strokes, from 256px on, differ from cv2's by a pixel at some
  edges);
* pages: where the class masks agree, within 1 gray level (cv2's float
  cubic resize of the paper shading rounds the other way now and then);
  on every training page, >= 99 % of pixels within 1 gray level;
* the rasteriser's pieces against cv2 directly: the cubic resize within
  1e-4, a thickness-1 line pixel for pixel."""

import json

import cv2
import numpy as np
import pytest
from PIL import Image

from synthesis_in_style_tpu.scripts import make_capstone_fixture as jax_fixture
from synthesis_in_style_tpu_torch.scripts import make_capstone_fixture as fixture

MASK_AGREEMENT = 0.99
GRAY_BOUND = 1


def _read(path):
    return np.asarray(Image.open(path).convert("RGB")).astype(np.int32)


@pytest.mark.parametrize("size,pages,evals", [(128, 4, 2), (256, 3, 2)])
def test_fixture_matches_the_jax_script(tmp_path, size, pages, evals):
    argv = ["--size", str(size), "--num-pages", str(pages), "--num-eval", str(evals)]
    assert jax_fixture.main([str(tmp_path / "jax"), *argv]) == 0
    assert fixture.main([str(tmp_path / "port"), *argv]) == 0
    ref, ours = tmp_path / "jax", tmp_path / "port"

    for manifest in ("train.json", "val.json"):
        assert json.loads((ours / manifest).read_text()) == \
            json.loads((ref / manifest).read_text())
    names = sorted(p.relative_to(ref).as_posix() for p in ref.rglob("*.png"))
    assert names == sorted(p.relative_to(ours).as_posix() for p in ours.rglob("*.png"))
    assert len(names) == pages + 2 * evals

    for i in range(evals):
        gt_ref = _read(ref / "eval" / "gt" / f"eval_{i:05d}_gt.png")
        gt_ours = _read(ours / "eval" / "gt" / f"eval_{i:05d}_gt.png")
        agree = (gt_ref == gt_ours).all(axis=-1)
        assert agree.mean() >= MASK_AGREEMENT, (i, agree.mean())
        assert (gt_ref > 0).any()  # the page has ink
        page_ref = _read(ref / "eval" / "images" / f"eval_{i:05d}.png")
        page_ours = _read(ours / "eval" / "images" / f"eval_{i:05d}.png")
        assert np.abs(page_ref - page_ours)[agree].max() <= GRAY_BOUND, i
    for name in json.loads((ref / "train.json").read_text()):
        close = (np.abs(_read(ref / name) - _read(ours / name)) <= GRAY_BOUND).all(axis=-1)
        assert close.mean() >= MASK_AGREEMENT, (name, close.mean())


def test_cubic_resize_matches_cv2():
    rs = np.random.default_rng(0)
    for src, dst in ((9, 128), (17, 256), (5, 7)):
        grid = rs.normal(0, 6, (src, src)).astype(np.float32)
        ref = cv2.resize(grid, (dst, dst), interpolation=cv2.INTER_CUBIC)
        np.testing.assert_allclose(fixture.resize_cubic(grid, dst), ref, rtol=0, atol=1e-4)


def test_thin_lines_match_cv2():
    rs = np.random.default_rng(1)
    for _ in range(200):
        p0, p1 = [tuple(int(v) for v in rs.integers(0, 24, 2)) for _ in range(2)]
        ref = np.zeros((24, 24), np.float32)
        cv2.line(ref, p0, p1, 1.0, 1)
        ours = np.zeros((24, 24), np.float32)
        fixture.draw_polyline(ours, [p0, p1], 1)
        assert np.array_equal(ours, ref), (p0, p1)
    pts = rs.integers(0, 24, (12, 2)).astype(np.int32)
    ref = np.zeros((24, 24), np.float32)
    cv2.polylines(ref, [pts], False, 1.0, 1)
    ours = np.zeros((24, 24), np.float32)
    fixture.draw_polyline(ours, pts, 1)
    assert np.array_equal(ours, ref)


def test_thick_strokes_match_cv2_up_to_an_edge_pixel():
    """Horizontal dashes of thickness 2 to 4 (the printed blocks) are cv2's
    exactly; on random crooked thick polylines (harsher than the fixture's
    pen traces) every pixel that differs touches one that both draw."""
    for t in (2, 3, 4):
        ref = np.zeros((16, 32), np.float32)
        cv2.line(ref, (4, 8), (25, 8), 1.0, t)
        ours = np.zeros((16, 32), np.float32)
        fixture.draw_polyline(ours, [(4, 8), (25, 8)], t)
        assert np.array_equal(ours, ref), t
    rs = np.random.default_rng(2)
    for t in (2, 3):
        pts = np.cumsum(rs.integers(-2, 3, (60, 2)), axis=0).astype(np.int32) + 20
        ref = np.zeros((40, 40), np.float32)
        cv2.polylines(ref, [pts], False, 1.0, t)
        ours = np.zeros((40, 40), np.float32)
        fixture.draw_polyline(ours, pts, t)
        differ = (ref > 0) != (ours > 0)
        both = np.pad((ref > 0) & (ours > 0), 1)
        near = np.zeros_like(both)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                near |= np.roll(np.roll(both, dy, 0), dx, 1)
        assert near[1:-1, 1:-1][differ].all(), t
