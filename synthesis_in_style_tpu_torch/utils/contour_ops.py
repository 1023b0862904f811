"""OpenCV-free contour primitives of the host contour route (counterpart of
the cv2 calls in synthesis_in_style_tpu/segmentation/contours.py,
evaluation/coco_gt.py, models/base_segmenter.py and native/contour_engine.cpp),
in numpy and scipy.ndimage.

`find_contours` returns what `cv2.findContours(mask, RETR_EXTERNAL,
CHAIN_APPROX_SIMPLE | CHAIN_APPROX_NONE)` returns, point for point and in the
same order (tests/test_torch_contour_ops.py holds it against cv2):

* Any nonzero pixel is foreground; outside the image is background, so a
  component touching the border is traced like any other.
* One contour per 8-connected component whose surrounding background is the
  image's outer background (4-connected): a component inside a hole of
  another is dropped (RETR_EXTERNAL).
* Contours come in reverse raster order of their start points; the start
  point is the component's first pixel in raster order.
* Each contour is OpenCV's Suzuki-Abe outer border following
  (icvFetchContour): the first step is the first foreground neighbour
  clockwise from the left (right, down-right, down, down-left), every later
  step the first one counter-clockwise after the direction it came from; it
  ends when it leaves the start pixel towards the first step's pixel again.
  CHAIN_APPROX_NONE keeps every visited point (a pixel may appear twice);
  CHAIN_APPROX_SIMPLE keeps a point where the direction changes, so a lone
  pixel is one point and a straight run two.

All components of a batch of masks are traced together, one vectorised step
at a time, so the Python loop runs as many times as the longest contour has
points.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
from scipy import ndimage

Contour = np.ndarray  # (N, 1, 2) int32 (x, y)

# OpenCV's chain code directions: 0 right, 1 up-right, 2 up, ... 7 down-right
_DX = np.array([1, 1, 0, -1, -1, -1, 0, 1], np.int64)
_DY = np.array([0, -1, -1, -1, 0, 1, 1, 1], np.int64)
_EIGHT = np.ones((3, 3), bool)
_CROSS = ndimage.generate_binary_structure(2, 1)


def _search_tables() -> Tuple[np.ndarray, np.ndarray]:
    """For an 8-bit neighbour code (bit k: neighbour in direction k is
    foreground): `step[code, s]` is the first direction counter-clockwise
    after s that holds a neighbour; `first[code]` the first of right,
    down-right, down, down-left that does (-1: none), as OpenCV's initial
    clockwise search from the left finds it at a component's first pixel."""
    step = np.zeros((256, 8), np.int64)
    first = np.full(256, -1, np.int64)
    for code in range(256):
        for s in range(8):
            for k in range(s + 1, s + 9):
                if code >> (k & 7) & 1:
                    step[code, s] = k & 7
                    break
        for k in (0, 7, 6, 5):
            if code >> k & 1:
                first[code] = k
                break
    return step, first


_STEP, _FIRST = _search_tables()
_STEP_LISTS = _STEP.tolist()
# below this many contours still being traced, the rest go one by one in
# plain Python: a vectorised step costs ~20 numpy calls whatever its width
_TAIL = 24


def find_contours_batch(masks, approx: str = "simple") -> List[List[Contour]]:
    """External contours of each (H, W) plane of a (B, H, W) mask stack, as
    `cv2.findContours(plane, RETR_EXTERNAL, CHAIN_APPROX_<approx>)` gives
    them (module docstring)."""
    if approx not in ("simple", "none"):
        raise ValueError(f"approx must be 'simple' or 'none', got {approx!r}")
    fg = np.asarray(masks) != 0
    if fg.ndim != 3:
        raise ValueError(f"expected (B, H, W) masks, got shape {fg.shape}")
    b, h, w = fg.shape
    out: List[List[Contour]] = [[] for _ in range(b)]
    if not fg.any():
        return out
    pad = np.zeros((b, h + 2, w + 2), bool)
    pad[:, 1:-1, 1:-1] = fg
    wp = w + 2
    plane = (h + 2) * wp

    # components (8-connected) and the background regions (4-connected)
    labels, n = ndimage.label(pad, structure=np.stack([np.zeros((3, 3), bool), _EIGHT,
                                                       np.zeros((3, 3), bool)]))
    bg_labels, _ = ndimage.label(~pad, structure=np.stack([np.zeros((3, 3), bool), _CROSS,
                                                          np.zeros((3, 3), bool)]))
    flat_labels = labels.ravel()
    fg_idx = np.flatnonzero(flat_labels)
    _, first = np.unique(flat_labels[fg_idx], return_index=True)
    starts = np.sort(fg_idx[first])  # every component's first pixel, raster order
    outer = bg_labels[:, 0, 0]
    # kept: the background left of the first pixel is the plane's outer one
    starts = starts[bg_labels.ravel()[starts - 1] == outer[starts // plane]]

    # 8-neighbour code of every pixel
    delta = _DX + _DY * wp
    code = np.zeros(pad.size, np.uint8)
    flat = pad.ravel()
    for k in range(8):
        d = int(delta[k])
        shifted = np.zeros_like(flat)
        if d > 0:
            shifted[:-d] = flat[d:]
        else:
            shifted[-d:] = flat[:d]
        code |= shifted.astype(np.uint8) << k

    s0 = _FIRST[code[starts]]
    lone = s0 < 0
    simple = approx == "simple"

    # A step from pixel i3 searched from direction s emits i3 where the
    # direction found differs from the one it arrived by, s ^ 4 (SIMPLE);
    # a trace ends on leaving its second pixel i1 for its first i0.
    comp_ids = [np.arange(len(starts))[lone]]
    comp_pos = [starts[lone]]
    active = np.flatnonzero(~lone)
    i0 = starts[active]
    s = s0[active]
    i1 = i0 + delta[s]
    i3 = i0.copy()
    while len(active) > _TAIL:
        nxt = _STEP[code[i3], s]
        emit = (nxt != (s ^ 4)) if simple else np.ones(len(active), bool)
        comp_ids.append(active[emit])
        comp_pos.append(i3[emit])
        i4 = i3 + delta[nxt]
        going = ~((i4 == i0) & (i3 == i1))
        active, i0, i1 = active[going], i0[going], i1[going]
        i3 = i4[going]
        s = (nxt[going] + 4) & 7
    steps = delta.tolist()
    for k, p, ss, a0, a1 in zip(active.tolist(), i3.tolist(), s.tolist(), i0.tolist(),
                                i1.tolist()):
        pts = []
        while True:
            nxt = _STEP_LISTS[code.item(p)][ss]
            if not simple or nxt != ss ^ 4:
                pts.append(p)
            p4 = p + steps[nxt]
            if p4 == a0 and p == a1:
                break
            p, ss = p4, (nxt + 4) & 7
        comp_ids.append(np.full(len(pts), k))
        comp_pos.append(np.array(pts, np.int64))

    ids = np.concatenate(comp_ids)
    pos = np.concatenate(comp_pos)
    order = np.argsort(ids, kind="stable")
    ids, pos = ids[order], pos[order]
    img = pos // plane
    rem = pos - img * plane
    pts = np.stack([rem % wp - 1, rem // wp - 1], axis=-1).astype(np.int32)
    bounds = np.flatnonzero(np.diff(ids)) + 1
    img_of = starts // plane
    for comp, chunk in enumerate(np.split(pts, bounds)):
        out[int(img_of[comp])].append(chunk.reshape(-1, 1, 2))
    return [contours[::-1] for contours in out]


def find_contours(mask, approx: str = "simple") -> List[Contour]:
    """`cv2.findContours(mask, RETR_EXTERNAL, CHAIN_APPROX_SIMPLE|NONE)[0]`
    of one (H, W) mask (module docstring)."""
    mask = np.asarray(mask)
    if mask.ndim != 2:
        raise ValueError(f"expected an (H, W) mask, got shape {mask.shape}")
    return find_contours_batch(mask[None], approx)[0]


def _concat(contours: Sequence[Contour]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All points (P, 2) int64, and each contour's point count and first
    index."""
    lens = np.array([len(c) for c in contours], np.int64)
    pts = np.concatenate([np.asarray(c).reshape(-1, 2) for c in contours]).astype(np.int64)
    return pts, lens, np.cumsum(lens) - lens


def contour_bounds_many(contours: Sequence[Contour]) -> np.ndarray:
    """(n, 4) int64 (x_min, y_min, x_max, y_max) of each contour."""
    if not len(contours):
        return np.zeros((0, 4), np.int64)
    pts, _, starts = _concat(contours)
    return np.concatenate([np.minimum.reduceat(pts, starts), np.maximum.reduceat(pts, starts)],
                          axis=1)


def contour_areas(contours: Sequence[Contour]) -> np.ndarray:
    """`contour_area` of each contour, float64."""
    if not len(contours):
        return np.zeros(0)
    pts, lens, starts = _concat(contours)
    prev = np.arange(len(pts)) - 1
    prev[starts] = starts + lens - 1
    x, y = pts[:, 0], pts[:, 1]
    twice = np.add.reduceat(x[prev] * y - x * y[prev], starts)
    return np.where(lens < 3, 0.0, np.abs(twice) * 0.5)


def filled_pixels(contours: Sequence[Contour]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(ids, xs, ys): every pixel `draw_contour_filled` paints for each
    contour, as contour index (ascending) and image coordinates, for all
    contours at once: their bounding boxes (each with a ring of outside) are
    packed on shelves of one canvas, the paths drawn, and the outside
    labelled once."""
    n = len(contours)
    if n == 0:
        empty = np.zeros(0, np.int64)
        return empty, empty, empty
    pts, lens, starts = _concat(contours)
    bounds = np.concatenate([np.minimum.reduceat(pts, starts), np.maximum.reduceat(pts, starts)],
                            axis=1)
    widths = bounds[:, 2] - bounds[:, 0] + 3
    heights = bounds[:, 3] - bounds[:, 1] + 3
    # shelves: tallest first, left to right up to a row width
    row_width = max(1024, int(widths.max()))
    left = np.zeros(n, np.int64)
    top = np.zeros(n, np.int64)
    x = y = shelf = 0
    for k in np.argsort(-heights, kind="stable").tolist():
        if x + widths[k] > row_width:
            x, y, shelf = 0, y + shelf, 0
        left[k], top[k] = x, y
        x += int(widths[k])
        shelf = max(shelf, int(heights[k]))
    canvas = np.zeros((y + shelf, row_width), bool)
    owner = np.full(canvas.shape, -1, np.int64)
    # each contour's path: its points joined by horizontal, vertical or
    # diagonal runs, as the tracer makes them
    nxt = np.arange(len(pts)) + 1
    nxt[starts + lens - 1] = starts
    d = pts[nxt] - pts
    steps = np.abs(d).max(axis=1)
    if np.any((np.abs(d) != steps[:, None]) & (d != 0)):
        raise ValueError("filled_pixels takes traced contours: every segment must be "
                         "horizontal, vertical or diagonal")
    counts = np.maximum(steps, 1)
    seg = np.repeat(np.arange(len(pts)), counts)
    k_step = np.arange(len(seg)) - np.repeat(np.cumsum(counts) - counts, counts)
    path = pts[seg] + np.sign(d)[seg] * k_step[:, None]
    path_id = np.repeat(np.repeat(np.arange(n), lens), counts)
    ox = left - bounds[:, 0] + 1  # image -> canvas offsets
    oy = top - bounds[:, 1] + 1
    canvas[path[:, 1] + oy[path_id], path[:, 0] + ox[path_id]] = True
    outside, _ = ndimage.label(~canvas, structure=_CROSS)
    for k in range(n):  # box interiors (without the ring) belong to their contour
        owner[top[k] + 1: top[k] + heights[k] - 1, left[k] + 1: left[k] + widths[k] - 1] = k
    cy, cx = np.nonzero((outside != outside[0, 0]) & (owner >= 0))
    ids = owner[cy, cx]
    # group by contour (a stable radix sort where the ids fit 16 bits)
    order = np.argsort(ids.astype(np.uint16) if n <= 1 << 16 else ids, kind="stable")
    ids, cx, cy = ids[order], cx[order], cy[order]
    return ids, cx - ox[ids], cy - oy[ids]


def contour_area(contour: Contour) -> float:
    """`cv2.contourArea`: the absolute shoelace area of the polygon through
    the points (not a pixel count)."""
    return float(contour_areas([contour])[0])


def bounding_rect(contour: Contour) -> Tuple[int, int, int, int]:
    """`cv2.boundingRect` of points: (x, y, w, h) with w = x_max - x_min + 1."""
    x0, y0, x1, y1 = contour_bounds_many([contour])[0].tolist()
    return x0, y0, x1 - x0 + 1, y1 - y0 + 1


def draw_contour_filled(canvas: np.ndarray, contour: Contour, value) -> np.ndarray:
    """`cv2.drawContours(canvas, [contour], 0, value, FILLED)` (and
    `cv2.fillPoly(canvas, [contour], value)`) for one traced contour, in
    place, clipped to the canvas; returns the canvas."""
    _, xs, ys = filled_pixels([contour])
    h, w = canvas.shape[:2]
    keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    canvas[ys[keep], xs[keep]] = value
    return canvas


def _neutral_filter(img: np.ndarray, footprint: np.ndarray, op: str) -> np.ndarray:
    """Grey dilation (max) or erosion (min) over a centred footprint with
    OpenCV's default border: the outside never wins."""
    img = np.asarray(img)
    if op == "max":
        return ndimage.maximum_filter(img, footprint=footprint, mode="constant",
                                      cval=np.iinfo(img.dtype).min if img.dtype.kind in "ui"
                                      else -np.inf)
    return ndimage.minimum_filter(img, footprint=footprint, mode="constant",
                                  cval=np.iinfo(img.dtype).max if img.dtype.kind in "ui"
                                  else np.inf)


def cross_kernel(size: int = 3) -> np.ndarray:
    """`cv2.getStructuringElement(MORPH_CROSS, (size, size))`."""
    kernel = np.zeros((size, size), np.uint8)
    kernel[size // 2, :] = 1
    kernel[:, size // 2] = 1
    return kernel


def dilate(mask: np.ndarray, kernel: np.ndarray, iterations: int = 1) -> np.ndarray:
    """`cv2.dilate(mask, kernel, iterations=n)` for an odd-sized kernel
    anchored at its centre (the 3x3 cross, 5x5 and 3x3 ones of the host
    route), with the border neutral. Works on (H, W) or, plane by plane, on
    (B, H, W)."""
    footprint = np.asarray(kernel) != 0
    if np.asarray(mask).ndim == 3:
        footprint = footprint[None]
    out = np.asarray(mask)
    for _ in range(iterations):
        out = _neutral_filter(out, footprint, "max")
    return out


def morph_close(img: np.ndarray, size: int = 5) -> np.ndarray:
    """`cv2.morphologyEx(img, MORPH_CLOSE, np.ones((size, size)))`: dilation
    then erosion, each with its border neutral. Works on (H, W) or, plane by
    plane, on (B, H, W)."""
    footprint = np.ones((size, size), bool)
    if np.asarray(img).ndim == 3:
        footprint = footprint[None]
    return _neutral_filter(_neutral_filter(img, footprint, "max"), footprint, "min")


def draw_rectangle(img: np.ndarray, p0: Sequence[int], p1: Sequence[int], color) -> np.ndarray:
    """`cv2.rectangle(img, p0, p1, color, 1)`: the outline of the box with
    corners p0 and p1 (inclusive), clipped to the image, in place."""
    h, w = img.shape[:2]
    xa, xb = sorted((int(p0[0]), int(p1[0])))
    ya, yb = sorted((int(p0[1]), int(p1[1])))
    xs = slice(max(xa, 0), min(xb, w - 1) + 1)
    ys = slice(max(ya, 0), min(yb, h - 1) + 1)
    for y in (ya, yb):
        if 0 <= y < h:
            img[y, xs] = color
    for x in (xa, xb):
        if 0 <= x < w:
            img[ys, x] = color
    return img
