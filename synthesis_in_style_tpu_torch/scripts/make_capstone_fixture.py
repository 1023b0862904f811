"""The appearance-coded capstone fixture: synthetic document pages whose
printed / handwritten distinction is stroke appearance, not position
(counterpart of synthesis_in_style_tpu/scripts/make_capstone_fixture.py,
without OpenCV).

* printed_text: blocks of straight horizontal dash rows on regular
  baselines (machine-set type);
* handwritten_text: loopy cursive squiggles (cycloid-like pen traces with
  drifting loop radius and frequency);
* blocks of either class anywhere on the page (rejection-sampled, no
  overlap), so only appearance separates the classes.

Every random draw comes from the same `np.random.default_rng` in the same
order as the JAX script, and no draw depends on what the rasteriser drew:
block layout, class mix, dash and loop geometry and ink tone are identical.
The JAX script draws with cv2; here numpy does:

* `cv2.resize(..., INTER_CUBIC)` of the paper's coarse shading: a separable
  cubic convolution with A = -0.75, half-pixel centres and a replicated
  border;
* `cv2.line` / `cv2.polylines`: a thickness-1 stroke is OpenCV's 8-connected
  Bresenham walk (left to right); a thicker one is a rectangle of half-width
  r = (t + t % 2) / 2 around the segment, widened by half a pixel as
  OpenCV's outline pass widens it, with discs x^2 + y^2 <= r^2 at the
  vertices.

Stroke edges may differ from OpenCV's by a pixel (tests/
test_torch_capstone_fixture.py holds class masks and pages against the JAX
script's).

Output layout (read by cli.train_stylegan_2 and cli.analyze_image_segments):

  <out>/pages/page_00000.png ...      GAN training pages
  <out>/train.json, <out>/val.json    manifests (relative paths)
  <out>/eval/images/eval_00000.png    held-out pages (a second seed stream)
  <out>/eval/gt/eval_00000_gt.png     colour GT masks (#000000 background,
                                      #0000FF printed, #FF0000 handwritten)

Usage:
  python -m synthesis_in_style_tpu_torch.scripts.make_capstone_fixture <out> \\
      --size 128 --num-pages 768 --num-eval 64 [--seed 3]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from synthesis_in_style_tpu_torch.utils.png import write_png

CUBIC_A = -0.75


def _cubic_weights(frac: np.ndarray) -> np.ndarray:
    """(n,) fractional offsets -> (n, 4) weights of the taps at -1, 0, 1, 2
    (OpenCV's interpolateCubic)."""
    a, x = CUBIC_A, frac.astype(np.float32)
    w0 = ((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a
    w1 = ((a + 2) * x - (a + 3)) * x * x + 1
    w2 = ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1
    return np.stack([w0, w1, w2, 1 - w0 - w1 - w2], axis=1).astype(np.float32)


def _cubic_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) interpolation matrix of one axis: half-pixel centres,
    border taps clamped to the edge (replicated)."""
    pos = ((np.arange(dst) + 0.5) * (src / dst) - 0.5).astype(np.float32)
    base = np.floor(pos).astype(np.int64)
    weights = _cubic_weights(pos - base)
    m = np.zeros((dst, src), np.float32)
    for k in range(4):
        np.add.at(m, (np.arange(dst), np.clip(base - 1 + k, 0, src - 1)), weights[:, k])
    return m


def resize_cubic(image: np.ndarray, size: int) -> np.ndarray:
    """(h, w) float32 -> (size, size), as cv2.resize INTER_CUBIC."""
    rows = _cubic_matrix(image.shape[0], size)
    cols = _cubic_matrix(image.shape[1], size)
    return (rows @ image.astype(np.float32) @ cols.T).astype(np.float32)


def _line8(ink: np.ndarray, p0, p1) -> None:
    """OpenCV's 8-connected line (LineIterator, walked left to right)."""
    (x0, y0), (x1, y1) = p0, p1
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, y1 - y0
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    steep = dy > dx
    major, minor = (dy, dx) if steep else (dx, dy)
    err = major - 2 * minor
    x, y = x0, y0
    h, w = ink.shape
    for _ in range(major + 1):
        if 0 <= x < w and 0 <= y < h:
            ink[y, x] = 1.0
        step_minor = err < 0
        err += -2 * minor + (2 * major if step_minor else 0)
        if steep:
            y += sy
            x += 1 if step_minor else 0
        else:
            x += 1
            y += sy if step_minor else 0


def _thick_polyline(ink: np.ndarray, points: np.ndarray, radius: int) -> None:
    """Every pixel whose centre lies within the rectangle of half-width
    radius + 0.5 around a segment (between its end normals), or within a
    disc x^2 + y^2 <= radius^2 around a vertex; all segments at once over
    the polyline's bounding window."""
    h, w = ink.shape
    reach = radius + 1
    x_lo, y_lo = np.maximum(points.min(axis=0) - reach, 0)
    x_hi, y_hi = np.minimum(points.max(axis=0) + reach + 1, (w, h))
    gx = np.arange(x_lo, x_hi)[None, None, :] - points[:, 0, None, None]  # (n, 1, W)
    gy = np.arange(y_lo, y_hi)[None, :, None] - points[:, 1, None, None]  # (n, H, 1)
    inside = (gx * gx + gy * gy <= radius * radius).any(axis=0)
    d = (points[1:] - points[:-1]).astype(np.float64)
    length2 = (d * d).sum(axis=1)
    if len(d):
        dx, dy = d[:, 0, None, None], d[:, 1, None, None]
        along = (gx[:-1] * dx + gy[:-1] * dy) / length2[:, None, None]
        across = np.abs(gx[:-1] * dy - gy[:-1] * dx) / np.sqrt(length2)[:, None, None]
        inside |= ((along >= 0) & (along <= 1) & (across <= radius + 0.5)).any(axis=0)
    ink[y_lo:y_hi, x_lo:x_hi][inside] = 1.0


def draw_polyline(ink: np.ndarray, points, thickness: int) -> None:
    """An open polyline of integer points (cv2.polylines, LINE_8)."""
    # a repeated point draws nothing new (a zero-length segment, the same disc)
    points = np.asarray(points, np.int64).reshape(-1, 2)
    points = points[np.r_[True, (points[1:] != points[:-1]).any(axis=1)]]
    if thickness <= 1:
        for p0, p1 in zip(points.tolist(), points[1:].tolist()):
            _line8(ink, p0, p1)
        return
    _thick_polyline(ink, points, (thickness + (thickness & 1)) // 2)


def _paper(rng: np.random.Generator, size: int) -> np.ndarray:
    """Light paper background with low-frequency shading and fine grain."""
    base = rng.uniform(225, 248)
    coarse = resize_cubic(
        rng.normal(0.0, 6.0, (size // 16 + 1, size // 16 + 1)).astype(np.float32), size)
    grain = rng.normal(0.0, 2.0, (size, size)).astype(np.float32)
    return np.clip(base + coarse + grain, 200, 255)


def _draw_printed_block(ink: np.ndarray, rng: np.random.Generator, box, scale: float) -> None:
    """Straight horizontal dash rows on regular baselines inside `box`."""
    x0, y0, w, h = box
    spacing = max(4, int(round(rng.uniform(6, 10) * scale)))
    thickness = max(1, int(round(rng.uniform(1.0, 1.6) * scale)))
    y = y0 + spacing // 2
    while y < y0 + h - thickness:
        x = x0 + int(rng.integers(0, max(1, int(4 * scale))))
        while x < x0 + w - 3:
            dash = int(round(rng.uniform(6, 18) * scale))
            gap = int(round(rng.uniform(2, 5) * scale))
            x1 = min(x + dash, x0 + w - 1)
            draw_polyline(ink, [(x, y), (x1, y)], thickness)
            x = x1 + gap
        y += spacing


def _draw_handwritten_block(ink: np.ndarray, rng: np.random.Generator, box,
                            scale: float) -> None:
    """Loopy cursive squiggles: cycloid pen traces with drifting radius and
    frequency."""
    x0, y0, w, h = box
    thickness = max(1, int(round(rng.uniform(1.0, 1.5) * scale)))
    n_rows = max(1, int(h / max(1.0, rng.uniform(10, 16) * scale)))
    row_h = h / n_rows
    for r in range(n_rows):
        yc = y0 + (r + 0.5) * row_h
        t = np.linspace(0.0, 1.0, max(32, int(w * 4)))
        radius = rng.uniform(2.2, 4.5) * scale
        radius_mod = 1.0 + 0.5 * np.sin(
            2 * np.pi * rng.uniform(0.5, 2.0) * t + rng.uniform(0, 2 * np.pi))
        loops = w / (rng.uniform(4.0, 7.0) * scale)
        phase = 2 * np.pi * loops * t + rng.uniform(0, 2 * np.pi)
        drift = np.cumsum(rng.normal(0, 0.35 * scale, t.shape))
        drift -= np.linspace(0, drift[-1], len(drift))
        xs = x0 + t * (w - 1) + radius * radius_mod * np.cos(phase) * 0.6
        ys = yc + radius * radius_mod * np.sin(phase) + drift
        xs = np.clip(xs, x0, x0 + w - 1)
        ys = np.clip(ys, y0, y0 + h - 1)
        pts = np.stack([xs, ys], axis=-1).round().astype(np.int32)
        draw_polyline(ink, pts, thickness)


def _place_blocks(rng: np.random.Generator, size: int, n_blocks: int):
    """Rejection-sample non-overlapping block boxes anywhere on the page."""
    scale = size / 128.0
    boxes = []
    for _ in range(n_blocks):
        for _attempt in range(60):
            w = int(rng.uniform(30, 62) * scale)
            h = int(rng.uniform(18, 46) * scale)
            x0 = int(rng.integers(2, max(3, size - w - 2)))
            y0 = int(rng.integers(2, max(3, size - h - 2)))
            pad = int(3 * scale)
            clash = any(
                not (x0 + w + pad < bx or bx + bw + pad < x0
                     or y0 + h + pad < by or by + bh + pad < y0)
                for bx, by, bw, bh in boxes
            )
            if not clash:
                boxes.append((x0, y0, w, h))
                break
    return boxes


def render_page(rng: np.random.Generator, size: int):
    """One page and its class ink: (rgb uint8, printed mask, handwritten
    mask), masks in {0, 1} uint8 at stroke-pixel precision."""
    scale = size / 128.0
    page = _paper(rng, size)
    # class mix: most pages have both, some one class only
    mix = rng.uniform()
    if mix < 0.70:
        n_printed, n_hand = rng.integers(2, 5), rng.integers(2, 5)
    elif mix < 0.85:
        n_printed, n_hand = rng.integers(3, 7), 0
    else:
        n_printed, n_hand = 0, rng.integers(3, 7)
    boxes = _place_blocks(rng, size, int(n_printed + n_hand))
    printed = np.zeros((size, size), np.float32)
    hand = np.zeros((size, size), np.float32)
    for i, box in enumerate(boxes):
        if i < n_printed:
            _draw_printed_block(printed, rng, box, scale)
        else:
            _draw_handwritten_block(hand, rng, box, scale)
    ink = np.clip(printed + hand, 0, 1)
    ink_tone = rng.uniform(15, 70)
    noise = rng.normal(0, 6, page.shape).astype(np.float32)
    img = page * (1 - ink) + ink * (ink_tone + noise * ink)
    img = np.clip(img, 0, 255).astype(np.uint8)
    rgb = np.stack([img] * 3, axis=-1)
    return rgb, (printed > 0).astype(np.uint8), (hand > 0).astype(np.uint8)


def gt_color_image(printed: np.ndarray, hand: np.ndarray) -> np.ndarray:
    """Colour GT mask in the creation config's class_to_color_map."""
    gt = np.zeros((*printed.shape, 3), np.uint8)
    gt[printed > 0] = (0, 0, 255)
    gt[hand > 0] = (255, 0, 0)
    return gt


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("out")
    parser.add_argument("--size", type=int, default=128)
    parser.add_argument("--num-pages", type=int, default=768)
    parser.add_argument("--num-eval", type=int, default=64)
    parser.add_argument("--val-frac", type=float, default=0.1)
    parser.add_argument("--seed", type=int, default=3)
    args = parser.parse_args(argv)

    out = Path(args.out)
    (out / "pages").mkdir(parents=True, exist_ok=True)
    (out / "eval" / "images").mkdir(parents=True, exist_ok=True)
    (out / "eval" / "gt").mkdir(parents=True, exist_ok=True)

    rng = np.random.default_rng(args.seed)
    names = []
    for i in range(args.num_pages):
        rgb, _, _ = render_page(rng, args.size)
        name = f"pages/page_{i:05d}.png"
        write_png(out / name, rgb)
        names.append(name)
    n_val = max(1, int(len(names) * args.val_frac))
    (out / "train.json").write_text(json.dumps(names[n_val:]))
    (out / "val.json").write_text(json.dumps(names[:n_val]))

    eval_rng = np.random.default_rng(args.seed + 100_000)
    for i in range(args.num_eval):
        rgb, printed, hand = render_page(eval_rng, args.size)
        write_png(out / "eval" / "images" / f"eval_{i:05d}.png", rgb)
        write_png(out / "eval" / "gt" / f"eval_{i:05d}_gt.png", gt_color_image(printed, hand))
    print(f"wrote {len(names)} pages ({n_val} val) + {args.num_eval} eval pairs at "
          f"{args.size}px under {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
