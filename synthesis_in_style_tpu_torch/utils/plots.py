"""Small PNG plots drawn with PIL (the port does not depend on
matplotlib): histograms, line plots, parallel-coordinate plots and
heatmaps with a colour bar, each on a white canvas with a frame and the
data range written at the axes."""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
from PIL import Image, ImageDraw

WIDTH, HEIGHT, MARGIN = 640, 480, 48
BLUE, ORANGE, BLACK = (31, 119, 180), (255, 127, 14), (0, 0, 0)


def _canvas() -> Tuple[Image.Image, ImageDraw.ImageDraw]:
    image = Image.new("RGB", (WIDTH, HEIGHT), "white")
    draw = ImageDraw.Draw(image)
    draw.rectangle([MARGIN, MARGIN, WIDTH - MARGIN, HEIGHT - MARGIN], outline=BLACK)
    return image, draw


def _label_axes(draw: ImageDraw.ImageDraw, x_range: Tuple[float, float],
                y_range: Tuple[float, float]) -> None:
    draw.text((MARGIN, HEIGHT - MARGIN + 6), f"{x_range[0]:.3g}", fill=BLACK)
    draw.text((WIDTH - MARGIN - 40, HEIGHT - MARGIN + 6), f"{x_range[1]:.3g}", fill=BLACK)
    draw.text((4, HEIGHT - MARGIN - 10), f"{y_range[0]:.3g}", fill=BLACK)
    draw.text((4, MARGIN), f"{y_range[1]:.3g}", fill=BLACK)


def _to_px(values: np.ndarray, lo: float, hi: float, start: float, end: float) -> np.ndarray:
    span = hi - lo if hi > lo else 1.0
    return start + (np.asarray(values, np.float64) - lo) / span * (end - start)


def histogram(data: np.ndarray, path: Path, bins: int = 100,
              overlay: Optional[np.ndarray] = None) -> np.ndarray:
    """Bars of np.histogram(data, bins); `overlay` drawn over them in a
    second colour on the same bin edges. Returns the bin edges."""
    counts, edges = np.histogram(np.asarray(data).reshape(-1), bins=bins)
    layers = [(counts, BLUE)]
    if overlay is not None:
        layers.append((np.histogram(np.asarray(overlay).reshape(-1), bins=edges)[0], ORANGE))
    top = max(int(c.max()) for c, _ in layers) or 1
    image, draw = _canvas()
    xs = _to_px(edges, edges[0], edges[-1], MARGIN, WIDTH - MARGIN)
    for c, colour in layers:
        ys = _to_px(c, 0, top, HEIGHT - MARGIN, MARGIN)
        for i in range(len(c)):
            if c[i]:
                draw.rectangle([xs[i], ys[i], max(xs[i], xs[i + 1] - 1), HEIGHT - MARGIN],
                               outline=colour)
    _label_axes(draw, (edges[0], edges[-1]), (0, top))
    image.save(path)
    return edges


def line_plot(x: np.ndarray, y: np.ndarray, path: Path, y_label: str = "") -> None:
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    image, draw = _canvas()
    px = _to_px(x, x.min(), x.max(), MARGIN, WIDTH - MARGIN)
    py = _to_px(y, y.min(), y.max(), HEIGHT - MARGIN, MARGIN)
    if len(x) > 4096:  # a line of a few thousand points draws the same
        keep = np.linspace(0, len(x) - 1, 4096).astype(int)
        px, py = px[keep], py[keep]
    draw.line(list(zip(px.tolist(), py.tolist())), fill=BLUE, width=1)
    _label_axes(draw, (x.min(), x.max()), (y.min(), y.max()))
    if y_label:
        draw.text((4, HEIGHT // 2), y_label, fill=BLACK)
    image.save(path)


def parallel_coordinates(rows: np.ndarray, path: Path, alpha: float = 0.1) -> None:
    """One black line per row across its columns, blended with `alpha`."""
    rows = np.asarray(rows, np.float64)
    lo, hi = float(rows.min()), float(rows.max())
    n_cols = rows.shape[1]
    xs = _to_px(np.arange(n_cols), 0, max(1, n_cols - 1), MARGIN, WIDTH - MARGIN).tolist()
    image, _ = _canvas()
    draw = ImageDraw.Draw(image, "RGBA")
    fill = BLACK + (max(1, int(round(alpha * 255))),)
    for row in rows:
        draw.line(list(zip(xs, _to_px(row, lo, hi, HEIGHT - MARGIN, MARGIN).tolist())),
                  fill=fill)
    _label_axes(draw, (0, n_cols - 1), (lo, hi))
    image.save(path)


def _viridis_like(t: np.ndarray) -> np.ndarray:
    """A blue -> green -> yellow ramp for t in [0, 1] -> uint8 RGB."""
    stops = np.array([[68, 1, 84], [59, 82, 139], [33, 145, 140], [94, 201, 98],
                      [253, 231, 37]], np.float64)
    pos = np.clip(t, 0, 1) * (len(stops) - 1)
    i = np.minimum(pos.astype(int), len(stops) - 2)
    f = (pos - i)[..., None]
    return (stops[i] * (1 - f) + stops[i + 1] * f).astype(np.uint8)


def heatmap(matrix: np.ndarray, path: Path) -> None:
    """The matrix's cells scaled to the canvas, with a colour bar and its
    range at the right."""
    m = np.atleast_2d(np.asarray(matrix, np.float64))
    finite = m[np.isfinite(m)]
    lo, hi = (float(finite.min()), float(finite.max())) if finite.size else (0.0, 1.0)
    t = (np.nan_to_num(m, nan=lo) - lo) / (hi - lo if hi > lo else 1.0)
    cells = Image.fromarray(_viridis_like(t))
    plot_w, plot_h = WIDTH - 3 * MARGIN, HEIGHT - 2 * MARGIN
    image, draw = _canvas()
    image.paste(cells.resize((plot_w, plot_h), Image.NEAREST), (MARGIN, MARGIN))
    bar = _viridis_like(np.linspace(1, 0, plot_h)[:, None].repeat(12, axis=1))
    image.paste(Image.fromarray(bar), (WIDTH - 2 * MARGIN + 12, MARGIN))
    draw = ImageDraw.Draw(image)
    draw.text((WIDTH - 2 * MARGIN + 28, MARGIN), f"{hi:.3g}", fill=BLACK)
    draw.text((WIDTH - 2 * MARGIN + 28, HEIGHT - MARGIN - 10), f"{lo:.3g}", fill=BLACK)
    image.save(path)


PALETTE = (BLUE, ORANGE, (44, 160, 44), (214, 39, 40), (148, 103, 189), (140, 86, 75))


def boxplot(groups: Sequence[Sequence[float]], path: Path,
            positions: Optional[Sequence[float]] = None,
            colours: Optional[Sequence[Tuple[int, int, int]]] = None,
            tick_positions: Sequence[float] = (), tick_labels: Sequence[str] = (),
            x_label: str = "", y_label: str = "", title: str = "") -> None:
    """One box per group (quartiles, the median line, whiskers to the most
    extreme values within 1.5 IQR of the box, points beyond them) at its
    position (1, 2, ... by default)."""
    groups = [np.asarray(g, np.float64).reshape(-1) for g in groups]
    positions = list(positions) if positions is not None else list(range(1, len(groups) + 1))
    colours = list(colours) if colours is not None else [BLUE] * len(groups)
    values = np.concatenate([g for g in groups if g.size] or [np.zeros(1)])
    lo, hi = float(values.min()), float(values.max())
    pad = 0.05 * (hi - lo if hi > lo else 1.0)
    lo, hi = lo - pad, hi + pad
    x_lo, x_hi = min(positions) - 1, max(positions) + 1
    image, draw = _canvas()
    half = 0.4 * (WIDTH - 2 * MARGIN) / max(1, x_hi - x_lo)
    for group, pos, colour in zip(groups, positions, colours):
        if not group.size:
            continue
        q1, med, q3 = np.percentile(group, (25, 50, 75))
        reach = 1.5 * (q3 - q1)
        inside = group[(group >= q1 - reach) & (group <= q3 + reach)]
        w_lo, w_hi = float(inside.min()), float(inside.max())
        x = float(_to_px(pos, x_lo, x_hi, MARGIN, WIDTH - MARGIN))
        y = lambda v: float(_to_px(v, lo, hi, HEIGHT - MARGIN, MARGIN))  # noqa: E731
        draw.rectangle([x - half, y(q3), x + half, y(q1)], outline=colour)
        draw.line([(x - half, y(med)), (x + half, y(med))], fill=ORANGE if colour == BLUE
                  else BLACK)
        draw.line([(x, y(q3)), (x, y(w_hi))], fill=colour)
        draw.line([(x, y(q1)), (x, y(w_lo))], fill=colour)
        draw.line([(x - half / 2, y(w_hi)), (x + half / 2, y(w_hi))], fill=colour)
        draw.line([(x - half / 2, y(w_lo)), (x + half / 2, y(w_lo))], fill=colour)
        for v in group[(group < w_lo) | (group > w_hi)]:
            draw.ellipse([x - 2, y(v) - 2, x + 2, y(v) + 2], outline=colour)
    for pos, label in zip(tick_positions, tick_labels):
        x = float(_to_px(pos, x_lo, x_hi, MARGIN, WIDTH - MARGIN))
        draw.line([(x, HEIGHT - MARGIN), (x, HEIGHT - MARGIN + 4)], fill=BLACK)
        draw.text((x - 3 * len(str(label)), HEIGHT - MARGIN + 6), str(label), fill=BLACK)
    draw.text((4, MARGIN), f"{hi:.3g}", fill=BLACK)
    draw.text((4, HEIGHT - MARGIN - 10), f"{lo:.3g}", fill=BLACK)
    if x_label:
        draw.text((WIDTH // 2 - 3 * len(x_label), HEIGHT - MARGIN + 22), x_label, fill=BLACK)
    if y_label:
        draw.text((4, HEIGHT // 2), y_label, fill=BLACK)
    if title:
        draw.text((WIDTH // 2 - 3 * len(title), MARGIN // 2 - 6), title, fill=BLACK)
    image.save(path)
