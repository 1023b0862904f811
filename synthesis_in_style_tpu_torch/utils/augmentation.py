"""Paired image/mask augmentation without OpenCV (counterpart of
synthesis_in_style_tpu/utils/augmentation.py).

The JAX package's augmenter draws its program from a caller-supplied
`numpy.random.Generator` and applies it with OpenCV. This one draws the same
values in the same order, so one generator gives one program in both, and
reproduces OpenCV's geometry with numpy and scipy.ndimage:

* `warpAffine` takes the forward matrix (source -> destination) and samples
  the source at its inverse; bilinear or nearest, zero outside the image
  (each bilinear tap outside contributes 0, as BORDER_CONSTANT does);
* `getRotationMatrix2D(centre, degrees, 1)`;
* `remap` with float maps (the elastic transformation);
* `GaussianBlur(ksize, sigma)` with OpenCV's kernel (a sampled Gaussian,
  normalized) and its reflect-101 border (scipy's 'mirror');
* `resize`: bilinear with half-pixel centres, clamped at the edges; nearest
  at floor(x * scale).

OpenCV computes coordinates and weights in fixed point; this module in float
(the results differ by rounding: the tests hold masks to >= 99 % agreement
and images to <= 1 grey level on average).

Geometric ops go to image and mask with identical parameters (the mask by
nearest neighbour): 1-2 of elastic, shear, crop-and-pad, translate; then
with p=0.66 a 90-degree rotation or a rotation of up to 15 degrees. Colour
ops go to the image only: gamma with p=0.8, inversion with p=0.1.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
from scipy import ndimage


def _round_to(values: np.ndarray, dtype) -> np.ndarray:
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return np.clip(np.rint(values), info.min, info.max).astype(dtype)
    return values.astype(dtype)


def _sample(image: np.ndarray, sx: np.ndarray, sy: np.ndarray, nearest: bool) -> np.ndarray:
    """image sampled at source coordinates (sx, sy) (each (H', W')), zero
    outside the image."""
    h, w = image.shape[:2]
    img = image if image.ndim == 3 else image[:, :, None]
    if nearest:
        xi, yi = np.rint(sx).astype(np.int64), np.rint(sy).astype(np.int64)
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        out = img[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)] * valid[..., None]
        out = out.astype(image.dtype)
    else:
        # a 2-pixel zero border: with the top-left tap clipped into it, every
        # tap outside the image reads 0 and no per-tap mask is needed
        padded = np.pad(img, ((2, 2), (2, 2), (0, 0))).astype(np.float32)
        wp = w + 4
        x0, y0 = np.floor(sx), np.floor(sy)
        fx = (sx - x0).astype(np.float32)[..., None]
        fy = (sy - y0).astype(np.float32)[..., None]
        xi = np.clip(x0.astype(np.int64) + 2, 0, w + 2)
        yi = np.clip(y0.astype(np.int64) + 2, 0, h + 2)
        flat = padded.reshape(-1, img.shape[2])
        top = yi * wp + xi
        p00, p01 = flat[top], flat[top + 1]
        p10, p11 = flat[top + wp], flat[top + wp + 1]
        acc = (p00 + (p01 - p00) * fx) * (1 - fy) + (p10 + (p11 - p10) * fx) * fy
        out = _round_to(acc, image.dtype)
    return out if image.ndim == 3 else out[:, :, 0]


def warp_affine(image: np.ndarray, matrix: np.ndarray, nearest: bool) -> np.ndarray:
    """cv2.warpAffine(image, matrix[:2], (W, H), INTER_NEAREST or
    INTER_LINEAR, BORDER_CONSTANT, 0): `matrix` maps source to destination."""
    h, w = image.shape[:2]
    m = np.asarray(matrix, np.float64)[:2]
    inv = np.linalg.inv(np.vstack([m, [0.0, 0.0, 1.0]]))[:2]
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
    return _sample(image, sx, sy, nearest)


def rotation_matrix_2d(center: Tuple[float, float], angle_deg: float,
                       scale: float = 1.0) -> np.ndarray:
    """cv2.getRotationMatrix2D: (2, 3), a counter-clockwise rotation by
    `angle_deg` about `center` (x, y)."""
    a = np.deg2rad(angle_deg)
    alpha, beta = np.cos(a) * scale, np.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel(ksize, sigma) for sigma > 0."""
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    k = np.exp(-(x * x) / (2 * sigma * sigma))
    return k / k.sum()


def gaussian_blur(field: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    """cv2.GaussianBlur(field, (ksize, ksize), sigma) of a float32 (H, W)
    array, reflect-101 border."""
    k = gaussian_kernel(ksize, sigma)
    out = ndimage.correlate1d(field.astype(np.float64), k, axis=0, mode="mirror")
    out = ndimage.correlate1d(out, k, axis=1, mode="mirror")
    return out.astype(np.float32)


def resize(image: np.ndarray, width: int, height: int, nearest: bool) -> np.ndarray:
    """cv2.resize(image, (width, height)): INTER_NEAREST samples source
    pixel floor(x * src / dst); INTER_LINEAR uses half-pixel centres,
    (x + 0.5) * src / dst - 0.5, clamped to the image."""
    h, w = image.shape[:2]
    sx_scale, sy_scale = w / width, h / height
    if nearest:
        xi = np.minimum(np.floor(np.arange(width) * sx_scale).astype(np.int64), w - 1)
        yi = np.minimum(np.floor(np.arange(height) * sy_scale).astype(np.int64), h - 1)
        return image[yi[:, None], xi[None, :]]
    sx = np.clip((np.arange(width) + 0.5) * sx_scale - 0.5, 0, w - 1)
    sy = np.clip((np.arange(height) + 0.5) * sy_scale - 0.5, 0, h - 1)
    sx, sy = np.meshgrid(sx, sy)
    return _sample(image, sx, sy, nearest=False)


def _elastic_fields(shape: Tuple[int, int], alpha: float, sigma: float,
                    rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """Gaussian-smoothed uniform displacement fields scaled by alpha, added
    to the pixel grid (the remap's source coordinates)."""
    h, w = shape
    dx = rng.uniform(-1, 1, (h, w)).astype(np.float32)
    dy = rng.uniform(-1, 1, (h, w)).astype(np.float32)
    ksize = int(max(3, (int(sigma * 4) | 1)))
    dx = gaussian_blur(dx, ksize, sigma) * np.float32(alpha)
    dy = gaussian_blur(dy, ksize, sigma) * np.float32(alpha)
    grid_x, grid_y = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    return grid_x + dx, grid_y + dy


def _crop_and_pad(image: np.ndarray, amount: int, nearest: bool) -> np.ndarray:
    """Positive `amount` pads every side with zeros, negative crops; then
    resize back to the original size."""
    h, w = image.shape[:2]
    if amount == 0:
        return image
    if amount > 0:
        pad_width = [(amount, amount), (amount, amount)] + [(0, 0)] * (image.ndim - 2)
        out = np.pad(image, pad_width, mode="constant")
    else:
        c = min(-amount, (min(h, w) - 2) // 2)
        if c <= 0:
            return image
        out = image[c: h - c, c: w - c]
    return resize(out, w, h, nearest)


class PairedAugmenter:
    """Samples one augmentation program per call and applies it to an
    (image, mask) pair."""

    def __init__(
        self,
        elastic_alpha: Tuple[float, float] = (5.0, 25.0),
        elastic_sigma: Tuple[float, float] = (5.0, 9.0),
        shear_deg: Tuple[float, float] = (20.0, 20.0),
        crop_and_pad_px: Tuple[int, int] = (-80, 80),
        translate_pct: float = 0.15,
        rotate_deg: float = 15.0,
        rot_prob: float = 0.66,
        gamma_prob: float = 0.8,
        invert_prob: float = 0.10,
    ):
        self.elastic_alpha = elastic_alpha
        self.elastic_sigma = elastic_sigma
        self.shear_deg = shear_deg
        self.crop_and_pad_px = crop_and_pad_px
        self.translate_pct = translate_pct
        self.rotate_deg = rotate_deg
        self.rot_prob = rot_prob
        self.gamma_prob = gamma_prob
        self.invert_prob = invert_prob

    def _apply_color(self, image: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        out = image
        if rng.uniform() < self.gamma_prob:
            if rng.uniform() < 0.5:
                gamma = rng.uniform(1.5, 2.5)
            else:
                gamma = rng.uniform(0.1, 1.0)
            out = (np.power(out.astype(np.float32) / 255.0, gamma) * 255.0).astype(np.uint8)
        if rng.uniform() < self.invert_prob:
            out = 255 - out
        return out

    def __call__(self, image: np.ndarray, mask: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> Tuple[np.ndarray, np.ndarray]:
        """image: (H, W, C) uint8; mask: (H, W[, C]) uint8. Returns the
        augmented pair, same shapes."""
        rng = rng or np.random.default_rng()
        h, w = image.shape[:2]
        image = self._apply_color(image, rng)

        ops = ["elastic", "shear", "crop_pad", "translate"]
        n_ops = int(rng.integers(1, 3))
        chosen = list(rng.choice(ops, size=n_ops, replace=False))

        pair: List[np.ndarray] = [image, mask]
        for op in chosen:
            if op == "elastic":
                alpha = rng.uniform(*self.elastic_alpha)
                sigma = rng.uniform(*self.elastic_sigma)
                map_x, map_y = _elastic_fields((h, w), alpha, sigma, rng)
                pair = [_sample(arr, map_x, map_y, nearest=(i == 1)) for i, arr in enumerate(pair)]
            elif op == "shear":
                deg = rng.uniform(*self.shear_deg)
                shear = np.tan(np.deg2rad(deg))
                m = np.array([[1, shear, -shear * h / 2], [0, 1, 0]], np.float32)
                pair = [warp_affine(arr, m, nearest=(i == 1)) for i, arr in enumerate(pair)]
            elif op == "crop_pad":
                amount = int(rng.integers(self.crop_and_pad_px[0], self.crop_and_pad_px[1] + 1))
                pair = [_crop_and_pad(arr, amount, nearest=(i == 1)) for i, arr in enumerate(pair)]
            elif op == "translate":
                tx = rng.uniform(-self.translate_pct, self.translate_pct) * w
                ty = rng.uniform(-self.translate_pct, self.translate_pct) * h
                m = np.array([[1, 0, tx], [0, 1, ty]], np.float32)
                pair = [warp_affine(arr, m, nearest=(i == 1)) for i, arr in enumerate(pair)]

        if rng.uniform() < self.rot_prob:
            if rng.uniform() < 0.5:
                k = int(rng.choice([1, 3]))
                pair = [np.rot90(arr, k).copy() for arr in pair]
                if h != w:  # keep the input's shape
                    pair = [resize(arr, w, h, nearest=(i == 1)) for i, arr in enumerate(pair)]
            else:
                deg = rng.uniform(-self.rotate_deg, self.rotate_deg)
                m = rotation_matrix_2d((w / 2, h / 2), deg, 1.0).astype(np.float32)
                pair = [warp_affine(arr, m, nearest=(i == 1)) for i, arr in enumerate(pair)]

        return pair[0], pair[1]
