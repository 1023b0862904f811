"""Minimal PNG codec on the standard library's zlib: 8-bit RGB, filter 0.

`write_png` writes what the dataset CLI needs (an (H, W, 3) uint8 image);
`write_png_batch` writes a batch of them over a thread pool (the
counterpart of the JAX package's native/fast_png.cpp: zlib releases the
GIL while it compresses, so the encodes run in parallel); `read_png` reads
back files of that form (8-bit RGB, non-interlaced, every scanline with
filter type 0) and raises on anything else.
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Sequence, Union

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data)) + kind + data
        + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)
    )


def encode_png(image: np.ndarray, level: int = 6) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"encode_png takes (H, W, 3) uint8, got {image.dtype} {image.shape}")
    h, w, _ = image.shape
    raw = np.empty((h, 1 + 3 * w), np.uint8)
    raw[:, 0] = 0  # filter type 0 on every scanline
    raw[:, 1:] = image.reshape(h, 3 * w)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit, colour type 2 (RGB)
    return (
        _SIGNATURE
        + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
        + _chunk(b"IEND", b"")
    )


def write_png(path: Union[str, Path], image: np.ndarray, level: int = 6) -> None:
    Path(path).write_bytes(encode_png(image, level))


def write_png_batch(images: np.ndarray, paths: Sequence[Union[str, Path]],
                    compression: int = 6, num_threads: int = 0) -> None:
    """Write (N, H, W, 3) uint8 `images` to `paths` (one each), encoded and
    written by `num_threads` threads (0: os.cpu_count()). Each file holds
    the bytes `encode_png(image, compression)` gives. Raises on a length
    mismatch and re-raises any writer's error."""
    if len(images) != len(paths):
        raise ValueError(f"write_png_batch: {len(images)} images for {len(paths)} paths")
    workers = min(num_threads or os.cpu_count() or 1, max(1, len(paths)))
    with ThreadPoolExecutor(workers) as pool:
        for done in [pool.submit(write_png, path, image, compression)
                     for image, path in zip(images, paths)]:
            done.result()


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes (8-bit RGB, filter 0) -> (H, W, 3) uint8."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    header = None
    idat = []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos: pos + 4])
        kind = data[pos + 4: pos + 8]
        body = data[pos + 8: pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, colour, _, _, interlace = header
    if (depth, colour, interlace) != (8, 2, 0):
        raise ValueError(
            f"decode_png reads 8-bit RGB non-interlaced PNGs, got depth {depth}, "
            f"colour type {colour}, interlace {interlace}"
        )
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + 3 * w)
    if raw[:, 0].any():
        raise ValueError("decode_png reads filter type 0 only")
    return raw[:, 1:].reshape(h, w, 3).copy()


def read_png(path: Union[str, Path]) -> np.ndarray:
    return decode_png(Path(path).read_bytes())
