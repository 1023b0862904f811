"""`utils/png.write_png_batch` (a thread pool over zlib) against the port's
one-thread `encode_png` and the JAX package's native multi-threaded writer
(`synthesis_in_style_tpu.native`, built with g++ on first use): the same
zlib at the same level gets the same filter-0 scanlines, so every file is
byte-equal. Also the dataset CLI's `save_generated_images` layout through
it, and its errors."""

from pathlib import Path

import numpy as np
import pytest

from synthesis_in_style_tpu.native import encode_png as native_encode_png
from synthesis_in_style_tpu.native import write_png_batch as native_write_png_batch
from synthesis_in_style_tpu_torch.utils.dataset_creation import save_generated_images
from synthesis_in_style_tpu_torch.utils.png import encode_png, read_png, write_png_batch


def _images(n=6, h=37, w=53, seed=0):
    rs = np.random.default_rng(seed)
    images = rs.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    images[:, : h // 2] //= 32  # compressible rows too
    return images


@pytest.mark.parametrize("num_threads", [0, 1, 3, 16])
@pytest.mark.parametrize("compression", [1, 6, 9])
def test_batch_files_equal_both_encoders(tmp_path, compression, num_threads):
    images = _images()
    paths = [tmp_path / f"{i}.png" for i in range(len(images))]
    write_png_batch(images, paths, compression=compression, num_threads=num_threads)
    for image, path in zip(images, paths):
        data = path.read_bytes()
        assert data == encode_png(image, compression)
        assert data == native_encode_png(image, compression)
        np.testing.assert_array_equal(read_png(path), image)


def test_batch_equals_the_native_batch_writer(tmp_path):
    images = _images(n=9, h=64, w=128, seed=1)
    ours = [tmp_path / f"ours_{i}.png" for i in range(len(images))]
    theirs = [tmp_path / f"native_{i}.png" for i in range(len(images))]
    write_png_batch(images, ours)
    assert native_write_png_batch(images, theirs)
    for a, b in zip(ours, theirs):
        assert a.read_bytes() == b.read_bytes()


def test_save_generated_images_writes_the_sharded_pairs(tmp_path):
    images, labels = _images(n=4, seed=2), _images(n=4, seed=3)
    save_generated_images(images, labels, 998, tmp_path, 5000)
    for idx in range(4):
        image_id = 998 + idx
        path = Path(tmp_path) / "0" / str(image_id // 1000) / f"{image_id:04d}.png"
        np.testing.assert_array_equal(read_png(path),
                                      np.concatenate([images[idx], labels[idx]], axis=1))


def test_batch_errors(tmp_path):
    images = _images(n=2)
    with pytest.raises(ValueError):
        write_png_batch(images, [tmp_path / "a.png"])
    with pytest.raises(FileNotFoundError):
        write_png_batch(images, [tmp_path / "a.png", tmp_path / "missing" / "b.png"])
