"""The launch geometry of the shared-memory blur-tail kernel
(csrc/fused_blur.cu), computed in Python by `blur_tile_geometry`: every
output column, row and channel vector is covered by one block, a block never
exceeds the kernel's thread bound, and its ring of staged input rows fits the
48 KB of shared memory a launch gets without opting in."""

import math

import pytest

from synthesis_in_style_tpu_torch.ops.cuda.fused_blur import (
    MIN_ROWS,
    THREADS_PER_BLOCK,
    blur_tile_geometry,
)

STAGES = 4  # kStages in csrc/fused_blur.cu
SHAPES = [(8, 512), (16, 512), (32, 512), (64, 512), (128, 256), (256, 128),  # 256px generator
          (1024, 32), (10, 24), (3, 8)]


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("h_out,c", SHAPES)
def test_tiles_cover_the_output(h_out, c, batch, itemsize):
    tile_x, vpp, rows = blur_tile_geometry(batch, h_out, c, itemsize)
    c_vecs = c * itemsize // 16
    assert 1 <= tile_x * vpp <= THREADS_PER_BLOCK
    assert 1 <= tile_x <= h_out and 1 <= vpp <= c_vecs
    assert min(MIN_ROWS, h_out) <= rows <= h_out
    assert math.ceil(h_out / tile_x) * tile_x >= h_out
    assert math.ceil(c_vecs / vpp) * vpp >= c_vecs
    assert STAGES * (tile_x + 3) * vpp * 16 <= 48 * 1024


def test_a_warp_reads_one_contiguous_pixel_run():
    """At the 256px generator's widths a warp's 32 threads hold 32
    consecutive 16-byte channel vectors: 512 contiguous bytes per row."""
    for h_out, c in SHAPES[:6]:
        for itemsize in (4, 2):
            _, vpp, _ = blur_tile_geometry(16, h_out, c, itemsize)
            assert vpp in (16, 32) and (32 % vpp == 0)
