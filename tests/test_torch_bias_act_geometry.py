"""The launch geometry of the fused bias-act forward kernel
(csrc/fused_bias_act.cu), computed in Python by `bias_act_geometry`, and a
numpy emulation of how the kernel partitions the (R, C) rows among its
threads: every element is written exactly once, each element's bias index
is its channel, a block never exceeds the kernel's __launch_bounds__, and
the vector width is 1 exactly when C or a pointer forbids 16-byte access."""

import math
import re
from pathlib import Path

import numpy as np
import pytest

from synthesis_in_style_tpu_torch.ops.cuda import build
from synthesis_in_style_tpu_torch.ops.cuda import fused_bias_act as mod
from synthesis_in_style_tpu_torch.ops.cuda.fused_bias_act import (
    THREADS_PER_BLOCK,
    bias_act_geometry,
)

SOURCE = (Path(build.CSRC) / "fused_bias_act.cu").read_text()
KERNEL_THREADS = int(re.search(r"#define SIS_BIAS_ACT_THREADS (\d+)", SOURCE).group(1))
KERNEL_UNROLL = int(re.search(r"#define SIS_BIAS_ACT_UNROLL (\d+)", SOURCE).group(1))

# generator_channels(2) of the 256px model
CHANNELS = {4: 512, 8: 512, 16: 512, 32: 512, 64: 512, 128: 256, 256: 128}
# every forward shape of the 256px generator and discriminator at batch 16
# (mapping MLP and final linear (16, 512); one activation per resolution),
# and the path-length batch of 8
PATH_SHAPES = ([(16, 512), (8, 512)] + [(16, r, r, c) for r, c in CHANNELS.items()]
               + [(8, 256, 256, 128), (8, 8, 8, 512)])
EDGE_SHAPES = [(37, 3), (1000, 8), (33, 509), (129, 512), (3,), (0, 8), (2, 5, 7, 24)]


def emulate(numel, c, vec, threads, rows_per_step, grid, unroll=KERNEL_UNROLL):
    """Run the kernel's thread partition: returns the number of writes of
    each element (per `vec`-wide vector) and checks, for every write, that
    the vector lies in one row and that its bias index (the thread's
    column) is the element's channel."""
    rows = numel // c
    c_vecs = c // vec
    t = np.arange(grid * threads, dtype=np.int64)
    row0 = t // c_vecs
    live = (row0 < rows_per_step) & (row0 < rows)
    t, row0 = t[live], row0[live]
    col = (t - row0 * c_vecs) * vec
    assert (col + vec <= c).all()
    counts = np.zeros(numel // vec, dtype=np.uint8)
    n, step = rows * c, rows_per_step * c
    off = row0 * c + col
    first = True
    while off.size:
        for u in range(unroll):
            o = off + u * step
            keep = o < n
            o, col_u = o[keep], col[keep]
            if first:  # later steps are this one shifted: no thread writes twice
                assert np.unique(o).size == o.size
                first = False
            assert (o % c == col_u).all(), "bias index is not the channel"
            counts[o // vec] += 1
        off = off + unroll * step
        keep = off < n
        off, col = off[keep], col[keep]
    return counts


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("x_offset", [0, 1], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("shape", PATH_SHAPES + EDGE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_partition_writes_every_element_once(shape, x_offset, itemsize):
    numel, c = math.prod(shape), shape[-1]
    x_ptr = 1 << 20 | x_offset * itemsize  # one element past a 16-byte boundary
    vec, threads, rows_per_step, grid = bias_act_geometry(numel, c, itemsize, x_ptr, 1 << 21)
    assert THREADS_PER_BLOCK == KERNEL_THREADS
    assert 32 <= threads <= KERNEL_THREADS and threads % 32 == 0
    forbids = x_offset != 0 or (c * itemsize) % 16 != 0
    if numel:
        assert vec == (1 if forbids else 16 // itemsize)
        assert c % vec == 0
        live = rows_per_step * (c // vec)
        assert 1 <= rows_per_step <= numel // c
        assert (grid - 1) * threads < live <= grid * threads  # the C entry's check
    counts = emulate(numel, c, vec, threads, rows_per_step, grid)
    assert (counts == 1).all()


def test_small_calls_spread_over_the_sms():
    """(16, 512) bfloat16 is 1024 live threads: whole-warp blocks on 32 SMs,
    not two full blocks on two."""
    vec, threads, rows_per_step, grid = bias_act_geometry(16 * 512, 512, 2, 0, 0)
    assert (vec, threads, rows_per_step, grid) == (8, 32, 16, 32)
    _, threads, _, grid = bias_act_geometry(16 * 4 * 4 * 512, 512, 2, 0, 0)
    assert threads < THREADS_PER_BLOCK and grid <= 132


def test_misaligned_output_also_takes_the_scalar_route():
    assert bias_act_geometry(16 * 512, 512, 2, 0, 2)[0] == 1
    assert bias_act_geometry(16 * 512, 512, 2, 0, 16)[0] == 8


def test_main_shape_grid_is_cut_and_threads_walk_rows():
    """At (16, 256, 256, 128) the grid is cut to TARGET_BLOCKS_PER_SM blocks
    for each of 132 SMs, and each thread walks several rows: one placement,
    then adds."""
    for itemsize in (4, 2):
        vec, threads, rows_per_step, grid = bias_act_geometry(
            16 * 256 * 256 * 128, 128, itemsize, 0, 0)
        assert vec == 16 // itemsize
        assert grid == 132 * mod.TARGET_BLOCKS_PER_SM
        assert (16 * 256 * 256) // rows_per_step >= 4


def test_geometry_is_cached_on_alignment_not_pointers():
    """Every tensor has its own pointers; the cache must still hit."""
    bias_act_geometry(16 * 512, 512, 4, 0, 0)
    hits = mod._geometry.cache_info().hits
    for ptr in range(0, 16 * 64, 16):
        bias_act_geometry(16 * 512, 512, 4, ptr, 1 << 20)
    assert mod._geometry.cache_info().hits >= hits + 64
