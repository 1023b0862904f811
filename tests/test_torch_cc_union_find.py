"""The rules of the union-find connected-components kernel
(synthesis_in_style_tpu_torch/csrc/segmented_cc.cu), emulated on the CPU and
held against the JAX package's connected_components (XLA route): labels
bit-identical, 4- and 8-connected, tile sides 4 and 8, on the masks of
tests/test_torch_device_cc.py.

The kernel cannot run without a card, so the emulation follows its rules:
  1. per tile: link each row run to its first pixel, then union a pixel with
     the row above where `_links` says so (the first pixel of each overlap
     between runs); each pixel's parent becomes its tile-local root;
  2. across tile edges, the same rule: a tile's top row against the row
     above, its left column against the column to the left (the pixel
     before x counts only inside the tile);
  3. label = root of the pixel.
A union links the larger root under the smaller with a min-update and
retries when the larger root was linked elsewhere meanwhile. On the card
the threads of a phase run in any order and interleave: here each union is
a coroutine that yields at every access to the shared parents (the
min-update is one indivisible step, as atomicMin is), and the coroutines of
a phase are stepped in an order drawn from a seed. The local phase keeps
image-wide indices where the kernel keeps tile-local ones: both orders are
the image's row-major order, so the roots are the same pixels.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthesis_in_style_tpu.segmentation import device_cc as jcc
from synthesis_in_style_tpu_torch.segmentation import device_cc as tcc
from test_torch_device_cc import _masks, _snake

MASKS = dict(_masks())
_JAX_LABELS = {}


def _jax_labels(name, connectivity):
    key = (name, connectivity)
    if key not in _JAX_LABELS:
        _JAX_LABELS[key] = np.asarray(jcc.connected_components(
            jnp.asarray(MASKS[name]), connectivity=connectivity, backend="xla"))
    return _JAX_LABELS[key]


def _find(parent, x):
    p = parent[x]
    yield
    while p != x:
        x = p
        p = parent[x]
        yield
    return x


def _unite(parent, a, b):
    while True:
        a = yield from _find(parent, a)
        b = yield from _find(parent, b)
        if a == b:
            return
        if a > b:
            a, b = b, a
        old = parent[b]  # atomicMin(&parent[b], a)
        parent[b] = min(old, a)
        yield
        if old == b:
            return
        b = old


def _root(parent, x):
    while parent[x] != x:
        x = parent[x]
    return x


def _run_interleaved(coroutines, rng, width=32):
    """Step up to `width` coroutines at once, a random one each step."""
    pending = list(coroutines)
    rng.shuffle(pending)
    active = []
    while pending or active:
        while pending and len(active) < width:
            active.append(pending.pop())
        i = rng.randrange(len(active))
        try:
            next(active[i])
        except StopIteration:
            active[i] = active[-1]
            active.pop()


def _links(a, b, c, d, connectivity):
    """(join b, join a, join c) for a pixel x: b the neighbour across the
    line, a / c the diagonal ones before / after it, d the pixel before x
    in its own run (the kernel's `links`)."""
    if b:
        return not (a and d), False, False
    if connectivity != 8:
        return False, False, False
    return False, a and not d, c


def union_find_labels(mask, connectivity, tile, rng):
    """(H, W) bool -> (H, W) labels by the kernel's rules, its threads
    interleaved in an order drawn from `rng`."""
    h, w = mask.shape

    def fg(y, x):
        return 0 <= y < h and 0 <= x < w and bool(mask[y, x])

    parent = [-1] * (h * w)
    tiles = [(ty, tx) for ty in range(0, h, tile) for tx in range(0, w, tile)]
    rng.shuffle(tiles)
    for ty, tx in tiles:  # 1. local merge, one tile ("block") at a time

        def in_tile(y, x, ty=ty, tx=tx):
            return ty <= y < ty + tile and tx <= x < tx + tile and fg(y, x)

        local = {}
        for y in range(ty, min(ty + tile, h)):
            for x in range(tx, min(tx + tile, w)):
                if fg(y, x):
                    start = x
                    while in_tile(y, start - 1):
                        start -= 1
                    local[y * w + x] = y * w + start
        unions = []
        for y in range(ty + 1, min(ty + tile, h)):
            for x in range(tx, min(tx + tile, w)):
                if not fg(y, x):
                    continue
                joins = _links(in_tile(y - 1, x - 1), in_tile(y - 1, x), in_tile(y - 1, x + 1),
                               in_tile(y, x - 1), connectivity)
                for join, n in zip(joins, ((y - 1) * w + x, (y - 1) * w + x - 1,
                                           (y - 1) * w + x + 1)):
                    if join:
                        unions.append(_unite(local, y * w + x, n))
        _run_interleaved(unions, rng)
        for i in local:
            parent[i] = _root(local, i)

    unions = []  # 2. boundary merge, all tiles' threads together
    for ty, tx in tiles:
        for top in (True, False):
            for k in range(tile):
                y, x = (ty, tx + k) if top else (ty + k, tx)
                if y >= h or x >= w or (y == 0 if top else x == 0) or not fg(y, x):
                    continue
                ay, ax = (y - 1, x) if top else (y, x - 1)
                sy, sx = (0, 1) if top else (1, 0)
                joins = _links(fg(ay - sy, ax - sx), fg(ay, ax), fg(ay + sy, ax + sx),
                               k > 0 and fg(y - sy, x - sx), connectivity)
                for join, (ny, nx) in zip(joins, ((ay, ax), (ay - sy, ax - sx),
                                                  (ay + sy, ax + sx))):
                    if join:
                        unions.append(_unite(parent, y * w + x, ny * w + nx))
    _run_interleaved(unions, rng)

    labels = [_root(parent, i) if parent[i] >= 0 else -1 for i in range(h * w)]  # 3. flatten
    return np.asarray(labels, np.int32).reshape(h, w)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("tile", [4, 8])
@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("name", sorted(MASKS))
def test_union_find_rules_match_jax(name, connectivity, tile, seed):
    rng = random.Random(seed)
    got = np.stack([union_find_labels(m, connectivity, tile, rng) for m in MASKS[name]])
    np.testing.assert_array_equal(got, _jax_labels(name, connectivity))


@pytest.mark.parametrize("connectivity", [4, 8])
def test_full_and_checkerboard_tiles(connectivity):
    """Adversarial tiles: all foreground (one component, label 0) and a
    checkerboard (joined only diagonally, so one component under 8 and
    isolated pixels under 4), across ragged tiles."""
    full = np.ones((13, 21), bool)
    ys, xs = np.mgrid[:13, :21]
    checker = (ys + xs) % 2 == 0
    for mask in (full, checker, _snake(13, 21)):
        got = union_find_labels(mask, connectivity, 4, random.Random(5))
        ref = np.asarray(jcc.connected_components(jnp.asarray(mask), connectivity=connectivity,
                                                  backend="xla"))
        np.testing.assert_array_equal(got, ref)
    assert (union_find_labels(full, connectivity, 4, random.Random(6)) == 0).all()


def test_options_are_keyword_only():
    """The JAX function's positional order is (mask, max_iters,
    connectivity): the port takes both by keyword only, so a positional call
    cannot mean different things in the two packages. max_iters is accepted
    and changes nothing (both routes reach the fixpoint)."""
    mask = torch.from_numpy(_snake(9, 11))
    with pytest.raises(TypeError):
        tcc.connected_components(mask, 8)
    np.testing.assert_array_equal(
        tcc.connected_components(mask, connectivity=8, max_iters=1).numpy(),
        tcc.connected_components(mask, connectivity=8).numpy())
