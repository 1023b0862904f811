"""The port's connected components and component statistics (the plain
versions, taken for CPU tensors) against the JAX package's device_cc on the
CPU. Labels are bit-identical: the minimum-linear-index labelling is the
unique fixpoint, whichever sweep schedule reaches it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthesis_in_style_tpu.segmentation import device_cc as jcc
from synthesis_in_style_tpu_torch.segmentation import device_cc as tcc


def _snake(h, w):
    """A 1-px serpentine: full rows every other row, joined at alternating ends."""
    mask = np.zeros((h, w), bool)
    for row in range(0, h, 2):
        mask[row, :] = True
        if row + 1 < h:
            mask[row + 1, w - 1 if (row // 2) % 2 == 0 else 0] = True
    return mask


def _masks():
    rng = np.random.default_rng(7)
    cases = [(f"random{d}", rng.random((2, 64, 128)) < d) for d in (0.2, 0.45, 0.6)]
    cases.append(("snake", _snake(8, 128)[None]))
    cases.append(("non_aligned", rng.random((3, 37, 53)) < 0.5))
    cases.append(("non_aligned_snake", _snake(37, 53)[None]))
    return cases


# the JAX XLA path takes every shape, its Pallas kernel (8k, 128k) shapes only
CASES = [
    pytest.param(mask, backend, id=f"{name}-{backend}")
    for name, mask in _masks()
    for backend in ("xla", "pallas_interpret")
    if backend == "xla" or (mask.shape[1] % 8 == 0 and mask.shape[2] % 128 == 0)
]


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("mask,backend", CASES)
def test_labels_bit_identical(mask, backend, connectivity):
    ref = np.asarray(jcc.connected_components(jnp.asarray(mask), connectivity=connectivity,
                                              backend=backend))
    got = tcc.connected_components(torch.from_numpy(mask), connectivity=connectivity).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)


def test_unbatched_and_unknown_backend():
    mask = _snake(9, 11)
    ref = np.asarray(jcc.connected_components(jnp.asarray(mask), backend="xla"))
    np.testing.assert_array_equal(tcc.connected_components(torch.from_numpy(mask)).numpy(), ref)
    with pytest.raises(ValueError, match="backend"):
        tcc.connected_components(torch.from_numpy(mask), backend="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        tcc.connected_components(torch.from_numpy(mask), backend="kernel")


def test_fill_holes_and_dilate_cross():
    rng = np.random.default_rng(3)
    mask = rng.random((3, 37, 53)) < 0.55
    np.testing.assert_array_equal(tcc.fill_holes(torch.from_numpy(mask)).numpy(),
                                  np.asarray(jcc.fill_holes(jnp.asarray(mask))))
    np.testing.assert_array_equal(tcc.dilate_cross(torch.from_numpy(mask)).numpy(),
                                  np.asarray(jcc.dilate_cross(jnp.asarray(mask))))


def test_component_statistics():
    rng = np.random.default_rng(4)
    mask = rng.random((2, 24, 40)) < 0.5
    values = rng.random((2, 24, 40)) < 0.3
    jl = jcc.connected_components(jnp.asarray(mask), connectivity=8, backend="xla")
    tl = tcc.connected_components(torch.from_numpy(mask), connectivity=8)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(
        tcc.component_sums(tl, torch.from_numpy(values)).numpy(),
        np.asarray(jcc.component_sums(jl, jnp.asarray(values))))
    np.testing.assert_array_equal(tcc.component_bboxes(tl).numpy(),
                                  np.asarray(jcc.component_bboxes(jl)))
    np.testing.assert_array_equal(tcc.component_areas(tl).numpy(),
                                  np.asarray(jcc.component_areas(jl)))
    np.testing.assert_array_equal(
        tcc.filter_small_components(torch.from_numpy(mask), 4).numpy(),
        np.asarray(jcc.filter_small_components(jnp.asarray(mask), 4)))
