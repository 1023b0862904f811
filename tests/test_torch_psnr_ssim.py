"""The port's PSNR and SSIM (`evaluation/psnr_ssim.py`) against the JAX
package's on the CPU, on seeded NHWC images in [-1, 1], in [0, 1] and a
pair where only one side needs the rescale: `psnr`, `ssim` with windows 5
and 7, and `PSNRSSIMEvaluator` (a batch of one, asserted). Tolerance 1e-5
absolute (dB for PSNR): both compute in float32, in another summation
order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthesis_in_style_tpu.evaluation import psnr_ssim as jax_ps
from synthesis_in_style_tpu_torch.evaluation import psnr_ssim as ps

TOL = 1e-5


def _pair(kind: str, batch: int = 2, size: int = 24, channels: int = 3):
    rs = np.random.RandomState({"signed": 0, "unit": 1, "mixed": 2}[kind])
    target = rs.uniform(-1, 1, (batch, size, size, channels)).astype(np.float32)
    image = np.clip(target + 0.2 * rs.randn(*target.shape), -1, 1).astype(np.float32)
    if kind == "unit":
        image, target = (image + 1) / 2, (target + 1) / 2
    if kind == "mixed":  # only the image is in [-1, 1]
        target = np.clip((target + 1) / 2 + 0.05 * rs.randn(*target.shape), 0, 1).astype(
            np.float32)
    return image, target


@pytest.mark.parametrize("kind", ["signed", "unit", "mixed"])
def test_psnr_matches_jax(kind):
    image, target = _pair(kind)
    want = float(jax_ps.psnr(jnp.asarray(image), jnp.asarray(target)))
    got = float(ps.psnr(torch.from_numpy(image), torch.from_numpy(target)))
    assert abs(got - want) <= TOL, (got, want)
    unnorm = ps.clamp_and_unnormalize(torch.from_numpy(image)).numpy()
    np.testing.assert_allclose(unnorm, np.asarray(jax_ps.clamp_and_unnormalize(
        jnp.asarray(image))), rtol=0, atol=1e-7)


@pytest.mark.parametrize("kind", ["signed", "unit", "mixed"])
@pytest.mark.parametrize("kernel_size", [5, 7])
def test_ssim_matches_jax(kind, kernel_size):
    image, target = _pair(kind)
    want = float(jax_ps.ssim(jnp.asarray(image), jnp.asarray(target), kernel_size))
    got = float(ps.ssim(torch.from_numpy(image), torch.from_numpy(target), kernel_size))
    assert abs(got - want) <= TOL, (got, want)
    # identical images: SSIM 1, PSNR at its 1e-12 floor (120 dB)
    same = torch.from_numpy(target)
    assert abs(float(ps.ssim(same, same, kernel_size)) - 1.0) <= TOL
    assert abs(float(ps.psnr(same, same)) - 120.0) <= TOL


def test_evaluator_matches_jax_and_asserts_a_batch_of_one():
    image, target = _pair("signed", batch=1, size=32)
    ours = ps.PSNRSSIMEvaluator().psnr_and_ssim(torch.from_numpy(image), torch.from_numpy(target))
    theirs = jax_ps.PSNRSSIMEvaluator().psnr_and_ssim(jnp.asarray(image), jnp.asarray(target))
    for got, want in zip(ours, theirs):
        assert abs(float(got) - float(want)) <= TOL, (got, want)
    seven = ps.PSNRSSIMEvaluator(ssim_kernel_size=7).ssim(torch.from_numpy(image),
                                                         torch.from_numpy(target))
    assert abs(float(seven) - float(jax_ps.ssim(jnp.asarray(image), jnp.asarray(target), 7))) \
        <= TOL
    two = torch.from_numpy(np.concatenate([image, image]))
    with pytest.raises(AssertionError, match="Batch size"):
        ps.PSNRSSIMEvaluator().psnr(two, two)
    with pytest.raises(AssertionError, match="Batch size"):
        ps.PSNRSSIMEvaluator().ssim(two, two)


def test_ssim_in_float64_is_the_float32_metric_without_its_rounding():
    """float64 inputs compute the same SSIM in float64: within the
    float32 metric's own rounding of the JAX value, and of a float64 numpy
    SSIM of the same formula to 1e-12."""
    from scipy import ndimage

    image, target = _pair("unit", batch=1, size=20)
    got = float(ps.ssim(torch.from_numpy(image).double(), torch.from_numpy(target).double()))
    assert abs(got - float(jax_ps.ssim(jnp.asarray(image), jnp.asarray(target)))) <= TOL
    coords = np.arange(5) - 2.0
    g = np.exp(-coords**2 / (2 * 1.5**2))
    g /= g.sum()
    window = np.outer(g, g)

    def filt(x):
        return np.stack([ndimage.correlate(x[..., c], window, mode="constant")[2:-2, 2:-2]
                         for c in range(x.shape[-1])], axis=-1)

    x, y = image[0].astype(np.float64), target[0].astype(np.float64)
    mx, my = filt(x), filt(y)
    sx, sy, sxy = filt(x * x) - mx**2, filt(y * y) - my**2, filt(x * y) - mx * my
    c1, c2 = 0.01**2, 0.03**2
    ref = np.mean((2 * mx * my + c1) * (2 * sxy + c2) / ((mx**2 + my**2 + c1) * (sx + sy + c2)))
    assert abs(got - ref) <= 1e-12, (got, ref)
