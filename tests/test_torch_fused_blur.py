"""The port's fused blur tail (plain version, taken for CPU tensors) against
the JAX package's Pallas kernel in interpret mode. The JAX kernel takes the
width-padded producer layout; the port takes the logical (B, 2h+1, 2h+1, C)
tensor. float32, atol 1e-4 (as the JAX package's own kernel test: the blur
sums 16 taps in a different order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthesis_in_style_tpu.ops.pallas.fused_blur import (
    blur_demod_noise_bias_act as jax_blur_tail,
    padded_width,
)
from synthesis_in_style_tpu_torch.ops.cuda.fused_blur import (
    blur_demod_noise_bias_act,
    blur_demod_noise_bias_act_cuda,
)

ATOL = 1e-4


def _make_inputs(b, hin, c, seed=0):
    rs = np.random.RandomState(seed)
    wp = padded_width(hin)
    xr = rs.randn(b, hin, hin, c).astype(np.float32)
    xpad = np.zeros((b, hin, wp, c), np.float32)
    xpad[:, :, 1: 1 + hin, :] = xr
    demod = (rs.rand(b, c) + 0.5).astype(np.float32)
    noise = rs.randn(b, hin - 1, hin - 1).astype(np.float32)
    bias = rs.randn(c).astype(np.float32)
    return xr, xpad, demod, noise, bias


@pytest.mark.parametrize("b,hin,c", [(2, 17, 16), (3, 33, 8), (2, 129, 32)])
def test_matches_pallas_interpret(b, hin, c):
    xr, xpad, demod, noise, bias = _make_inputs(b, hin, c)
    ref = np.asarray(jax_blur_tail(jnp.asarray(xpad), jnp.asarray(demod), jnp.asarray(noise),
                                   jnp.asarray(bias), interpret=True))
    got = blur_demod_noise_bias_act(*(torch.from_numpy(a) for a in (xr, demod, noise, bias)))
    assert got.shape == (b, hin - 1, hin - 1, c)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


def test_shared_noise_plane_broadcasts():
    """A (1, 2h, 2h) noise plane (the generator's fixed noise buffer) acts
    like the same plane repeated over the batch."""
    xr, _, demod, noise, bias = _make_inputs(3, 17, 8, seed=1)
    t = [torch.from_numpy(a) for a in (xr, demod, noise[:1], bias)]
    shared = blur_demod_noise_bias_act(*t)
    t[2] = t[2].expand(3, -1, -1).contiguous()
    torch.testing.assert_close(shared, blur_demod_noise_bias_act(*t), rtol=0, atol=0)


def test_kernel_wrapper_refuses_cpu_tensors():
    xr, _, demod, noise, bias = _make_inputs(1, 17, 4)
    with pytest.raises(ValueError, match="CUDA"):
        blur_demod_noise_bias_act_cuda(*(torch.from_numpy(a) for a in (xr, demod, noise, bias)))
