"""The port's fused bias-act (plain version, taken for CPU tensors) against
the JAX package's XLA path and its Pallas kernel in interpret mode.
float32, atol 1e-6: the same three float32 operations in the same order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from synthesis_in_style_tpu.ops.fused_act import fused_leaky_relu as jax_fused_leaky_relu
from synthesis_in_style_tpu.ops.fused_act import scaled_leaky_relu as jax_scaled_leaky_relu
from synthesis_in_style_tpu.ops.pallas.fused_bias_act import fused_leaky_relu_pallas
from synthesis_in_style_tpu_torch.ops.cuda.fused_bias_act import fused_leaky_relu_cuda
from synthesis_in_style_tpu_torch.ops.fused_act import fused_leaky_relu, scaled_leaky_relu

ATOL = 1e-6


@pytest.mark.parametrize("shape", [(4, 33, 16), (16, 64), (2, 8, 8, 24)])
def test_matches_jax_xla_and_pallas(shape):
    rs = np.random.RandomState(0)
    x = rs.randn(*shape).astype(np.float32)
    b = rs.randn(shape[-1]).astype(np.float32)
    got = fused_leaky_relu(torch.from_numpy(x), torch.from_numpy(b)).numpy()
    ref_xla = np.asarray(jax_fused_leaky_relu(jnp.asarray(x), jnp.asarray(b)))
    with pltpu.force_tpu_interpret_mode():
        ref_pallas = np.asarray(fused_leaky_relu_pallas(jnp.asarray(x), jnp.asarray(b)))
    np.testing.assert_allclose(got, ref_xla, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, ref_pallas, atol=ATOL, rtol=0)


def test_without_bias_and_scaled():
    x = np.random.RandomState(1).randn(3, 5, 7).astype(np.float32)
    got = fused_leaky_relu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_fused_leaky_relu(jnp.asarray(x))),
                               atol=ATOL, rtol=0)
    got = scaled_leaky_relu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_scaled_leaky_relu(jnp.asarray(x))),
                               atol=ATOL, rtol=0)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never falls back: a CPU tensor is refused."""
    with pytest.raises(ValueError, match="CUDA"):
        fused_leaky_relu_cuda(torch.zeros(2, 4), torch.zeros(4))
