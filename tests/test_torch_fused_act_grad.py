"""First- and second-order gradients of the port's fused ops (their autograd
Functions, plain versions on the CPU) against JAX.

* FusedLeakyReLUFunction: first order against jax.grad through
  `fused_leaky_relu_pallas` (its custom VJP runs the Pallas `_bwd_kernel`,
  here in interpret mode) and through the XLA `fused_leaky_relu`; second
  order (the gradient of a function of the first gradient, as in R1)
  against jax.grad of jax.grad through the XLA path. float32, atol 1e-5:
  the same elementwise products, and bias sums of a few hundred terms
  taken in another order.
* FusedBlurTailFunction: against jax.vjp of `blur_demod_noise_bias_act(...,
  interpret=True)` (whose AD rule is plain XLA) on the width-padded input
  the JAX kernel takes; the gradient of that input is compared on its
  logical columns. Second order through the same JAX op. float32, atol
  1e-4 (as the JAX package's own blur test: 16 taps summed in another
  order).
* bfloat16: one rounding of the result each, so 2^-7 of the largest
  reference value.
* upfirdn2d (an autograd Function whose backward is upfirdn2d again):
  first and second order against JAX's upfirdn2d, float32, atol 1e-5.
* gradcheck / gradgradcheck in float64 on the Functions' plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from synthesis_in_style_tpu.ops.fused_act import fused_leaky_relu as jax_fused_leaky_relu
from synthesis_in_style_tpu.ops.pallas.fused_bias_act import fused_leaky_relu_pallas
from synthesis_in_style_tpu.ops.upfirdn2d import upfirdn2d as jax_upfirdn2d
from synthesis_in_style_tpu.ops.pallas.fused_blur import (
    blur_demod_noise_bias_act as jax_blur_tail,
    padded_width,
)
from synthesis_in_style_tpu_torch.ops.cuda.fused_bias_act import fused_leaky_relu_bwd_cuda
from synthesis_in_style_tpu_torch.ops.cuda.fused_blur import blur_demod_noise_bias_act
from synthesis_in_style_tpu_torch.ops.fused_act import (
    FusedLeakyReLUFunction,
    fused_leaky_relu,
    scaled_leaky_relu,
)
from synthesis_in_style_tpu_torch.ops.upfirdn2d import make_kernel, upfirdn2d
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ACT_ATOL = 1e-5
BLUR_ATOL = 1e-4
BF16_REL = 2.0**-7


def _t(a, requires_grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(requires_grad)


def _bias_act_inputs(shape, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(*s).astype(np.float32) for s in (shape, shape[-1:], shape)]


@pytest.mark.parametrize("shape", [(4, 33, 16), (16, 64), (2, 8, 8, 24)])
def test_bias_act_first_order_matches_pallas_and_xla(shape):
    x, b, w = _bias_act_inputs(shape)

    def loss(act):
        return lambda x, b: jnp.sum(act(x, b) * w)

    with pltpu.force_tpu_interpret_mode():
        ref_pallas = jax.grad(loss(fused_leaky_relu_pallas), argnums=(0, 1))(x, b)
    ref_xla = jax.grad(loss(jax_fused_leaky_relu), argnums=(0, 1))(x, b)

    xt, bt = _t(x, True), _t(b, True)
    (fused_leaky_relu(xt, bt) * _t(w)).sum().backward()
    for got, ref in ((xt.grad, ref_pallas[0]), (bt.grad, ref_pallas[1]),
                     (xt.grad, ref_xla[0]), (bt.grad, ref_xla[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ACT_ATOL, rtol=0)


@pytest.mark.parametrize("shape", [(4, 33, 16), (2, 8, 8, 24)])
def test_bias_act_second_order_matches_xla(shape):
    """R = sum(v * dL/dx ^ 2) + sum(u * dL/db) with L = sum(act(x, b) * t):
    its gradient with respect to t goes through the double backward of both
    the dx and the db output; those with respect to x and b are 0 (the mask
    is piecewise constant)."""
    x, b, t = _bias_act_inputs(shape, seed=1)
    rs = np.random.RandomState(2)
    v = rs.randn(*shape).astype(np.float32)
    u = rs.randn(shape[-1]).astype(np.float32)

    def r_jax(x, b, t):
        gx, gb = jax.grad(lambda x, b: jnp.sum(jax_fused_leaky_relu(x, b) * t), (0, 1))(x, b)
        return jnp.sum(v * gx**2) + jnp.sum(u * gb)

    ref = jax.grad(r_jax, argnums=(0, 1, 2))(x, b, t)

    xt, bt, tt = _t(x, True), _t(b, True), _t(t, True)
    gx, gb = torch.autograd.grad((fused_leaky_relu(xt, bt) * tt).sum(), (xt, bt),
                                 create_graph=True)
    r = (_t(v) * gx**2).sum() + (_t(u) * gb).sum()
    got = torch.autograd.grad(r, (xt, bt, tt), allow_unused=True)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), atol=ACT_ATOL, rtol=0)
    for g, rr in zip(got[:2], ref[:2]):
        assert not np.any(np.asarray(rr))
        assert g is None or not g.any()


def test_bias_act_bfloat16_matches_pallas():
    x, b, w = _bias_act_inputs((4, 16, 32), seed=3)
    xb, bb, wb = (jnp.asarray(a, jnp.bfloat16) for a in (x, b, w))
    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(lambda x, b: jnp.sum((fused_leaky_relu_pallas(x, b) * wb)
                                            .astype(jnp.float32)), (0, 1))(xb, bb)
    xt = _t(np.asarray(xb.astype(jnp.float32))).bfloat16().requires_grad_()
    bt = _t(np.asarray(bb.astype(jnp.float32))).bfloat16().requires_grad_()
    wt = _t(np.asarray(wb.astype(jnp.float32))).bfloat16()
    (fused_leaky_relu(xt, bt) * wt).float().sum().backward()
    assert xt.grad.dtype == torch.bfloat16 and bt.grad.dtype == torch.bfloat16
    for got, r in ((xt.grad, ref[0]), (bt.grad, ref[1])):
        r = np.asarray(r.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), r, rtol=0,
                                   atol=BF16_REL * np.abs(r).max())


def test_bias_act_gradcheck_float64():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 4, 5), dtype=torch.float64, generator=g, requires_grad=True)
    b = torch.randn((5,), dtype=torch.float64, generator=g, requires_grad=True)
    fn = lambda x, b: FusedLeakyReLUFunction.apply(x, b, 0.2, 2**0.5)  # noqa: E731
    assert torch.autograd.gradcheck(fn, (x, b))
    assert torch.autograd.gradgradcheck(fn, (x, b))
    assert torch.autograd.gradgradcheck(scaled_leaky_relu, (x,))


def test_backward_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        fused_leaky_relu_bwd_cuda(torch.zeros(2, 4), torch.zeros(2, 4))


# ---------------------------------------------------------------------------
# fused blur tail


def _blur_inputs(b, hin, c, seed=0, shared_noise=False):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, hin, hin, c).astype(np.float32)
    xpad = np.zeros((b, hin, padded_width(hin), c), np.float32)
    xpad[:, :, 1:1 + hin, :] = x
    demod = (rs.rand(b, c) + 0.5).astype(np.float32)
    noise = rs.randn(1 if shared_noise else b, hin - 1, hin - 1).astype(np.float32)
    bias = rs.randn(c).astype(np.float32)
    cot = rs.randn(b, hin - 1, hin - 1, c).astype(np.float32)
    return x, xpad, demod, noise, bias, cot


def _jax_blur(xpad, demod, noise, bias):
    noise = jnp.broadcast_to(noise, (xpad.shape[0],) + noise.shape[1:])
    return jax_blur_tail(xpad, demod, noise, bias, (0.25, 0.75, 0.75, 0.25), 0.2, 2**0.5, True)


@pytest.mark.parametrize("b,hin,c,shared", [(2, 17, 8, False), (3, 17, 4, True),
                                            (2, 33, 8, True)])
def test_blur_tail_first_order_matches_jax_vjp(b, hin, c, shared):
    """A shared (1, H, W) noise plane is held against JAX's (B, H, W)
    gradient summed over the batch."""
    x, xpad, demod, noise, bias, cot = _blur_inputs(b, hin, c, shared_noise=shared)
    _, vjp = jax.vjp(_jax_blur, *(jnp.asarray(a) for a in (xpad, demod, noise, bias)))
    r_x, r_demod, r_noise, r_bias = (np.asarray(g) for g in vjp(jnp.asarray(cot)))

    ins = [_t(a, True) for a in (x, demod, noise, bias)]
    (blur_demod_noise_bias_act(*ins) * _t(cot)).sum().backward()
    np.testing.assert_allclose(ins[0].grad.numpy(), r_x[:, :, 1:1 + hin, :],
                               atol=BLUR_ATOL, rtol=0)
    np.testing.assert_allclose(ins[1].grad.numpy(), r_demod, atol=BLUR_ATOL, rtol=0)
    assert ins[2].grad.shape == noise.shape
    np.testing.assert_allclose(ins[2].grad.numpy(), r_noise, atol=BLUR_ATOL, rtol=0)
    np.testing.assert_allclose(ins[3].grad.numpy(), r_bias, atol=BLUR_ATOL, rtol=0)


def test_blur_tail_second_order_matches_jax():
    """R = sum(v * dL/dx ^ 2) + sum(u * dL/ddemod), L = sum(tail * t): its
    gradient with respect to x, demod and t (the path-length pattern)."""
    x, xpad, demod, noise, bias, t = _blur_inputs(2, 17, 4, seed=4)
    rs = np.random.RandomState(5)
    v = rs.randn(*x.shape).astype(np.float32)
    vpad = np.zeros_like(xpad)
    vpad[:, :, 1:18, :] = v
    u = rs.randn(*demod.shape).astype(np.float32)

    def r_jax(xpad, demod, t):
        gx, gd = jax.grad(lambda xp, d: jnp.sum(_jax_blur(xp, d, noise, bias) * t),
                          (0, 1))(xpad, demod)
        return jnp.sum(vpad * gx**2) + jnp.sum(u * gd)

    r_x, r_demod, r_t = (np.asarray(g) for g in jax.grad(r_jax, (0, 1, 2))(xpad, demod, t))

    xt, dt, tt = _t(x, True), _t(demod, True), _t(t, True)
    gx, gd = torch.autograd.grad((blur_demod_noise_bias_act(xt, dt, _t(noise), _t(bias)) * tt)
                                 .sum(), (xt, dt), create_graph=True)
    r = (_t(v) * gx**2).sum() + (_t(u) * gd).sum()
    g_x, g_d, g_t = torch.autograd.grad(r, (xt, dt, tt))
    np.testing.assert_allclose(g_x.numpy(), r_x[:, :, 1:18, :], atol=BLUR_ATOL, rtol=0)
    np.testing.assert_allclose(g_d.numpy(), r_demod, atol=BLUR_ATOL, rtol=0)
    np.testing.assert_allclose(g_t.numpy(), r_t, atol=BLUR_ATOL, rtol=0)


def test_blur_tail_bfloat16_first_order():
    """bfloat16 x: the port computes in float32 and rounds once per stage,
    so it is held against JAX in float32 on the same bfloat16-valued x and
    cotangent (JAX's own bfloat16 composition rounds the pre-activation and
    flips the mask of values near 0)."""
    x, xpad, demod, noise, bias, cot = _blur_inputs(2, 17, 8, seed=6)
    bf16 = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    xpad, cot = bf16(xpad), bf16(cot)
    _, vjp = jax.vjp(lambda xp, d: _jax_blur(xp, d, noise, bias), jnp.asarray(xpad),
                     jnp.asarray(demod))
    r_x, r_demod = (np.asarray(g) for g in vjp(jnp.asarray(cot)))
    xt = _t(xpad[:, :, 1:18, :].copy()).bfloat16().requires_grad_()
    dt = _t(demod, True)
    (blur_demod_noise_bias_act(xt, dt, _t(noise), _t(bias)).float() * _t(cot)).sum().backward()
    assert xt.grad.dtype == torch.bfloat16 and dt.grad.dtype == torch.float32
    for got, r in ((xt.grad.float().numpy(), r_x[:, :, 1:18, :]), (dt.grad.numpy(), r_demod)):
        np.testing.assert_allclose(got, r, rtol=0, atol=BF16_REL * np.abs(r).max())


@pytest.mark.parametrize("shared", [False, True])
def test_blur_tail_gradcheck_float64(shared):
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 9, 9, 3), dtype=torch.float64, generator=g, requires_grad=True)
    demod = (torch.rand((2, 3), dtype=torch.float64, generator=g) + 0.5).requires_grad_()
    noise = torch.randn((1 if shared else 2, 8, 8), dtype=torch.float64, generator=g,
                        requires_grad=True)
    bias = torch.randn((3,), dtype=torch.float64, generator=g, requires_grad=True)
    args = (x, demod, noise, bias)
    assert torch.autograd.gradcheck(blur_demod_noise_bias_act, args)
    assert torch.autograd.gradgradcheck(blur_demod_noise_bias_act, args)


# ---------------------------------------------------------------------------
# upfirdn2d


@pytest.mark.parametrize("up,down,pad", [(1, 1, (2, 2)), (2, 1, (2, 1)), (1, 2, (1, 1)),
                                         (2, 2, (1, 2))])
def test_upfirdn2d_gradients_match_jax(up, down, pad):
    """First order: the adjoint; second order: R = sum(v * (dL/dx)^2) with
    L = sum(upfirdn2d(x)^2 * t), differentiated with respect to x and t."""
    rs = np.random.RandomState(7)
    x = rs.randn(2, 9, 11, 3).astype(np.float32)
    kernel = np.asarray(make_kernel([1, 3, 3, 1]))
    out_shape = jax_upfirdn2d(jnp.asarray(x), jnp.asarray(kernel), up=up, down=down,
                              pad=pad).shape
    t = rs.randn(*out_shape).astype(np.float32)
    v = rs.randn(*x.shape).astype(np.float32)

    def r_jax(x, t):
        gx = jax.grad(lambda x: jnp.sum(jax_upfirdn2d(x, kernel, up=up, down=down,
                                                      pad=pad) ** 2 * t))(x)
        return jnp.sum(v * gx**2)

    ref = jax.grad(r_jax, (0, 1))(x, t)
    xt, tt = _t(x, True), _t(t, True)
    (gx,) = torch.autograd.grad((upfirdn2d(xt, _t(kernel), up, down, pad) ** 2 * tt).sum(), xt,
                                create_graph=True)
    got = torch.autograd.grad((_t(v) * gx**2).sum(), (xt, tt))
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-5 * max(1.0, np.abs(r).max()))


def test_upfirdn2d_gradcheck_float64():
    g = torch.Generator().manual_seed(2)
    x = torch.randn((2, 7, 9, 3), dtype=torch.float64, generator=g, requires_grad=True)
    kernel = torch.rand((3, 4), dtype=torch.float64, generator=g)
    for up, down, pad in ((2, 1, (2, 1)), (1, 2, (1, 1)), (3, 2, (2, 1, 0, 3))):
        fn = lambda x: upfirdn2d(x, kernel, up, down, pad)  # noqa: E731
        assert torch.autograd.gradcheck(fn, (x,))
        assert torch.autograd.gradgradcheck(fn, (x,))
