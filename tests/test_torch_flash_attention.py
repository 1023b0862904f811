"""The port's flash attention (ops/attention.py) on the CPU.

The CUDA kernels (csrc/flash_attention.cu) run only on the card, where
chip_smoke.py holds them against the plain version. Here:

* the plain version against the JAX package's route, the Pallas TPU library
  kernel `jax.experimental.pallas.ops.tpu.flash_attention` run in interpret
  mode: outputs within 2e-5 and gradients within 1e-4 of max|ref| (float32;
  the kernel's online softmax and the plain version sum in other orders);
* the autograd Function against autograd through softmax in float64, and
  in bfloat16 within one bfloat16 rounding;
* a numpy emulation of the kernels' tiling (64-row query and key tiles,
  base-2 online softmax, the logsumexp in natural log, masked rows and
  columns past N, D = rowsum(dO * O), the dK / dV pass over query tiles and
  the dQ pass over key tiles) against the plain version at ragged N and
  padded head dims, within 1e-5 of max|ref|;
* the wrappers' checks, which raise before any launch, and the C entries'
  argument counts against the ctypes declarations.
"""

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthesis_in_style_tpu_torch.ops.attention import flash_attention
from synthesis_in_style_tpu_torch.ops.cuda import build
from synthesis_in_style_tpu_torch.ops.cuda import flash_attention as fa
from pallas_interpret import synced_flash_interpret_mode

SOURCE = Path(fa.__file__).resolve().parents[2] / "csrc" / "flash_attention.cu"
TILE = 64
LOG2E = 1.4426950408889634


def _inputs(shape, seed=0):
    rs = np.random.default_rng(seed)
    return [rs.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _naive(q, k, v, scale):
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    return torch.matmul(torch.softmax(s, dim=-1), v)


def test_plain_matches_the_jax_library_kernel_in_interpret_mode(monkeypatch):
    from jax.experimental.pallas.ops.tpu.flash_attention import flash_attention as jax_flash

    q, k, v, t = _inputs((1, 2, 256, 8))
    scale = 1.0 / math.sqrt(8)

    def loss(q_, k_, v_):
        return jnp.sum(jax_flash(q_, k_, v_, sm_scale=scale) * t)

    with synced_flash_interpret_mode(monkeypatch):
        ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   sm_scale=scale))
        ref_grads = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                                      jnp.asarray(v))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = flash_attention(*leaves, sm_scale=scale)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=2e-5)
    (out * torch.from_numpy(t)).sum().backward()
    for leaf, want in zip(leaves, ref_grads):
        want = np.asarray(want)
        err = np.abs(leaf.grad.numpy() - want).max() / np.abs(want).max()
        assert err <= 1e-4, err


@pytest.mark.parametrize("shape", [(2, 3, 70, 16), (1, 2, 128, 80), (1, 1, 5, 128)])
def test_function_matches_softmax_in_float64(shape):
    q, k, v, t = _inputs(shape, seed=1)
    scale = shape[-1] ** -0.5
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = flash_attention(*leaves, sm_scale=scale)
    (out * torch.from_numpy(t)).sum().backward()
    ref_leaves = [torch.from_numpy(a).double().requires_grad_(True) for a in (q, k, v)]
    ref = _naive(*ref_leaves, scale)
    (ref * torch.from_numpy(t).double()).sum().backward()
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert (out.double() - ref).abs().max() <= 1e-5 * ref.abs().max()
    for leaf, ref_leaf in zip(leaves, ref_leaves):
        assert (leaf.grad.double() - ref_leaf.grad).abs().max() <= 1e-5 * ref_leaf.grad.abs().max()


def test_bfloat16_keeps_its_dtype_within_one_rounding():
    q, k, v, t = _inputs((2, 2, 64, 32), seed=2)
    scale = 32 ** -0.5
    leaves = [torch.from_numpy(a).bfloat16().requires_grad_(True) for a in (q, k, v)]
    out = flash_attention(*leaves, sm_scale=scale)
    (out.float() * torch.from_numpy(t)).sum().backward()
    ref_leaves = [leaf.detach().double().requires_grad_(True) for leaf in leaves]
    ref = _naive(*ref_leaves, scale)
    (ref * torch.from_numpy(t).double()).sum().backward()
    assert out.dtype == torch.bfloat16 and all(leaf.grad.dtype == torch.bfloat16 for leaf in leaves)
    assert (out.double() - ref).abs().max() <= 2.0**-7 * ref.abs().max()
    for leaf, ref_leaf in zip(leaves, ref_leaves):
        assert (leaf.grad.double() - ref_leaf.grad).abs().max() <= \
            2.0**-7 * ref_leaf.grad.abs().max()


def test_logsumexp_is_natural_log_in_float32():
    q, k, v, _ = _inputs((1, 2, 33, 8), seed=3)
    o, lse = fa.flash_attention_fwd_plain(*(torch.from_numpy(a) for a in (q, k, v)), 0.5)
    want = torch.logsumexp(torch.from_numpy(q) @ torch.from_numpy(k).transpose(-1, -2) * 0.5, -1)
    assert lse.dtype == torch.float32 and lse.shape == (1, 2, 33)
    torch.testing.assert_close(lse, want)


# ---------------------------------------------------------------------------
# the kernels' tiling, emulated in float32 numpy


def _tile(x, start, n):
    """Rows [start, start + 64) of x, zero rows past n."""
    out = np.zeros((TILE, x.shape[1]), np.float32)
    rows = x[start:min(start + TILE, n)]
    out[:len(rows)] = rows
    return out


def emulate_forward(q, k, v, scale):
    """flash_fwd_kernel for one (batch, head): (N, d) float32 arrays."""
    n, d = q.shape
    o, lse = np.zeros((n, d), np.float32), np.zeros(n, np.float32)
    scale_log2 = np.float32(scale * LOG2E)
    for m0 in range(0, n, TILE):
        qt = _tile(q, m0, n)
        m = np.full(TILE, -np.inf, np.float32)
        l_sum = np.zeros(TILE, np.float32)
        acc = np.zeros((TILE, d), np.float32)
        for n0 in range(0, n, TILE):
            kt, vt = _tile(k, n0, n), _tile(v, n0, n)
            s = (qt @ kt.T) * scale_log2
            s[:, n0 + np.arange(TILE) >= n] = -np.inf
            m_new = np.maximum(m, s.max(1))
            alpha = np.exp2(m - m_new)
            p = np.exp2(s - m_new[:, None])
            l_sum = l_sum * alpha + p.sum(1)
            acc = acc * alpha[:, None] + p @ vt
            m = m_new
        rows = min(TILE, n - m0)
        o[m0:m0 + rows] = (acc / l_sum[:, None])[:rows]
        lse[m0:m0 + rows] = ((m + np.log2(l_sum)) * np.float32(math.log(2)))[:rows]
    return o, lse


def _probs_and_ds(qt, dot, kt, vt, lse2, delta, n0, n, scale_log2):
    s = qt @ kt.T
    p = np.exp2(s * scale_log2 - lse2[:, None])
    p[:, n0 + np.arange(TILE) >= n] = 0.0
    return p, p * (dot @ vt.T - delta[:, None])


def emulate_backward(q, k, v, o, lse, do, scale):
    """flash_bwd_delta, flash_bwd_dkdv and flash_bwd_dq for one (batch,
    head)."""
    n, d = q.shape
    scale_log2 = np.float32(scale * LOG2E)
    delta = (do * o).sum(1).astype(np.float32)
    dq, dk, dv = (np.zeros((n, d), np.float32) for _ in range(3))

    def rows_of(m0):
        valid = m0 + np.arange(TILE) < n
        lse2 = np.full(TILE, np.inf, np.float32)
        dl = np.zeros(TILE, np.float32)
        lse2[valid] = lse[m0 + np.arange(TILE)[valid]] * np.float32(LOG2E)
        dl[valid] = delta[m0 + np.arange(TILE)[valid]]
        return lse2, dl

    for n0 in range(0, n, TILE):  # dK, dV: one block per key tile
        kt, vt = _tile(k, n0, n), _tile(v, n0, n)
        dk_acc, dv_acc = np.zeros((TILE, d), np.float32), np.zeros((TILE, d), np.float32)
        for m0 in range(0, n, TILE):
            qt, dot = _tile(q, m0, n), _tile(do, m0, n)
            p, ds = _probs_and_ds(qt, dot, kt, vt, *rows_of(m0), n0, n, scale_log2)
            dv_acc += p.T @ dot
            dk_acc += ds.T @ qt
        rows = min(TILE, n - n0)
        dk[n0:n0 + rows], dv[n0:n0 + rows] = (dk_acc * scale)[:rows], dv_acc[:rows]
    for m0 in range(0, n, TILE):  # dQ: one block per query tile
        qt, dot = _tile(q, m0, n), _tile(do, m0, n)
        dq_acc = np.zeros((TILE, d), np.float32)
        for n0 in range(0, n, TILE):
            kt, vt = _tile(k, n0, n), _tile(v, n0, n)
            _, ds = _probs_and_ds(qt, dot, kt, vt, *rows_of(m0), n0, n, scale_log2)
            dq_acc += ds @ kt
        rows = min(TILE, n - m0)
        dq[m0:m0 + rows] = (dq_acc * scale)[:rows]
    return dq, dk, dv


@pytest.mark.parametrize("n, d", [(64, 8), (150, 8), (128, 80), (257, 64), (3, 128)])
def test_tiling_emulation_matches_the_plain_version(n, d):
    q, k, v, do = _inputs((n, d), seed=n + d)
    scale = d ** -0.5
    with np.errstate(invalid="ignore", over="ignore"):
        o, lse = emulate_forward(q, k, v, scale)
        grads = emulate_backward(q, k, v, o, lse, do, scale)
    tq, tk, tv, tdo = (torch.from_numpy(a)[None, None] for a in (q, k, v, do))
    ref_o, ref_lse = fa.flash_attention_fwd_plain(tq, tk, tv, scale)
    ref_grads = fa.flash_attention_bwd_plain(tq, tk, tv, ref_o, ref_lse, tdo, scale)
    assert np.isfinite(o).all() and np.isfinite(lse).all()
    np.testing.assert_allclose(o, ref_o[0, 0].numpy(), rtol=0,
                               atol=1e-5 * np.abs(ref_o.numpy()).max())
    np.testing.assert_allclose(lse, ref_lse[0, 0].numpy(), rtol=0, atol=1e-5)
    for got, want in zip(grads, ref_grads):
        want = want[0, 0].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# the wrappers


@pytest.mark.parametrize("fn", ["fwd", "bwd"])
@pytest.mark.parametrize("case, match", [
    ("cpu", "CUDA tensor"), ("float16", "float32 or bfloat16"), ("head_dim", "head dim"),
    ("ndim", r"\(B, heads, N, d\)")])
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(fn, case, match):
    shape = {"head_dim": (1, 1, 8, 129), "ndim": (2, 8, 16)}.get(case, (1, 1, 8, 16))
    dtype = torch.float16 if case == "float16" else torch.float32
    q = torch.zeros(shape, dtype=dtype)
    before = (fa.flash_attention_fwd_cuda.launches, fa.flash_attention_bwd_cuda.launches)
    with pytest.raises(ValueError, match=match):
        if fn == "fwd":
            fa.flash_attention_fwd_cuda(q, q, q, 1.0)
        else:
            fa.flash_attention_bwd_cuda(q, q, q, q, torch.zeros(shape[:-1]), q, 1.0)
    assert (fa.flash_attention_fwd_cuda.launches, fa.flash_attention_bwd_cuda.launches) == before


def test_cpu_calls_never_count_launches():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs((1, 2, 16, 8)))
    before = (fa.flash_attention_fwd_cuda.launches, fa.flash_attention_bwd_cuda.launches)
    leaves = [t.requires_grad_(True) for t in (q, k, v)]
    flash_attention(*leaves).sum().backward()
    assert (fa.flash_attention_fwd_cuda.launches, fa.flash_attention_bwd_cuda.launches) == before


@pytest.mark.parametrize("entry, argtypes", [("sis_flash_attention_fwd", fa._FWD_ARGTYPES),
                                             ("sis_flash_attention_bwd", fa._BWD_ARGTYPES)])
def test_c_entries_take_what_the_wrapper_declares(entry, argtypes):
    source = SOURCE.read_text()
    signature = re.search(rf'extern "C" int {entry}\(([^)]*)\)', source).group(1)
    assert len(signature.split(",")) == len(argtypes)
    assert "flash_attention" in build.KERNEL_SOURCES
