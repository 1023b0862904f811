"""The port's flash attention (ops/attention.py) on the CPU.

The CUDA kernels (csrc/flash_attention.cu) run only on the card, where
chip_smoke.py holds them against the plain version. Here:

* the plain version against the JAX package's route, the Pallas TPU library
  kernel `jax.experimental.pallas.ops.tpu.flash_attention` run in interpret
  mode (in a child process that dispatches synchronously:
  tests/pallas_interpret.py says why): in float32 outputs within 2e-5 and
  gradients within 1e-4 of max|ref| (the kernel's online softmax and the
  plain version sum in other orders); in bfloat16 within 2^-7 of max|ref|,
  and with at most a quarter of the elements differing at all, which holds
  only because both round P and dS to bfloat16 in the same places (without
  those roundings 37-46 % differ);
* the autograd Function against autograd through softmax in float64, and
  in bfloat16 within one bfloat16 rounding;
* a numpy emulation of the float32 kernels' tiling (64-row query and key
  tiles, base-2 online softmax, the logsumexp in natural log, masked rows
  and columns past N, D = rowsum(dO * O), the dK / dV pass over query
  tiles and the dQ pass over key tiles) against the plain version at
  ragged N and padded head dims, within 1e-5 of max|ref|;
* a numpy emulation of the bfloat16 tensor-core kernels' tiling (128-row
  query blocks, 128- or 64-key tiles, d padded to 64 or 128, the dK / dV
  pass's 32-row query tiles and the dQ pass's 64-key tiles, P and dS
  rounded to bfloat16) against the plain version within 2^-7 of max|ref|,
  and the plain version's bfloat16 roundings written out;
* the wrappers' checks, which raise before any launch (a bfloat16 head dim
  not a multiple of 8 too), and the C entries' argument counts against the
  ctypes declarations.
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
from pallas_interpret import run_in_sync_child

SOURCE = Path(fa.__file__).resolve().parents[2] / "csrc" / "flash_attention.cu"
TILE = 64
LOG2E = 1.4426950408889634


def _inputs(shape, seed=0):
    rs = np.random.default_rng(seed)
    return [rs.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _naive(q, k, v, scale):
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    return torch.matmul(torch.softmax(s, dim=-1), v)


def _jax_library_flash(q, k, v, t, scale, dtype):
    """jax's Pallas TPU flash attention (run by `run_in_sync_child` in
    interpret mode) on q, k, v cast to `dtype`: its output and the gradients
    of sum(o * t), as float32."""
    from jax.experimental.pallas.ops.tpu.flash_attention import flash_attention as jax_flash

    scale = float(scale)
    q, k, v = (jnp.asarray(a, jnp.dtype(str(dtype))) for a in (q, k, v))

    def loss(q_, k_, v_):
        return jnp.sum(jax_flash(q_, k_, v_, sm_scale=scale).astype(jnp.float32) * t)

    o = jax_flash(q, k, v, sm_scale=scale)
    dq, dk, dv = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    return {name: x.astype(jnp.float32) for name, x in
            (("o", o), ("dq", dq), ("dk", dk), ("dv", dv))}


def test_plain_matches_the_jax_library_kernel_in_interpret_mode(tmp_path):
    q, k, v, t = _inputs((1, 2, 256, 8))
    scale = 1.0 / math.sqrt(8)
    ref = run_in_sync_child(_jax_library_flash, tmp_path, q=q, k=k, v=v, t=t,
                            scale=np.float64(scale), dtype=np.str_("float32"))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = flash_attention(*leaves, sm_scale=scale)
    np.testing.assert_allclose(out.detach().numpy(), ref["o"], rtol=0, atol=2e-5)
    (out * torch.from_numpy(t)).sum().backward()
    for leaf, want in zip(leaves, (ref["dq"], ref["dk"], ref["dv"])):
        err = np.abs(leaf.grad.numpy() - want).max() / np.abs(want).max()
        assert err <= 1e-4, err


def test_plain_matches_the_jax_library_kernel_in_bfloat16_interpret_mode(tmp_path):
    """The same bfloat16 inputs through jax's kernel and the port's plain
    version. A P or dS rounded elsewhere shows as a larger share of
    elements that differ: readings (this shape and seed) o 17.1 %, dq
    10.9 %, dk 17.8 %, dv 0.02 % (o and dk differ where jax rounds P against
    a running maximum over its two 128-key blocks, the plain version against
    the row's); with P and dS unrounded 37.8 %, 42.4 %, 41.9 %, 41.6 %. The
    largest differences, one bfloat16 rounding of an output, read 1.1e-3 to
    6.0e-3 of max|ref|."""
    q, k, v, t = _inputs((1, 2, 256, 64))
    q, k, v = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    scale = 1.0 / math.sqrt(64)
    ref = run_in_sync_child(_jax_library_flash, tmp_path,
                            **{name: x.float().numpy() for name, x in
                               (("q", q), ("k", k), ("v", v))},
                            t=t, scale=np.float64(scale), dtype=np.str_("bfloat16"))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = flash_attention(*leaves, sm_scale=scale)
    (out.float() * torch.from_numpy(t)).sum().backward()
    assert out.dtype == torch.bfloat16 and all(x.grad.dtype == torch.bfloat16 for x in leaves)
    for name, got in (("o", out), ("dq", leaves[0].grad), ("dk", leaves[1].grad),
                      ("dv", leaves[2].grad)):
        diff = np.abs(got.detach().float().numpy() - ref[name])
        assert diff.max() <= 2.0**-7 * np.abs(ref[name]).max(), (name, diff.max())
        assert (diff > 0).mean() <= 0.25, (name, (diff > 0).mean())


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
# the bfloat16 tensor-core kernels' tiling (csrc/flash_attention_bf16.cuh),
# emulated in float32 numpy with bfloat16 rounding

BF16_ROWS = 128  # query rows of a forward block, keys of a dK / dV block,
# query rows of a dQ block
BF16_DKDV_QUERIES = 32  # query rows per tile of the dK / dV pass
BF16_DQ_KEYS = 64  # keys per tile of the dQ pass


def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).bfloat16().float().numpy()


def _bf16_tiles(d):
    """(DP, the forward's K / V tile)."""
    dp = 64 if d <= 64 else 128
    return dp, (128 if dp == 64 else 64)


def _rows(x, start, count, n, dp):
    """Rows [start, start + count) of x, zeros past n and in the columns
    past d up to dp (TMA's and cp.async's zero fill)."""
    out = np.zeros((count, dp), np.float32)
    rows = x[start:min(start + count, n)]
    out[:len(rows), :x.shape[1]] = rows
    return out


def emulate_bf16_forward(q, k, v, scale):
    """flash_fwd_wgmma_kernel for one (batch, head): 128-row query blocks,
    K / V tiles of 128 keys (64 at d > 64), d padded with zeros, the base-2
    online softmax with P rounded to bfloat16 (against the running maximum)
    before P V, the row sum taken before the rounding."""
    n, d = q.shape
    dp, bn = _bf16_tiles(d)
    o, lse = np.zeros((n, d), np.float32), np.zeros(n, np.float32)
    scale_log2 = np.float32(scale * LOG2E)
    for m0 in range(0, n, BF16_ROWS):
        qt = _rows(q, m0, BF16_ROWS, n, dp)
        m = np.full(BF16_ROWS, -np.inf, np.float32)
        l_sum = np.zeros(BF16_ROWS, np.float32)
        acc = np.zeros((BF16_ROWS, dp), np.float32)
        for n0 in range(0, n, bn):
            kt, vt = _rows(k, n0, bn, n, dp), _rows(v, n0, bn, n, dp)
            s = (qt @ kt.T) * scale_log2
            s[:, n0 + np.arange(bn) >= n] = -np.inf
            m_new = np.maximum(m, s.max(1))
            alpha = np.exp2(m - m_new)
            p = np.exp2(s - m_new[:, None])
            l_sum = l_sum * alpha + p.sum(1)
            acc = acc * alpha[:, None] + _bf16(p) @ vt
            m = m_new
        rows = min(BF16_ROWS, n - m0)
        o[m0:m0 + rows] = (acc / l_sum[:, None])[:rows, :d]
        lse[m0:m0 + rows] = ((m + np.log2(l_sum)) * np.float32(math.log(2)))[:rows]
    return o, lse


def emulate_bf16_backward(q, k, v, o, lse, do, scale):
    """flash_bwd_delta, flash_bwd_dkdv_mma and flash_bwd_dq_mma for one
    (batch, head): D = rowsum(dO * O); dK / dV blocks of 128 keys over query
    tiles of 32 with S^T and dP^T, P^T rounded to bfloat16 for dV and dS^T =
    P^T (dP^T - D) * scale rounded for dK; dQ blocks of 128 query rows over
    64-key tiles, dS rounded for dQ."""
    n, d = q.shape
    dp, _ = _bf16_tiles(d)
    kq, dq_keys = BF16_DKDV_QUERIES, BF16_DQ_KEYS
    scale_log2 = np.float32(scale * LOG2E)
    delta = (do * o).sum(1).astype(np.float32)
    dq, dk, dv = (np.zeros((n, d), np.float32) for _ in range(3))

    def row_values(x, start, count):
        out = np.zeros(count, np.float32)
        part = x[start:min(start + count, n)]
        out[:len(part)] = part
        return out

    for n0 in range(0, n, BF16_ROWS):
        kt, vt = _rows(k, n0, BF16_ROWS, n, dp), _rows(v, n0, BF16_ROWS, n, dp)
        dk_acc, dv_acc = (np.zeros((BF16_ROWS, dp), np.float32) for _ in range(2))
        for m0 in range(0, n, kq):
            qt, dot = _rows(q, m0, kq, n, dp), _rows(do, m0, kq, n, dp)
            lse2 = row_values(lse, m0, kq) * np.float32(LOG2E)
            pt = np.exp2((kt @ qt.T) * scale_log2 - lse2[None, :])
            pt[:, m0 + np.arange(kq) >= n] = 0.0
            dst = pt * ((vt @ dot.T) - row_values(delta, m0, kq)[None, :]) * np.float32(scale)
            dv_acc += _bf16(pt) @ dot
            dk_acc += _bf16(dst) @ qt
        rows = min(BF16_ROWS, n - n0)
        dk[n0:n0 + rows], dv[n0:n0 + rows] = dk_acc[:rows, :d], dv_acc[:rows, :d]
    for m0 in range(0, n, BF16_ROWS):
        qt, dot = _rows(q, m0, BF16_ROWS, n, dp), _rows(do, m0, BF16_ROWS, n, dp)
        lse2 = np.full(BF16_ROWS, np.inf, np.float32)
        lse2[:min(BF16_ROWS, n - m0)] = lse[m0:m0 + BF16_ROWS] * np.float32(LOG2E)
        dl = row_values(delta, m0, BF16_ROWS)
        dq_acc = np.zeros((BF16_ROWS, dp), np.float32)
        for n0 in range(0, n, dq_keys):
            kt, vt = _rows(k, n0, dq_keys, n, dp), _rows(v, n0, dq_keys, n, dp)
            p = np.exp2((qt @ kt.T) * scale_log2 - lse2[:, None])
            p[:, n0 + np.arange(dq_keys) >= n] = 0.0
            ds = p * ((dot @ vt.T) - dl[:, None]) * np.float32(scale)
            dq_acc += _bf16(ds) @ kt
        rows = min(BF16_ROWS, n - m0)
        dq[m0:m0 + rows] = dq_acc[:rows, :d]
    return dq, dk, dv


@pytest.mark.parametrize("n, d", [(64, 8), (150, 8), (128, 80), (257, 64), (3, 128),
                                  (300, 40)])
def test_bfloat16_tiling_emulation_matches_the_plain_version(n, d):
    """Both round P and dS to bfloat16 where the TPU kernel does; their
    outputs (the plain version's in bfloat16) agree within one bfloat16
    rounding of max|ref| (2^-7, chip_smoke.py's bfloat16 tolerance)."""
    q, k, v, do = (_bf16(a) for a in _inputs((n, d), seed=n + d + 1))
    scale = d ** -0.5
    with np.errstate(invalid="ignore", over="ignore"):
        o, lse = emulate_bf16_forward(q, k, v, scale)
    tq, tk, tv, tdo = (torch.from_numpy(a)[None, None].bfloat16() for a in (q, k, v, do))
    ref_o, ref_lse = fa.flash_attention_fwd_plain(tq, tk, tv, scale)
    assert np.isfinite(o).all() and np.isfinite(lse).all()
    want_o = ref_o[0, 0].float().numpy()
    np.testing.assert_allclose(o, want_o, rtol=0, atol=2.0**-7 * np.abs(want_o).max())
    np.testing.assert_allclose(lse, ref_lse[0, 0].numpy(), rtol=0, atol=1e-5)
    # the backward from the plain forward's bfloat16 output, as the kernels run it
    with np.errstate(invalid="ignore", over="ignore"):
        grads = emulate_bf16_backward(q, k, v, ref_o[0, 0].float().numpy(),
                                      ref_lse[0, 0].numpy(), do, scale)
    ref_grads = fa.flash_attention_bwd_plain(tq, tk, tv, ref_o, ref_lse, tdo, scale)
    for got, want in zip(grads, ref_grads):
        want = want[0, 0].float().numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0**-7 * np.abs(want).max())


def test_bfloat16_plain_version_rounds_where_the_tpu_kernel_does():
    """P before P V and P^T dO, dS * scale before dS^T Q and dS K: the
    plain version equals the float32 computation with those roundings
    written out (jax flash_attention.py:471, :900, :918, :1258)."""
    q, k, v, do = (torch.from_numpy(a)[None].bfloat16() for a in _inputs((2, 96, 24), seed=5))
    scale = 24 ** -0.5
    o, lse = fa.flash_attention_fwd_plain(q, k, v, scale)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = qf @ kf.transpose(-1, -2) * scale
    p = torch.exp(s - s.amax(-1, keepdim=True))
    want_o = (p.bfloat16().float() @ vf) / p.sum(-1, keepdim=True)
    assert torch.equal(o, want_o.bfloat16())
    dq, dk, dv = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
    p = torch.exp(s - lse[..., None])
    ds = p * (dof @ vf.transpose(-1, -2) - (dof * o.float()).sum(-1, keepdim=True))
    ds = (ds * scale).bfloat16().float()
    assert torch.equal(dv, (p.bfloat16().float().transpose(-1, -2) @ dof).bfloat16())
    assert torch.equal(dq, (ds @ kf).bfloat16())
    assert torch.equal(dk, (ds.transpose(-1, -2) @ qf).bfloat16())


# ---------------------------------------------------------------------------
# the wrappers


@pytest.mark.parametrize("fn", ["fwd", "bwd"])
@pytest.mark.parametrize("case, match", [
    ("cpu", "CUDA tensor"), ("float16", "float32 or bfloat16"), ("head_dim", "head dim"),
    ("ndim", r"\(B, heads, N, d\)"), ("bf16_head_dim", "not a multiple of 16")])
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(fn, case, match):
    shape = {"head_dim": (1, 1, 8, 129), "ndim": (2, 8, 16),
             "bf16_head_dim": (1, 1, 8, 12)}.get(case, (1, 1, 8, 16))
    dtype = {"float16": torch.float16, "bf16_head_dim": torch.bfloat16}.get(case, torch.float32)
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
