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
* a numpy emulation of the float32 kernels (3xTF32 on mma.sync): their
  tiling (64-row blocks, 64-key forward tiles, backward tiles of 64 rows
  or keys, 32 at d > 64, the base-2 online softmax, masks past N, D =
  rowsum(dO * O)), the TF32 split bit for bit (hi rounded, lo = x - hi read
  truncated by the mma), the three products in the kernels' order, each
  mma's sum rounded toward zero as the tensor cores round it, each tile's
  partial sums added by round-to-nearest, and the k order the fragments
  give each operand (derived from the PTX layouts and the kernels' register
  choices), against the plain version at ragged N and padded head dims
  within 1e-5 of max|ref|; and, as a negative control, TF32 alone (hi * hi)
  failing that gate;
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
# the float32 kernels (csrc/flash_attention_f32.cuh), emulated in numpy: the
# tiling, the TF32 split bit for bit, the fragments' k order and the tensor
# cores' accumulation

F32_ROWS = 64  # query rows of a forward or dQ block, keys of a dK / dV block
F32_FWD_KEYS = 64  # keys per K / V tile of the forward
F32_CHUNK = 32  # columns of a tile's partial sums at a time
# the kernels' order: a_hi b_lo, a_lo b_hi, a_hi b_hi
THREE_PRODUCTS = (("hi", "lo"), ("lo", "hi"), ("hi", "hi"))

# mma.m16n8k8 with TF32 operands (PTX ISA), lane = 4 g + t: what register i
# of a lane holds, A as (row, k), B as (k, column), C as (row, column)
_G, _T = np.arange(32) // 4, np.arange(32) % 4
A_LAYOUT = ((_G, _T), (_G + 8, _T), (_G, _T + 4), (_G + 8, _T + 4))
B_LAYOUT = ((_T, _G), (_T + 4, _G))
C_LAYOUT = ((_G, 2 * _T), (_G, 2 * _T + 1), (_G + 8, 2 * _T), (_G + 8, 2 * _T + 1))
# what the kernels put in those registers: load_a, (row, column) of a
# row-major tile; c_to_a, which accumulator register; load_bt (B = X^T),
# (row, column) of X; load_b (B = X), (row, column) of X
A_FROM_TILE = ((_G, 2 * _T), (_G + 8, 2 * _T), (_G, 2 * _T + 1), (_G + 8, 2 * _T + 1))
A_FROM_C = (0, 2, 1, 3)
B_FROM_TILE_T = ((_G, 2 * _T), (_G, 2 * _T + 1))
B_FROM_TILE = ((2 * _T, _G), (2 * _T + 1, _G))


def _k_order(pairs):
    """For each k slot of an 8-deep step, the source column (of A) or row
    (of B) the fragments put there: from (slot, source index, a check that
    the other index matches) per register."""
    order = np.full(8, -1)
    for slot, index, same in pairs:
        assert np.all(same)
        order[slot] = index
    assert sorted(order) == list(range(8))
    return order


A_TILE_ORDER = _k_order((A_LAYOUT[i][1], A_FROM_TILE[i][1], A_LAYOUT[i][0] == A_FROM_TILE[i][0])
                        for i in range(4))
A_C_ORDER = _k_order((A_LAYOUT[i][1], C_LAYOUT[A_FROM_C[i]][1],
                      A_LAYOUT[i][0] == C_LAYOUT[A_FROM_C[i]][0]) for i in range(4))
B_TILE_T_ORDER = _k_order((B_LAYOUT[i][0], B_FROM_TILE_T[i][1],
                           B_LAYOUT[i][1] == B_FROM_TILE_T[i][0]) for i in range(2))
B_TILE_ORDER = _k_order((B_LAYOUT[i][0], B_FROM_TILE[i][0], B_LAYOUT[i][1] == B_FROM_TILE[i][1])
                        for i in range(2))


def _tf32(x):
    """hopper::to_tf32, cvt.rna.tf32.f32's rounding: the float32 bits plus
    0x1000, the low 13 cleared (to nearest, ties away from zero)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_read(x):
    """A TF32 operand as the tensor cores read a float32 register: its top
    19 bits (truncated)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    """The kernels' split: hi = x rounded to TF32, lo = x - hi (exact),
    which the mma reads truncated."""
    hi = _tf32(x)
    return {"hi": hi, "lo": _tf32_read(x - hi)}


def _toward_zero(x):
    """float64 to float32, rounded toward zero."""
    out = x.astype(np.float32)
    over = np.abs(out.astype(np.float64)) > np.abs(x)
    out[over] = np.nextafter(out[over], np.float32(0))
    return out


def _product(a, b, a_order, b_order, products=THREE_PRODUCTS):
    """a @ b (a: (M, K), b: (K, N), K a multiple of 8) as the kernels'
    mma.sync run it into a zeroed accumulator: k steps of 8 whose slots
    take a's columns and b's rows in the fragments' orders, each operand
    split into TF32 hi and lo, one mma per product of `products` in that
    order, each the exact sum of its products and the accumulator rounded
    toward zero (the tensor cores' rounding)."""
    a_parts, b_parts = _split(a), _split(b)
    c = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        for pa, pb in products:
            step = a_parts[pa][:, k0 + a_order].astype(np.float64) @ \
                b_parts[pb][k0 + b_order].astype(np.float64)
            c = _toward_zero(c + step)
    return c


def _head_dim_padded(d):
    return 32 if d <= 32 else 64 if d <= 64 else 128


def _bwd_tile(dp):
    """Query rows (dK / dV) or keys (dQ) per tile of the backward."""
    return 64 if dp <= 64 else 32


def _rows(x, start, count, n, dp):
    """Rows [start, start + count) of x, zeros past n and in the columns
    past d up to dp (TMA's and cp.async's zero fill)."""
    out = np.zeros((count, dp), np.float32)
    rows = x[start:min(start + count, n)]
    out[:len(rows), :x.shape[1]] = rows
    return out


def _values(x, start, count, n):
    out = np.zeros(count, np.float32)
    part = x[start:min(start + count, n)]
    out[:len(part)] = part
    return out


def _fma(a, b, c):
    return (a.astype(np.float64) * b + c).astype(np.float32)


def emulate_forward(q, k, v, scale, products=THREE_PRODUCTS):
    """flash_fwd_split_kernel for one (batch, head): (N, d) float32 arrays.
    64-row blocks over 64-key tiles, d padded with zeros; S = Q K^T, the
    base-2 online softmax (the maximum of the raw scores times the scale on
    a full tile, the scale folded into one FMA before exp2), and each tile's
    P V into zeroed partial sums of 32 columns added to O by FMA (O alpha +
    P V); O times 1 / its weight sum, the logsumexp in natural log."""
    n, d = q.shape
    dp = _head_dim_padded(d)
    o, lse = np.zeros((n, d), np.float32), np.zeros(n, np.float32)
    scale_log2 = np.float32(scale * LOG2E)
    for m0 in range(0, n, F32_ROWS):
        qt = _rows(q, m0, F32_ROWS, n, dp)
        m = np.full(F32_ROWS, -np.inf, np.float32)
        l_sum = np.zeros(F32_ROWS, np.float32)
        acc = np.zeros((F32_ROWS, dp), np.float32)
        for n0 in range(0, n, F32_FWD_KEYS):
            kt, vt = _rows(k, n0, F32_FWD_KEYS, n, dp), _rows(v, n0, F32_FWD_KEYS, n, dp)
            s = _product(qt, kt.T, A_TILE_ORDER, B_TILE_T_ORDER, products)
            if scale_log2 > 0 and n0 + F32_FWD_KEYS <= n:
                mx, a = s.max(1) * scale_log2, scale_log2
            else:
                s = np.where(n0 + np.arange(F32_FWD_KEYS) < n, s * scale_log2, -np.inf)
                mx, a = s.max(1), np.float32(1)
            m_new = np.maximum(m, mx)
            alpha = np.exp2(m - m_new)
            p = np.exp2(_fma(s, a, -m_new[:, None].astype(np.float64)))
            l_sum = l_sum * alpha + p.sum(1, dtype=np.float32)
            for c0 in range(0, dp, F32_CHUNK):
                pv = _product(p, vt[:, c0:c0 + F32_CHUNK], A_C_ORDER, B_TILE_ORDER, products)
                acc[:, c0:c0 + F32_CHUNK] = _fma(acc[:, c0:c0 + F32_CHUNK], alpha[:, None], pv)
            m = m_new
        rows = min(F32_ROWS, n - m0)
        o[m0:m0 + rows] = (acc * (np.float32(1) / l_sum)[:, None])[:rows, :d]
        lse[m0:m0 + rows] = ((m + np.log2(l_sum)) * np.float32(math.log(2)))[:rows]
    return o, lse


def emulate_backward(q, k, v, o, lse, do, scale):
    """flash_bwd_delta, flash_bwd_dkdv_split and flash_bwd_dq_split for one
    (batch, head): D = rowsum(dO * O); dK / dV blocks of 64 keys over
    query tiles of 64 rows (32 at d > 64: S^T, dP^T, P^T and dS^T = P^T
    (dP^T - D), each tile's P^T dO and dS^T Q into zeroed partial sums of 32
    columns added to dV and dK), dK times the scale; dQ blocks of 64 query
    rows over key tiles of 64 (32 at d > 64: S, dP, dS, dS K the same way),
    dQ times the scale."""
    n, d = q.shape
    dp = _head_dim_padded(d)
    scale_log2, log2e = np.float32(scale * LOG2E), np.float32(LOG2E)
    delta = (do * o).sum(1, dtype=np.float32)
    dq, dk, dv = (np.zeros((n, d), np.float32) for _ in range(3))
    tile = _bwd_tile(dp)

    def chunked(x, y):  # x (rows, tile) as A from its accumulator, y (tile, dp) as B
        return np.concatenate([_product(x, y[:, c0:c0 + F32_CHUNK], A_C_ORDER, B_TILE_ORDER)
                               for c0 in range(0, dp, F32_CHUNK)], axis=1)

    for n0 in range(0, n, F32_ROWS):  # dK, dV: a block per 64 keys
        kt, vt = _rows(k, n0, F32_ROWS, n, dp), _rows(v, n0, F32_ROWS, n, dp)
        dk_acc, dv_acc = np.zeros((F32_ROWS, dp), np.float32), np.zeros((F32_ROWS, dp), np.float32)
        for m0 in range(0, n, tile):
            qt, dot = _rows(q, m0, tile, n, dp), _rows(do, m0, tile, n, dp)
            lse_t, delta_t = _values(lse, m0, tile, n), _values(delta, m0, tile, n)
            st = _product(kt, qt.T, A_TILE_ORDER, B_TILE_T_ORDER)
            dpt = _product(vt, dot.T, A_TILE_ORDER, B_TILE_T_ORDER)
            pt = np.where(m0 + np.arange(tile) < n,
                          np.exp2(st * scale_log2 - lse_t * log2e), np.float32(0))
            dst = pt * (dpt - delta_t)
            dv_acc += chunked(pt, dot)
            dk_acc += chunked(dst, qt)
        rows = min(F32_ROWS, n - n0)
        dk[n0:n0 + rows] = (dk_acc * np.float32(scale))[:rows, :d]
        dv[n0:n0 + rows] = dv_acc[:rows, :d]
    for m0 in range(0, n, F32_ROWS):  # dQ: a block per 64 query rows
        qt, dot = _rows(q, m0, F32_ROWS, n, dp), _rows(do, m0, F32_ROWS, n, dp)
        rows = min(F32_ROWS, n - m0)
        lse2 = np.full(F32_ROWS, np.inf, np.float32)
        lse2[:rows] = lse[m0:m0 + rows] * log2e
        dl = _values(delta, m0, F32_ROWS, n)
        dq_acc = np.zeros((F32_ROWS, dp), np.float32)
        for n0 in range(0, n, tile):
            kt, vt = _rows(k, n0, tile, n, dp), _rows(v, n0, tile, n, dp)
            s = _product(qt, kt.T, A_TILE_ORDER, B_TILE_T_ORDER)
            dpm = _product(dot, vt.T, A_TILE_ORDER, B_TILE_T_ORDER)
            p = np.where(n0 + np.arange(tile) < n,
                         np.exp2(s * scale_log2 - lse2[:, None]), np.float32(0))
            dq_acc += chunked(p * (dpm - dl[:, None]), kt)
        dq[m0:m0 + rows] = (dq_acc * np.float32(scale))[:rows, :d]
    return dq, dk, dv


def test_fragment_orders_agree_and_interleave_pairs():
    """Every operand's k step puts index 2t in slot t and 2t + 1 in slot
    t + 4: an accumulator's columns become the next A operand without a
    shuffle, and the float2 loads read neighbouring columns."""
    want = [0, 2, 4, 6, 1, 3, 5, 7]
    for order in (A_TILE_ORDER, A_C_ORDER, B_TILE_T_ORDER, B_TILE_ORDER):
        assert list(order) == want


def test_tf32_split_rounds_to_nearest_ties_away():
    # ties (2^-11 past a TF32 value) go away from zero, less than half down
    x = np.array([1.0, 1 + 2.0**-11, 1 + 2.0**-10 + 2.0**-11, -(1 + 2.0**-11), 1 + 2.0**-12],
                 np.float32)
    np.testing.assert_array_equal(_tf32(x), np.array(
        [1.0, 1 + 2.0**-10, 1 + 2.0**-9, -(1 + 2.0**-10), 1.0], np.float32))
    rs = np.random.default_rng(4)
    y = rs.standard_normal(10000).astype(np.float32)
    parts = _split(y)
    assert np.all(parts["hi"].view(np.uint32) & 0x1FFF == 0)
    assert np.all(parts["lo"].view(np.uint32) & 0x1FFF == 0)
    # hi alone keeps 11 of float32's 24 bits, hi + lo as the mma reads them 21
    err = np.abs((parts["hi"].astype(np.float64) + parts["lo"]) - y) / np.abs(y)
    assert err.max() < 2.0**-20 and np.abs(parts["hi"] - y).max() > 2.0**-14


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


@pytest.mark.parametrize("head", [0, 1])
def test_one_tf32_product_fails_the_float32_gate(head):
    """Negative control: the same emulation with the hi * hi product alone
    (plain TF32) lands far outside the float32 forward's gate (1e-5 of
    max|ref|, chip_smoke.py) at (1, 2, 256, 64), so the gate tells 3xTF32
    from TF32."""
    q, k, v, _ = (a[0, head] for a in _inputs((1, 2, 256, 64), seed=6))
    scale = 64 ** -0.5
    ref_o, _ = fa.flash_attention_fwd_plain(*(torch.from_numpy(a) for a in (q, k, v)), scale)
    tol = 1e-5 * ref_o.abs().max().item()
    three, _ = emulate_forward(q, k, v, scale)
    one, _ = emulate_forward(q, k, v, scale, products=(("hi", "hi"),))
    assert np.abs(three - ref_o.numpy()).max() <= tol
    assert np.abs(one - ref_o.numpy()).max() > 10 * tol


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
