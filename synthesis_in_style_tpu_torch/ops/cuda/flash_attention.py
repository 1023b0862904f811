"""Flash attention, forward and backward: the kernel wrappers and their
plain versions.

Counterpart of the Pallas TPU kernels that the JAX package's TransUNet
reaches with `attention_impl: flash`
(synthesis_in_style_tpu/models/trans_u_net.py, `Attention.__call__`):
jax.experimental.pallas.ops.tpu.flash_attention's forward and the `bwd_dkv`
and `bwd_dq` kernels of its custom VJP. The CUDA kernels are in
`csrc/flash_attention.cu`, all on the tensor cores: in bfloat16 a wgmma
forward fed by TMA and an mma.sync backward (`csrc/flash_attention_bf16.cuh`),
in float32 mma.sync in 3xTF32 (each operand split into a TF32 high and low
part, three products: float32-class sums whatever
torch.backends.cuda.matmul.allow_tf32 says; `csrc/flash_attention_f32.cuh`).
The autograd Function in ops/attention.py sends a CUDA tensor to a kernel
(which raises rather than fall back) and a CPU tensor to the plain version.

Tensors are (B, heads, N, d), contiguous; d <= 128, and in bfloat16 a
multiple of 8 (TMA moves rows of a multiple of 16 bytes). The forward returns
the output in the input type and the per-row logsumexp (natural log) in
float32, which the backward reads to recompute the probabilities. In
bfloat16 the kernels and the plain versions round where the TPU kernel
rounds: P before P V and P^T dO, dS (scale included) before dS^T Q and dS K.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from synthesis_in_style_tpu_torch.ops.cuda import build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
_FWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int,
                                                               ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int,
                                                                ctypes.c_void_p]


def _operand(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x (float32) as a product's operand in `dtype`: rounded to bfloat16
    (and back to float32) for bfloat16 inputs, as the TPU kernel casts P and
    dS to the inputs' type before the tensor-core products; unchanged for
    float32."""
    return x.to(dtype).float() if dtype == torch.bfloat16 else x


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(softmax(q k^T * sm_scale) v in q's type, logsumexp (B, heads, N)
    float32), computed in float32 (P rounded to bfloat16 before P V for
    bfloat16 inputs, its row sum taken before the rounding). The output is
    normalised by the sum of its own weights, as the kernel's is:
    normalising by exp(logsumexp) instead leaves a relative error of
    |logsumexp| x eps in o, which the backward's D = rowsum(dO * O) turns
    into dS = P * (dP - D) where dP and D nearly cancel (seen as 7e-4 of a
    gradient's scale in a 2-block ViT)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l_sum = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(_operand(p, q.dtype), v.float()) / l_sum
    return o.to(q.dtype), (m + torch.log(l_sum))[..., 0]


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                              sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in q's type, computed in float32 from the forward's
    output and logsumexp, as the kernels do: P = exp(q k^T * scale - lse),
    D = rowsum(dO * O), dS = P * (dO v^T - D). For bfloat16 inputs P is
    rounded to bfloat16 before P^T dO, and dS * scale before dS^T Q and
    dS K; float32 scales the two products instead."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * sm_scale - lse[..., None])
    dv = torch.matmul(_operand(p, q.dtype).transpose(-1, -2), dof)
    delta = (dof * o.float()).sum(-1, keepdim=True)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)
    if q.dtype == torch.bfloat16:
        ds = _operand(ds * sm_scale, q.dtype)
        dq, dk = torch.matmul(ds, kf), torch.matmul(ds.transpose(-1, -2), qf)
    else:
        dq = torch.matmul(ds, kf) * sm_scale
        dk = torch.matmul(ds.transpose(-1, -2), qf) * sm_scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(what: str, ref: torch.Tensor, **tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of ref's
    device, dtype and shape, (B, heads, N, d) with d <= 128 (in bfloat16 a
    multiple of 8)."""
    if ref.ndim != 4:
        raise ValueError(f"{what}: expected (B, heads, N, d) tensors, got shape "
                         f"{tuple(ref.shape)}")
    if ref.dtype not in DTYPE_CODES:
        raise ValueError(f"{what}: dtype {ref.dtype} is not float32 or bfloat16")
    if not 0 < ref.shape[-1] <= MAX_HEAD_DIM:
        raise ValueError(f"{what}: head dim {ref.shape[-1]} is not in 1..{MAX_HEAD_DIM}")
    if ref.dtype == torch.bfloat16 and ref.shape[-1] % 8:
        raise ValueError(f"{what}: bfloat16 head dim {ref.shape[-1]}: a row of "
                         f"{2 * ref.shape[-1]} bytes is not a multiple of 16, which the "
                         f"tensor-core kernels' TMA and 16-byte copies need")
    if ref.shape[0] * ref.shape[1] > 65535:
        raise ValueError(f"{what}: B * heads = {ref.shape[0] * ref.shape[1]} > 65535")
    for name, t in tensors.items():
        if not t.is_cuda or t.device != ref.device:
            raise ValueError(f"{what}: {name} must be a CUDA tensor on {ref.device}, "
                             f"got {t.device}")
        if t.dtype != ref.dtype or t.shape != ref.shape:
            raise ValueError(f"{what}: {name} is {t.dtype} {tuple(t.shape)}, expected "
                             f"{ref.dtype} {tuple(ref.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def flash_attention_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) from the forward kernel on the current stream."""
    _check("flash_attention_fwd_cuda", q, q=q, k=k, v=v)
    b, h, n, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return o, lse
    fn = build.load("flash_attention", "sis_flash_attention_fwd", _FWD_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), b * h, n, d,
             float(sm_scale), DTYPE_CODES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "sis_flash_attention_fwd")
    if torch.cuda.is_current_stream_capturing():
        # recorded into a CUDA graph, not launched: whoever replays the
        # graph counts the launches (analysis_segmenter.PageProgram.run)
        flash_attention_fwd_cuda.captured += 1
    else:
        flash_attention_fwd_cuda.launches += 1
    return o, lse


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                             sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the backward kernels (D, then dK / dV, then dQ) on
    the current stream."""
    _check("flash_attention_bwd_cuda", q, q=q, k=k, v=v, o=o, do=do)
    b, h, n, d = q.shape
    if lse.dtype != torch.float32 or lse.shape != (b, h, n) or not lse.is_contiguous() \
            or lse.device != q.device:
        raise ValueError(f"flash_attention_bwd_cuda: lse must be contiguous float32 "
                         f"{(b, h, n)} on {q.device}, got {lse.dtype} {tuple(lse.shape)} on "
                         f"{lse.device}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk, dv
    delta = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    fn = build.load("flash_attention", "sis_flash_attention_bwd", _BWD_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
             do.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             b * h, n, d, float(sm_scale), DTYPE_CODES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "sis_flash_attention_bwd")
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


# one count per call: the forward kernel (launched, and recorded into
# graphs), and the backward's three kernels
flash_attention_fwd_cuda.launches = 0
flash_attention_fwd_cuda.captured = 0
flash_attention_bwd_cuda.launches = 0
