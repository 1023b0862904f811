"""Flash attention as an autograd Function (counterpart of the library call
`jax.experimental.pallas.ops.tpu.flash_attention.flash_attention` in
synthesis_in_style_tpu/models/trans_u_net.py, with its custom VJP).

`flash_attention(q, k, v, sm_scale)` on (B, heads, N, d): a CUDA tensor runs
the hand-written kernels (ops/cuda/flash_attention.py, csrc/flash_attention.cu),
a CPU tensor their plain version, and any other device raises. The forward
saves q, k, v, the output and the float32 per-row logsumexp; the backward
recomputes the probabilities from them. Non-causal, no bias, no dropout.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from synthesis_in_style_tpu_torch.ops.cuda.flash_attention import (
    flash_attention_bwd_cuda,
    flash_attention_bwd_plain,
    flash_attention_fwd_cuda,
    flash_attention_fwd_plain,
)


class FlashAttentionFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, sm_scale: float):
        if q.is_cuda:
            o, lse = flash_attention_fwd_cuda(q, k, v, sm_scale)
        elif q.device.type == "cpu":
            o, lse = flash_attention_fwd_plain(q, k, v, sm_scale)
        else:
            raise ValueError(f"flash_attention: no implementation for device {q.device}")
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.is_cuda:
            dq, dk, dv = flash_attention_bwd_cuda(q, k, v, o, lse, do.contiguous(), ctx.sm_scale)
        elif do.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, o, lse, do, ctx.sm_scale)
        else:
            raise ValueError(f"flash_attention backward: no implementation for device "
                             f"{do.device}")
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: float = 1.0) -> torch.Tensor:
    """softmax(q k^T * sm_scale) v over (B, heads, N, d) tensors of one
    dtype (float32 or bfloat16 on the card), contiguous on the card."""
    return FlashAttentionFunction.apply(q, k, v, sm_scale)
