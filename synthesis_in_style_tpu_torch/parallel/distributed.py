"""Training in more than one process (counterpart of
synthesis_in_style_tpu/parallel/mesh.py), on `torch.distributed`.

One process drives one device. A launch is indicated by the launcher's
environment (torchrun, or torch.distributed.launch with `--local_rank`):
`WORLD_SIZE`, `RANK`, and `MASTER_ADDR` / `MASTER_PORT` for the rendezvous.
`maybe_initialize_distributed` then opens the process group: NCCL where the
tensors live on the card (the process's device is `cuda:LOCAL_RANK`), gloo
where they live on the CPU, or what `--mpi-backend` names. Without a launch
it does nothing, and every function below is the identity of a single
process, so one code path serves both.

The JAX package computes one step on the sharded global batch; here each
process computes on its shard, and these pieces make the result that of the
global batch:

* the gradients are all-reduced as means (`average_gradients`, called by
  the optimizers), which is the gradient of the global batch mean when every
  loss is a mean over equal shards;
* a statistic that spans the batch is taken over the global batch by
  differentiable collectives: `global_sum` (an all-reduce whose adjoint is
  the same all-reduce) and `all_gather_batch` (the minibatch-stddev layer
  of the discriminator), and BatchNorm in training runs
  `global_batch_norm` (the mean and variance of the global batch in the
  forward, the two sums the backward needs in the backward); both work on
  gloo and NCCL alike;
* the random draws of the global batch are made on every process from the
  same generator and sliced (`local_batch_slice`), and the data loader
  shards the dataset as the JAX loader does (data/loader.py).
"""

from __future__ import annotations

import datetime
import os
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist


def is_initialized() -> bool:
    """Is a process group open (a launched run, of any world size)?"""
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_main_process() -> bool:
    """Rank 0, or the single process: the one that writes files."""
    return get_rank() == 0


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def maybe_initialize_distributed(local_rank_arg: Optional[int] = None,
                                 backend: Optional[str] = None,
                                 device: str = "cuda") -> bool:
    """Open the process group when the environment indicates a launch
    (`WORLD_SIZE` and `RANK` set); returns whether one is open. Idempotent.
    `local_rank_arg` is the `--local_rank` of torch.distributed.launch, taken
    as LOCAL_RANK when the environment has none. A positive `--local_rank`
    without the launcher's environment raises: it names a launch that did not
    happen. `backend` defaults to NCCL for a CUDA `device` and gloo otherwise."""
    if is_initialized():
        return True
    if local_rank_arg is not None and "LOCAL_RANK" not in os.environ:
        os.environ["LOCAL_RANK"] = str(local_rank_arg)
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        if (local_rank_arg or 0) > 0:
            raise RuntimeError(
                f"--local_rank {local_rank_arg}: a multi-process launch needs WORLD_SIZE, "
                "RANK, MASTER_ADDR and MASTER_PORT in the environment (torchrun sets them)")
        return False
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    dist.init_process_group(backend, init_method="env://", rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]),
                            timeout=datetime.timedelta(minutes=10))
    return True


def process_device(device: str) -> torch.device:
    """The device this process drives: `cuda:LOCAL_RANK` for "cuda" in a
    launched run, else `device` itself."""
    device = torch.device(device)
    if is_initialized() and device.type == "cuda" and device.index is None:
        return torch.device("cuda", local_rank())
    return device


@dataclass(frozen=True)
class DataParallel:
    """A launched run: this process's rank in `world_size` processes, one
    device each; `per_process_batch` rows of a global batch of
    `global_batch`."""

    rank: int
    world_size: int
    per_process_batch: int

    @property
    def global_batch(self) -> int:
        return self.per_process_batch * self.world_size


def data_parallel(batch_size: int) -> Optional[DataParallel]:
    """The data parallelism a train CLI should use, as the JAX package's
    `data_parallel_mesh`: None in a single process; in a launched run the
    processes' shards of a global batch of `batch_size` (the per-process
    batch) times the world size, one device per process. A global batch the
    devices do not divide warns and gives None."""
    if not is_initialized():
        return None
    world = get_world_size()
    global_batch = batch_size * world
    if global_batch % world:
        warnings.warn(f"global batch {global_batch} is not divisible by the {world} "
                      "devices: no data parallelism", stacklevel=2)
        return None
    return DataParallel(get_rank(), world, batch_size)


def local_batch_slice(global_batch_size: int) -> slice:
    """This process's rows of a global batch."""
    per_process = global_batch_size // get_world_size()
    start = get_rank() * per_process
    return slice(start, start + per_process)


# ---------------------------------------------------------------------------
# collectives


def all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of `t` over the processes (no gradient); `t` itself alone."""
    if not is_initialized():
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out / get_world_size()


def average_gradients(grads: Sequence[Optional[torch.Tensor]]) -> List[Optional[torch.Tensor]]:
    """The gradients averaged over the processes in one all-reduce (None
    stays None where every process has None: a parameter no loss reached)."""
    grads = list(grads)
    if not is_initialized():
        return grads
    present = [g for g in grads if g is not None]
    if not present:
        return grads
    dtype = torch.float64 if any(g.dtype == torch.float64 for g in present) else torch.float32
    flat = torch.cat([g.reshape(-1).to(dtype) for g in present])
    dist.all_reduce(flat)
    flat /= get_world_size()
    out, offset = [], 0
    for g in grads:
        if g is None:
            out.append(None)
            continue
        out.append(flat[offset: offset + g.numel()].view_as(g).to(g.dtype))
        offset += g.numel()
    return out


def reduce_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Scalar metrics (means over each process's shard) averaged over the
    processes in one all-reduce: the global batch's values."""
    if not is_initialized() or not metrics:
        return metrics
    keys = list(metrics)
    stacked = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    dist.all_reduce(stacked)
    stacked /= get_world_size()
    return {k: stacked[i] for i, k in enumerate(keys)}


class _AllReduceSum(torch.autograd.Function):
    """Sum over the processes; its adjoint is the same sum, so it is
    differentiable to any order."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g.contiguous())


class _AllGather(torch.autograd.Function):
    """Concatenate the processes' tensors along dim 0 (equal shapes). The
    gradient of this process's rows is the sum over the processes of the
    gradient they hand back for those rows (differentiable to any order)."""

    @staticmethod
    def forward(ctx, t):
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, t)
        ctx.rows = t.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        rank = dist.get_rank()
        return _AllReduceSum.apply(g.contiguous())[rank * ctx.rows: (rank + 1) * ctx.rows]


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum of `t` over the processes, differentiable; `t` itself alone."""
    return _AllReduceSum.apply(t) if is_initialized() else t


def all_gather_batch(x: torch.Tensor) -> torch.Tensor:
    """The global batch (the processes' rows in rank order), differentiable;
    `x` itself alone."""
    return _AllGather.apply(x) if is_initialized() else x


class _GlobalBatchNorm(torch.autograd.Function):
    """Training-mode batch norm over the global batch, channel axis 1.
    Forward: the global mean, then the global biased variance (two
    all-reduces); backward: the global sums of g and g * x_hat (one)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        dims = [d for d in range(x.ndim) if d != 1]
        shape = [1, -1] + [1] * (x.ndim - 2)
        # float32 statistics (float64 for a float64 input)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        head = torch.cat([xf.sum(dims), xf.new_tensor([x.numel() // x.shape[1]])])
        dist.all_reduce(head)
        count = head[-1]
        mean = head[:-1] / count
        centred = xf - mean.reshape(shape)
        var = centred.square().sum(dims)
        dist.all_reduce(var)
        var = var / count
        invstd = torch.rsqrt(var + eps)
        x_hat = centred * invstd.reshape(shape)
        y = x_hat * weight.to(xf.dtype).reshape(shape) + bias.to(xf.dtype).reshape(shape)
        ctx.save_for_backward(x_hat, invstd, weight)
        ctx.count, ctx.dims, ctx.shape = count, dims, shape
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g, _gm, _gv):
        x_hat, invstd, weight = ctx.saved_tensors
        dims, shape = ctx.dims, ctx.shape
        gf = g.to(x_hat.dtype)
        local = torch.cat([gf.sum(dims), (gf * x_hat).sum(dims)])
        sums = local.clone()
        dist.all_reduce(sums)
        c = invstd.shape[0]
        mean_g, mean_gx = sums[:c] / ctx.count, sums[c:] / ctx.count
        gx = (weight.to(x_hat.dtype) * invstd).reshape(shape) * (
            gf - mean_g.reshape(shape) - x_hat * mean_gx.reshape(shape))
        # this process's share of the weight and bias gradients: the
        # optimizer's all-reduce averages them
        return gx.to(g.dtype), local[c:].to(weight.dtype), local[:c].to(weight.dtype), None


def global_batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float):
    """(y, batch mean, biased batch variance) of training-mode batch norm
    over the global batch (a launched run only)."""
    return _GlobalBatchNorm.apply(x, weight, bias, eps)
