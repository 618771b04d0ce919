"""Data-parallel training over processes (port of
self6dpp_tpu/parallel/mesh.py's process layer: add_distributed_args,
maybe_init_distributed_from_args, init_distributed).

The JAX package jits each train step over a device mesh: every process
feeds its local slice of the global batch, and the loss, its normalisers
and train-mode batch norm's statistics are reduced over the global batch
by XLA. Here each process (rank) runs the eager step on its local batch of
ims_per_batch, and this module supplies the reductions that make the
ranks together compute the step on the global batch of world x
ims_per_batch, in rank order:
  - global_sum(x): x summed over the ranks, differentiable (the backward
    sums the cotangents over the ranks too), for batch norm's statistics;
  - batch_denom(s): a loss normaliser max(sum over the global batch, 1)
    divided by the world size, so that a rank's term, its own numerator
    over it, averages over the ranks to the global term (rank_share for a
    term that a kernel normalised by its own batch);
  - global_mean(x): the ranks' mean of a batch mean, differentiable (MS-
    SSIM's per-level means);
  - average_gradients(params): the gradients averaged over the ranks, in
    one all-reduce, before the solver's clip and update and the EMA, so
    that every rank holds the same state;
  - mean_metrics(metrics): the ranks' mean of each loss term, the global
    batch's value, for the logs.
With one process (or none initialised) each of these is the identity, so
a single-process run computes exactly what it did without this module.

The JAX mesh's fsdp axis shards parameters and changes no number; the
port runs data parallel over every rank and does not shard parameters
(DistConfig.mesh_shape is read by nothing here).
"""

from __future__ import annotations

import logging

import torch
import torch.distributed as dist
from torch import Tensor

logger = logging.getLogger("self6dpp_tpu_torch")


def add_distributed_args(parser) -> None:
    """--dist-coordinator host:port of rank 0, --dist-nprocs N,
    --dist-rank R (the JAX CLIs' flags and defaults)."""
    parser.add_argument("--dist-coordinator", default="",
                        help="host:port of process 0 (multi-process "
                             "training)")
    parser.add_argument("--dist-nprocs", default=1, type=int)
    parser.add_argument("--dist-rank", default=0, type=int)


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device: torch.device | str | None = None) -> None:
    """Join the process group: NCCL on CUDA devices, gloo on the CPU,
    rendezvous at tcp://<coordinator_address>, world size num_processes,
    this process's rank process_id. On CUDA each rank takes the card
    rank % device_count as its current device. A no-op for one process or
    without a coordinator, as the JAX function is, and when a group is
    already up."""
    if num_processes is None or int(num_processes) <= 1 \
            or not coordinator_address or world_size() > 1:
        return
    dev = torch.device(device) if device is not None else torch.device(
        "cuda" if torch.cuda.is_available() else "cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(int(process_id) % torch.cuda.device_count())
    dist.init_process_group(
        backend="nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id))
    logger.info(f"rank {process_id} of {num_processes} joined "
                f"{coordinator_address} ({dist.get_backend()})")


def maybe_init_distributed_from_args(args, device) -> torch.device:
    """The CLIs' hook: init_distributed from --dist-* when a coordinator is
    given (a no-op otherwise); returns the device this rank runs on (its
    card, rank % device_count, for CUDA)."""
    if getattr(args, "dist_coordinator", ""):
        init_distributed(args.dist_coordinator, int(args.dist_nprocs),
                         int(args.dist_rank), device=device)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and world_size() > 1:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if world_size() > 1 else 0


def is_main() -> bool:
    """Whether this process writes (checkpoints, metrics, logs): rank 0."""
    return rank() == 0


def global_sum(x: Tensor) -> Tensor:
    """x summed over the ranks, differentiable: the backward sums the
    cotangent over the ranks (torch.distributed.nn's all_reduce)."""
    if world_size() == 1:
        return x
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(x)


def global_mean(x: Tensor) -> Tensor:
    """The ranks' mean of x, differentiable."""
    w = world_size()
    return x if w == 1 else global_sum(x) / w


def batch_denom(s: Tensor) -> Tensor:
    """A loss normaliser: s is a sum over this rank's batch (of a mask, a
    count); returns max(s summed over the ranks, 1) / world_size, i.e.
    max(s, 1) with one rank. A rank's term numerator / batch_denom(s)
    then averages over the ranks (as average_gradients averages their
    gradients) to the global batch's numerator over max(S, 1)."""
    w = world_size()
    if w == 1:
        return s.clamp_min(1.0)
    return global_sum(s.detach()).clamp_min(1.0) / w


def rank_share(s: Tensor) -> Tensor | None:
    """max(s, 1) / batch_denom(s): the factor that turns a term a function
    normalised by its own batch's max(s, 1) (kernel B3's) into this rank's
    share of the global term; None with one rank."""
    if world_size() == 1:
        return None
    return s.detach().clamp_min(1.0) / batch_denom(s)


def global_max(x: Tensor) -> Tensor:
    """x's maximum over the ranks (no gradient)."""
    if world_size() == 1:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX)
    return y


@torch.no_grad()
def average_gradients(params) -> None:
    """Each parameter's gradient averaged over the ranks, in one
    all-reduce over their flattened concatenation (parameters without a
    gradient are skipped; every rank's model has the same ones)."""
    w = world_size()
    if w == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= w
    torch._foreach_copy_(grads, [f.view_as(g) for f, g in zip(
        flat.split([g.numel() for g in grads]), grads)])


@torch.no_grad()
def mean_metrics(metrics: dict[str, Tensor]) -> dict[str, Tensor]:
    """Each 0-d metric's mean over the ranks (the global batch's loss
    terms), in one all-reduce; every rank must hold the same keys."""
    w = world_size()
    if w == 1 or not metrics:
        return metrics
    keys = sorted(metrics)
    stack = torch.stack([metrics[k].float().reshape(()) for k in keys])
    dist.all_reduce(stack)
    stack /= w
    return dict(zip(keys, stack.unbind()))

