"""The device mesh as a process group, the collectives, and data-parallel
helpers (counterpart of `jamun_tpu/parallel/mesh.py`).

JAX's one-axis "data" mesh becomes the process group, one rank per card.
Every rank loads the same global batch from the same seed and keeps its
contiguous slice of the graph axis (`shard_batch`): JAX's single-host
semantics. Parameters are replicated (`replicate` broadcasts rank 0's).

The collectives state their autograd rules, which JAX derives from
`shard_map`'s transpose:
  - `gather_replicated`: all-gather of rows whose cotangent is the same on
    every rank (an arch's output under a replicated loss); the backward
    keeps this rank's slice and sums nothing.
  - `gather_halo`: all-gather of rows each rank reads in part (the source
    features of its destination rows); the backward is a reduce-scatter:
    the sum over ranks, then this rank's slice.
gloo has only broadcast and all-reduce for CUDA tensors, so there an
all-gather sums each rank's slice into a zero tensor (exact: one nonzero
term per element).

Random draws: a `GraphShardGenerator` draws the normal noise of the global
batch (world x the local graphs) and keeps this rank's rows
(`randn_graphs`), so a data-parallel walk or training step sees the draws of
the single-process run.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from jamun_tpu_torch.ops.graph import GraphBatch

__all__ = [
    "Mesh", "make_mesh", "shard_batch", "replicate", "data_parallel_shardings",
    "pad_batch_to_multiple", "resolve_group", "check_axis_name", "all_gather", "gather_replicated",
    "gather_halo",
    "all_reduce_sum", "all_reduce_max", "all_reduce_grads", "global_graph_mean", "GraphShardGenerator",
    "randn_graphs", "make_generator",
]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of one process group: `size`, this process's `rank`, and
    the `group` (None for the single process, whose collectives are
    identities)."""

    size: int = 1
    rank: int = 0
    group: Any = None

    @property
    def distributed(self) -> bool:
        return self.group is not None


def make_mesh(num_devices: Optional[int] = None, group=None) -> Mesh:
    """The mesh of the process group (`group`, else the default one). Without
    a group it is the single process, for `num_devices` None or 1; a
    `num_devices` that differs from the world size raises."""
    if group is None and not dist.is_initialized():
        if num_devices not in (None, 1):
            raise ValueError(
                f"num_devices={num_devices} needs a process group of {num_devices} ranks "
                "(launch with torchrun --nproc_per_node, or parallel.distributed."
                "initialize_distributed)"
            )
        return Mesh()
    group = group or dist.group.WORLD
    size = dist.get_world_size(group)
    if num_devices is not None and num_devices != size:
        raise ValueError(f"num_devices={num_devices} but the process group has {size} ranks")
    return Mesh(size, dist.get_rank(group), group)


def resolve_group(axis):
    """A process group, or the axis name "data" (the default group, which
    must be set up)."""
    if isinstance(axis, str):
        check_axis_name(axis)
        if not dist.is_initialized():
            raise ValueError(
                "the axis 'data' is the default process group, which is not set up "
                "(torchrun, or parallel.distributed.initialize_distributed)"
            )
        return dist.group.WORLD
    return axis


def check_axis_name(axis) -> None:
    """An axis given by name must be "data", the default group's."""
    if isinstance(axis, str) and axis != "data":
        raise ValueError(f"atom_axis={axis!r}: a process group, or 'data' for the default one")


def _rows(batch_size: int, mesh: Mesh) -> Tuple[int, int]:
    if batch_size % mesh.size:
        raise ValueError(
            f"{batch_size} graphs over {mesh.size} ranks: pad_batch_to_multiple first"
        )
    n = batch_size // mesh.size
    return mesh.rank * n, n


def shard_batch(batch, mesh: Mesh):
    """This rank's contiguous slice of the leading (graph or chain) axis of
    every tensor of `batch` (a GraphBatch, a tensor or a dict of them)."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    G = batch.pos.shape[0] if isinstance(batch, GraphBatch) else batch.shape[0]
    start, n = _rows(G, mesh)

    def take(t):
        return t.narrow(0, start, n) if t.ndim and t.shape[0] == G else t

    return batch.map(take) if isinstance(batch, GraphBatch) else take(batch)


def _state_tensors(obj) -> list:
    if isinstance(obj, nn.Module):
        return list(obj.parameters()) + list(obj.buffers())
    if isinstance(obj, torch.optim.Optimizer):
        return [
            t for group in obj.param_groups for p in group["params"]
            for t in obj.state.get(p, {}).values() if torch.is_tensor(t)
        ]
    if torch.is_tensor(obj):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _state_tensors(o)]
    if dataclasses.is_dataclass(obj):
        return [t for f in dataclasses.fields(obj) for t in _state_tensors(getattr(obj, f.name))]
    return []


@torch.no_grad()
def replicate(tree, mesh: Mesh):
    """Broadcast rank 0's tensors of `tree` (a module, an optimizer's state,
    a TrainState, tensors) to every rank, in place; returns `tree`."""
    if mesh.distributed:
        for t in _state_tensors(tree):
            dist.broadcast(t.data, src=dist.get_global_rank(mesh.group, 0), group=mesh.group)
    return tree


def data_parallel_shardings(mesh: Mesh):
    """(replicated, batch-sharded) placements: `replicate` and `shard_batch`
    bound to `mesh`."""
    return (lambda tree: replicate(tree, mesh)), (lambda batch: shard_batch(batch, mesh))


def pad_batch_to_multiple(batch, multiple: int):
    """Pad the graph axis with masked dummy graphs (zeros) to a multiple of
    `multiple`."""
    G = batch.pos.shape[0]
    pad = (-G) % multiple
    if pad == 0:
        return batch

    def pad_arr(x):
        if x.ndim == 0 or x.shape[0] != G:
            return x
        return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))], dim=0)

    return batch.map(pad_arr)


# ---- collectives ----


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' `x` concatenated along `dim` (no autograd). A group of
    one rank still runs the collective."""
    if group is None:
        return x
    world = dist.get_world_size(group)
    is_bool = x.dtype == torch.bool
    if is_bool:
        x = x.to(torch.uint8)
    x = x.contiguous()
    if x.is_cuda and dist.get_backend(group) == "gloo":
        # gloo has broadcast and all-reduce alone for CUDA tensors
        n = x.shape[dim]
        full = x.new_zeros(tuple(x.shape[:dim]) + (n * world,) + tuple(x.shape[dim + 1:]))
        full.narrow(dim, dist.get_rank(group) * n, n).copy_(x)
        _all_reduce(full, group)
    else:
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x, group=group)
        full = torch.cat(parts, dim=dim)
    return full.to(torch.bool) if is_bool else full


def _all_reduce(x: torch.Tensor, group) -> None:
    """In-place sum over the ranks; under gloo a bf16 or f16 tensor is summed
    in f32 and rounded once (gloo's reductions take f32)."""
    if x.dtype in (torch.bfloat16, torch.float16) and dist.get_backend(group) == "gloo":
        wide = x.float()
        dist.all_reduce(wide, group=group)
        x.copy_(wide)
    else:
        dist.all_reduce(x, group=group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ranks of `x` (a new tensor; no autograd)."""
    x = x.detach().clone()
    if group is not None:
        _all_reduce(x, group)
    return x


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The largest over ranks of `x` (a new tensor; no autograd)."""
    x = x.detach().clone()
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        start = dist.get_rank(ctx.group) * ctx.n
        return grad.narrow(ctx.dim, start, ctx.n).contiguous(), None, None


class _GatherHalo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        total = grad.contiguous().clone()
        _all_reduce(total, ctx.group)
        start = dist.get_rank(ctx.group) * ctx.n
        return total.narrow(ctx.dim, start, ctx.n).contiguous(), None, None


def gather_replicated(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """All-gather along `dim`; the backward takes this rank's slice of a
    cotangent that every rank holds whole. `x` itself without a group."""
    if group is None or not x.requires_grad or x.dtype == torch.bool:
        return all_gather(x, group, dim)
    return _GatherReplicated.apply(x, group, dim)


def gather_halo(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """All-gather along `dim`; the backward is a reduce-scatter (each rank's
    cotangent covers only the rows it read). `x` itself without a group."""
    if group is None or not x.requires_grad or x.dtype == torch.bool:
        return all_gather(x, group, dim)
    return _GatherHalo.apply(x, group, dim)


@torch.no_grad()
def all_reduce_grads(params, mesh: Mesh) -> None:
    """Sum every parameter's gradient over the ranks, in one flat buffer per
    dtype (a parameter without one takes zeros, as every rank does)."""
    if not mesh.distributed:
        return
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    by_dtype: Dict[torch.dtype, list] = {}
    for p in params:
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        _all_reduce(flat, mesh.group)
        parts = flat.split([g.numel() for g in grads])
        torch._foreach_copy_(grads, [v.view_as(g) for v, g in zip(parts, grads)])


def global_graph_mean(per_graph: torch.Tensor, aux: Dict[str, torch.Tensor], graph_mask, mesh: Mesh):
    """`masked_graph_mean` over the valid graphs of every rank: (this rank's
    masked sum over the global count, whose gradients summed over the ranks
    are the global mean's; aux with the global means, equal on every rank,
    "loss" among them). Padded dummy graphs count on no rank."""
    gm = graph_mask.to(per_graph.dtype)
    denom = torch.clamp(all_reduce_sum(gm.sum(), mesh.group), min=1.0)
    loss = (per_graph * gm).sum() / denom
    names = list(aux)
    local = torch.stack([(aux[k].detach() * gm).sum() / denom for k in names] + [loss.detach()])
    total = all_reduce_sum(local, mesh.group)
    out = {k: total[i] for i, k in enumerate(names)}
    out["loss"] = total[-1]
    return loss, out


# ---- random draws ----


class GraphShardGenerator(torch.Generator):
    """A torch.Generator of one rank of `world` that splits the graph axis:
    `randn_graphs` draws the global batch's noise and keeps rows
    [rank * G, (rank + 1) * G) of it. Any other draw is the plain
    generator's, the same on every rank."""

    def __new__(cls, device="cpu", rank: int = 0, world: int = 1):
        return super().__new__(cls, device)

    def __init__(self, device="cpu", rank: int = 0, world: int = 1):
        self.rank, self.world = rank, world


def randn_graphs(shape, generator: torch.Generator, dtype=None, device=None) -> torch.Tensor:
    """torch.randn(shape) whose leading axis is graphs or chains: under a
    `GraphShardGenerator` this rank's rows of the global draw."""
    shape = tuple(shape)
    device = device if device is not None else generator.device
    world = getattr(generator, "world", 1)
    if world == 1:
        return torch.randn(shape, generator=generator, dtype=dtype, device=device)
    full = torch.randn((shape[0] * world,) + shape[1:], generator=generator, dtype=dtype, device=device)
    return full.narrow(0, generator.rank * shape[0], shape[0])


def make_generator(device, seed: int, mesh: Optional[Mesh] = None) -> torch.Generator:
    """A generator on `device` seeded with `seed`; graph-sharded over a
    distributed mesh."""
    if mesh is None or not mesh.distributed:
        return torch.Generator(device=device).manual_seed(seed)
    return GraphShardGenerator(device, mesh.rank, mesh.size).manual_seed(seed)
