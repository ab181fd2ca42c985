"""Tensor parallelism of the fusion encoder on a grid's model axis.

Port of the layout of JAX ``parallel/mesh.py::tp_param_sharding``
(``mesh.tp_param_spec``), in Megatron's idiom: where JAX places each
parameter with a ``NamedSharding`` and lets GSPMD insert the collectives,
each rank here holds its block of every sharded parameter, and the forward
calls the collectives itself (``models/fusion_encoder.py``):

- ``in_proj`` is column-parallel **by heads** where the model axis divides
  the heads: the rank holds its heads' rows of q, k and v out of the packed
  ``[3D, D]`` weight and ``[3D]`` bias, and attends over those heads alone.
  That block is a permutation of JAX's, which cuts the packed axis into
  contiguous blocks across the q, k and v boundaries; no one sees it,
  because checkpoints hold the gathered tree. Where the axis divides ``3D``
  but not the heads, the rank holds a contiguous block, and q, k and v are
  gathered over the model axis and attended whole.
- ``linear1`` is column-parallel (its rows and bias), ``out_proj`` and
  ``linear2`` row-parallel (their columns), each with one all-reduce over the
  model axis; the replicated bias is added once, after the sum.
- The conv stacks' stem and block kernels are stored sharded on their output
  channels. The forward gathers each whole and runs the fused stage (K4 in
  training, K3 in eval) on every channel, because the stage's GroupNorm(1)
  and second conv need every channel; each rank keeps its block of the
  weight gradient, which is the same on every rank of the axis.
- Everything else is replicated, and its gradient is the same on every rank
  of the axis, so no collective sums it.

The collectives are ``torch.autograd.Function``s on the model axis's
process group: :func:`copy_to_model` (identity forward, all-reduce
backward), :func:`reduce_from_model` (all-reduce forward, identity
backward), :func:`gather_from_model` (all-gather forward, the rank's block of
the gradient backward) and :func:`scatter_to_model` (the rank's block
forward, all-gather backward).
"""

from __future__ import annotations

import typing as T

import torch
import torch.distributed as dist

from .mesh import Rank, tp_param_spec


class TensorParallel:
    """One rank's view of a model axis for a model whose parameters have the
    full shapes ``shapes`` (``{name: shape}``) and ``heads`` attention heads:
    which parameters are sharded, on which axis, which block is the rank's,
    and the collectives. ``rank`` is the rank within the model axis
    (``Rank.model``)."""

    def __init__(self, rank: Rank, heads: int, shapes: T.Mapping[str, T.Sequence[int]]):
        self.rank = rank
        self.size = rank.world
        self.index = rank.rank
        # in_proj column-parallel by heads (else by contiguous rows, attended whole)
        self.by_heads = heads % self.size == 0
        self.axes: T.Dict[str, int] = {}
        self.full_shapes: T.Dict[str, T.Tuple[int, ...]] = {}
        for name, shape in shapes.items():
            axis = tp_param_spec(name, tuple(shape), self.size)
            if axis is not None:
                self.axes[name] = axis
                self.full_shapes[name] = tuple(shape)

    def sharded(self, name: str) -> bool:
        return name in self.axes

    def _block(self, name: str, r: int) -> torch.Tensor:
        """The indices, along the sharded axis, of rank ``r``'s block of ``name``."""
        n = self.full_shapes[name][self.axes[name]]
        per = n // self.size
        if self.by_heads and name.endswith(("in_proj_weight", "in_proj_bias")):
            d, dl = n // 3, n // 3 // self.size
            return torch.cat([torch.arange(j * d + r * dl, j * d + (r + 1) * dl) for j in range(3)])
        return torch.arange(r * per, (r + 1) * per)

    def shard(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole tensor ``full`` of parameter ``name``
        (a replicated parameter's tensor as it is)."""
        if name not in self.axes:
            return full
        if tuple(full.shape) != self.full_shapes[name]:
            raise ValueError(f"{name}: expected the whole {self.full_shapes[name]}, got {tuple(full.shape)}")
        idx = self._block(name, self.index).to(full.device)
        return full.index_select(self.axes[name], idx).contiguous()

    def gather(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor of parameter ``name`` from every rank's block
        (a collective: every rank of the axis calls it, in the same order)."""
        if name not in self.axes:
            return local
        axis = self.axes[name]
        parts = [torch.empty_like(local) for _ in range(self.size)]
        dist.all_gather(parts, local.detach().contiguous(), group=self.rank.group)
        order = torch.cat([self._block(name, r) for r in range(self.size)]).to(local.device)
        full = torch.empty(self.full_shapes[name], dtype=local.dtype, device=local.device)
        return full.index_copy_(axis, order, torch.cat(parts, dim=axis))


def _all_reduce(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=tp.rank.group)
    return out


def _all_gather(x: torch.Tensor, tp: TensorParallel, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(tp.size)]
    dist.all_gather(parts, x.contiguous(), group=tp.rank.group)
    return torch.cat(parts, dim=dim)


def _own_block(x: torch.Tensor, tp: TensorParallel, dim: int) -> torch.Tensor:
    per = x.shape[dim] // tp.size
    return x.narrow(dim, tp.index * per, per).contiguous()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.tp), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x, tp)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return _all_gather(x, tp, dim)

    @staticmethod
    def backward(ctx, grad):
        # every rank of the axis computes the same function of the gathered
        # tensor, so the gradient's block of this rank is already whole
        return _own_block(grad, ctx.tp, ctx.dim), None, None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return _own_block(x, tp, dim)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad, ctx.tp, ctx.dim), None, None


def copy_to_model(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The replicated input of a column-parallel layer: identity forward; the
    backward sums the ranks' partial gradients over the model axis."""
    return _CopyToModel.apply(x, tp)


def reduce_from_model(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The partial output of a row-parallel layer summed over the model axis;
    the backward passes the (replicated) gradient through."""
    return _ReduceFromModel.apply(x, tp)


def gather_from_model(x: torch.Tensor, tp: TensorParallel, dim: int) -> torch.Tensor:
    """Every rank's equal block of ``x`` along ``dim``, concatenated in rank
    order; the backward keeps this rank's block of the gradient."""
    return _GatherFromModel.apply(x, tp, dim)


def scatter_to_model(x: torch.Tensor, tp: TensorParallel, dim: int) -> torch.Tensor:
    """This rank's contiguous block of the replicated ``x`` along ``dim``;
    the backward gathers the ranks' gradient blocks."""
    return _ScatterToModel.apply(x, tp, dim)
