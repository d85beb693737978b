"""Process groups, the batch split and the Conformer's tensor-parallel
rules (port of ``css_tpu/parallel/mesh.py``).

The JAX package lays a ``(data, model)`` mesh over the devices of its
processes and lets jit insert the collectives. Here one process (rank)
drives one card, and the mesh is a grid of ranks: rank = d * model + m,
the JAX package's device array reshaped ``(data, model)``. Each rank
belongs to one data group (the ranks with its m: gradients and BatchNorm
statistics are averaged there) and one model group (the ranks with its
d: the tensor-parallel shards of one replica of the parameters).

Every collective of the port is an ``all_reduce`` or a ``broadcast``: the
two that gloo takes on CUDA tensors, so one code runs under NCCL, gloo
on the CPU and gloo with ranks sharing a card. A gather is an all-reduce
of a zero-filled buffer into which each rank writes its own part.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

import torch
import torch.distributed as dist


def world() -> tuple:
    """(rank, world size): (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


class Mesh:
    """A ``(data, model)`` grid over the world's ranks, this rank's place
    in it, and its two process groups (None without a process group)."""

    def __init__(self, data: int, model: int, rank: int, data_group=None,
                 model_group=None):
        self.data, self.model, self.rank = data, model, rank
        self.data_group, self.model_group = data_group, model_group

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    def data_src(self) -> int:
        """The global rank of data rank 0 in this rank's data group."""
        return self.model_rank


def make_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """The ``(data, model)`` mesh over the world; raises when
    data * model is not the world size. Every rank must call it, in the
    same order as every other ``new_group``."""
    rank, n = world()
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} ranks")
    if not dist.is_initialized():
        return Mesh(data, model, rank)
    data_group = model_group = None
    for m in range(model):
        g = dist.new_group([d * model + m for d in range(data)])
        if rank % model == m:
            data_group = g
    for d in range(data):
        g = dist.new_group([d * model + m for m in range(model)])
        if rank // model == d:
            model_group = g
    return Mesh(data, model, rank, data_group, model_group)


def split_batch(batch: Dict, parts: int, index: int) -> Dict:
    """Part ``index`` of ``parts`` equal parts of a global batch's rows:
    every leaf with a leading batch axis is sliced, scalars (``win``,
    ``ovl``) are kept."""
    n = next(len(v) for v in batch.values() if getattr(v, "ndim", 0))
    if n % parts:
        raise ValueError(f"{n} rows do not split into {parts} equal parts")
    lo, hi = index * (n // parts), (index + 1) * (n // parts)
    return {k: (v[lo:hi] if getattr(v, "ndim", 0) else v)
            for k, v in batch.items()}


# ------------------------------------------------------------ collectives
class _AllReduceSum(torch.autograd.Function):
    """Sum over the group forward and backward: the global sums of every
    rank's local sums, whose gradient reaches every rank's inputs."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFrom(torch.autograd.Function):
    """Sum forward, identity backward: after a row-parallel product."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyTo(torch.autograd.Function):
    """Identity forward, sum backward: before a column-parallel product,
    whose input's gradient is the sum of every shard's part."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFrom.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyTo.apply(x, group)


# --------------------------------------------------------------------- TP
# The Conformer's tensor-parallel layout, as the JAX package's rules: each
# FFN a column -> row pair (w1 split on its outputs, w2 on its inputs), the
# attention's Q/K/V split by heads (outputs) and linear_out on its inputs.
# Parameter name -> the torch weight's split dimension (Linear weights are
# (out, in)); a column-parallel layer's bias is split with its outputs.
_TP_RULES = [
    (re.compile(r"feed_forward_(in|out)\.w1\.(weight|bias)$"), 0),
    (re.compile(r"feed_forward_(in|out)\.w2\.weight$"), 1),
    (re.compile(r"self_attn\.linear_[qkv]\.(weight|bias)$"), 0),
    (re.compile(r"self_attn\.linear_out\.weight$"), 1),
]


def conformer_tp_spec(names) -> Dict[str, int]:
    """{parameter name: split dimension} for the TP-sharded parameters
    among ``names`` (a state_dict or any iterable of its keys)."""
    spec = {}
    for name in names:
        for pat, dim in _TP_RULES:
            if pat.search(name):
                spec[name] = dim
                break
    return spec


def shard_params(state: Dict[str, torch.Tensor], spec: Dict[str, int],
                 index: int, parts: int) -> Dict[str, torch.Tensor]:
    """Shard ``index`` of ``parts`` of a full state_dict: every entry in
    ``spec`` cut into equal parts along its dimension, the rest whole."""
    out = {}
    for k, v in state.items():
        if k in spec:
            size = v.shape[spec[k]]
            if size % parts:
                raise ValueError(f"{k}: {size} does not split into {parts}")
            v = v.narrow(spec[k], index * (size // parts), size // parts)
        out[k] = v
    return out


def gather_params(shards: List[Dict[str, torch.Tensor]],
                  spec: Dict[str, int]) -> Dict[str, torch.Tensor]:
    """The inverse of ``shard_params``: the full state_dict."""
    return {k: (torch.cat([s[k] for s in shards], dim=spec[k]) if k in spec
                else shards[0][k]) for k in shards[0]}


def gather_shard(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """This rank's shard -> the full tensor on every rank of its model
    group (an all-reduce of a zero-filled buffer)."""
    if mesh.model == 1:
        return t
    shape = list(t.shape)
    size = shape[dim]
    shape[dim] = size * mesh.model
    full = t.new_zeros(shape)
    full.narrow(dim, mesh.model_rank * size, size).copy_(t)
    dist.all_reduce(full, group=mesh.model_group)
    return full
