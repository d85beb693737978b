"""Distributed training strategies (port of ``css_tpu/parallel/dp.py``).

* ``DataParallel``: synchronous data parallelism, optionally with the
  Conformer's tensor parallelism. Every rank builds the same initial
  state (``load_full``), and data rank 0's is broadcast over each data
  group, so the ranks start bit-equal. Each rank runs the step on its
  rows of the global batch; BatchNorm takes its statistics over the data
  group's global batch; the gradients and the loss are averaged over the
  data group before the global-norm clip (so the clip, Adam, the schedule
  and the non-finite skip see the same values on every rank), and the
  norm sums the tensor-parallel shards over the model group. Each data rank draws
  its own dropout (seed + 7919 * data rank); the model group's ranks
  draw alike, as they hold the same rows.

  Every objective of the port reduces by a plain mean over the batch's
  examples (the PIT losses, the noise, order and consistency terms,
  ``objectives/``), so with equal row counts per rank the mean of the
  ranks' losses is the global batch's loss and its gradient the mean of
  theirs (``tests/test_torch_parallel.py`` holds each on split batches).

* ``ReplicaAveraging``: the reference's algorithm, N independent
  replicas averaged at epoch boundaries, one replica per rank. Steps run
  with no collective; ``average(alive=)`` is one all-reduce of every
  float leaf of the training state (parameters, BatchNorm statistics,
  Adam's moments) weighted by the alive mask renormalised over the
  survivors; counts stay as they are.

The JAX package's strategies also take the device-mix pools to replicate
them over the mesh; here each rank's ``DeviceMixer`` holds its own copy
of the pools on its own card.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from css_tpu_torch.models.conformer import set_batchnorm_group
from css_tpu_torch.parallel.mesh import (Mesh, gather_shard, make_mesh,
                                         shard_params, split_batch)
from css_tpu_torch.trainer.checkpoint import TrainState
from css_tpu_torch.trainer.loop import Trainer

SEED_STRIDE = 7919  # the per-process seed offset of css_tpu's cli.train


def _flat_all_reduce(tensors, group, scale: float = 1.0) -> None:
    """In place: every tensor summed over ``group`` (one collective over
    a float32 buffer of them all), times ``scale``."""
    if not tensors:
        return
    flat = torch.cat([t.detach().float().reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    if scale != 1.0:
        flat.mul_(scale)
    off = 0
    with torch.no_grad():
        for t in tensors:
            n = t.numel()
            t.copy_(flat[off:off + n].view_as(t))
            off += n


def _broadcast(tensors, src: int, group) -> None:
    if not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.broadcast(flat, src=src, group=group)
    off = 0
    with torch.no_grad():
        for t in tensors:
            n = t.numel()
            t.copy_(flat[off:off + n].view_as(t))
            off += n


def state_digest(trainer: Trainer) -> str:
    """sha256 of the trainer's parameters and buffers as stored."""
    h = hashlib.sha256()
    for t in list(trainer.model.parameters()) + list(trainer.model.buffers()):
        h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


class DataParallel:
    """A Trainer's step over a (data, model) mesh of ranks."""

    def __init__(self, trainer: Trainer, mesh: Optional[Mesh] = None,
                 tp_spec: Optional[Dict[str, int]] = None):
        self.trainer = trainer
        self.mesh = mesh if mesh is not None else make_mesh()
        self.tp_spec = dict(tp_spec or {})
        if self.tp_spec and self.mesh.model == 1:
            raise ValueError("a TP spec needs a mesh with model > 1")
        names = trainer.names
        self._sharded = [n in self.tp_spec for n in names]
        set_batchnorm_group(trainer.model, self.mesh.data_group)
        trainer.comm = self
        trainer.generator.manual_seed(trainer.seed
                                      + SEED_STRIDE * self.mesh.data_rank)

    # ------------------------------------------------------------ state
    def sync(self) -> None:
        """Broadcast data rank 0's parameters and buffers over each data
        group (the ranks built the same state; this makes it bit-equal)."""
        if self.mesh.data_group is None or self.mesh.data == 1:
            return
        model = self.trainer.model
        _broadcast(list(model.parameters()) + list(model.buffers()),
                   self.mesh.data_src(), self.mesh.data_group)

    def load_full(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """The initial state: load a full state_dict (every rank builds
        the same one) into this rank's model, its TP shard under tensor
        parallelism, then ``sync``."""
        self.trainer.model.load_state_dict(self.local(state_dict))
        self.sync()

    def local(self, named: Dict[str, torch.Tensor]) -> Dict:
        """Full tensors -> this rank's TP shards."""
        if not self.tp_spec:
            return named
        return shard_params(named, self.tp_spec, self.mesh.model_rank,
                            self.mesh.model)

    def full(self, named: Dict[str, torch.Tensor]) -> Dict:
        """This rank's TP shards -> full tensors (a collective over the
        model group)."""
        if not self.tp_spec:
            return named
        return {k: (gather_shard(v.detach(), self.tp_spec[k], self.mesh)
                    if k in self.tp_spec else v) for k, v in named.items()}

    def in_sync(self) -> bool:
        """Whether every rank holds data rank 0's parameters and buffers
        bit for bit (a collective)."""
        if self.mesh.data_group is None or self.mesh.data == 1:
            return True
        model = self.trainer.model
        mine = [t.detach().clone() for t in
                list(model.parameters()) + list(model.buffers())]
        theirs = [t.clone() for t in mine]
        _broadcast(theirs, self.mesh.data_src(), self.mesh.data_group)
        diff = torch.tensor([float(any(not torch.equal(a, b)
                                       for a, b in zip(mine, theirs)))],
                            device=mine[0].device)
        dist.all_reduce(diff)
        return float(diff) == 0.0

    # ---------------------------------------------------- trainer hooks
    def reduce(self, loss: torch.Tensor, grads) -> torch.Tensor:
        """Average the gradients (in place) and the loss over the data
        group; returns the global loss."""
        if self.mesh.data_group is None:
            return loss
        loss = loss.detach().float().reshape(1).clone()
        _flat_all_reduce(list(grads) + [loss], self.mesh.data_group,
                         1.0 / self.mesh.data)
        return loss[0]

    def grad_norm(self, grads) -> torch.Tensor:
        """The global gradient norm: the TP shards' squares summed over
        the model group, the replicated parameters' counted once."""
        rep = [g for g, s in zip(grads, self._sharded) if not s]
        sh = [g for g, s in zip(grads, self._sharded) if s]
        sq = sum(torch.sum(torch.square(g)) for g in rep)
        if sh:
            sq_sh = sum(torch.sum(torch.square(g)) for g in sh)
            dist.all_reduce(sq_sh, group=self.mesh.model_group)
            sq = sq + sq_sh
        return torch.sqrt(sq)

    # ------------------------------------------------------------- step
    def shard_batch(self, batch: Dict) -> Dict:
        """This rank's rows of a global batch (a process of ``cli.train
        --multihost`` feeds its own rows and skips this); the step is the
        trainer's own."""
        return split_batch(batch, self.mesh.data, self.mesh.data_rank)


class ReplicaAveraging:
    """One independent replica per rank, averaged on demand."""

    def __init__(self, trainer: Trainer, mesh: Optional[Mesh] = None,
                 num_replicas: Optional[int] = None):
        self.trainer = trainer
        self.mesh = mesh if mesh is not None else make_mesh()
        world = self.mesh.world
        self.num_replicas = (num_replicas if num_replicas is not None
                             else world)
        if not 1 <= self.num_replicas <= world:
            raise ValueError(f"{self.num_replicas} replicas on {world} "
                             "ranks (one replica per rank at most)")
        self.replica = (self.mesh.rank if self.mesh.rank < self.num_replicas
                        else None)
        trainer.generator.manual_seed(trainer.seed
                                      + SEED_STRIDE * self.mesh.rank)

    def shard_batch(self, batch: Dict) -> Dict:
        """This replica's rows of the global batch (J * B rows); the step
        is the trainer's own, with no collective."""
        if self.replica is None:
            raise RuntimeError(f"rank {self.mesh.rank} holds no replica")
        return split_batch(batch, self.num_replicas, self.replica)

    def average(self, alive=None) -> None:
        """Every float leaf of every replica's state set to the mean over
        the alive replicas (``alive`` (J,) bool, default all)."""
        alive = (np.ones(self.num_replicas, bool) if alive is None
                 else np.asarray(alive, bool))
        if alive.shape != (self.num_replicas,) or not alive.any():
            raise ValueError(f"alive {alive} for {self.num_replicas} "
                             "replicas (at least one alive)")
        w = alive / alive.sum()
        mine = float(w[self.replica]) if self.replica is not None else 0.0
        leaves = self.trainer.float_leaves()
        if self.mesh.world == 1:
            return
        flat = torch.cat([t.detach().float().reshape(-1) for t in leaves])
        flat.mul_(mine)
        dist.all_reduce(flat)
        off = 0
        with torch.no_grad():
            for t in leaves:
                n = t.numel()
                t.copy_(flat[off:off + n].view_as(t))
                off += n

    def replica_state(self, j: int = 0) -> TrainState:
        """Replica ``j``'s state as a TrainState (for evaluation and
        checkpoints): a collective, every rank calls it."""
        if self.mesh.world == 1:
            return self.trainer.state()
        leaves = self.trainer.float_leaves()
        saved = [t.detach().clone() for t in leaves]
        _broadcast(leaves, j, None)
        try:
            return self.trainer.state()
        finally:
            with torch.no_grad():
                for t, s in zip(leaves, saved):
                    t.copy_(s)
