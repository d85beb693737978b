"""A few train steps of a parallel strategy, from a saved state on saved
global batches, one process per rank; each rank writes what it saw.

    python -m css_tpu_torch.parallel.runner SPEC.json --rank R \\
        --coordinator HOST:PORT

``run(spec, workdir)`` writes the spec, starts the ranks (strategy
``single`` runs with no process group, in this process unless the spec
says ``spawn``), waits for them with a time limit and returns each rank's
results. It is the harness of the parity tests
(``tests/test_torch_parallel*.py``) and of ``chip_smoke.py``'s parallel
phase. The spec (JSON):

  strategy    single | dp | replica (or collectives: only the port's
              collectives on the ranks' devices)
  world, tp   ranks, and the model axis of dp's mesh (data = world / tp)
  device      cpu | cuda (rank r on cuda:{r % count})
  model       {"name": ..., "conf": {...}}  (``MODELS[name].build_model``)
  objective   {"name": ..., "conf": {...}}
  trainer     {"optim", "lr", "warmup", "grad_thresh", "weight_decay",
               "seed", "input_domain"}
  init        a checkpoint (JAX layout) every rank starts from; for
              replica a list of one per replica, or one checkpoint of
              stacked replicas (the JAX package's ReplicaAveraging state)
  batches     an npz of global batches (``save_batches``)
  steps       steps to take; step 0's gradients are recorded
  timed_steps more steps after those, timed only (``timed_ms``)
  spawn       single only: run in a process of its own, as the ranks do
  split_like_tp  single only: a Conformer computing its TP layers as
              that many TP ranks would (``split_like_tp``), the witness
              a TP step is held to
  local_bn    dp only: per-rank BatchNorm statistics (a control)
  averages    replica only: alive masks to average with, each from the
              state after the steps
  timeout_s   the process group's and the wait's limit

Each rank writes ``rank{r}.npz`` (``grad/<path>``: step 0's gradients,
averaged and, under TP, gathered to full shape; ``stats0/<path>``: the
BatchNorm running statistics after step 0; ``param/<path>`` and
``stats/<path>`` after the steps; ``replica0/...``, replica 0's state
then; ``avg<i>/param/<path>``... after each average) and
``rank{r}.json`` (losses, gradient norms, step ms, each kernel's
launches and plain routes in the steps, the backend, and for dp whether
every rank ended bit-equal).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import types
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from css_tpu_torch.models import MODELS, from_jax, to_jax
from css_tpu_torch.models.conformer import set_batchnorm_group
from css_tpu_torch.objectives import OBJECTIVES
from css_tpu_torch.ops import istft_cuda, lstm_cuda, stft_mag_cuda
from css_tpu_torch.parallel import launch
from css_tpu_torch.parallel.dp import DataParallel, ReplicaAveraging
from css_tpu_torch.parallel.mesh import (conformer_tp_spec, gather_shard,
                                         make_mesh)
from css_tpu_torch.trainer.checkpoint import load_checkpoint
from css_tpu_torch.trainer.loop import Trainer
from css_tpu_torch.trainer.lr_schedule import LRSchedule


KERNELS = (stft_mag_cuda.stft_mag, istft_cuda.istft, lstm_cuda.lstm_fused)


def save_batches(path, batches: List[Dict[str, np.ndarray]]) -> None:
    np.savez(path, **{f"{i}/{k}": np.asarray(v) for i, b in
                      enumerate(batches) for k, v in b.items()})


def load_batches(path) -> List[Dict[str, np.ndarray]]:
    with np.load(path) as z:
        out: Dict[int, Dict] = {}
        for key in z.files:
            i, _, k = key.partition("/")
            out.setdefault(int(i), {})[k] = z[key]
    return [out[i] for i in sorted(out)]


def _flat(tree, prefix: str) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _state_arrays(state, prefix: str = "") -> Dict[str, np.ndarray]:
    return {**_flat(state.params, prefix + "param/"),
            **_flat(state.batch_stats, prefix + "stats/")}


def _part(t: torch.Tensor, dim: int, index: int, parts: int):
    return t.chunk(parts, dim)[index].contiguous()


def split_like_tp(model, parts: int) -> None:
    """Make a full Conformer compute each tensor-parallel layer as
    ``parts`` TP ranks do, in one process: each rank's input its own copy
    (its gradient summed over the rank's uses first, as TP's ``copy_to``
    sums it), w1 and Q/K/V one output slice a rank (the attention one
    head group a rank), w2 and linear_out the sum of the ranks' partial
    products in rank order, then the bias. The model's function, with
    TP's order of sums: the witness a TP step is held to where the order
    of a sum alone moves the gradient by more than the gates (random
    weights, ``chip_smoke.py`` phase 9 (c)). Two ranks' sums are exact in
    either order, so TP = 2 should meet it to a few ulps."""
    from css_tpu_torch.models.conformer import (FeedForward,
                                                RelPosMultiHeadAttention)

    def feed_forward(self, x):
        x = self.layer_norm(x)
        y = None
        for r in range(parts):
            h = F.relu(F.linear(x.clone(), _part(self.w1.weight, 0, r, parts),
                                _part(self.w1.bias, 0, r, parts)))
            p = F.linear(self.drop(h), _part(self.w2.weight, 1, r, parts))
            y = p if y is None else y + p
        return self.drop(y + self.w2.bias)

    def attention(self, x, pos_k, mask=None):
        x = self.layer_norm(x)
        b, t, _ = x.shape
        y = None
        for r in range(parts):
            xr = x.clone()
            q, k, v = (F.linear(xr, _part(lin.weight, 0, r, parts),
                                _part(lin.bias, 0, r, parts))
                       .reshape(b, t, -1, self.d_k).transpose(1, 2)
                       for lin in (self.linear_q, self.linear_k,
                                   self.linear_v))
            ctx = self._context(q, k, v, None if pos_k is None
                                else pos_k.clone(), mask)
            p = F.linear(ctx, _part(self.linear_out.weight, 1, r, parts))
            y = p if y is None else y + p
        return self.drop(y + self.linear_out.bias)

    for m in model.modules():
        if isinstance(m, FeedForward):
            m.forward = types.MethodType(feed_forward, m)
        elif isinstance(m, RelPosMultiHeadAttention):
            m.forward = types.MethodType(attention, m)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_rank(spec: Dict, rank: int, coordinator: str = None) -> Dict:
    """One rank's run; returns (and, with ``spec["out"]``, writes) its
    results."""
    strategy, world, tp = spec["strategy"], spec.get("world", 1), \
        spec.get("tp", 1)
    if strategy == "single":
        dev = torch.device(spec["device"])
        backend = None
    else:
        dev = launch.initialize(coordinator, world, rank, spec["device"],
                                spec.get("timeout_s", 60.0))
        backend = dist.get_backend()
    if strategy == "collectives":
        return _collectives(spec, rank, world, dev)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(int(spec.get("threads", 2)))
    mesh = make_mesh(model=tp) if strategy != "single" else None
    mconf, tconf = spec["model"], spec["trainer"]
    cls = MODELS[mconf["name"]]
    model = (cls.build_model(mconf["conf"], tp_group=mesh.model_group)
             if tp > 1 else cls.build_model(mconf["conf"]))
    init, replica = spec["init"], None
    if strategy == "replica":
        # one checkpoint per replica, or one of stacked replicas
        if isinstance(init, list):
            init = init[rank]
        else:
            replica = rank
    ckpt = load_checkpoint(init)
    full = from_jax(model, ckpt["params"], ckpt.get("batch_stats"),
                    replica=replica)
    if spec.get("split_like_tp"):
        split_like_tp(model, spec["split_like_tp"])
    spec_tp = conformer_tp_spec(full) if tp > 1 else {}
    trainer = Trainer(
        model, OBJECTIVES[spec["objective"]["name"]].build_objective(
            spec["objective"].get("conf", {})),
        LRSchedule(lr=tconf.get("lr", 1e-3), warmup=tconf.get("warmup", 0)),
        optim=tconf.get("optim", "sgd"),
        weight_decay=tconf.get("weight_decay", 0.0),
        grad_thresh=tconf.get("grad_thresh", 30.0),
        input_domain=tconf.get("input_domain", "stft"), device=dev,
        seed=tconf.get("seed", 0))
    if strategy == "dp":
        strat = DataParallel(trainer, mesh, tp_spec=spec_tp)
        strat.load_full(full)
        if spec.get("local_bn"):
            set_batchnorm_group(model, None)
    else:
        model.load_state_dict(full)
        strat = (ReplicaAveraging(trainer, mesh) if strategy == "replica"
                 else None)
    batches = load_batches(spec["batches"])
    out: Dict[str, np.ndarray] = {}
    rec = {"rank": rank, "backend": backend, "device": str(dev),
           "losses": [], "grad_norms": [], "step_ms": []}
    for k in KERNELS:
        k.launches = k.plain_routes = 0
    for i in range(spec["steps"]):
        batch = batches[i % len(batches)]
        if strat is not None:
            batch = strat.shard_batch(batch)
        _sync(dev)
        t = time.perf_counter()
        stats = [b.clone() for b in model.buffers()]
        loss, aux, norm = trainer.compute_grads(batch)
        if i == 0:
            named = dict(zip(trainer.names, [p.grad for p in
                                             model.parameters()]))
            if strategy == "dp":
                named = strat.full(named)
            out.update(_flat(to_jax(named)[0], "grad/"))
        m = trainer.apply_grads(loss, aux, norm, stats)
        if i == 0:
            out.update(_flat(to_jax(dict(model.named_buffers()))[1],
                             "stats0/"))
        _sync(dev)
        rec["step_ms"].append(1e3 * (time.perf_counter() - t))
        rec["losses"].append(float(m["loss"]))
        rec["grad_norms"].append(float(m["grad_norm"]))
    rec["launches"] = {k.__name__: k.launches for k in KERNELS}
    rec["plain_routes"] = {k.__name__: k.plain_routes for k in KERNELS}
    out.update(_state_arrays(trainer.state()))
    if strategy == "dp":
        rec["in_sync"] = strat.in_sync()
    rec["timed_ms"] = []
    for i in range(spec.get("timed_steps", 0)):
        batch = batches[i % len(batches)]
        if strat is not None:
            batch = strat.shard_batch(batch)
        _sync(dev)
        t = time.perf_counter()
        stats = [b.clone() for b in model.buffers()]
        trainer.apply_grads(*trainer.compute_grads(batch), stats)
        _sync(dev)
        rec["timed_ms"].append(1e3 * (time.perf_counter() - t))
    if strategy == "replica":
        out.update(_state_arrays(strat.replica_state(0), "replica0/"))
        leaves = trainer.float_leaves()
        saved = [t.detach().clone() for t in leaves]
        for a, alive in enumerate(spec.get("averages", [])):
            strat.average(alive)
            out.update(_state_arrays(trainer.state(), f"avg{a}/"))
            with torch.no_grad():
                for t, s in zip(leaves, saved):
                    t.copy_(s)
    if spec.get("out"):
        d = Path(spec["out"])
        np.savez(d / f"rank{rank}.npz", **out)
        (d / f"rank{rank}.json").write_text(json.dumps(rec))
    if strategy != "single":
        dist.destroy_process_group()
    return {"arrays": out, **rec}


def _collectives(spec: Dict, rank: int, world: int, dev) -> Dict:
    """The port's collectives on this rank's device: an all-reduce, a
    broadcast from the last rank and a gather of one shard per rank."""
    x = torch.full((4,), float(rank + 1), device=dev)
    dist.all_reduce(x)
    y = torch.full((3,), float(rank), device=dev)
    dist.broadcast(y, src=world - 1)
    mesh = make_mesh(data=1, model=world)
    g = gather_shard(torch.full((2, 1), float(rank), device=dev), 1, mesh)
    rec = {"rank": rank, "backend": dist.get_backend(), "device": str(dev),
           "all_reduce": x.cpu().tolist(), "broadcast": y.cpu().tolist(),
           "gather": g.cpu().tolist()}
    if spec.get("out"):
        Path(spec["out"], f"rank{rank}.json").write_text(json.dumps(rec))
        np.savez(Path(spec["out"], f"rank{rank}.npz"))
    dist.destroy_process_group()
    return rec


def run(spec: Dict, workdir, timeout: float = None) -> List[Dict]:
    """Write ``spec`` under ``workdir``, run every rank, return their
    results (rank order)."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    spec = dict(spec, out=str(workdir))
    if spec["strategy"] == "single" and not spec.get("spawn"):
        return [run_rank(spec, 0)]
    path = workdir / "spec.json"
    path.write_text(json.dumps(spec))
    world = spec.get("world", 1)
    timeout = timeout or 4 * spec.get("timeout_s", 60.0)
    procs = launch.spawn_local_workers(
        lambda r, coord: [sys.executable, "-m",
                          "css_tpu_torch.parallel.runner", str(path),
                          "--rank", str(r), "--coordinator", coord], world)
    launch.wait_all(procs, timeout=timeout)
    results = []
    for r in range(world):
        rec = json.loads((workdir / f"rank{r}.json").read_text())
        with np.load(workdir / f"rank{r}.npz") as z:
            rec["arrays"] = {k: z[k] for k in z.files}
        results.append(rec)
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("spec")
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--coordinator", required=True)
    args = parser.parse_args(argv)
    spec = json.loads(Path(args.spec).read_text())
    run_rank(spec, args.rank, args.coordinator)


if __name__ == "__main__":
    main()
