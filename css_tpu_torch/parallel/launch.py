"""Multi-process launch (port of ``css_tpu/parallel/launch.py``).

One process (rank) drives one card, ``cuda:{local_rank % device_count}``,
its local rank counted among the ranks of its host. The JAX package's
``jax.distributed.initialize(coordinator, num_processes, process_id)``
becomes ``torch.distributed.init_process_group`` on a TCP store at
``<coordinator>``, with a timeout on every collective and a backend by a
stated rule (``plan_ranks``), never a fallback: NCCL where every rank has
a card of its own, gloo on the CPU and where ranks share a card. A failed
initialisation raises.

    python -m css_tpu_torch.parallel.launch --num-processes 2 -- \\
        --expdir exp --strategy dp ...

runs N local workers of ``css_tpu_torch.cli.train --multihost`` (a cluster
on one machine), forwarding everything after ``--``; ``wait_all`` stops
every worker as soon as one fails or the time limit passes.
"""

from __future__ import annotations

import datetime
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from css_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

DEFAULT_TIMEOUT_S = 600.0


def rank_device(device: str, local_rank: int, cards: int) -> torch.device:
    """A rank's device: ``cuda`` becomes ``cuda:{local_rank % cards}``
    (``cards``: the cards its host shows); an indexed device or the CPU
    stays as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        if cards == 0:
            raise RuntimeError("device 'cuda' requested but no card is "
                               "visible; pass --device cpu")
        return torch.device("cuda", local_rank % cards)
    return dev


def plan_ranks(peers: Sequence[Tuple[str, str, int]]
               ) -> Tuple[List[torch.device], str]:
    """Every rank's device and the group's backend, from what each rank
    reported, in rank order: (its host's name, the device it was asked
    for, the cards its host shows). A rank's local rank counts the ranks
    before it on its host. NCCL when every rank runs on a card and no two
    ranks share one (on any number of hosts); gloo on the CPU and when
    ranks share a card (NCCL refuses two ranks on one device; gloo takes
    CUDA tensors for all_reduce and broadcast, the only collectives the
    port uses). Every rank computes the same plan."""
    local: dict = {}
    devices = []
    for host, device, cards in peers:
        devices.append(rank_device(device, local.get(host, 0), cards))
        local[host] = local.get(host, 0) + 1
    places = [(host, d.index) for (host, _, _), d in zip(peers, devices)]
    nccl = (all(d.type == "cuda" for d in devices)
            and len(set(places)) == len(places))
    return devices, "nccl" if nccl else "gloo"


def initialize(coordinator: str, num_processes: int, process_id: int,
               device: str = "cuda",
               timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group at ``coordinator`` (host:port) as rank
    ``process_id`` of ``num_processes``; returns this rank's device.
    Before the group forms, the ranks exchange their host names, devices
    and card counts through the coordinator's store (``plan_ranks``)."""
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("--multihost needs --coordinator, --num-processes "
                         "and --process-id (python -m "
                         "css_tpu_torch.parallel.launch sets them)")
    host, port = coordinator.rsplit(":", 1)
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore(host, int(port), num_processes, process_id == 0,
                          timeout)
    key = "css_tpu_torch/peer/{}"
    store.set(key.format(process_id), json.dumps(
        [socket.gethostname(), device, torch.cuda.device_count()]))
    devices, backend = plan_ranks(
        [tuple(json.loads(store.get(key.format(r))))
         for r in range(num_processes)])
    dev = devices[process_id]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=store, world_size=num_processes,
                            rank=process_id, timeout=timeout)
    log.info("rank %d of %d on %s, backend %s", process_id, num_processes,
             dev, backend)
    return dev


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def spawn_local_workers(argv_builder, num_processes: int,
                        coordinator: Optional[str] = None,
                        env_extra: Optional[dict] = None,
                        cwd: Optional[str] = None) -> List[subprocess.Popen]:
    """One subprocess per rank: ``argv_builder(rank, coordinator)`` gives
    its argv. Each one's output goes to a temporary file (a pipe nobody
    reads would block it). The caller waits with ``wait_all``."""
    coordinator = coordinator or f"localhost:{free_port()}"
    env = dict(os.environ)
    env.update(env_extra or {})
    procs = []
    for pid in range(num_processes):
        out = tempfile.TemporaryFile()
        p = subprocess.Popen(argv_builder(pid, coordinator), env=env,
                             cwd=cwd, stdout=out, stderr=subprocess.STDOUT)
        p.output_file = out
        procs.append(p)
    return procs


def wait_all(procs: Sequence[subprocess.Popen],
             timeout: float = DEFAULT_TIMEOUT_S) -> List[str]:
    """Wait for every worker; as soon as one fails, or ``timeout``
    seconds pass, kill the rest and raise with every worker's output."""
    deadline = time.monotonic() + timeout
    failed = None
    while any(p.poll() is None for p in procs):
        bad = [i for i, p in enumerate(procs)
               if p.poll() not in (None, 0)]
        if bad or time.monotonic() > deadline:
            failed = bad or "timeout"
            break
        time.sleep(0.05)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    outputs = []
    for p in procs:
        p.output_file.seek(0)
        outputs.append(p.output_file.read().decode(errors="replace"))
        p.output_file.close()
    bad = [i for i, p in enumerate(procs) if p.returncode != 0]
    if failed is not None or bad:
        detail = "\n".join(
            f"--- worker {i} (rc={procs[i].returncode}) ---\n"
            f"{outputs[i][-4000:]}" for i in range(len(procs)))
        raise RuntimeError(f"multi-process workers failed ({failed or bad})"
                           f":\n{detail}")
    return outputs


def main(argv=None):
    """Spawn N local workers of ``css_tpu_torch.cli.train``; everything
    after ``--`` goes to every worker, with its --multihost flags."""
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--num-processes", type=int, required=True)
    parser.add_argument("--coordinator", default=None)
    parser.add_argument("--timeout", type=float, default=24 * 3600.0,
                        help="seconds before every worker is stopped")
    parser.add_argument("train_args", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    train_args = [a for a in args.train_args if a != "--"]

    def build(pid, coord):
        return [sys.executable, "-m", "css_tpu_torch.cli.train",
                "--multihost", "--coordinator", coord,
                "--num-processes", str(args.num_processes),
                "--process-id", str(pid), *train_args]

    procs = spawn_local_workers(build, args.num_processes, args.coordinator)
    outs = wait_all(procs, timeout=args.timeout)
    sys.stdout.write(outs[0])


if __name__ == "__main__":
    main()
