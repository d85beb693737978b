"""Set-up shared by the drivers: the outcome a driver returns, the
model from the seed for both sides, and the kernel launch counters."""

from __future__ import annotations

import gc
import importlib
import random
from dataclasses import dataclass, field
from typing import Dict, List

import torch

from bench_gpu.harness import weights


@dataclass
class Outcome:
    correct: bool
    attempted: int
    failed: int
    metrics: Dict[str, float]
    checks: Dict[str, Dict]
    memory_peak: int
    record: object = None
    notes: List[str] = field(default_factory=list)


def reference(config: Dict):
    """``reference/<config['reference']>.py``: spec() and masks()."""
    return importlib.import_module(
        f"bench_gpu.reference.{config['reference']}")


def weights_for(config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return weights.make(reference(config).spec(config["widths"]), seed,
                        device)


def program_model(config: Dict, seed: int, device):
    """The program's model, built from the configuration's
    ``program_conf``, holding the seed's weights (a strict load: every
    name and shape of the reference's spec)."""
    from css_tpu_torch.models import build_model

    with torch.device("meta"):
        model = build_model(config["model"], config["program_conf"])
    model = model.to_empty(device=device)
    model.load_state_dict(weights_for(config, seed, device), strict=True)
    return model


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def memory_peak(device) -> int:
    if device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


class Launches:
    """The program's kernel launch counters (``ops/*_cuda.py``; CUDA graph
    replays count through ``utils/programs.py``), read as deltas."""

    KERNELS = {"k1": ("istft_cuda", "istft"),
               "k2": ("lstm_cuda", "lstm_fused"),
               "k3": ("stft_mag_cuda", "stft_mag")}

    def __init__(self):
        self._fns = {}
        for key, (mod, attr) in self.KERNELS.items():
            m = importlib.import_module(f"css_tpu_torch.ops.{mod}")
            self._fns[key] = getattr(m, attr)
        self.mark()

    def mark(self) -> None:
        self._base = {k: f.launches for k, f in self._fns.items()}

    def since(self) -> Dict[str, int]:
        return {k: f.launches - self._base[k] for k, f in self._fns.items()}


class Reservoir:
    """A uniform sample of ``k`` items of a stream of unknown length,
    drawn from the seed (Algorithm R)."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.items: list = []
        self.seen = 0
        self._rng = random.Random(seed)

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self._rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = item
