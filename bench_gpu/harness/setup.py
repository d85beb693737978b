"""Set-up shared by the drivers: the outcome a driver returns, the
model from the seed for both sides, and the kernel launch counters.

``root`` is the checkout whose ``bench_gpu/`` holds the cell's files
(``Cell.root``): a configuration's reference and the kernels' cost files
are read from there (``harness/manifest.py``)."""

from __future__ import annotations

import gc
import importlib
import random
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

import torch

from bench_gpu.harness import manifest, weights


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


def reference(config: Dict, root: Path = manifest.ROOT):
    """``reference/<config['reference']>.py``, the model: spec() and
    masks()."""
    return manifest.load("reference", config["reference"], root)


def pipeline_reference(config: Dict, root: Path = manifest.ROOT):
    """``reference/<config['pipeline_reference']>.py``, the pipeline
    around the model (``separation`` where the configuration names none):
    ``separate(wav, masks, pipeline, num_spk)``."""
    return manifest.load("reference",
                         config.get("pipeline_reference", "separation"), root)


def weights_for(config: Dict, seed: int, device,
                root: Path = manifest.ROOT) -> Dict[str, torch.Tensor]:
    return weights.make(reference(config, root).spec(config["widths"]),
                        seed, device)


def program_model(config: Dict, seed: int, device,
                  root: Path = manifest.ROOT):
    """The program's model, built from the configuration's
    ``program_conf``, holding the seed's weights (a strict load: every
    name and shape of the reference's spec)."""
    from css_tpu_torch.models import build_model

    with torch.device("meta"):
        model = build_model(config["model"], config["program_conf"])
    model = model.to_empty(device=device)
    model.load_state_dict(weights_for(config, seed, device, root),
                          strict=True)
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
    replays count through ``utils/programs.py``), read as deltas. The
    kernels are the cost files under ``costs/`` that declare ``PROGRAM =
    (<module under css_tpu_torch.ops>, <wrapper>)``, keyed by the file's
    name; where the program has no such module, or the module no such
    wrapper (a parent without the kernel), the kernel is ``missing`` and
    counts no launch. A module that is there but fails to import raises."""

    def __init__(self, root: Path = manifest.ROOT):
        self._fns, self.missing = {}, {}
        for key in manifest.names("costs", root):
            program = getattr(manifest.cost(key, root), "PROGRAM", None)
            if program is None:
                continue
            mod, attr = program
            name = f"css_tpu_torch.ops.{mod}"
            try:
                module = importlib.import_module(name)
            except ModuleNotFoundError as exc:
                if exc.name != name:
                    raise
                module = None
            fn = getattr(module, attr, None)
            if fn is None:
                self.missing[key] = f"{mod}.{attr}"
                continue
            self._fns[key] = fn
        self.mark()

    def mark(self) -> None:
        self._base = {k: f.launches for k, f in self._fns.items()}

    def since(self) -> Dict[str, int]:
        """Launches since ``mark()``, by kernel; 0 for a missing one."""
        out = dict.fromkeys(self.missing, 0)
        out.update({k: f.launches - self._base[k]
                    for k, f in self._fns.items()})
        return out


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
