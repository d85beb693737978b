#!/usr/bin/env python3
"""Where a train step of the PyTorch port goes on the card.

    python3 scripts/torch_train_profile.py [--steps 3] [--top 15]

For the flagship-width Conformer (16 x 256, 4 heads, kernel 33) in bf16
and float32 (TF32 off) and the full-width BLSTM (hidden 1024, 3 layers)
in bf16, on chip_smoke.py's training batch (``train_batch``: 32 windows
of 4.0 s of the recipe's on-the-fly mixtures) and trainer
(``make_trainer``: random weights, Adam, clip 5.0, MSE with noise weight
0.3): three warm steps (the train step is the trainer's captured CUDA
graph: the first runs eagerly, the second captures), then ``--steps``
replayed steps under torch.profiler (CPU and CUDA). Prints one JSON
line per configuration: host ms per step (the profiled window over the
steps), the device kernel time per step (the sum
of every kernel's and copy's self device time, without the
record_function spans), the idle share of the card (1 - device / host
time; the profiler's own host overhead counts in the host time), and the ``--top`` kernels by device time with their
share and call count, and the device time by class (matrix products,
convolutions, attention's softmax, the relative-position gather and its
backward, K3, the optimiser, the rest), classed by kernel name. Then the
card's name and power limit (nvidia-smi). Needs a CUDA card; exits 1
without one.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

CLASSES = [  # (class, substrings of a kernel's name), first match wins
    ("k3_stft_mag", ("stft_mag",)),
    ("optimizer", ("multi_tensor", "foreach", "adam")),
    ("conv", ("conv", "cudnn", "winograd", "implicit", "dgrad", "wgrad",
              "depthwise")),
    ("matmul", ("gemm", "cutlass", "sm90_xmma", "nvjet", "ampere_", "sm80",
                "matmul")),
    ("softmax", ("softmax",)),
    ("gather_scatter", ("index", "scatter", "gather", "sort", "radix")),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
]


REPO = Path(__file__).resolve().parents[1]


def _chip_smoke():
    sys.path.insert(0, str(REPO))  # css_tpu_torch, beside chip_smoke.py
    path = REPO / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def profile_steps(torch, trainer, batch, steps: int, top: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = {}
    for e in prof.key_averages():
        dev = (getattr(e, "self_device_time_total", None)
               or getattr(e, "self_cuda_time_total", 0.0))
        # torch.optim's record_function spans (Optimizer.step#Adam.step,
        # Optimizer.zero_grad#...) show on the device timeline around the
        # kernels they launch: not counted
        if (dev and not e.key.startswith("Optimizer.")
                and str(getattr(e, "device_type", "")).endswith("CUDA")):
            k = kernels.setdefault(e.key, [0.0, 0])
            k[0] += dev / 1e3 / steps
            k[1] += e.count // steps
    device = sum(v[0] for v in kernels.values())
    by_class = {}
    for name, (ms, _) in kernels.items():
        by_class[kernel_class(name)] = by_class.get(kernel_class(name),
                                                    0.0) + ms
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "host_ms_per_step": host_ms, "device_ms_per_step": device,
        "idle_share": 1.0 - device / host_ms if host_ms else None,
        "kernels_per_step": sum(v[1] for v in kernels.values()),
        "by_class_ms": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
        "top": [{"name": name[:120], "ms": ms, "share": ms / device,
                 "calls": calls} for name, (ms, calls) in ranked]}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--top", type=int, default=15)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs = _chip_smoke()
    dev = torch.device("cuda")
    batch = cs.train_batch(cs.TRAIN_SEED)
    for label, name, conf in (("conformer bf16", "Conformer", {"bf16": True}),
                              ("conformer float32", "Conformer", {}),
                              ("blstm bf16", "BLSTM", {"bf16": True})):
        trainer = cs.make_trainer(torch, name, conf, 1e-4, dev)
        steps = args.steps if name == "Conformer" else 1
        out = profile_steps(torch, trainer, batch, steps, args.top)
        print(json.dumps({"config": label, "batch": list(batch["mix"].shape),
                          **out}), flush=True)
        del trainer
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
