#!/usr/bin/env python3
"""What calling K2 through its registered op costs, at the hop streaming
chunk's shape, where the host's time per call is on the latency path:

    python3 scripts/torch_k2_op_overhead.py

Three ways to run the same float32 recurrence with a carried (h0, c0),
(1, 8, 4096) + (1024, 4096) -> (1, 8, 1024) and the final (h, c):
``launch``, the launch code called directly (``lstm_cuda._launch``, what
the op's CUDA kernel runs); ``op``, the registered op
``css_tpu_torch::lstm_fused``; ``wrapper``, ``lstm_cuda.lstm_fused``, the
call the BLSTM's ``stream`` makes. Each is timed in turns over ROUNDS
rounds, the order reversed every other round, as host microseconds a
call (ROUNDS x CALLS calls, one synchronize at the end) and as CUDA-event
milliseconds around one call (chip_smoke.py's ``time_ms``: median of
30). The three outputs are checked bit-equal. Prints one JSON line with
the card's name and power limit (nvidia-smi). Needs a CUDA card; exits 1
without one.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROUNDS, CALLS = 4, 300
HIDDEN, FRAMES = 1024, 8


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def host_us(torch, fn, calls: int = CALLS) -> float:
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / calls * 1e6


def main() -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import torch

    if not torch.cuda.is_available():
        print("torch_k2_op_overhead: no CUDA card", file=sys.stderr)
        return 1
    from css_tpu_torch.ops import lstm_cuda

    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    rng = np.random.default_rng(cs.HOP_SEED)
    xw = torch.as_tensor(rng.standard_normal((1, FRAMES, 4 * HIDDEN))
                         .astype(np.float32), device=dev)
    w_hh = torch.as_tensor((rng.standard_normal((HIDDEN, 4 * HIDDEN))
                            / np.sqrt(HIDDEN)).astype(np.float32),
                           device=dev)
    h0 = torch.as_tensor(np.tanh(rng.standard_normal((1, HIDDEN)))
                         .astype(np.float32), device=dev)
    c0 = torch.as_tensor(rng.standard_normal((1, HIDDEN))
                         .astype(np.float32), device=dev)
    state = (h0, c0)
    ways = {
        "launch": lambda: lstm_cuda._launch(xw, w_hh, HIDDEN, False, state),
        "op": lambda: lstm_cuda.lstm_op(xw, w_hh, HIDDEN, False, h0, c0),
        "wrapper": lambda: lstm_cuda.lstm_fused(xw, w_hh, HIDDEN,
                                                state=state,
                                                return_state=True),
    }
    with torch.no_grad():
        outs = [ways["launch"](), ways["op"]()]
        hs, (h_t, c_t) = ways["wrapper"]()
        outs.append((hs, h_t, c_t))
        for got in outs[1:]:
            if not all(torch.equal(a, b) for a, b in zip(got, outs[0])):
                raise AssertionError("K2's three routes disagree")
        rec = {k: {"host_us": [], "event_ms": []} for k in ways}
        order = list(ways)
        for rnd in range(ROUNDS):
            for k in (order if rnd % 2 == 0 else order[::-1]):
                rec[k]["host_us"].append(host_us(torch, ways[k]))
                rec[k]["event_ms"].append(cs.time_ms(torch, ways[k]))
    for r in rec.values():
        r["host_us_median"] = float(np.median(r["host_us"]))
        r["event_ms_median"] = float(np.median(r["event_ms"]))
    print(json.dumps({"shape": [1, FRAMES, 4 * HIDDEN], "rounds": ROUNDS,
                      "calls": CALLS, "card": smi.stdout.strip(),
                      "ways": rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
