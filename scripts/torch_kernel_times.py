#!/usr/bin/env python3
"""Card times of the PyTorch port's K3 (STFT magnitude), K1 (masked
iSTFT) and K2 (LSTM recurrence) kernels at their main-path shapes, taken
from the ``css_tpu_torch`` package of a given checkout, so that two
versions can be compared in one card run, in turns (a, b, b, a):

    python3 scripts/torch_kernel_times.py --root /path/to/other --label a
    python3 scripts/torch_kernel_times.py --root . --label b

The inputs, the shapes and the timer are chip_smoke.py's (of this
checkout: ``stft_input``, ``istft_input``, ``lstm_layer_inputs``,
``time_ms``, a median of 30 CUDA-event times after 3 warm-ups), so the
times are those of its kernel phase. Each case is checked against its
plain version on the same inputs (max abs error printed). K3's yardstick,
``torch.stft(...).abs()``, is timed beside it; K1's device time
(``device_ms``, torch.profiler) too; K2's phase split (clock64() cycles
per step) where the version records one. TF32 off. Prints one JSON line
with the label, the card's name and power limit (nvidia-smi), and per
case its shape, kernel ms and error. Needs a CUDA card; exits 1 without
one.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True,
                    help="checkout whose css_tpu_torch is timed")
    ap.add_argument("--label", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA card", file=sys.stderr)
        return 1
    from css_tpu_torch.ops import istft_cuda, lstm_cuda, stft_mag_cuda

    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    shapes = cs.main_shapes()
    frame, hop = shapes["frame"], shapes["hop"]
    cases = []

    x = cs.stft_input(torch, dev)
    err = float((stft_mag_cuda.stft_mag(x, frame, hop)
                 - stft_mag_cuda.stft_mag_plain(x, frame, hop)).abs().max())
    hann = torch.hann_window(frame, device=dev)
    cases.append({
        "kernel": "stft_mag", "shape": list(x.shape), "max_abs_err": err,
        "ms": cs.time_ms(torch, lambda: stft_mag_cuda.stft_mag(x, frame,
                                                               hop)),
        "library_ms": cs.time_ms(torch, lambda: torch.stft(
            x, frame, hop, window=hann, center=False,
            return_complex=True).abs())})

    spec = cs.istft_input(torch, dev)
    err = float((istft_cuda.istft(spec, frame, hop)
                 - istft_cuda.istft_plain(spec, frame, hop)).abs().max())
    cases.append({
        "kernel": "istft", "shape": list(spec.shape), "max_abs_err": err,
        "ms": cs.time_ms(torch, lambda: istft_cuda.istft(spec, frame, hop)),
        "device_ms": cs.device_ms(torch, lambda: istft_cuda.istft(
            spec, frame, hop))})
    del spec

    for h, dtype, reverse in ((512, torch.float32, False),
                              (512, torch.float32, True),
                              (512, torch.bfloat16, False),
                              (1024, torch.float32, False)):
        _, _, _, w_hh, xw = cs.lstm_layer_inputs(torch, dev, h)
        xw, w_hh = xw.to(dtype), w_hh.to(dtype)
        got = lstm_cuda.lstm_fused(xw, w_hh, h, reverse)
        want = lstm_cuda.lstm_plain(xw, w_hh, h, reverse)
        case = {
            "kernel": "lstm_fused", "shape": list(xw.shape),
            "dtype": str(dtype)[6:], "reverse": reverse,
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "ms": cs.time_ms(torch, lambda: lstm_cuda.lstm_fused(
                xw, w_hh, h, reverse))}
        if hasattr(lstm_cuda, "phase_split"):  # the versions that record it
            case["cycles_per_step"] = lstm_cuda.phase_split(xw, w_hh, h,
                                                            reverse)
        cases.append(case)
    print(json.dumps({"label": args.label, "card": smi.stdout.strip(),
                      "cases": cases}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
