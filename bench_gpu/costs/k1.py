"""K1, the masked iSTFT (``csrc/istft.cu``): complex64 (rows, frames,
bins) -> float32 (rows, (frames + 1) * hop), uncentered, Hann window,
divided by the squared-window envelope."""

import math

from bench_gpu.costs import peaks

NAME = "istft_kernel"
PROGRAM = ("istft_cuda", "istft")


def work(rows: int, frames: int, bins: int = 257, hop: int = 256):
    """(operations, bytes) of one launch: an inverse real FFT of n_fft
    (2.5 N log2 N), the window, the overlap-add and the envelope a frame;
    the spectrum, window, twiddles and a (3, hop) envelope table in, the
    signal out."""
    n_fft = 2 * (bins - 1)
    fft = 2.5 * n_fft * math.log2(n_fft)
    flops = rows * frames * (fft + 2 * n_fft) + rows * (frames + 1) * hop
    nbytes = (8 * rows * frames * bins
              + 4 * (2 * hop + 2 * (n_fft - 1) + 3 * hop)
              + 4 * rows * (frames + 1) * hop)
    return flops, nbytes


def shape(config: dict, geo: dict):
    """One launch a session: every window's speaker streams, at the
    separator's frames a window; under Souden MVDR through the centered
    entry, at the window's centered frames (``win // hop + 1``)."""
    bf = config["pipeline"]["beamforming"]
    frames = geo["frames"]
    if bf.get("type") == "souden_mvdr":
        frames = geo["win"] // int(bf["hop_size"]) + 1
    return {"rows": geo["windows"] * geo["streams"], "frames": frames}


def bound_seconds(**shape) -> float:
    flops, nbytes = work(**shape)
    return peaks.bound_seconds(flops, nbytes, peaks.FP32_FLOPS)
