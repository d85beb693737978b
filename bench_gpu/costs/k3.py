"""K3, the STFT magnitude (``csrc/stft_mag.cu``): real (rows, n) ->
(rows, frames, bins) float32 |STFT|, uncentered, Hann window."""

import math

from bench_gpu.costs import peaks

NAME = "stft_mag_kernel"  # the kernel's symbol in the device trace
PROGRAM = ("stft_mag_cuda", "stft_mag")


def work(rows: int, n: int, frame_len: int = 512, hop: int = 256):
    """(operations, bytes) of one launch: a real FFT of frame_len
    (2.5 N log2 N), the window and the magnitude a frame; the signal, the
    window, the twiddles (frame_len - 1 complex) in, the magnitudes
    out."""
    frames = (n - frame_len) // hop + 1
    bins = frame_len // 2 + 1
    fft = 2.5 * frame_len * math.log2(frame_len)
    flops = rows * frames * (fft + frame_len + 3 * bins)
    nbytes = 4 * (rows * n + frame_len + 2 * (frame_len - 1)
                  + rows * frames * bins)
    return flops, nbytes


def shape(config: dict, geo: dict):
    """One launch a separator batch, over its windows."""
    return {"rows": geo["batch"], "n": geo["win"]}


def bound_seconds(**shape) -> float:
    flops, nbytes = work(**shape)
    return peaks.bound_seconds(flops, nbytes, peaks.FP32_FLOPS)
