"""STFT / iSTFT as matrix products (the plain PyTorch versions).

Port of ``css_tpu/ops/stft.py``: framing + one (frame_len, 2*bins) rDFT
matrix product for analysis, and one (2*bins, frame_len) synthesis matrix
+ windowed overlap-add + squared-window-envelope division for synthesis.
Both the uncentered (conv-STFT) and the centered (``torch.stft``-style,
reflect-padded) conventions are provided.

These are the plain versions the CUDA kernels are held against: K1
(``istft_cuda.istft``) computes ``istft(center=False)`` and K3
(``stft_mag_cuda.stft_mag``) computes ``|stft(center=False)|``.

Layout is time-major ``(..., T, F)``, as in the JAX package.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(n: int, periodic: bool = True, dtype=np.float32) -> np.ndarray:
    """Hann window matching torch.hann_window (periodic by default)."""
    if n == 1:
        return np.ones((1,), dtype)
    denom = n if periodic else n - 1
    i = np.arange(n)
    return (0.5 - 0.5 * np.cos(2.0 * math.pi * i / denom)).astype(dtype)


def _n_fft(frame_len: int, round_pow_of_two: bool) -> int:
    return 2 ** math.ceil(math.log2(frame_len)) if round_pow_of_two else frame_len


def num_fft_bins(frame_len: int, round_pow_of_two: bool = True) -> int:
    return _n_fft(frame_len, round_pow_of_two) // 2 + 1


@functools.lru_cache(maxsize=None)
def stft_analysis_kernel(
    frame_len: int,
    round_pow_of_two: bool = True,
    window: str = "hann",
) -> np.ndarray:
    """(frame_len, 2*bins) real rDFT-analysis matrix, [real | imag] halves:
    real[k] = sum_n w[n] x[n] cos(2pi nk/N), imag[k] = -sum_n w[n] x[n]
    sin(2pi nk/N)."""
    n_fft = _n_fft(frame_len, round_pow_of_two)
    bins = n_fft // 2 + 1
    n = np.arange(frame_len, dtype=np.float64)[:, None]
    k = np.arange(bins, dtype=np.float64)[None, :]
    ang = -2.0 * math.pi * n * k / n_fft
    if window == "hann":
        w = hann_window(frame_len, dtype=np.float64)[:, None]
    elif window in (None, "rect", "ones"):
        w = np.ones((frame_len, 1), np.float64)
    else:
        raise ValueError(f"unknown window {window!r}")
    real = np.cos(ang) * w
    imag = np.sin(ang) * w
    return np.concatenate([real, imag], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _istft_synthesis_kernel(frame_len: int, n_fft: int) -> np.ndarray:
    """(2*bins, frame_len) matrix: [real | imag] spectrum -> irfft frame."""
    bins = n_fft // 2 + 1
    k = np.arange(bins, dtype=np.float64)[:, None]
    n = np.arange(n_fft, dtype=np.float64)[None, :]
    ang = 2.0 * math.pi * k * n / n_fft
    # irfft: x[n] = (1/N) sum_k c_k (re[k] cos - im[k] sin), c_k = 1 for
    # k in {0, N/2} else 2 (hermitian fold)
    scale = np.full((bins, 1), 2.0 / n_fft)
    scale[0] = 1.0 / n_fft
    if n_fft % 2 == 0:
        scale[-1] = 1.0 / n_fft
    real_part = np.cos(ang) * scale
    imag_part = -np.sin(ang) * scale
    kern = np.concatenate([real_part, imag_part], axis=0)
    return kern[:, :frame_len].astype(np.float32)


@functools.lru_cache(maxsize=None)
def _on_device(fn, device: torch.device, *args) -> torch.Tensor:
    """A constant numpy matrix, copied once per device."""
    return torch.as_tensor(fn(*args), device=device)


def frame_signal(x: torch.Tensor, frame_len: int, hop: int) -> torch.Tensor:
    """(..., T) -> (..., num_frames, frame_len) sliding frames, no padding
    (a strided view)."""
    t = x.shape[-1]
    if t < frame_len:
        raise ValueError(f"signal length {t} < frame_len {frame_len}")
    return x.unfold(-1, frame_len, hop)


def overlap_add(frames: torch.Tensor, hop: int,
                out_len: Optional[int] = None) -> torch.Tensor:
    """(..., num_frames, frame_len) -> (..., T) overlap-add synthesis."""
    num_frames, frame_len = frames.shape[-2], frames.shape[-1]
    lead = frames.shape[:-2]
    total = (num_frames - 1) * hop + frame_len
    if frame_len % hop == 0:
        # chunk j of frame i lands at hop-slot i+j
        r = frame_len // hop
        chunks = frames.reshape(*lead, num_frames, r, hop)
        slots = num_frames + r - 1
        out = frames.new_zeros((*lead, slots, hop))
        for j in range(r):
            out[..., j : j + num_frames, :] += chunks[..., j, :]
        out = out.reshape(*lead, slots * hop)[..., :total]
    else:
        idx = (torch.arange(num_frames)[:, None] * hop
               + torch.arange(frame_len)[None, :]).reshape(-1)
        out = frames.new_zeros((*lead, total))
        out = out.index_add(-1, idx.to(frames.device),
                            frames.reshape(*lead, -1))
    if out_len is not None:
        if out_len > out.shape[-1]:
            out = F.pad(out, (0, out_len - out.shape[-1]))
        else:
            out = out[..., :out_len]
    return out


def stft(
    x: torch.Tensor,
    frame_len: int = 512,
    hop: int = 256,
    *,
    center: bool = False,
    round_pow_of_two: bool = True,
    window: str = "hann",
    pad_mode: str = "reflect",
) -> torch.Tensor:
    """STFT of real (..., T) -> complex64 (..., num_frames, bins).

    center=False is the conv-STFT convention of the separator;
    center=True matches torch.stft(center=True, pad_mode='reflect').
    """
    if center:
        pad = _n_fft(frame_len, round_pow_of_two) // 2
        lead = x.shape[:-1]
        mode = "constant" if pad_mode == "zeros" else pad_mode
        x = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode=mode)
        x = x.reshape(*lead, x.shape[-1])
    frames = frame_signal(x, frame_len, hop)
    kern = _on_device(stft_analysis_kernel, x.device, frame_len,
                      round_pow_of_two, window)
    spec = frames @ kern  # (..., T, 2*bins)
    bins = spec.shape[-1] // 2
    return torch.complex(spec[..., :bins], spec[..., bins:])


def istft(
    spec: torch.Tensor,
    frame_len: int = 512,
    hop: int = 256,
    *,
    center: bool = False,
    length: Optional[int] = None,
    round_pow_of_two: bool = True,
    window: str = "hann",
) -> torch.Tensor:
    """Inverse STFT of complex (..., num_frames, bins) -> real (..., T).

    Per-frame irfft * window, overlap-add, divide by the summed
    squared-window envelope; samples whose envelope is below 1e-2 (partial
    coverage at the edges) are 0. center=True trims n_fft//2 from both
    sides first, like torch.istft.
    """
    n_fft = _n_fft(frame_len, round_pow_of_two)
    num_frames = spec.shape[-2]
    ri = torch.cat([spec.real, spec.imag], dim=-1)  # (..., T, 2*bins)
    kern = _on_device(_istft_synthesis_kernel, spec.device, frame_len, n_fft)
    if window == "hann":
        w = _on_device(hann_window, spec.device, frame_len)
    else:
        w = torch.ones(frame_len, device=spec.device)
    frames = (ri @ kern) * w
    sig = overlap_add(frames, hop)
    env = overlap_add((w * w).expand(num_frames, frame_len), hop)
    sig = torch.where(env >= 1e-2, sig / torch.clamp(env, min=1e-2),
                      torch.zeros((), dtype=sig.dtype, device=sig.device))
    if center:
        pad = n_fft // 2
        sig = sig[..., pad : sig.shape[-1] - pad]
    if length is not None:
        if length > sig.shape[-1]:
            sig = F.pad(sig, (0, length - sig.shape[-1]))
        else:
            sig = sig[..., :length]
    return sig
