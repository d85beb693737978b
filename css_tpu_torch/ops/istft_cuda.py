"""K1: masked iSTFT — the CUDA kernel ``csrc/istft.cu`` and its plain version.

Replaces the TPU kernel ``css_tpu/ops/istft_pallas.py:istft_pallas`` (body
``_istft_kernel``): complex (rows, T, bins) -> (rows, (T+1)*hop) float32,
uncentered, frame_len == 2*hop, n_fft = 2*(bins - 1). On the main paths
it resynthesises every stream of a recording in one launch
(``executor/beamformer.py``): uncentered for the masking beamformer, and
through ``istft_centered`` (K1, then the centering trim) for Souden MVDR.

What bounds the function on the H100: bytes — ~0.46 MB in and out per
row, 0.020 ms for the 146 rows of a 60 s recording at 3.35 TB/s. The
kernel computes each frame's inverse real FFT in shared memory (a
half-length complex inverse FFT after the split step, K3's FFT run
backwards), ~12k operations a frame, so operations are far below the
bytes; it reads no synthesis matrix, only the spectrum, K3's twiddle
table, the window and a (3, hop) envelope table. See the source for the
layout.

``istft(spec)`` on a CPU tensor returns the plain version. On a CUDA
tensor it launches the kernel, or raises, except on one route, decided
from the shape alone before any launch and counted in
``istft.plain_routes``: **frame_len != 2*hop, or an FFT length that is
not a power of two in [4, 2048]**, runs the plain version on the card, as
the reference runs such shapes on XLA. More than ``MAX_ROWS`` rows are
split across launches (rows are independent, so this is exact).
``istft.launches`` counts kernel launches (``ops/_build.py``), those of a
captured program's replays too (``utils/programs.py``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from css_tpu_torch.ops import _build, stft_mag_cuda
from css_tpu_torch.ops import stft as stft_ops

MAX_ROWS = 65535  # rows sit in gridDim.y


def istft_plain(spec: torch.Tensor, frame_len: int = 512,
                hop: int = 256) -> torch.Tensor:
    """The plain PyTorch version: ``ops.stft.istft(center=False)``."""
    return stft_ops.istft(spec, frame_len, hop, center=False)


def takes_kernel(frame_len: int, hop: int, n_fft: int) -> bool:
    """Whether the kernel computes this framing (else the plain route):
    K3's FFT lengths, powers of two in [MIN_FFT, MAX_FFT]."""
    return (frame_len == 2 * hop and frame_len <= n_fft
            and stft_mag_cuda.MIN_FFT <= n_fft <= stft_mag_cuda.MAX_FFT
            and n_fft & (n_fft - 1) == 0)


@functools.lru_cache(maxsize=None)
def _tables(frame_len: int, hop: int, n_fft: int, device: torch.device):
    """What the kernel reads beside the spectrum: K3's twiddles for n_fft
    (``stft_mag_cuda.twiddles``), the periodic Hann window of frame_len,
    and the envelope reciprocal as a (3, hop) table, computed in float64
    and stored in float32: 1 / the summed squared-window envelope of slot
    0 (the head of frame 0 alone), of every inner slot (a head and a tail)
    and of slot T (the tail of frame T-1 alone), 0 where the envelope is
    < 1e-2."""
    window = stft_ops.hann_window(frame_len)
    w2 = window.astype(np.float64) ** 2
    env = np.stack([w2[:hop], w2[hop:] + w2[:hop], w2[hop:]])
    recip = np.where(env >= 1e-2, 1.0 / np.maximum(env, 1e-2), 0.0)
    return (stft_mag_cuda.twiddles(n_fft, device),
            torch.as_tensor(window, device=device),
            torch.as_tensor(recip.astype(np.float32), device=device))


@_build.counted
def istft(spec: torch.Tensor, frame_len: int = 512,
          hop: int = 256) -> torch.Tensor:
    """Complex64 (rows, T, bins) -> float32 (rows, (T+1)*hop)."""
    if spec.device.type == "cpu":
        return istft_plain(spec, frame_len, hop)
    if spec.device.type != "cuda":
        raise ValueError(f"istft: unsupported device {spec.device}")
    if spec.dtype != torch.complex64:
        raise TypeError(f"istft kernel takes complex64, got {spec.dtype}")
    if spec.ndim != 3:
        raise ValueError(f"istft kernel takes (rows, T, bins), got "
                         f"{tuple(spec.shape)}")
    if not spec.is_contiguous():
        raise ValueError("istft kernel needs a contiguous spectrum")
    rows, num_frames, bins = spec.shape
    n_fft = (bins - 1) * 2
    if not 0 < frame_len <= n_fft:
        raise ValueError(f"istft kernel: unsupported shape {tuple(spec.shape)}"
                         f" with frame_len {frame_len}")
    if not takes_kernel(frame_len, hop, n_fft):
        _build.KERNELS["istft"].plain_routes += 1
        return istft_plain(spec, frame_len, hop)
    log_m = n_fft.bit_length() - 2
    twid, window, env = _tables(frame_len, hop, n_fft, spec.device)
    out = torch.empty((rows, (num_frames + 1) * hop), dtype=torch.float32,
                      device=spec.device)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(spec.device).cuda_stream
    for lo, hi in _build.split_rows(rows, MAX_ROWS):
        err = lib.css_istft(
            spec[lo].data_ptr(), twid.data_ptr(), window.data_ptr(),
            env.data_ptr(), out[lo].data_ptr(), hi - lo, num_frames, hop,
            log_m, spec.device.index or 0, stream)
        _build.check(err, "istft")
        _build.KERNELS["istft"].launches += 1
    return out


def istft_centered(spec: torch.Tensor, frame_len: int = 512, hop: int = 256,
                   length: int = None) -> torch.Tensor:
    """The centered iSTFT, ``ops.stft.istft(center=True, length=length)``
    (its plain version): ``istft`` above (K1 on the card), then the
    centering pad n_fft//2 trimmed from both ends, then zero-padded or cut
    to ``length``. Launches and plain routes count in ``istft``'s
    counters."""
    pad = spec.shape[-1] - 1  # n_fft // 2 = bins - 1
    sig = istft(spec, frame_len, hop)
    sig = sig[..., pad : sig.shape[-1] - pad]
    if length is not None:
        if length > sig.shape[-1]:
            sig = F.pad(sig, (0, length - sig.shape[-1]))
        else:
            sig = sig[..., :length]
    return sig
