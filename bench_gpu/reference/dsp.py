"""Plain STFT, iSTFT and utterance MVN.

Conventions of the separation pipeline: the periodic Hann window, frames
of 512 samples at a hop of 256, uncentered (frame t covers samples
[t*hop, t*hop + 512)), 257 bins; the iSTFT divides the overlap-added,
windowed frames by the summed squared window and leaves 0 where that
envelope is below 1e-2.
"""

from __future__ import annotations

import torch

EPSILON = float(torch.finfo(torch.float32).eps)
ENVELOPE_FLOOR = 1e-2


def hann(n: int, device) -> torch.Tensor:
    return torch.hann_window(n, periodic=True, dtype=torch.float64,
                             device=device).float()


def stft(x: torch.Tensor, frame_len: int = 512, hop: int = 256
         ) -> torch.Tensor:
    """Real (..., N) -> complex (..., T, frame_len//2 + 1), uncentered."""
    frames = x.unfold(-1, frame_len, hop) * hann(frame_len, x.device)
    return torch.fft.rfft(frames, n=frame_len)


def stft_mag(x: torch.Tensor, frame_len: int = 512, hop: int = 256
             ) -> torch.Tensor:
    return torch.abs(stft(x, frame_len, hop))


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """(..., T, L) frames -> (..., (T - 1) * hop + L) by summing each
    frame in at t * hop."""
    t, length = frames.shape[-2], frames.shape[-1]
    lead = frames.shape[:-2]
    idx = (torch.arange(t, device=frames.device)[:, None] * hop
           + torch.arange(length, device=frames.device)[None, :])
    out = frames.new_zeros(lead + ((t - 1) * hop + length,))
    return out.index_add_(-1, idx.reshape(-1),
                          frames.reshape(lead + (-1,)))


def istft(spec: torch.Tensor, frame_len: int = 512, hop: int = 256
          ) -> torch.Tensor:
    """Complex (..., T, bins) -> real (..., (T - 1) * hop + frame_len)."""
    n_fft = 2 * (spec.shape[-1] - 1)
    w = hann(frame_len, spec.device)
    frames = torch.fft.irfft(spec, n=n_fft)[..., :frame_len] * w
    sig = overlap_add(frames, hop)
    env = overlap_add((w * w).expand(spec.shape[-2], frame_len), hop)
    return torch.where(env >= ENVELOPE_FLOOR,
                       sig / torch.clamp(env, min=ENVELOPE_FLOOR),
                       torch.zeros((), device=sig.device))


def mvn(x: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """(x - mean) / (std + eps) over ``dim``, std with n - 1."""
    mean = x.mean(dim=dim, keepdim=True)
    var = torch.square(x - mean).sum(dim=dim, keepdim=True) / max(
        x.shape[dim] - 1, 1)
    return (x - mean) / (torch.sqrt(var) + EPSILON)
