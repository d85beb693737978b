"""Spectral feature extraction: magnitude, floor, MVN (1ch).

Port of ``css_tpu/ops/features.py`` (``EPSILON``, ``mvn``,
``cumulative_mvn`` and the 1ch ``FeatureExtractor``). On a CUDA tensor
the magnitude comes from the K3 kernel (``stft_mag_cuda``); on a CPU
tensor from its plain version. IPD features wait for the 7ch slice.

Layout is time-major (..., T, F).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from css_tpu_torch.ops import stft as stft_ops
from css_tpu_torch.ops import stft_mag_cuda

EPSILON = float(np.finfo(np.float32).eps)


def mvn(x: torch.Tensor, dim: int = -2, eps: float = EPSILON) -> torch.Tensor:
    """Mean-variance normalisation with the Bessel-corrected (ddof=1) std,
    as torch.std in the reference models and feature extractor."""
    mean = x.mean(dim=dim, keepdim=True)
    n = x.shape[dim]
    var = torch.square(x - mean).sum(dim=dim, keepdim=True) / max(n - 1, 1)
    return (x - mean) / (torch.sqrt(var) + eps)


def cumulative_mvn(x: torch.Tensor, carry=None, eps: float = EPSILON):
    """Causal MVN over the time axis (-2): frame t is normalised by the
    running per-bin statistics of frames [0..t] (Bessel-corrected, as
    ``mvn``).

    ``carry`` is ``(count, sum, sumsq)`` from a previous chunk (count a 0-d
    tensor; sum and sumsq shaped like one frame) or None to start fresh.
    Returns ``(normalised, new_carry)``, so chained chunk calls equal one
    call on the whole utterance.
    """
    t = x.shape[-2]
    if carry is None:
        zeros = x.new_zeros(x.shape[:-2] + x.shape[-1:])
        carry = (x.new_zeros(()), zeros, zeros)
    count0, sum0, sumsq0 = carry
    n = count0 + torch.arange(1, t + 1, dtype=x.dtype, device=x.device)
    n = n.reshape((1,) * (x.ndim - 2) + (t, 1))
    csum = sum0[..., None, :] + torch.cumsum(x, dim=-2)
    csumsq = sumsq0[..., None, :] + torch.cumsum(torch.square(x), dim=-2)
    mean = csum / n
    var = torch.clamp(csumsq - n * torch.square(mean), min=0.0) / torch.clamp(
        n - 1.0, min=1.0)
    out = (x - mean) / (torch.sqrt(var) + eps)
    return out, (count0 + t, csum[..., -1, :], csumsq[..., -1, :])


class FeatureExtractor:
    """Uncentered STFT magnitude, floored at EPSILON, MVN over frames."""

    def __init__(self, frame_len: int = 512, frame_hop: int = 256,
                 ipd_index: Optional[str] = None):
        if ipd_index:
            raise NotImplementedError(
                "IPD features (7ch) are not ported yet: ROADMAP.md Queue 1 "
                "item 6")
        self.frame_len = frame_len
        self.frame_hop = frame_hop
        self.num_bins = stft_ops.num_fft_bins(frame_len)

    def __call__(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, N) waveform -> (mag (B, T, F), feats (B, T, F))."""
        if x.ndim != 2:
            raise ValueError(f"1ch features take (B, N), got {tuple(x.shape)}")
        mag = stft_mag_cuda.stft_mag(x, self.frame_len, self.frame_hop)
        feats = mvn(torch.clamp(mag, min=EPSILON), dim=-2)
        return mag, feats
