"""Spectral feature extraction: magnitude, floor, MVN (1ch).

Port of ``css_tpu/ops/features.py`` (``EPSILON``, ``mvn`` and the 1ch
``FeatureExtractor``). On a CUDA tensor the magnitude comes from the K3
kernel (``stft_mag_cuda``); on a CPU tensor from its plain version. IPD
features wait for the 7ch slice.

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
