"""Spectral and spatial feature extraction: magnitude, floor, MVN, IPD.

Port of ``css_tpu/ops/features.py`` (``EPSILON``, ``mvn``,
``cumulative_mvn``, ``parse_ipd_index``, ``ipd`` and
``FeatureExtractor``). Channel 0's magnitude comes from the K3 kernel
(``stft_mag_cuda``) on a CUDA tensor and from its plain version on a CPU
tensor. The complex spectrum of every channel, which the IPD features
and the DOA merge read, is the matrix-product STFT (``ops/stft.py``), as
the reference computes it outside any Pallas kernel.

Layout is time-major (..., T, F).
"""

from __future__ import annotations

import functools
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


def parse_ipd_index(ipd_index: str) -> Tuple[np.ndarray, np.ndarray]:
    """'1,0;2,0;...' -> (left, right) channel index arrays."""
    pairs = [tuple(map(int, p.split(","))) for p in ipd_index.split(";")]
    left = np.asarray([p[0] for p in pairs], np.int64)
    right = np.asarray([p[1] for p in pairs], np.int64)
    return left, right


@functools.lru_cache(maxsize=None)
def _channels(index: tuple, device: torch.device) -> torch.Tensor:
    """Channel indices on ``device``, made once (a captured program
    cannot copy them from the host)."""
    return torch.as_tensor(index, dtype=torch.int64, device=device)


def ipd(phase: torch.Tensor, left: np.ndarray,
        right: np.ndarray) -> torch.Tensor:
    """Inter-channel phase difference, re-centred over time.

    phase (..., C, T, F) -> (..., M, T, F): the pair's phase difference
    as a unit vector (cos, sin), its mean over frames subtracted, and the
    angle of what is left, in (-pi, pi]."""
    left = _channels(tuple(int(i) for i in left), phase.device)
    right = _channels(tuple(int(i) for i in right), phase.device)
    dif = (torch.index_select(phase, -3, left)
           - torch.index_select(phase, -3, right))
    yr, yi = torch.cos(dif), torch.sin(dif)
    yrm = yr.mean(dim=-2, keepdim=True)
    yim = yi.mean(dim=-2, keepdim=True)
    return torch.atan2(yi - yim, yr - yrm)


class FeatureExtractor:
    """Uncentered STFT magnitude of channel 0, floored at EPSILON, MVN
    over frames, and optionally the IPD features of channel pairs."""

    def __init__(self, frame_len: int = 512, frame_hop: int = 256,
                 ipd_index: Optional[str] = None):
        self.frame_len = frame_len
        self.frame_hop = frame_hop
        self.num_bins = stft_ops.num_fft_bins(frame_len)
        if ipd_index:
            self.ipd_left, self.ipd_right = parse_ipd_index(ipd_index)
            self.feature_dim = self.num_bins * (1 + len(self.ipd_left))
        else:
            self.ipd_left = self.ipd_right = None
            self.feature_dim = self.num_bins

    def __call__(self, x: torch.Tensor, return_spec: bool = False):
        """x: (B, N) or (B, C, N) waveform -> (mag (B, T, F), feats
        (B, T, F')), and with ``return_spec`` the complex spectrum
        (B[, C], T, F) as a third item. mag is channel 0's; feats are
        its floored, MVN'd magnitude, then with IPD the M pairs' IPD in
        the reference's frequency-major (B, T, M*F) order."""
        if x.ndim not in (2, 3):
            raise ValueError(f"features take (B, N) or (B, C, N), got "
                             f"{tuple(x.shape)}")
        multi = x.ndim == 3
        if self.ipd_left is not None and not multi:
            raise ValueError("IPD features need multi-channel input")
        mag = stft_mag_cuda.stft_mag(
            x[:, 0].contiguous() if multi else x, self.frame_len,
            self.frame_hop)
        feats = mvn(torch.clamp(mag, min=EPSILON), dim=-2)
        spec = None
        if self.ipd_left is not None or return_spec:
            spec = stft_ops.stft(x, self.frame_len, self.frame_hop,
                                 center=False)
        if self.ipd_left is not None:
            phase = torch.atan2(spec.imag, spec.real)
            ip = ipd(phase, self.ipd_left, self.ipd_right)  # (B, M, T, F)
            b, m, t, f = ip.shape
            ip = ip.transpose(1, 2).reshape(b, t, m * f)
            feats = torch.cat([feats, ip], dim=-1)
        return (mag, feats, spec) if return_spec else (mag, feats)
