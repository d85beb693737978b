"""Direction of arrival on the 7-mic circular array, and the DOA merge.

Port of ``css_tpu/executor/doa.py``: analytic steering vectors for a
radius-4.25 cm circular array (6 mics + centre), masked DOA likelihoods
from power projections over the 80-2000 Hz band, and the "angle merge"
that kills the weaker of two masks whose DOA estimates coincide within a
threshold. The complex einsums run on the tensors' device in plain
PyTorch, as the reference leaves them to XLA.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def steervec_7ch(nfreqs: int = 257, nvecs: int = 30, radius: float = 0.0425,
                 snd_velocity: float = 340.0, sr: int = 16000,
                 reference: int = 0, inverse_shift: bool = False):
    """(nfreqs, nvecs, 7) complex64 steering vectors and their angles in
    degrees, both numpy."""
    angles = 2.0 * math.pi * np.arange(nvecs) / nvecs
    distances = radius * np.stack([
        np.zeros(nvecs),
        np.cos(angles + math.pi / 6),
        np.cos(angles - math.pi / 6),
        np.cos(angles - math.pi / 2),
        np.cos(angles - 5 * math.pi / 6),
        np.cos(angles + 5 * math.pi / 6),
        np.cos(angles + math.pi / 2),
    ], axis=1)  # (nvecs, 7)
    if reference != 0:
        distances = distances - distances[:, reference:reference + 1]
    deltas = distances / snd_velocity * sr
    f = np.arange(nfreqs)[:, None, None]
    sign = -1.0 if inverse_shift else 1.0
    sv = np.exp(sign * 1j * deltas[None] * math.pi * f / (nfreqs - 1))
    sv = (sv / math.sqrt(7)).astype(np.complex64)
    return sv, (angles * 180.0 / math.pi).astype(np.float32)


class SteeringVectors:
    def __init__(self, nfreqs: int = 257, nvecs: int = 30, sr: int = 16000,
                 lowcut: float = 80.0, highcut: float = 2000.0):
        self.sv, self.angles = steervec_7ch(nfreqs, nvecs, sr=sr)
        freq_step = (sr // 2) / (nfreqs - 1)
        self.lo = int(math.floor(lowcut / freq_step))
        self.hi = int(math.ceil(highcut / freq_step))
        # device -> (the band's steering vectors, the angles), copied once:
        # a copy from host memory waits for the host
        self._tables = {}

    def _on(self, device: torch.device):
        if device not in self._tables:
            self._tables[device] = (
                torch.as_tensor(self.sv[self.lo : self.hi], device=device),
                torch.as_tensor(self.angles, device=device))
        return self._tables[device]

    def doa_likelihood(self, spec: torch.Tensor, mask: torch.Tensor,
                       compression: float = 0.5, epsilon: float = 1e-12
                       ) -> torch.Tensor:
        """spec (B, C, T, F) complex; mask (B, T, F, S) -> (B, S, nangles):
        per frame and bin in the band, the mixture power left over after
        projecting on each steering vector, compressed and negated, then
        summed under each stream's mask."""
        x = spec[..., self.lo : self.hi]  # (B, C, T, F')
        sv = self._on(spec.device)[0]  # (F', A, C)
        xpow = (x.real.square() + x.imag.square()).sum(dim=1)  # (B, T, F')
        xh = torch.einsum("bctf,fac->btfa", x.conj(), sv).abs().square()
        tf_lik = -torch.pow(
            torch.clamp(xpow[..., None] - xh / (1 + epsilon), min=0.0),
            compression)
        m = mask[:, :, self.lo : self.hi, :].to(tf_lik.dtype)
        return torch.einsum("btfs,btfa->bsa", m, tf_lik)

    def merge_decisions(self, spec: torch.Tensor, mask: torch.Tensor,
                        thresh: float = 16.0, binarize: float = 0.5,
                        compression: float = 0.5
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(kill (B, 2) bool: the stream to kill in each window, if any;
        doa (B, 2) degrees). A window kills the stream of the lower masked
        channel-0 magnitude when the two streams' DOAs lie within
        ``thresh`` degrees; ties go to the first angle and the first
        stream, as argmax/argmin do in both packages."""
        binmask = (mask > binarize).to(torch.float32)
        lik = self.doa_likelihood(spec, binmask, compression=compression)
        doa = self._on(spec.device)[1][torch.argmax(lik, dim=-1)]  # (B, 2)
        diff = torch.minimum(torch.remainder(doa[:, 0] - doa[:, 1], 360.0),
                             torch.remainder(doa[:, 1] - doa[:, 0], 360.0))
        same_doa = diff <= thresh  # (B,)
        masked_mag = binmask * spec[:, 0].abs()[..., None]  # (B, T, F, 2)
        energy = masked_mag.sum(dim=(1, 2))  # (B, 2)
        kill = torch.argmin(energy, dim=-1)  # (B,)
        stream_ids = torch.arange(mask.shape[-1], device=spec.device)[None]
        return same_doa[:, None] & (stream_ids == kill[:, None]), doa

    def angle_merge(self, spec: torch.Tensor, mask: torch.Tensor,
                    thresh: float = 16.0, binarize: float = 0.5,
                    compression: float = 0.5) -> torch.Tensor:
        """Kill the weaker of two masks when their DOAs coincide.

        spec (B, C, T, F); mask (B, T, F, 2) -> merged mask, same shape:
        a killed stream's mask is 1e-12 everywhere."""
        kill, _ = self.merge_decisions(spec, mask, thresh, binarize,
                                       compression)
        return kill_masks(mask, kill)


def kill_masks(mask: torch.Tensor, kill: torch.Tensor) -> torch.Tensor:
    """mask (B, T, F, S); kill (B, S) bool -> the killed streams' masks
    set to 1e-12 everywhere."""
    return torch.where(kill[:, None, None, :],
                       torch.full((), 1e-12, dtype=mask.dtype,
                                  device=mask.device), mask)
