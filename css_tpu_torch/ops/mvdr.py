"""Mask-based Souden MVDR beamforming (complex, batched).

Port of ``css_tpu/ops/mvdr.py``: spatial covariance matrices (SCMs) as
mask-weighted outer products with diagonal loading, Souden MVDR weights
W = solve(noise_scm, tgt_scm) / trace taken at reference channel 0,
applied as y[t, f] = sum_c conj(W[f, c]) * spec[c, t, f]. Everything is
batched over (window, frequency) in plain PyTorch: the SCM is one batched
matrix product, and the 7x7 complex solves are one batched
``torch.linalg.solve_ex`` call, as the reference leaves them to
``jnp.linalg.solve`` outside any Pallas kernel.

``solve_ex(check_errors=False)``: ``torch.linalg.solve`` raises on a
singular matrix, and on the card its check waits for the device;
``jnp.linalg.solve`` returns non-finite values instead. Without the check
the port gives what the reference gives, in both cases, and never waits.

Layout: spectra are (..., C, T, F) complex64, time-major; masks (..., T, F).
"""

from __future__ import annotations

import torch


def compute_scm(spec: torch.Tensor, mask: torch.Tensor,
                diag_loading: float = 1e-15) -> torch.Tensor:
    """spec (..., C, T, F) complex; mask (..., T, F) real -> (..., F, C, C)
    complex: sum over frames of mask * x x^H, plus diag_loading * I."""
    c = spec.shape[-3]
    weighted = spec * mask[..., None, :, :].to(spec.real.dtype)
    # (..., F, C, T) @ (..., F, T, C) -> (..., F, C, C)
    scm = weighted.movedim(-1, -3) @ spec.conj().movedim(-1, -3).transpose(
        -1, -2)
    eye = torch.eye(c, dtype=scm.dtype, device=scm.device)
    return scm + diag_loading * eye


def souden_coefficients(noise_scm: torch.Tensor, tgt_scm: torch.Tensor,
                        ref_channel: int = 0,
                        trace_eps: float = 1e-15) -> torch.Tensor:
    """noise_scm, tgt_scm (..., F, C, C) -> W (..., F, C); the beamformed
    output is sum_c conj(W[..., f, c]) * spec[..., c, t, f]."""
    num, _ = torch.linalg.solve_ex(noise_scm, tgt_scm, check_errors=False)
    den = torch.diagonal(num, dim1=-2, dim2=-1).sum(-1)[..., None]
    return num[..., ref_channel] / (den + trace_eps)


def apply_beamformer(spec: torch.Tensor, weights: torch.Tensor
                     ) -> torch.Tensor:
    """spec (..., C, T, F), weights (..., F, C) -> (..., T, F)."""
    return torch.einsum("...ctf,...fc->...tf", spec, weights.conj())


def souden_mvdr(spec: torch.Tensor, target_mask: torch.Tensor,
                noise_mask: torch.Tensor, diag_loading: float = 1e-15,
                ref_channel: int = 0) -> torch.Tensor:
    """Masked Souden MVDR end to end: (..., C, T, F) -> (..., T, F)."""
    tgt = compute_scm(spec, target_mask, diag_loading)
    noi = compute_scm(spec, noise_mask, diag_loading)
    return apply_beamformer(spec, souden_coefficients(noi, tgt, ref_channel))
