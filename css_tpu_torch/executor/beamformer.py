"""Continuous beamformer: stitched masks + waveform -> separated audio.

Port of ``css_tpu/executor/beamformer.py``. All windows of a recording
are beamformed at once, and the per-window waveforms are assembled on the
proceed-margin partition of the timeline and peak-normalised. Two types:

  * ``souden_mvdr``, the reference's default (its asteroid class name
    ``SoudenMVDRBeamformer`` is accepted): the centered STFT of every
    channel, each stream's mask aligned to the centered frames, masked
    Souden MVDR (``ops/mvdr.py``) against the noise stream's SCM, shared
    by every speaker stream, the output rescaled to the energy of the masked channel 0, cross-stream
    dedup, and the centered iSTFT of all windows and streams in ONE K1
    launch (``istft_cuda.istft_centered``). With one channel it reduces to
    an energy rescale of the mixture, as in the reference.
  * ``masking``: channel 0's uncentered STFT (the convention the masks
    were estimated under, so frame counts line up with no alignment)
    times each stream's mask, dedup, and the uncentered iSTFT in one K1
    launch.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from css_tpu_torch.device import resolve_device
from css_tpu_torch.executor.windowing import EXTRA_SAMPLES, unfold
from css_tpu_torch.ops import istft_cuda
from css_tpu_torch.ops import stft as stft_ops
from css_tpu_torch.ops.mvdr import (apply_beamformer, compute_scm,
                                    souden_coefficients)
from css_tpu_torch.utils import trace

# cross-stream dedup: a stream more than DEDUP_DB below the loudest one in
# a window is ducked bin by bin, its gains floored at -40 dB
DEDUP_DB = 15.0
DEDUP_FLOOR = 10.0 ** (-40.0 / 20.0)
# the SCMs' diagonal loading, and the shift of the masks' uncentered
# frames onto the MVDR spectrum's centered ones
DIAG_LOADING = 1e-15
MASK_SHIFT = 1


class Beamformer:
    def __init__(
        self,
        bf_type: str = "souden_mvdr",
        sr: int = 16000,
        n_fft: int = 512,
        hop_length: int = 256,
        eval_win: float = 2.4,
        eval_hop: float = 0.8,
        proceed_margin: float = 2.0,
        device: Union[str, torch.device] = "cuda",
    ):
        # the reference's asteroid class names are accepted, as in css_tpu
        if "mvdr" in bf_type.lower():
            bf_type = "souden_mvdr"
        elif "mask" in bf_type.lower():
            bf_type = "masking"
        else:
            raise ValueError(f"unknown beamformer type {bf_type!r}")
        self.bf_type = bf_type
        self.device = resolve_device(device)
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.win = int(eval_win * sr) + EXTRA_SAMPLES
        self.hop = int(eval_hop * sr)
        self.mask_win = int(eval_win * sr / hop_length)
        self.mask_hop = int(eval_hop * sr / hop_length)
        self.margin = int(proceed_margin * sr)
        if not self.hop <= self.margin <= self.win:
            raise ValueError(
                f"proceed margin {self.margin} must lie in [hop {self.hop}, "
                f"window {self.win}] samples")

    def _align_mask(self, mask: torch.Tensor, t_spec: int) -> torch.Tensor:
        """Masks (..., T, F) on the uncentered frames -> (..., t_spec, F)
        on the centered ones: uncentered frame t is centered frame t + 1,
        so the masks move by MASK_SHIFT frames and the edges are
        replicated."""
        t_mask = mask.shape[-2]
        idx = torch.arange(t_spec, device=mask.device) - MASK_SHIFT
        return mask[..., torch.clamp(idx, 0, t_mask - 1), :]

    def _mvdr(self, wav_windows: torch.Tensor, speaker_masks: torch.Tensor,
              noise_mask: torch.Tensor) -> torch.Tensor:
        """wav_windows (B, D, N); speaker_masks (B, K, T, F); noise_mask
        (B, T, F) -> beamformed spectra (B, K, T', F) on the centered
        frames, rescaled. A ``beamformer.mvdr`` span holding
        ``beamformer.stft``, ``beamformer.scm`` (both SCMs),
        ``beamformer.solve`` and ``beamformer.apply`` (the apply and the
        energy rescale); counter ``mvdr_systems``, the B * K * F solves."""
        with trace.span("beamformer.mvdr"):
            with trace.span("beamformer.stft"):
                spec = stft_ops.stft(wav_windows, self.n_fft,
                                     self.hop_length,
                                     center=True)  # (B, D, T', F)
            t = spec.shape[2]
            # the SCMs, the solves and the apply in float64: with little
            # diffuse noise the noise SCMs' condition numbers reach 1e6-1e8,
            # and float32 leaves the streams undecided by ~1e-2 there
            speech = self._align_mask(speaker_masks,
                                      t).double()  # (B, K, T', F)
            noise = self._align_mask(noise_mask[:, None], t)  # (B, 1, T', F)
            spec_k = spec.to(torch.complex128)[:, None]  # (B, 1, D, T', F)
            with trace.span("beamformer.scm"):
                tgt = compute_scm(spec_k, speech, DIAG_LOADING)
                noi = compute_scm(spec_k, noise, DIAG_LOADING)
            with trace.span("beamformer.solve"):
                # one noise SCM, shared by every stream
                w = souden_coefficients(noi.expand_as(tgt),
                                        tgt)  # (B, K, F, D)
            trace.count("mvdr_systems", w.shape[0] * w.shape[1] * w.shape[2])
            with trace.span("beamformer.apply"):
                out = apply_beamformer(spec_k, w)  # (B, K, T', F)
                # the output's energy set to the masked channel 0's
                masked = speech * spec_k[:, :, 0]
                masked_e = torch.sqrt(masked.abs().square().mean(
                    dim=(2, 3), keepdim=True))
                out_e = torch.sqrt(out.abs().square().mean(dim=(2, 3),
                                                           keepdim=True))
                out = out / torch.clamp(out_e, min=1e-12) * masked_e
                return out.to(spec.dtype)

    def _process(self, wav_windows: torch.Tensor, speaker_masks: torch.Tensor,
                 noise_mask: torch.Tensor) -> torch.Tensor:
        """wav_windows (B, D, N); speaker_masks (B, K, T, F); noise_mask
        (B, T, F) -> (B, K, N)."""
        n = wav_windows.shape[-1]
        b, k = speaker_masks.shape[:2]
        if self.bf_type == "masking":
            spec = stft_ops.stft(wav_windows[:, 0], self.n_fft,
                                 self.hop_length, center=False)  # (B, T, F)
            t = min(spec.shape[1], speaker_masks.shape[2])
            outs = self._dedup(speaker_masks[:, :, :t] * spec[:, None, :t])
            wavs = self._masked_istft(
                outs.reshape(b * k, t, -1).contiguous(), n)
            return wavs.reshape(b, k, -1)
        outs = self._dedup(self._mvdr(wav_windows, speaker_masks, noise_mask))
        wavs = istft_cuda.istft_centered(
            outs.reshape(b * k, *outs.shape[2:]).contiguous(), self.n_fft,
            self.hop_length, length=n)
        return wavs.reshape(b, k, -1)

    def _dedup(self, s: torch.Tensor) -> torch.Tensor:
        """Duck streams more than DEDUP_DB below the loudest one."""
        s_abs = torch.abs(s)
        pow_db = 10.0 * torch.log10(
            torch.sum(s_abs ** 2, dim=(2, 3)) + 1e-30)  # (B, K)
        gain = s_abs / torch.clamp(s_abs.amax(dim=1, keepdim=True), min=1e-30)
        ducked = torch.clamp(gain, min=DEDUP_FLOOR) * s
        loudest = pow_db.amax(dim=1, keepdim=True)
        duck = (loudest - pow_db > DEDUP_DB)[:, :, None, None]
        return torch.where(duck, ducked, s)

    def _masked_istft(self, spec: torch.Tensor, n: int) -> torch.Tensor:
        """Uncentered synthesis: K1 on the card, its plain version on the
        CPU; padded or cut to n samples."""
        wav = istft_cuda.istft(spec, self.n_fft, self.hop_length)
        if wav.shape[-1] < n:
            wav = F.pad(wav, (0, n - wav.shape[-1]))
        return wav[..., :n]

    def _assemble(self, wavs: torch.Tensor, total: int) -> torch.Tensor:
        """Per-window wavs (B, N) -> (total,) on the proceed-margin
        partition: window 0 gives [0, margin), window i the hop that ends
        at i*hop + margin, the last window everything from its start on."""
        b = wavs.shape[0]
        if b == 1:  # one window covers the whole (short) recording
            out = wavs[0, :total]
        else:
            lo = self.margin - self.hop
            out = torch.cat([wavs[0, : self.margin],
                             wavs[1:-1, lo : self.margin].reshape(-1),
                             wavs[-1, lo:]])[:total]
        return F.pad(out, (0, total - out.shape[0]))

    @torch.no_grad()
    def continuous_process(self, wav, masks: Sequence[torch.Tensor]
                           ) -> Tuple[torch.Tensor, ...]:
        """wav (T,) or (D, T); masks: K+1 stitched (T_frames, F) masks (K
        speaker streams, then noise) -> K waveforms (T,), peak-normalised
        to 0.9. A ``beamformer`` span."""
        with trace.span("beamformer"):
            wav = torch.as_tensor(wav, dtype=torch.float32,
                                  device=self.device)
            if wav.ndim == 1:
                wav = wav[None]
            if wav.ndim != 2:
                raise ValueError(f"beamforming takes (T,) or (D, T), got "
                                 f"{tuple(wav.shape)}")
            total = wav.shape[-1]
            wav_windows = unfold(wav, self.win, self.hop)  # (B, D, N)
            mask_windows = [
                unfold(torch.as_tensor(m, device=self.device).T,
                       self.mask_win, self.mask_hop)  # (B, F, Tw)
                for m in masks]
            b = min([wav_windows.shape[0]]
                    + [mw.shape[0] for mw in mask_windows])
            tw = [mw[:b].transpose(1, 2) for mw in mask_windows]
            wavs = self._process(wav_windows[:b].contiguous(),
                                 torch.stack(tw[:-1], dim=1), tw[-1])
            return self._streams(wavs, total)

    def _streams(self, wavs: torch.Tensor, total: int
                 ) -> Tuple[torch.Tensor, ...]:
        """Per-window streams (B, K, N) -> K waveforms (total,), each
        assembled on the proceed-margin partition and peak-normalised to
        0.9."""
        outs = []
        for s in range(wavs.shape[1]):
            res = self._assemble(wavs[:, s], total)
            outs.append(res * 0.9 / torch.clamp(res.abs().max(), min=1e-12))
        return tuple(outs)

    @torch.no_grad()
    def assemble(self, wavs: torch.Tensor, total: int
                 ) -> Tuple[torch.Tensor, ...]:
        """A time-domain model's routed per-window streams (B, K, N) -> K
        waveforms (total,), as ``continuous_process`` ends: the
        proceed-margin partition and the 0.9 peak, with no STFT, no dedup
        and no K1. A ``beamformer`` span."""
        with trace.span("beamformer"):
            return self._streams(wavs, total)
