"""Continuous beamformer, ``masking`` type: stitched masks + waveform ->
separated audio.

Port of the masking branch of ``css_tpu/executor/beamformer.py``: every
window of the recording is analysed with the uncentered STFT (the
convention the masks were estimated under, so frame counts line up with
no alignment), multiplied by each stream's mask, deduplicated across
streams, and resynthesised by the K1 masked-iSTFT kernel in ONE launch
for all windows and streams. The per-window waveforms are then assembled
on the proceed-margin partition of the timeline and peak-normalised.

The Souden MVDR type, the reference's default, waits for the 7ch slice
(ROADMAP.md Queue 1 item 6): it raises, so a config that names no type
fails rather than giving another result than the reference.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from css_tpu_torch.device import resolve_device
from css_tpu_torch.executor.windowing import EXTRA_SAMPLES, unfold
from css_tpu_torch.ops import istft_cuda
from css_tpu_torch.ops import stft as stft_ops

# cross-stream dedup: a stream more than DEDUP_DB below the loudest one in
# a window is ducked bin by bin, its gains floored at -40 dB
DEDUP_DB = 15.0
DEDUP_FLOOR = 10.0 ** (-40.0 / 20.0)


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
            raise NotImplementedError(
                "souden_mvdr is not ported yet: ROADMAP.md Queue 1 item 6 "
                "(7ch inference); use type 'masking'")
        if "mask" not in bf_type.lower():
            raise ValueError(f"unknown beamformer type {bf_type!r}")
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

    def _process(self, wav_windows: torch.Tensor,
                 speaker_masks: torch.Tensor) -> torch.Tensor:
        """wav_windows (B, N); speaker_masks (B, K, T, F) -> (B, K, N)."""
        n = wav_windows.shape[-1]
        b, k = speaker_masks.shape[:2]
        spec = stft_ops.stft(wav_windows, self.n_fft, self.hop_length,
                             center=False)  # (B, T, F)
        t = min(spec.shape[1], speaker_masks.shape[2])
        outs = self._dedup(speaker_masks[:, :, :t] * spec[:, None, :t])
        wavs = self._masked_istft(outs.reshape(b * k, t, -1).contiguous(), n)
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
        """wav (T,); masks: K+1 stitched (T_frames, F) masks (K speaker
        streams, then noise) -> K waveforms (T,), peak-normalised to 0.9."""
        wav = torch.as_tensor(wav, dtype=torch.float32, device=self.device)
        if wav.ndim != 1:
            raise ValueError(f"1ch beamforming takes (T,), got "
                             f"{tuple(wav.shape)}")
        total = wav.shape[-1]
        wav_windows = unfold(wav, self.win, self.hop)  # (B, N)
        mask_windows = [
            unfold(torch.as_tensor(m, device=self.device).T, self.mask_win,
                   self.mask_hop)  # (B, F, Tw)
            for m in masks[:-1]]
        b = min([wav_windows.shape[0]] + [mw.shape[0] for mw in mask_windows])
        speaker_masks = torch.stack(
            [mw[:b].transpose(1, 2) for mw in mask_windows], dim=1)
        wavs = self._process(wav_windows[:b].contiguous(), speaker_masks)
        outs = []
        for s in range(wavs.shape[1]):
            res = self._assemble(wavs[:, s], total)
            outs.append(res * 0.9 / torch.clamp(res.abs().max(), min=1e-12))
        return tuple(outs)
