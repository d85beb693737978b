"""Chunked separator: long recording -> per-window TF masks.

Port of ``css_tpu/executor/separator.py`` (1ch, no DOA merge, no exported
graph): the recording is cut into sliding windows, the windows run through
features + model in batches of ``batch_size`` (the last batch padded with
zero windows and sliced back, so every forward has one shape), and the
masks are clamped at 1. Everything stays on ``device``.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from css_tpu_torch.device import resolve_device
from css_tpu_torch.executor.windowing import EXTRA_SAMPLES, unfold
from css_tpu_torch.ops.features import FeatureExtractor


class Separator:
    def __init__(
        self,
        model: torch.nn.Module,
        *,
        sr: int = 16000,
        eval_win: float = 2.4,
        eval_hop: float = 0.8,
        frame_len: int = 512,
        frame_hop: int = 256,
        batch_size: int = 32,
        ipd_index: Optional[str] = None,
        merge: bool = False,
        device: Union[str, torch.device] = "cuda",
    ):
        if merge:
            raise NotImplementedError(
                "the 7ch DOA mask merge is not ported yet: ROADMAP.md Queue 1 "
                "item 6")
        self.device = resolve_device(device)
        self.model = model
        self.win = int(eval_win * sr) + EXTRA_SAMPLES
        self.hop = int(eval_hop * sr)
        self.batch_size = batch_size
        self.features = FeatureExtractor(frame_len, frame_hop,
                                         ipd_index=ipd_index)

    @torch.no_grad()
    def forward(self, wav_batch: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, N) windows -> (masks (B, T, F, S) clamped at 1, mag (B, T, F))."""
        mag, feats = self.features(wav_batch)
        _, masks = self.model(feats)
        return torch.clamp(masks, max=1.0), mag

    @torch.no_grad()
    def separate(self, wav: Union[np.ndarray, torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """wav (T,) full recording -> (masks (B, T', F, S), mags (B, T', F))
        on ``device``, one row per sliding window."""
        wav = torch.as_tensor(wav, dtype=torch.float32, device=self.device)
        if wav.ndim != 1:
            raise ValueError(f"1ch separation takes (T,), got {tuple(wav.shape)}")
        windows = unfold(wav, self.win, self.hop)  # (B, win) view
        n = windows.shape[0]
        bs = self.batch_size
        outs_m, outs_g = [], []
        for i in range(0, n, bs):
            chunk = windows[i : i + bs]
            real = chunk.shape[0]
            batch = chunk.new_zeros((bs, self.win))
            batch[:real] = chunk
            masks, mag = self.forward(batch)
            outs_m.append(masks[:real])
            outs_g.append(mag[:real])
        return torch.cat(outs_m), torch.cat(outs_g)
