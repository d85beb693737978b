"""Sliding-window unfolding for chunked continuous separation.

Port of ``css_tpu/executor/windowing.py`` on tensors: ``unfold`` returns a
strided view (``Tensor.unfold``) with the window axis first.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# samples added to every 2.4 s window so that its uncentered STFT has as
# many frames as the beamformer's mask window: (38400 + 256 - 512)//256 + 1
# = 150 = int(2.4*16000/256), and (150 + 1)*256 = 38656 needs no padding
EXTRA_SAMPLES = 256


def unfold(x: torch.Tensor, win: int, hop: int,
           pad_to_one: bool = True) -> torch.Tensor:
    """(..., T) -> (B, ..., win) sliding windows; drops the ragged tail
    (torch.Tensor.unfold semantics). A signal shorter than one window is
    zero-padded to one window if ``pad_to_one``."""
    t = x.shape[-1]
    if t < win:
        if not pad_to_one:
            raise ValueError(f"signal length {t} < window {win}")
        x = F.pad(x, (0, win - t))
    return torch.movedim(x.unfold(-1, win, hop), -2, 0)


def pad_for_windows(x: torch.Tensor, win: int, hop: int) -> torch.Tensor:
    """Right-pad (..., T) with zeros so sliding (win, hop) windows cover the
    whole signal (bare ``unfold`` drops up to one window of audio)."""
    total = x.shape[-1]
    n_win = max(1, -(-(total - win) // hop) + 1)
    needed = (n_win - 1) * hop + win
    if needed > total:
        x = F.pad(x, (0, needed - total))
    return x
