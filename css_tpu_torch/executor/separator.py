"""Chunked separator: long recording -> per-window TF masks, or per-window
waveforms from a time-domain model.

Port of ``css_tpu/executor/separator.py``: the recording, (T,) or
(C, T), is cut into sliding windows, the windows run through features +
model in batches of ``batch_size`` (``forward_windows``: full batches as
cut, the last, partial one padded with zero windows and sliced back, so
every forward has one shape), and the masks are clamped at 1. With
``merge`` (7ch) the DOA merge (``executor/doa.py``) kills the weaker of
the two speaker masks in every window whose two DOAs coincide. Everything stays on ``device``.

A time-domain model (``domain = "time"``, Conv-TasNet) takes the (B, N)
windows themselves: the forward runs no K3 and no clamp and gives the
(B, K, N) float32 speaker waveforms, zero-padded to the window where the
decoder's frames end short of it. The path is decided once, here, from
the model.

On the card ``forward`` is one captured CUDA graph a (batch, [channels,]
window, compute dtype) (``utils/programs.py``), the counterpart of the
JAX package's jitted forward: K3, the model forward (or the served
artifact), the clamp and the 7ch DOA merge in one replay. Its outputs are
the replay's own copies, so the slices a caller keeps never alias the
graph's static buffers. On the CPU the same function runs directly.

``Separator(None, exported_path=...)`` serves a ``torch.export``
artifact of the clamped forward (``cli/export.py``) in place of a live
model; the features (K3) and the DOA merge stay outside it, as in the
JAX package. The artifact takes one (batch, frames, features) shape: a
``batch_size`` or window that gives another raises.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from css_tpu_torch.device import resolve_device
from css_tpu_torch.executor.doa import SteeringVectors, kill_masks
from css_tpu_torch.executor.windowing import EXTRA_SAMPLES, unfold
from css_tpu_torch.ops.features import FeatureExtractor
from css_tpu_torch.utils import trace
from css_tpu_torch.utils.programs import Program


def require_masks(model, where: str) -> None:
    """Raise a ``ValueError`` naming ``where`` for a time-domain model
    (``domain = "time"``): paths built on K3 features and masks
    (sharded separation, streaming, the exported forward, the IPD
    features and the DOA merge) do not take one; ``CssPipeline.process``
    does."""
    if getattr(model, "domain", "mask") == "time":
        raise ValueError(
            f"{where} runs mask estimators on STFT features; "
            f"{type(model).__name__} separates waveforms in the time domain, "
            "which only the offline CssPipeline.process path runs")


class Separator:
    def __init__(
        self,
        model: Optional[torch.nn.Module],
        *,
        exported_path: Optional[str] = None,
        sr: int = 16000,
        eval_win: float = 2.4,
        eval_hop: float = 0.8,
        frame_len: int = 512,
        frame_hop: int = 256,
        batch_size: int = 32,
        ipd_index: Optional[str] = None,
        merge: bool = False,
        merge_threshold: float = 16.0,
        num_spk: int = 2,
        device: Union[str, torch.device] = "cuda",
    ):
        if merge and num_spk != 2:
            # angle_merge compares exactly two speaker DOAs; with K > 2 it
            # would route the extra speakers as noise streams
            raise ValueError(
                f"merge=true requires num_spk==2 (got {num_spk}); disable "
                "the DOA merge for K-speaker separation")
        if (model is None) == (exported_path is None):
            raise ValueError("Separator serves a model or an exported "
                             "artifact (exported_path=), exactly one")
        self.device = resolve_device(device)
        self.model = model
        self.time_domain = getattr(model, "domain", "mask") == "time"
        if merge or ipd_index:
            require_masks(model, "the IPD features and the DOA merge")
        self.exported = None
        if exported_path is not None:
            from css_tpu_torch.cli.export import load_exported

            self.exported = load_exported(exported_path)
        self.win = int(eval_win * sr) + EXTRA_SAMPLES
        self.hop = int(eval_hop * sr)
        self.batch_size = batch_size
        self.features = FeatureExtractor(frame_len, frame_hop,
                                         ipd_index=ipd_index)
        self.merge = merge
        self.merge_threshold = merge_threshold
        self.steering = (SteeringVectors(nfreqs=self.features.num_bins, sr=sr)
                         if merge else None)
        # windows whose weaker speaker mask the DOA merge killed in the
        # last separate() call (a 0-d tensor on device; None without merge)
        self.merge_kills = None
        self.program = Program(self._forward_impl, "separator_forward")

    @torch.no_grad()
    def forward(self, wav_batch: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                           Optional[torch.Tensor]]:
        """(B, N) or (B, C, N) windows -> (masks (B, T, F, S) clamped at 1,
        mag (B, T, F), kill (B, 2) bool from the DOA merge or None), or for
        a time-domain model (streams (B, K, N), None, None): one program
        replay on the card."""
        dtype = getattr(self.model, "compute_dtype", None)
        return self.program(wav_batch, mode=(dtype,))

    def _forward_impl(self, wav_batch: torch.Tensor):
        # K3 takes a contiguous signal: a batch cut from the windows view
        # is copied once here, a program's static input not at all
        wav_batch = wav_batch.contiguous()
        if self.time_domain:
            streams = self.model(wav_batch)
            return F.pad(streams, (0, wav_batch.shape[-1]
                                   - streams.shape[-1])), None, None
        if self.merge:
            mag, feats, spec = self.features(wav_batch, return_spec=True)
        else:
            mag, feats = self.features(wav_batch)
        if self.exported is not None:
            if tuple(feats.shape) != self.exported.input_shape:
                raise ValueError(
                    f"the exported forward takes features "
                    f"{self.exported.input_shape} (batch, frames, bins), "
                    f"this separator gives {tuple(feats.shape)}: export at "
                    f"this batch_size and window")
            masks = self.exported(feats)  # clamped at export
        else:
            _, masks = self.model(feats)
            masks = torch.clamp(masks, max=1.0)
        kill = None
        if self.merge:
            kill, _ = self.steering.merge_decisions(
                spec, masks[..., :2], thresh=self.merge_threshold)
            masks = torch.cat([kill_masks(masks[..., :2], kill),
                               masks[..., 2:]], dim=-1)
        return masks, mag, kill

    @torch.no_grad()
    def separate(self, wav: Union[np.ndarray, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """wav (T,) or (C, T) full recording -> (masks (B, T', F, S),
        mags (B, T', F)) on ``device``, one row per sliding window; for a
        time-domain model (streams (B, K, N), None). A
        ``separator`` span: its own time is the last batch's padding and
        the final ``cat``; counters ``windows``, ``batch_slots`` and, with
        ``merge``, ``merge_windows`` (the recording's windows, the
        batches' padding left out)."""
        with trace.span("separator"):
            wav = torch.as_tensor(wav, dtype=torch.float32,
                                  device=self.device)
            if wav.ndim not in (1, 2):
                raise ValueError(f"a recording is (T,) or (C, T), got "
                                 f"{tuple(wav.shape)}")
            windows = unfold(wav, self.win, self.hop)  # (B, [C,] win) view
            n = windows.shape[0]
            bs = self.batch_size
            trace.count("windows", n)
            trace.count("batch_slots", -(-n // bs) * bs)
            if self.merge:
                trace.count("merge_windows", n)
            masks, mags, self.merge_kills = self.forward_windows(windows, bs)
            return masks, mags

    def forward_windows(self, windows: torch.Tensor, batch_size: int
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                   Optional[torch.Tensor]]:
        """(n, [C,] win) windows -> (masks, mags, the merge's killed
        windows as a 0-d tensor or None), or a time-domain model's
        (streams, None, None), in forwards of ``batch_size`` windows: full
        batches as cut, a partial last one zero-padded."""
        outs_m, outs_g, kills = [], [], []
        for i in range(0, windows.shape[0], batch_size):
            batch = windows[i : i + batch_size]
            real = batch.shape[0]
            if real < batch_size:
                batch = torch.cat([batch, batch.new_zeros(
                    (batch_size - real,) + tuple(batch.shape[1:]))])
            masks, mag, kill = self.forward(batch)
            outs_m.append(masks[:real])
            if mag is not None:
                outs_g.append(mag[:real])
            if kill is not None:
                kills.append(kill[:real].any(dim=-1).sum())
        kills = torch.stack(kills).sum() if kills else None
        return (torch.cat(outs_m), torch.cat(outs_g) if outs_g else None,
                kills)
