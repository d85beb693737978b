"""Held-out quality probe for checkpoint selection (port of
``css_tpu/trainer/probe.py``).

Validation MSE picks the wrong checkpoint (BASELINE.md): the criterion
that tracks what users score is the SI-SNR improvement of the whole
separation pipeline on held-out speakers. The probe measures it every
epoch on a few short fixed synthetic sessions (a held-out corpus seed),
made once at construction, in one of three modes:

  mask     1ch mask models (Conformer, BLSTM): windows -> features (K3)
           -> the model in eval mode -> the stitcher (permutation scan,
           winner-take-all, overlap-average) -> masked resynthesis of the
           whole session (K1).
  spatial  7ch models (``--spatialize-channels``): far-field sessions on
           the 7-mic array (``data/spatial.py``), [channel 0's magnitude,
           IPD] features, the same stitch, masked resynthesis of channel
           0, which is the dry mixture.
  time     waveform models (Conv-TasNet): the windows through the model,
           per-window PIT SI-SNRi against the aligned source windows (no
           stitcher).

The resynthesis masks the uncentered STFT of the whole session: window
w's frame j is the session's frame w * hop_frames + j, so the stitched
mask timeline lines up with the session's STFT bin for bin. On the card
the features of all sessions' windows are one K3 launch and the
resynthesis of all sessions' streams one K1 launch, trimmed to the
session length; a BLSTM's inference forward runs K2.

The probe leaves the model as it found it: it runs in eval mode under
``no_grad`` (no dropout draw, BatchNorm reads its running statistics), and
the model's mode is restored after, so that a run with the probe trains
as one without.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from css_tpu_torch.data.sessions import make_session
from css_tpu_torch.data.spatial import draw_azimuths, spatial_session
from css_tpu_torch.device import resolve_device
from css_tpu_torch.executor.stitcher import Stitcher
from css_tpu_torch.executor.windowing import EXTRA_SAMPLES, unfold
from css_tpu_torch.ops import istft_cuda
from css_tpu_torch.ops import stft as stft_ops
from css_tpu_torch.ops.features import FeatureExtractor
from css_tpu_torch.utils.permutations import permutations_array

# windows per model forward (the separator's batch)
FORWARD_BATCH = 32


def si_snr(est: torch.Tensor, ref: torch.Tensor,
           eps: float = 1e-8) -> torch.Tensor:
    """Scale-invariant SNR in dB over the last axis, mean-centred."""
    est = est - est.mean(dim=-1, keepdim=True)
    ref = ref - ref.mean(dim=-1, keepdim=True)
    proj = ((est * ref).sum(-1, keepdim=True)
            / ((ref * ref).sum(-1, keepdim=True) + eps)) * ref
    noise = est - proj
    return 10.0 * torch.log10((proj ** 2).sum(-1)
                              / ((noise ** 2).sum(-1) + eps) + eps)


class HeldOutProbe:
    """Mean held-out SI-SNRi (dB) of a model over fixed sessions;
    ``mode`` is "mask", "spatial" or "time" (module docstring)."""

    def __init__(self, corpus, *, sessions: int = 4, session_sec: float = 12.0,
                 seed: int = 123, sr: int = 16000, eval_win: float = 2.4,
                 eval_hop: float = 0.8, frame_len: int = 512,
                 frame_hop: int = 256, num_spk: int = 2,
                 wta_floor: float = 1e-4, overlap_frac: float = 0.3,
                 mode: str = "mask", ipd_index: Optional[str] = None,
                 noise_level: float = 0.003,
                 min_separation_deg: float = 20.0,
                 stratify_f0: bool = False, device="cuda"):
        if mode not in ("mask", "spatial", "time"):
            raise ValueError(f"unknown probe mode {mode!r}")
        if mode == "spatial" and not ipd_index:
            raise ValueError("spatial probe needs ipd_index")
        self.device = resolve_device(device)
        rng = np.random.default_rng(seed)
        self.sr = sr
        self.mode = mode
        win = int(eval_win * sr) + EXTRA_SAMPLES
        hop = int(eval_hop * sr)
        # stratify_f0: the session pairs spread evenly over the |f0_a -
        # f0_b| ranking of all pairs, the closest pair included (K=2 only)
        pairs = [None] * sessions
        if stratify_f0:
            if num_spk != 2:
                raise ValueError("stratify_f0 probe supports num_spk=2")
            f0 = corpus.f0_by_speaker
            ranked = sorted(
                ((a, b) for i, a in enumerate(corpus.speakers)
                 for b in corpus.speakers[i + 1:]),
                key=lambda p: abs(f0[p[0]] - f0[p[1]]))
            idx = np.linspace(0, len(ranked) - 1, sessions).round()
            pairs = [ranked[int(j)] for j in idx]
        mixes, refs = [], []
        for si in range(sessions):
            mix, srcs = make_session(corpus, rng, session_sec, sr=sr,
                                     overlap_frac=overlap_frac,
                                     num_spk=num_spk, pair=pairs[si])
            if mode == "spatial":
                az = draw_azimuths(rng, num_spk, min_separation_deg)
                mix = spatial_session(srcs, az, noise_level=noise_level,
                                      seed=int(rng.integers(2**31)))
            # padded so that the sliding windows cover the whole session
            total = mix.shape[-1]
            n_win = max(1, -(-(total - win) // hop) + 1)
            needed = (n_win - 1) * hop + win
            pad = [(0, 0)] * (mix.ndim - 1) + [(0, max(0, needed - total))]
            mixes.append(np.pad(mix, pad))
            refs.append(srcs)
        self.total = int(refs[0].shape[-1])
        self.mixes = torch.as_tensor(np.stack(mixes), device=self.device)
        self.refs = torch.as_tensor(np.stack(refs), device=self.device)

        def windows(x):  # (S, ..., Tp) -> (S, W, ..., win)
            return torch.movedim(unfold(x, win, hop), 0, 1).contiguous()

        self.windows = windows(self.mixes)  # (S, W, [C,] win)
        self.ref_windows = None
        if mode == "time":  # (S, W, K, win)
            self.ref_windows = windows(torch.nn.functional.pad(
                self.refs, (0, self.mixes.shape[-1] - self.total)))
        self.features = FeatureExtractor(
            frame_len, frame_hop,
            ipd_index=ipd_index if mode == "spatial" else None)
        self.stitcher = Stitcher(eval_win=eval_win, eval_hop=eval_hop,
                                 fft_hop=frame_hop, sr=sr,
                                 wta_floor=wta_floor, num_spk=num_spk,
                                 device=self.device)
        self.frame_len, self.frame_hop = frame_len, frame_hop
        self.num_spk = num_spk
        self._perms = permutations_array(num_spk)

    def _forward(self, model, x: torch.Tensor, index: int) -> torch.Tensor:
        """The model on x's rows, FORWARD_BATCH at a time; output
        ``index`` of a tuple (the masks of a mask model)."""
        outs = []
        for i in range(0, x.shape[0], FORWARD_BATCH):
            out = model(x[i:i + FORWARD_BATCH])
            outs.append(out[index] if isinstance(out, tuple) else out)
        return torch.cat(outs)

    def stitched_masks(self, model) -> Tuple[List[Tuple[torch.Tensor, ...]],
                                             torch.Tensor]:
        """Per session the K+1 stitched (T_total, F) masks, and the
        sessions' channel-0 mixtures (S, Tp): features of every window in
        one call (K3), the model, masks clamped at 1, the stitcher."""
        s, w = self.windows.shape[:2]
        mag, feats = self.features(self.windows.reshape(
            (s * w,) + tuple(self.windows.shape[2:])))
        masks = torch.clamp(self._forward(model, feats, 1), max=1.0)
        masks = masks.reshape((s, w) + tuple(masks.shape[1:]))
        mag = mag.reshape((s, w) + tuple(mag.shape[1:]))
        stitched = [self.stitcher.get_connect(
            self.stitcher.get_stitch(masks[i], mag[i]), masks[i])
            for i in range(s)]
        mix0 = self.mixes[:, 0] if self.mixes.ndim == 3 else self.mixes
        return stitched, mix0

    def masked_spectra(self, model) -> Tuple[torch.Tensor, torch.Tensor]:
        """The resynthesis input: the stitched speaker masks times each
        session's uncentered STFT, (S * K, T, F) complex64, and the
        sessions' channel-0 mixtures (S, Tp)."""
        stitched, mix0 = self.stitched_masks(model)
        k = self.num_spk
        spec = stft_ops.stft(mix0, self.frame_len, self.frame_hop)  # (S,T,F)
        t = min(spec.shape[1], stitched[0][0].shape[0])
        est = torch.stack([torch.stack(st[:k])[:, :t] for st in stitched])
        est = (est * spec[:, None, :t]).reshape(-1, t, spec.shape[-1])
        return est.contiguous(), mix0

    def _mask_si_snri(self, model) -> torch.Tensor:
        """(S,) SI-SNRi of the masking pipeline: all S x K streams
        resynthesised in one K1 launch, trimmed to the session."""
        est, mix0 = self.masked_spectra(model)
        sig = istft_cuda.istft(est, self.frame_len, self.frame_hop)
        if sig.shape[-1] < self.total:
            sig = torch.nn.functional.pad(sig, (0, self.total
                                                - sig.shape[-1]))
        k = self.num_spk
        ests = sig[:, :self.total].reshape(-1, k, self.total)
        refs = self.refs[..., :self.total]
        cand = torch.stack([si_snr(ests[:, list(p)], refs).mean(-1)
                            for p in self._perms])  # (K!, S)
        base = si_snr(mix0[:, None, :self.total].expand_as(refs),
                      refs).mean(-1)
        return cand.amax(0) - base

    def _time_si_snri(self, model) -> torch.Tensor:
        """(S,) mean per-window PIT SI-SNRi of a waveform model."""
        s, w, win = self.windows.shape
        ests = self._forward(model, self.windows.reshape(s * w, win), 0)
        ests = ests.reshape(s, w, -1, win)  # (S, W, K, win)
        refs = self.ref_windows
        cand = torch.stack([si_snr(ests[:, :, list(p)], refs).mean(-1)
                            for p in self._perms])  # (K!, S, W)
        base = si_snr(self.windows[:, :, None].expand_as(refs),
                      refs).mean(-1)  # (S, W)
        return (cand.amax(0) - base).mean(-1)

    def __call__(self, model) -> float:
        """Mean held-out SI-SNRi (dB) of ``model`` over the sessions."""
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                vals = (self._time_si_snri(model) if self.mode == "time"
                        else self._mask_si_snri(model))
        finally:
            model.train(was_training)
        return float(vals.mean())
