"""Window-granular streaming continuous separation.

Port of ``css_tpu/executor/streaming.py``: audio arrives in pushes of any
size, and separated audio is emitted as soon as no later window can change
it. Every stage of the CSS algorithm is windowed with bounded lookahead:

  * each 2.4 s separator window's masks are estimated on their own (the
    port's ``Separator.forward`` at batch 1: K3, and on 7ch the IPD
    features and the DOA merge);
  * the stitch decision at a window needs only the previous window's
    overlap-margin energies, and the stream assignment is the running
    composition of the boundary permutations (a (K,) carry);
  * a frame of the overlap-averaged masks is final once the last window
    covering it is in;
  * each beamform window is resynthesised (the port's
    ``Beamformer._process``: K1, or K1's centered entry after Souden
    MVDR) and its proceed-margin slice emitted.

The bookkeeping (stitch decisions, mask accumulation, online
re-anchoring, emission) runs on the host in numpy, as in ``css_tpu``;
the forward and the resynthesis run on ``device``. Buffers are pruned to
what a later window can still read, so memory and per-push cost stay
bounded however long the stream runs. The output matches
``CssPipeline.process`` but for the peak normalisation, which a causal
system cannot do (``pipeline.write_streams`` normalises at write time).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from css_tpu_torch.device import resolve_device
from css_tpu_torch.executor.beamformer import Beamformer
from css_tpu_torch.executor.separator import Separator, require_masks
from css_tpu_torch.utils.permutations import permutations_array


class StreamingCssPipeline:
    """Incremental separator -> stitcher -> resynthesis with carried state.

    The YAML config schema of ``CssPipeline``. ``push(samples)`` returns a
    (K, n) array of newly final audio (n may be 0); ``flush()`` processes
    the buffered tail (the last partial window padded as the offline path
    pads it) and returns the rest. ``model`` is moved to ``device`` and
    put in eval mode.
    """

    def __init__(self, model: torch.nn.Module, config: dict, sr: int = 16000,
                 device: Union[str, torch.device] = "cuda"):
        require_masks(model, "window streaming")
        sep = config.get("separation", {})
        sti = config.get("stitching", {})
        bf = config.get("beamforming", {})
        self.device = resolve_device(device)
        self.sr = int(config.get("sampling_rate", sr))
        num_spk = int(sep.get("num_spk", getattr(model, "num_spk", 2) or 2))
        self.num_spk = num_spk
        self.model = model.to(self.device).eval()
        self.separator = Separator(
            self.model, sr=self.sr,
            eval_win=float(sep.get("eval_win", 2.4)),
            eval_hop=float(sep.get("eval_hop", 0.8)),
            frame_len=int(sep.get("frame_length", 512)),
            frame_hop=int(sep.get("frame_shift", 256)),
            batch_size=1,
            ipd_index=sep.get("ipd"),
            merge=bool(sep.get("merge", False)),
            merge_threshold=float(sep.get("merge_threshold", 16.0)),
            num_spk=num_spk,
            device=self.device,
        )
        self.beamformer = Beamformer(
            bf_type=bf.get("type", "masking"),
            sr=self.sr,
            n_fft=int(bf.get("n_fft", 512)),
            hop_length=int(bf.get("hop_size", 256)),
            eval_win=float(bf.get("eval_win", sep.get("eval_win", 2.4))),
            eval_hop=float(bf.get("eval_hop", sep.get("eval_hop", 0.8))),
            proceed_margin=float(bf.get("proceed_margin", 2.0)),
            device=self.device,
        )
        self.win = self.separator.win  # eval_win * sr + EXTRA_SAMPLES
        self.hop = self.separator.hop
        fft_hop = int(sep.get("frame_shift", 256))
        eval_win = float(sep.get("eval_win", 2.4))
        eval_hop = float(sep.get("eval_hop", 0.8))
        self.margin_frames = int(round((eval_win - eval_hop) * self.sr
                                       / fft_hop))
        self.hop_frames = int(eval_hop * self.sr / fft_hop)
        self.wta_floor = float(bf.get("wta_thresh", 1e-4))
        self.perm_table = permutations_array(num_spk)  # (K!, K)

        # carried state; `_base` / `_frame_base` are the absolute positions
        # of the retained buffers' first sample / frame
        self._buf: Optional[np.ndarray] = None  # (D, n) retained audio
        self._base = 0
        self._buffered = 0  # samples pushed in all
        self._n_sep = 0  # separator windows processed
        self._prev_margin: Optional[np.ndarray] = None  # (M, F, K) energies
        self._assign = np.arange(num_spk)  # running stream assignment
        self._mask_sum: Optional[np.ndarray] = None  # (frames, F, S)
        self._mask_cnt: Optional[np.ndarray] = None  # (frames,)
        self._frame_base = 0
        self._n_bf = 0  # beamform windows emitted
        self._flushed = False

        # online stream-identity re-anchoring (``stitching: {reanchor:
        # true}``): per-stream timbre profiles over ~block_sec of routed
        # masked magnitude; at a block boundary a permutation that matches
        # the long-horizon anchors decisively better corrects `_assign` for
        # every later window (emitted audio cannot be rewritten)
        self.reanchor = bool(sti.get("reanchor", False))
        self._ra_block_frames = int(
            float(sti.get("reanchor_block_sec", 8.0)) * self.sr / fft_hop)
        self._ra_conf = float(sti.get("reanchor_confidence", 0.04))
        self._ra_anchors = None  # K unit profiles (or None entries)
        self._ra_aw = np.zeros(num_spk)  # anchor weights (active frames)
        self._ra_sum = None  # (K, F) running block profile sums
        self._ra_cnt = np.zeros(num_spk)  # active frames this block
        self._ra_ref = 0.0  # decaying max frame energy (activity ref)
        self._ra_next_block = self._ra_block_frames
        self._ra_min_active = max(4, int(0.2 * self.sr / fft_hop))

    # ------------------------------------------------------------- buffering
    def _audio_slice(self, start: int, n: int) -> np.ndarray:
        """(D, <= n) of retained audio at absolute sample ``start``."""
        lo = start - self._base
        if lo < 0:
            raise AssertionError("window starts before the pruned horizon")
        return self._buf[:, lo: lo + n]

    def _prune(self):
        """Drop the audio and frames no later window can read."""
        keep = min(self._n_bf, self._n_sep) * self.hop
        if self._buf is not None and keep > self._base:
            self._buf = self._buf[:, keep - self._base:]
            self._base = keep
        f_keep = self._n_bf * self.beamformer.mask_hop
        if self._mask_sum is not None and f_keep > self._frame_base:
            d = f_keep - self._frame_base
            self._mask_sum = self._mask_sum[d:]
            self._mask_cnt = self._mask_cnt[d:]
            self._frame_base = f_keep

    # ------------------------------------------------------------ separation
    def _process_sep_window(self, wav_window: np.ndarray):
        """One (D, win) window -> the stitch state's update and the
        window's masks added to the overlap-average (the offline
        stitcher's decision and composition, one window at a time)."""
        x = torch.as_tensor(np.ascontiguousarray(wav_window[None]),
                            device=self.device)
        masks, mag, _ = self.separator.forward(x)
        masks = masks[0].float().cpu().numpy()  # (T, F, S)
        mag = mag[0].float().cpu().numpy()  # (T, F)
        k = self.num_spk
        e = masks[..., :k] * mag[..., None]  # (T, F, K)

        if self._prev_margin is not None:
            # d[i, j] = sum sqrt|prev_j - now_i| over (margin, freq)
            nxt = e[: self.margin_frames]
            d = np.sum(np.sqrt(np.abs(
                self._prev_margin[:, :, None, :] - nxt[:, :, :, None])),
                axis=(0, 1))  # (now_i, prev_j)
            costs = d[np.arange(k)[None, :], self.perm_table].sum(axis=1)
            p = self.perm_table[int(np.argmin(costs))]  # now i -> prev p[i]
            self._assign = np.argsort(p)[self._assign]
        self._prev_margin = e[-self.margin_frames:]

        # route the local masks to the global streams, winner-take-all
        routed = masks[..., :k][..., self._assign]
        if self.reanchor:
            self._reanchor_accumulate(routed, mag)
        m = np.concatenate([routed, masks[..., k:]], axis=-1)  # (T, F, S)
        m_max = m.max(axis=-1, keepdims=True)
        m = np.where(m == m_max, m, np.float32(self.wta_floor))

        t = m.shape[0]
        start = self._n_sep * self.hop_frames - self._frame_base
        end = start + t
        if self._mask_sum is None:
            self._mask_sum = np.zeros((end, *m.shape[1:]), np.float32)
            self._mask_cnt = np.zeros(end, np.float32)
        elif self._mask_sum.shape[0] < end:
            grow = end - self._mask_sum.shape[0]
            self._mask_sum = np.concatenate(
                [self._mask_sum, np.zeros((grow, *m.shape[1:]), np.float32)])
            self._mask_cnt = np.concatenate(
                [self._mask_cnt, np.zeros(grow, np.float32)])
        self._mask_sum[start:end] += m
        self._mask_cnt[start:end] += 1.0
        self._n_sep += 1

    # ----------------------------------------------- online re-anchoring
    def _reanchor_accumulate(self, routed: np.ndarray, mag: np.ndarray):
        """Add one routed window to the per-stream timbre profiles, and at
        a block boundary correct `_assign` (the profile and decision math
        of ``executor/reanchor.py``, causal)."""
        k = self.num_spk
        e = routed * mag[..., None]  # (T, F, K) masked magnitude
        en = np.sum(e.astype(np.float64) ** 2, axis=1)  # (T, K) energy
        # decay by the new frames only (one hop): overlapping windows
        # revisit each frame ~win/hop times
        self._ra_ref = max(self._ra_ref * (0.995 ** self.hop_frames),
                           float(en.max()))
        thr = 1e-2 * self._ra_ref  # -20 dB of the running reference
        if self._ra_sum is None:
            self._ra_sum = np.zeros((k, e.shape[1]), np.float64)
        ls = np.log1p(e)
        for ki in range(k):
            act = en[:, ki] > thr
            if act.any():
                self._ra_sum[ki] += ls[act, :, ki].sum(axis=0)
                self._ra_cnt[ki] += int(act.sum())
        if (self._n_sep + 1) * self.hop_frames < self._ra_next_block:
            return
        self._ra_next_block += self._ra_block_frames
        profs = []
        for ki in range(k):
            if self._ra_cnt[ki] < self._ra_min_active:
                profs.append(None)
                continue
            p = self._ra_sum[ki] / self._ra_cnt[ki]
            p = p - p.mean()
            profs.append(p / (np.linalg.norm(p) + 1e-12))

        def absorb(pr, wt):
            if self._ra_anchors is None:
                self._ra_anchors = [None] * k
            for ki in range(k):
                if pr[ki] is None:
                    continue
                if self._ra_anchors[ki] is None:
                    self._ra_anchors[ki] = pr[ki].copy()
                    self._ra_aw[ki] = wt[ki]
                else:
                    a = (self._ra_anchors[ki] * self._ra_aw[ki]
                         + pr[ki] * wt[ki])
                    a = a - a.mean()
                    self._ra_anchors[ki] = a / (np.linalg.norm(a) + 1e-12)
                    self._ra_aw[ki] += wt[ki]

        weights = self._ra_cnt.copy()
        self._ra_sum[:] = 0.0
        self._ra_cnt[:] = 0.0
        if self._ra_anchors is None:
            absorb(profs, weights)
            return
        scores = []
        for perm in self.perm_table:
            vals = [float(np.dot(self._ra_anchors[ki], profs[perm[ki]]))
                    for ki in range(k)
                    if self._ra_anchors[ki] is not None
                    and profs[perm[ki]] is not None]
            scores.append(np.mean(vals) if vals else None)
        defined = [(sc, tuple(perm)) for sc, perm
                   in zip(scores, self.perm_table) if sc is not None]
        if len(defined) < 2:
            absorb(profs, weights)
            return
        defined.sort(key=lambda x: -x[0])
        best_score, best_perm = defined[0]
        if best_score - defined[1][0] < self._ra_conf:
            return  # ambiguous: keep the routing, do not grow the anchors
        if best_perm != tuple(range(k)):
            # later windows route old slot best_perm[ki] into slot ki
            best_perm = np.asarray(best_perm)
            self._assign = self._assign[best_perm]
            profs = [profs[i] for i in best_perm]
            weights = weights[best_perm]
        absorb(profs, weights)

    # ----------------------------------------------------------- resynthesis
    def _bf_ready(self, final: bool) -> bool:
        """Beamform window i needs the stitched frames [i * mask_hop,
        i * mask_hop + mask_win), final once the last separator window
        covering them is in; a window that is not the last one must also
        know that it is not."""
        if self._mask_sum is None:
            return False
        i = self._n_bf
        need = i * self.beamformer.mask_hop + self.beamformer.mask_win
        have = (self._frame_base + self._mask_sum.shape[0] if final
                else self._n_sep * self.hop_frames)
        return (need <= have
                and (final or i * self.hop + self.win + self.hop
                     <= self._buffered))

    def _emit_bf_window(self, is_last: bool, total: int) -> np.ndarray:
        """Resynthesise beamform window i and return its final slice of
        the proceed-margin partition (K, n) (``Beamformer._assemble``)."""
        bf = self.beamformer
        i = self._n_bf
        st = i * self.hop
        wav_win = self._audio_slice(st, self.win)
        if wav_win.shape[-1] < self.win:  # the flush tail, zero-padded
            wav_win = np.pad(wav_win,
                             [(0, 0), (0, self.win - wav_win.shape[-1])])
        f0 = i * bf.mask_hop - self._frame_base
        stitched = (self._mask_sum[f0: f0 + bf.mask_win]
                    / np.maximum(self._mask_cnt[f0: f0 + bf.mask_win],
                                 1.0)[:, None, None])  # (T, F, S)
        k = self.num_spk
        dev = self.device
        speaker = torch.as_tensor(
            np.ascontiguousarray(np.transpose(stitched[..., :k], (2, 0, 1))
                                 [None]), device=dev)  # (1, K, T, F)
        noise = torch.as_tensor(np.ascontiguousarray(stitched[..., -1][None]),
                                device=dev)  # (1, T, F)
        with torch.no_grad():
            wavs = bf._process(
                torch.as_tensor(np.ascontiguousarray(wav_win[None]),
                                device=dev), speaker, noise)
        wavs = wavs[0].cpu().numpy()  # (K, N)
        if is_last and i == 0:
            seg = wavs[:, :total]
        elif i == 0:
            seg = wavs[:, : bf.margin]
        elif is_last:
            lo = st + bf.margin - bf.hop
            seg = wavs[:, bf.margin - bf.hop:][:, : max(0, total - lo)]
        else:
            seg = wavs[:, bf.margin - bf.hop: bf.margin]
        self._n_bf += 1
        return seg

    # ------------------------------------------------------------------- API
    def push(self, samples: np.ndarray) -> np.ndarray:
        """Feed (n,) or (D, n) samples; returns newly final (K, m) audio."""
        if self._flushed:
            raise RuntimeError("pipeline already flushed")
        samples = np.atleast_2d(np.asarray(samples, np.float32))
        self._buf = (samples.copy() if self._buf is None
                     else np.concatenate([self._buf, samples], axis=-1))
        self._buffered += samples.shape[-1]
        out = []
        while self._n_sep * self.hop + self.win <= self._buffered:
            st = self._n_sep * self.hop
            self._process_sep_window(self._audio_slice(st, self.win))
        while self._bf_ready(final=False):
            out.append(self._emit_bf_window(is_last=False,
                                            total=self._buffered))
        self._prune()
        return (np.concatenate(out, axis=-1) if out
                else np.zeros((self.num_spk, 0), np.float32))

    def flush(self) -> np.ndarray:
        """Process the buffered tail; returns the remaining (K, m) audio."""
        if self._flushed:
            return np.zeros((self.num_spk, 0), np.float32)
        self._flushed = True
        total = self._buffered
        if self._buf is None:
            self._buf = np.zeros((1, 0), np.float32)
        # pad so that the sliding windows cover the whole recording, as
        # CssPipeline.process does
        n_win = max(1, -(-(total - self.win) // self.hop) + 1)
        needed = (n_win - 1) * self.hop + self.win
        if needed > total:
            self._buf = np.pad(self._buf, [(0, 0), (0, needed - total)])
        while self._n_sep < n_win:
            st = self._n_sep * self.hop
            self._process_sep_window(self._audio_slice(st, self.win))
        out = []
        while self._n_bf < n_win:
            out.append(self._emit_bf_window(
                is_last=(self._n_bf == n_win - 1), total=total))
        return (np.concatenate(out, axis=-1) if out
                else np.zeros((self.num_spk, 0), np.float32))
