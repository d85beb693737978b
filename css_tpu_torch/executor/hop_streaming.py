"""Hop-granular (frame-level) streaming separation with a causal model.

Port of ``css_tpu/executor/hop_streaming.py``. A causal model (the
BLSTM with ``blstm_causal``: one direction and running MVN; or the
Conformer with ``conformer_causal``: banded attention, left-padded conv
and running MVN) carries its state across the whole recording, so stream
identity stays continuous: no per-window permutation, no stitcher, and a
frame's masks are final as soon as the frame is computed. Per chunk of
``chunk_frames`` frames, on ``device``:

  frames -> rDFT (one matrix product) -> |.| -> ``model.stream`` (carried
  state) -> winner-take-all -> masked spectrum -> inverse rDFT (one
  matrix product) times the synthesis window

and on the host the overlap-add with the carried OLA and envelope tails,
the envelope division, and emission of the final samples. The analysis
and synthesis are ``ops/stft.py``'s matrices, as ``css_tpu`` computes
them outside any Pallas kernel. On the causal BLSTM each chunk launches
K2 once per layer with the carried (h, c).

On the card the device part of a chunk is one captured CUDA graph a
chunk size (``utils/programs.py``), as ``css_tpu``'s ``_step_fn`` is one
program a chunk size: the model's carry lives in static buffers that
every replay updates in place. On the CPU the same function runs
directly.

Latency: one analysis frame plus its overlap, ``frame_len + (frame_len -
hop)`` samples (48 ms at 512/256 and 16 kHz), plus the chunk (8 frames:
128 ms). Chained chunks give the full-utterance causal forward, so the
push size changes nothing in the output.
"""

from __future__ import annotations

import math
from typing import Union

import numpy as np
import torch
from torch.utils import _pytree as pytree

from css_tpu_torch.device import resolve_device
from css_tpu_torch.executor.separator import require_masks
from css_tpu_torch.ops import stft as stft_ops
from css_tpu_torch.utils.programs import Program


class HopStreamingPipeline:
    """push(samples) -> (K, m) newly final audio; flush() -> the tail.

    ``model`` must be causal (``model.causal``) and have ``stream(f,
    carry)`` / ``stream_init(batch)``. The YAML config schema of the
    offline pipeline: the separation section's frame_length and
    frame_shift, and the beamforming section's wta_thresh. ``model`` is
    moved to ``device`` and put in eval mode.
    """

    def __init__(self, model: torch.nn.Module, config: dict, sr: int = 16000,
                 chunk_frames: int = 8,
                 device: Union[str, torch.device] = "cuda"):
        require_masks(model, "hop streaming")
        if not getattr(model, "causal", False):
            raise ValueError(
                "hop streaming needs a causal model (e.g. BLSTM built with "
                "--blstm-causal); window-granular streaming "
                "(StreamingCssPipeline) works with any model")
        sep = config.get("separation", {})
        bf = config.get("beamforming", {})
        self.device = resolve_device(device)
        self.sr = int(config.get("sampling_rate", sr))
        self.model = model.to(self.device).eval()
        self.frame_len = int(sep.get("frame_length", 512))
        self.hop = int(sep.get("frame_shift", 256))
        self.num_spk = int(getattr(model, "num_spk", 2))
        self.wta_floor = float(bf.get("wta_thresh", 1e-4))
        self.chunk_frames = max(int(chunk_frames), 1)
        n_fft = 2 ** math.ceil(math.log2(self.frame_len))
        dev = self.device
        self._analysis = torch.as_tensor(
            stft_ops.stft_analysis_kernel(self.frame_len), device=dev)
        self._synthesis = torch.as_tensor(
            stft_ops._istft_synthesis_kernel(self.frame_len, n_fft),
            device=dev)
        self._window = torch.as_tensor(stft_ops.hann_window(self.frame_len),
                                       device=dev)
        self._env_frame = stft_ops.hann_window(self.frame_len) ** 2

        # the model's carry, updated in place by every step: every leaf a
        # buffer of its own (stream_init may hand one zero tensor to two)
        self._carry = pytree.tree_map(torch.clone, self.model.stream_init(1))
        self.program = Program(self._step_impl, "hop_step")
        ov = self.frame_len - self.hop
        self._raw = np.zeros(0, np.float32)  # samples not yet consumed
        self._total = 0  # samples pushed in all
        self._ola = np.zeros((self.num_spk, ov), np.float32)  # carried tails
        self._env = np.zeros(ov, np.float32)
        self._emitted = 0
        self._flushed = False

    # ---------------------------------------------------------------- device
    @torch.no_grad()
    def _step(self, frames: torch.Tensor) -> torch.Tensor:
        """(n, frame_len) raw frames -> masked synthesis frames (K, n,
        frame_len) on the device, advancing the model's carry: one program
        replay on the card."""
        dtype = getattr(self.model, "compute_dtype", None)
        return self.program(frames, mode=(dtype,))

    def _step_impl(self, frames: torch.Tensor) -> torch.Tensor:
        spec = frames @ self._analysis  # (n, 2 * bins) [re | im]
        bins = spec.shape[-1] // 2
        re, im = spec[:, :bins], spec[:, bins:]
        mag = torch.sqrt(re ** 2 + im ** 2)
        masks, carry = self.model.stream(mag[None], self._carry)
        for dst, src in zip(pytree.tree_leaves(self._carry),
                            pytree.tree_leaves(carry)):
            if src is not dst:
                dst.copy_(src)
        m = masks[0]  # (n, F, S), S = num_spk + num_noise
        # winner-take-all across the streams, per frame (final at once)
        m = torch.where(m == m.amax(dim=-1, keepdim=True), m,
                        torch.full_like(m, self.wta_floor))
        spk = m[..., : self.num_spk].permute(2, 0, 1)  # (K, n, F)
        ri = torch.cat([spk * re, spk * im], dim=-1)  # (K, n, 2 * bins)
        return (ri @ self._synthesis) * self._window

    # ------------------------------------------------------------------ host
    def _run_frames(self, frames: np.ndarray) -> np.ndarray:
        """(n, frame_len) frames -> the newly final samples (K, n * hop),
        overlap-added with the carried tails and divided by the
        envelope."""
        n = frames.shape[0]
        out = self._step(torch.as_tensor(frames, device=self.device))
        out = out.float().cpu().numpy()  # (K, n, frame_len)
        ov = self.frame_len - self.hop
        total = n * self.hop + ov
        sig = np.zeros((self.num_spk, total), np.float32)
        env = np.zeros(total, np.float32)
        sig[:, :ov] += self._ola
        env[:ov] += self._env
        for i in range(n):
            st = i * self.hop
            sig[:, st: st + self.frame_len] += out[:, i]
            env[st: st + self.frame_len] += self._env_frame
        self._ola = sig[:, n * self.hop:].copy()
        self._env = env[n * self.hop:].copy()
        final_sig = sig[:, : n * self.hop]
        final_env = env[: n * self.hop]
        # the partial-coverage guard of ops.stft.istft
        final = np.where(final_env >= 1e-2,
                         final_sig / np.maximum(final_env, 1e-2), 0.0)
        return final.astype(np.float32)

    # ------------------------------------------------------------------- API
    def push(self, samples: np.ndarray) -> np.ndarray:
        """Feed (n,) mono samples; returns newly final (K, m) audio."""
        if self._flushed:
            raise RuntimeError("pipeline already flushed")
        samples = np.asarray(samples, np.float32).reshape(-1)
        self._raw = np.concatenate([self._raw, samples])
        self._total += samples.shape[-1]
        outs = []
        n = self.chunk_frames
        # a frame consumes `hop` samples and needs `frame_len` of them
        while self._raw.shape[0] >= (n - 1) * self.hop + self.frame_len:
            idx = (np.arange(n)[:, None] * self.hop
                   + np.arange(self.frame_len)[None, :])
            outs.append(self._run_frames(self._raw[idx]))
            self._raw = self._raw[n * self.hop:]
        if outs:
            out = np.concatenate(outs, axis=-1)
            self._emitted += out.shape[-1]
            return out
        return np.zeros((self.num_spk, 0), np.float32)

    def flush(self) -> np.ndarray:
        """Process the remaining whole frames one at a time, then emit the
        overlap tail, zero-padded so that the output is as long as the
        input (the ragged tail after the last frame is never analysed, as
        in the offline uncentered STFT)."""
        if self._flushed:
            return np.zeros((self.num_spk, 0), np.float32)
        self._flushed = True
        outs = []
        while self._raw.shape[0] >= self.frame_len:
            outs.append(self._run_frames(self._raw[None, : self.frame_len]))
            self._raw = self._raw[self.hop:]
        tail = np.where(self._env >= 1e-2,
                        self._ola / np.maximum(self._env, 1e-2), 0.0)
        outs.append(tail.astype(np.float32))
        out = np.concatenate(outs, axis=-1)
        remaining = self._total - self._emitted
        if out.shape[-1] < remaining:
            out = np.pad(out, [(0, 0), (0, remaining - out.shape[-1])])
        else:
            out = out[:, :remaining]
        self._emitted = self._total
        return out
