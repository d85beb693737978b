"""Mask stitcher: resolve speaker permutations across sliding windows.

Port of ``css_tpu/executor/stitcher.py:29-145`` for K speakers:
  * all boundary K x K energy distances at once, over the frames two
    neighbouring windows share (``margin``);
  * the best permutation per boundary is an argmin over the static K!
    permutation table (ties go to the earliest row, the identity);
  * the composition scan (window n's stream order from window n-1's and
    the boundary permutation) runs on the host in numpy: it is a loop over
    a (B-1, K) integer array, so one small device-to-host copy;
  * winner-take-all and the overlap-average over windows run on the
    device.

A time-domain model's per-window waveforms (B, K, N) go through
``waves``: the same distance over the samples two neighbouring windows
share (window b's from ``hop`` on against window b+1's first ``win -
hop``), the same table and host scan, and the windows routed by a
gather, with no winner-take-all and no overlap-average (the beamformer
assembles them on the proceed-margin partition).
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from css_tpu_torch.device import resolve_device
from css_tpu_torch.executor.windowing import EXTRA_SAMPLES
from css_tpu_torch.ops.stft import overlap_add
from css_tpu_torch.utils import trace
from css_tpu_torch.utils.permutations import permutations_array


class Stitcher:
    def __init__(self, eval_win: float = 2.4, eval_hop: float = 0.8,
                 fft_hop: int = 256, sr: int = 16000, wta_floor: float = 1e-4,
                 num_spk: int = 2, device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.margin = int(round((eval_win - eval_hop) * sr / fft_hop))
        self.hop_frames = int(eval_hop * sr / fft_hop)
        self.wta_floor = wta_floor
        self.num_spk = num_spk
        # samples two neighbouring waveform windows share: win - hop
        self.overlap = int(eval_win * sr) + EXTRA_SAMPLES - int(eval_hop * sr)

    def _perm_table(self, device) -> torch.Tensor:
        return torch.as_tensor(permutations_array(self.num_spk),
                               dtype=torch.long, device=device)

    def _margin_costs(self, prev: torch.Tensor, nxt: torch.Tensor
                      ) -> torch.Tensor:
        """prev, nxt (B-1, ..., K): what windows b and b+1 share (masked
        energies (M, F) a stream, or waveform samples (M,)) -> (B-1, K!)
        costs; entry [b, p] scores routing window b+1's local stream i to
        window b's stream p[i]: sum_i d[b, i, p[i]], d[b, i, j] = sum
        sqrt|prev_j - next_i| over the shared axes."""
        k = self.num_spk
        d = torch.sqrt(torch.abs(prev[..., None, :] - nxt[..., :, None])
                       ).sum(dim=tuple(range(1, prev.ndim - 1)))  # (B-1, i, j)
        table = self._perm_table(prev.device)  # (K!, K)
        rows = torch.arange(k, device=prev.device)[None, :]
        return d[:, rows, table].sum(dim=-1)

    def get_stitch(self, masks: torch.Tensor, mags: torch.Tensor
                   ) -> torch.Tensor:
        """(B-1, K) boundary permutations: row b maps window b+1's local
        stream i to window b's local stream perm[b, i]."""
        e = masks[..., : self.num_spk] * mags[..., None]
        costs = self._margin_costs(e[:-1, -self.margin:],
                                   e[1:, : self.margin])  # (B-1, M, F, K)
        return self._perm_table(e.device)[torch.argmin(costs, dim=-1)]

    def wave_perms(self, streams: torch.Tensor) -> torch.Tensor:
        """streams (B, K, N) -> (B-1, K) boundary permutations, as
        ``get_stitch`` gives them, from the ``overlap`` samples windows b
        and b+1 share; ties go to the identity."""
        prev = streams[:-1, :, -self.overlap:].transpose(1, 2)  # (B-1, M, K)
        nxt = streams[1:, :, : self.overlap].transpose(1, 2)
        costs = self._margin_costs(prev, nxt)
        return self._perm_table(streams.device)[torch.argmin(costs, dim=-1)]

    def _compose(self, perms: torch.Tensor, device
                 ) -> Tuple[torch.Tensor, np.ndarray]:
        """(B-1, K) boundary permutations -> (B, K) on ``device``: row n
        the local stream index of each global stream at window n; and the
        permutations as the host read them. A ``stitcher.scan`` span: it
        blocks on the permutations' producer."""
        # m_n[s] = local index of global stream s at window n; the
        # boundary perm p maps now-local i -> prev-local p[i], so
        # m_n = argsort(p_n)[m_{n-1}]
        with trace.span("stitcher.scan"):
            host = perms.cpu().numpy()
            m_cur = np.arange(self.num_spk)
            assign = [m_cur]
            for p in host:
                m_cur = np.argsort(p)[m_cur]
                assign.append(m_cur)
            return torch.as_tensor(np.stack(assign), dtype=torch.long,
                                   device=device), host

    def get_connect(self, perms: torch.Tensor, masks: torch.Tensor,
                    valid: torch.Tensor = None) -> Tuple[torch.Tensor, ...]:
        """Composition scan + WTA + overlap-average -> K+1 stitched
        (T_total, F) masks (speaker streams, then noise). ``valid`` (B,)
        bool marks the real windows: padded ones (sharded separation's)
        add neither mask mass nor coverage count."""
        k = self.num_spk
        b, t, f, _ = masks.shape
        assign = self._compose(perms, masks.device)[0]  # (B, K)
        routed = torch.gather(masks[..., :k], -1,
                              assign[:, None, None, :].expand(b, t, f, k))
        m = torch.cat([routed, masks[..., k:]], dim=-1)
        # winner-take-all across streams per TF bin
        m_max = m.amax(dim=-1, keepdim=True)
        m = torch.where(m == m_max, m, torch.full_like(m, self.wta_floor))
        ones = m.new_ones((b, t))
        if valid is not None:
            v = valid.to(m.dtype)
            m = m * v[:, None, None, None]
            ones = ones * v[:, None]
        summed = overlap_add(m.permute(2, 3, 0, 1), self.hop_frames)  # (F,S,Tt)
        count = overlap_add(ones, self.hop_frames)
        avg = (summed / torch.clamp(count, min=1.0)).permute(2, 0, 1)
        return tuple(avg[..., s] for s in range(avg.shape[-1]))

    @torch.no_grad()
    def __call__(self, masks: torch.Tensor, mags: torch.Tensor
                 ) -> Tuple[torch.Tensor, ...]:
        """masks (B, T, F, K+noise), mags (B, T, F) -> K+1 x (T_total, F):
        a ``stitcher`` span, the host scan a ``stitcher.scan`` inside."""
        with trace.span("stitcher"):
            masks = torch.as_tensor(masks, device=self.device)
            mags = torch.as_tensor(mags, device=self.device)
            return self.get_connect(self.get_stitch(masks, mags), masks)

    @torch.no_grad()
    def waves(self, streams: torch.Tensor) -> torch.Tensor:
        """A time-domain model's per-window streams (B, K, N) -> the same
        windows with their streams routed to the global order (B, K, N). A
        ``stitcher`` span holding ``stitcher.wave`` (the boundary costs,
        the scan and the gather) and, inside, ``stitcher.scan``; counter
        ``stitch_swaps``, the boundaries whose permutation is not the
        identity (from the scan's host copy, under tracing alone)."""
        with trace.span("stitcher"), trace.span("stitcher.wave"):
            streams = torch.as_tensor(streams, device=self.device)
            b, k, n = streams.shape
            assign, host = self._compose(self.wave_perms(streams),
                                         streams.device)
            if trace.enabled():
                trace.count("stitch_swaps", int(
                    (host != np.arange(k)).any(axis=-1).sum()))
            return torch.gather(streams, 1,
                                assign[:, :, None].expand(b, k, n))
