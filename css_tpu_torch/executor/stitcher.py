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
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from css_tpu_torch.device import resolve_device
from css_tpu_torch.ops.stft import overlap_add
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

    def _perm_table(self, device) -> torch.Tensor:
        return torch.as_tensor(permutations_array(self.num_spk),
                               dtype=torch.long, device=device)

    def _margin_costs(self, e: torch.Tensor) -> torch.Tensor:
        """e (B, T, F, K) masked energies -> (B-1, K!) costs; entry [b, p]
        scores routing window b+1's local stream i to window b's stream
        p[i]: sum_i d[b, i, p[i]], d[b, i, j] = sum sqrt|prev_j - next_i|
        over the shared frames and all bins."""
        k = self.num_spk
        prev = e[:-1, -self.margin:]  # (B-1, M, F, K)
        nxt = e[1:, : self.margin]
        d = torch.sqrt(torch.abs(prev[..., None, :] - nxt[..., :, None])
                       ).sum(dim=(1, 2))  # (B-1, now_i, prev_j)
        table = self._perm_table(e.device)  # (K!, K)
        rows = torch.arange(k, device=e.device)[None, :]
        return d[:, rows, table].sum(dim=-1)

    def get_stitch(self, masks: torch.Tensor, mags: torch.Tensor
                   ) -> torch.Tensor:
        """(B-1, K) boundary permutations: row b maps window b+1's local
        stream i to window b's local stream perm[b, i]."""
        e = masks[..., : self.num_spk] * mags[..., None]
        costs = self._margin_costs(e)
        return self._perm_table(e.device)[torch.argmin(costs, dim=-1)]

    def get_connect(self, perms: torch.Tensor, masks: torch.Tensor,
                    valid: torch.Tensor = None) -> Tuple[torch.Tensor, ...]:
        """Composition scan + WTA + overlap-average -> K+1 stitched
        (T_total, F) masks (speaker streams, then noise). ``valid`` (B,)
        bool marks the real windows: padded ones (sharded separation's)
        add neither mask mass nor coverage count."""
        k = self.num_spk
        b, t, f, _ = masks.shape
        # m_n[s] = local mask index of global stream s at window n; the
        # boundary perm p maps now-local i -> prev-local p[i], so
        # m_n = argsort(p_n)[m_{n-1}]
        m_cur = np.arange(k)
        assign = [m_cur]
        for p in perms.cpu().numpy():
            m_cur = np.argsort(p)[m_cur]
            assign.append(m_cur)
        assign = torch.as_tensor(np.stack(assign), dtype=torch.long,
                                 device=masks.device)  # (B, K)
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
        """masks (B, T, F, K+noise), mags (B, T, F) -> K+1 x (T_total, F)."""
        masks = torch.as_tensor(masks, device=self.device)
        mags = torch.as_tensor(mags, device=self.device)
        return self.get_connect(self.get_stitch(masks, mags), masks)
