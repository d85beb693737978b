"""Window-sharded separation: one long recording across several devices.

Port of ``css_tpu/executor/sharded.py``. The JAX package shards the window
axis of one recording over a device mesh inside one jit program; here the
windows are split over a list of devices (the default: every visible
card; a device may repeat, which runs two shards on one card), each shard
runs the features (K3) and the mask model on its own device, in batches of
``batch_size`` windows (``Separator.forward_windows``; all the shard's
windows in one forward without a ``batch_size``), and the masks and
magnitudes are gathered
to ``devices[0]`` and stitched there. The window count is padded to a
multiple of the shard count with zero windows; their magnitudes and masks
are zeroed before the boundary permutations and they add nothing to the
stitched timeline (``Stitcher.get_connect(valid=)``), whose padded frames
are trimmed. One process: no process group is needed.

Like the JAX package's, this path runs no DOA merge (``separation.merge``).
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence, Tuple, Union

import torch

from css_tpu_torch.device import resolve_device
from css_tpu_torch.executor.separator import Separator, require_masks
from css_tpu_torch.executor.stitcher import Stitcher
from css_tpu_torch.executor.windowing import EXTRA_SAMPLES, unfold


def visible_devices() -> list:
    """Every visible card, or the CPU where there is none."""
    n = torch.cuda.device_count()
    return ([torch.device(f"cuda:{i}") for i in range(n)] if n
            else [torch.device("cpu")])


def _indexed(dev: torch.device) -> torch.device:
    """cuda -> cuda:<current>, so that one card is one key."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class ShardedSeparation:
    """Window-sharded forward + stitch for one recording."""

    def __init__(self, model: torch.nn.Module,
                 devices: Optional[Sequence[Union[str, torch.device]]] = None,
                 sr: int = 16000, eval_win: float = 2.4,
                 eval_hop: float = 0.8, frame_len: int = 512,
                 frame_hop: int = 256, ipd_index: Optional[str] = None,
                 wta_floor: float = 1e-4, extra_samples: int = EXTRA_SAMPLES,
                 num_spk: int = 2, batch_size: Optional[int] = None):
        require_masks(model, "sharded separation")
        self.devices = [_indexed(resolve_device(d)) for d in
                        (devices if devices is not None
                         else visible_devices())]
        if not self.devices:
            raise ValueError("ShardedSeparation needs at least one device")
        self.win = int(eval_win * sr) + extra_samples
        self.hop = int(eval_hop * sr)
        self.batch_size = batch_size
        # one model copy per distinct device, one separator per shard
        copies = {}
        for d in self.devices:
            if d not in copies:
                copies[d] = (model if next(model.parameters()).device == d
                             else copy.deepcopy(model)).to(d).eval()
        self.separators = [
            Separator(copies[d], sr=sr, eval_win=eval_win, eval_hop=eval_hop,
                      frame_len=frame_len, frame_hop=frame_hop,
                      ipd_index=ipd_index, num_spk=num_spk, device=d)
            for d in self.devices]
        self.stitcher = Stitcher(eval_win, eval_hop, frame_hop, sr, wta_floor,
                                 num_spk=num_spk, device=self.devices[0])

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    @torch.no_grad()
    def separate(self, wav) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor,
                                     torch.Tensor]:
        """wav (T,) or (C, T) -> ((res1, res2, noise) stitched (T', F)
        masks, per-window masks (B, T, F, S), mags (B, T, F)), all on
        ``devices[0]``."""
        home = self.devices[0]
        wav = torch.as_tensor(wav, dtype=torch.float32, device=home)
        windows = unfold(wav, self.win, self.hop)
        b = windows.shape[0]
        pad = (-b) % self.n_shards
        if pad:
            windows = torch.cat([windows, windows.new_zeros(
                (pad,) + tuple(windows.shape[1:]))])
        per = windows.shape[0] // self.n_shards
        shards = [sep.forward_windows(windows[i * per:(i + 1) * per].to(d),
                                      self.batch_size or per)
                  for i, (sep, d) in enumerate(zip(self.separators,
                                                   self.devices))]
        masks = torch.cat([m.to(home) for m, _, _ in shards])
        mags = torch.cat([g.to(home) for _, g, _ in shards])
        valid = torch.arange(b + pad, device=home) < b
        # padded windows must not steer the boundary permutations
        mags = torch.where(valid[:, None, None], mags, 0.0)
        masks = torch.where(valid[:, None, None, None], masks, 0.0)
        perms = self.stitcher.get_stitch(masks, mags)
        res = self.stitcher.get_connect(perms, masks, valid)
        if pad:
            # the padded windows' frames lie past the real timeline
            total = (b - 1) * self.stitcher.hop_frames + masks.shape[1]
            res = tuple(r[:total] for r in res)
            masks, mags = masks[:b], mags[:b]
        return res, masks, mags
