"""Continuous separation of one recording, plainly: sliding windows,
magnitude features, masks, the window stitcher and masking resynthesis.

For a 1-channel recording at 16 kHz under the pipeline settings of the
configuration (``pipeline``: the reference repo's ``config_1ch.yaml``
schema):

1. the recording is zero-padded so that windows of ``eval_win`` s plus 256
   samples at a hop of ``eval_hop`` s cover it;
2. each window's features are MVN(max(|STFT|, eps)) over its frames; the
   model's masks are clipped at 1;
3. stitching: between neighbouring windows, over the frames they share,
   d[i, j] = sum sqrt|E_prev[j] - E_next[i]| of the mask-weighted
   magnitudes E; the boundary permutation minimises sum_i d[i, p(i)]
   (ties to the identity); window n's stream order is composed from
   window 0's; in every bin the largest of the routed masks (speakers
   and noise) is kept and the others set to ``wta_thresh``; masks are
   averaged over the windows that cover a frame;
4. masking resynthesis: per window, the mixture's STFT times each
   speaker's stitched mask, streams more than 15 dB below the loudest in
   a window ducked bin by bin (gain |S_k| / max_j |S_j|, floored at
   -40 dB), the iSTFT of every window, window 0's first ``proceed_margin``
   seconds, then each later window's hop ending ``proceed_margin`` s
   into it, the last window to its end, and each stream scaled to a peak
   of 0.9.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from bench_gpu.reference import dsp

EXTRA_SAMPLES = 256
DEDUP_DB = 15.0
DEDUP_FLOOR = 10.0 ** (-40.0 / 20.0)
PEAK = 0.9


def geometry(pipe: Dict, sr: int = 16000) -> Dict[str, int]:
    sep, bf = pipe["separation"], pipe["beamforming"]
    return {"win": int(sep["eval_win"] * sr) + EXTRA_SAMPLES,
            "hop": int(sep["eval_hop"] * sr),
            "frame_len": int(sep["frame_length"]),
            "frame_hop": int(sep["frame_shift"]),
            "margin_frames": int(round((sep["eval_win"] - sep["eval_hop"])
                                       * sr / sep["frame_shift"])),
            "hop_frames": int(sep["eval_hop"] * sr / sep["frame_shift"]),
            "mask_win": int(bf["eval_win"] * sr / bf["hop_size"]),
            "proceed": int(bf["proceed_margin"] * sr),
            "wta": float(bf["wta_thresh"])}


def windows(wav: torch.Tensor, win: int, hop: int) -> torch.Tensor:
    """(T,) -> (B, win), after zero-padding so the windows cover T."""
    total = wav.shape[-1]
    n = max(1, -(-(total - win) // hop) + 1)
    wav = F.pad(wav, (0, max((n - 1) * hop + win - total, 0)))
    return wav.unfold(-1, win, hop)


def _permutations(k: int, device) -> torch.Tensor:
    return torch.tensor(list(itertools.permutations(range(k))),
                        device=device)


def stitch(masks: torch.Tensor, mags: torch.Tensor, g: Dict, k: int
           ) -> torch.Tensor:
    """masks (B, T, F, S) clipped, mags (B, T, F) -> stitched (Tt, F, S)."""
    b, t, f, s = masks.shape
    m = g["margin_frames"]
    e = masks[..., :k] * mags[..., None]
    prev, nxt = e[:-1, -m:], e[1:, :m]
    d = torch.sqrt(torch.abs(prev[..., None, :] - nxt[..., :, None])).sum(
        dim=(1, 2))  # (B-1, i of next, j of prev)
    table = _permutations(k, masks.device)
    rows = torch.arange(k, device=masks.device)
    costs = d[:, rows, table].sum(dim=-1)  # (B-1, K!)
    perms = table[torch.argmin(costs, dim=-1)].cpu()
    order = [torch.arange(k)]
    for p in perms:
        order.append(torch.argsort(p)[order[-1]])
    order = torch.stack(order).to(masks.device)  # (B, K)
    routed = torch.gather(masks[..., :k], -1,
                          order[:, None, None, :].expand(b, t, f, k))
    routed = torch.cat([routed, masks[..., k:]], dim=-1)
    top = routed.amax(dim=-1, keepdim=True)
    routed = torch.where(routed == top, routed,
                         torch.full_like(routed, g["wta"]))
    hop = g["hop_frames"]
    summed = dsp.overlap_add(routed.permute(2, 3, 0, 1), hop)  # (F, S, Tt)
    count = dsp.overlap_add(routed.new_ones((b, t)), hop)
    return (summed / torch.clamp(count, min=1.0)).permute(2, 0, 1)


def _dedup(s: torch.Tensor) -> torch.Tensor:
    """s (B, K, T, F) complex: duck streams DEDUP_DB below the loudest."""
    mag = torch.abs(s)
    power_db = 10.0 * torch.log10(torch.sum(mag ** 2, dim=(2, 3)) + 1e-30)
    gain = mag / torch.clamp(mag.amax(dim=1, keepdim=True), min=1e-30)
    duck = (power_db.amax(dim=1, keepdim=True) - power_db
            > DEDUP_DB)[:, :, None, None]
    return torch.where(duck, torch.clamp(gain, min=DEDUP_FLOOR) * s, s)


def resynthesise(wav_padded: torch.Tensor, stitched: torch.Tensor, g: Dict,
                 k: int) -> Tuple[torch.Tensor, ...]:
    """The padded recording (Tp,) and stitched masks (Tt, F, S) -> K
    streams (Tp,)."""
    wins = windows(wav_padded, g["win"], g["hop"])  # (B, N)
    n = wins.shape[-1]
    mw = stitched.permute(1, 2, 0).unfold(-1, g["mask_win"],
                                          g["hop_frames"])  # (F, S, B, Tw)
    b = min(wins.shape[0], mw.shape[2])
    spec = dsp.stft(wins[:b], g["frame_len"], g["frame_hop"])  # (B, T, F)
    t = min(spec.shape[1], mw.shape[-1])
    speakers = mw[:, :k, :b, :t].permute(2, 1, 3, 0)  # (B, K, T, F)
    out = _dedup(speakers * spec[:, None, :t])
    wavs = dsp.istft(out, g["frame_len"], g["frame_hop"])
    wavs = F.pad(wavs, (0, max(n - wavs.shape[-1], 0)))[..., :n]
    total = wav_padded.shape[-1]
    lo = g["proceed"] - g["hop"]
    streams = []
    for s in range(k):
        w = wavs[:, s]
        if b == 1:
            res = w[0, :total]
        else:
            res = torch.cat([w[0, :g["proceed"]],
                             w[1:-1, lo:g["proceed"]].reshape(-1),
                             w[-1, lo:]])[:total]
        res = F.pad(res, (0, total - res.shape[0]))
        streams.append(res * PEAK / torch.clamp(res.abs().max(), min=1e-12))
    return tuple(streams)


@torch.no_grad()
def separate(wav: torch.Tensor, mask_fn: Callable, pipe: Dict, k: int,
             block: int = 64) -> Tuple[torch.Tensor, ...]:
    """wav (T,) float32 -> K streams (T,). ``mask_fn(features (B, T, F))``
    gives the model's masks; windows go through it ``block`` at a time."""
    g = geometry(pipe)
    total = wav.shape[-1]
    wins = windows(wav, g["win"], g["hop"])
    padded_len = (wins.shape[0] - 1) * g["hop"] + g["win"]
    padded = F.pad(wav, (0, padded_len - total))
    masks, mags = [], []
    for lo in range(0, wins.shape[0], block):
        mag = dsp.stft_mag(wins[lo:lo + block], g["frame_len"],
                           g["frame_hop"])
        feats = dsp.mvn(torch.clamp(mag, min=dsp.EPSILON), dim=-2)
        masks.append(torch.clamp(mask_fn(feats), max=1.0))
        mags.append(mag)
    stitched = stitch(torch.cat(masks), torch.cat(mags), g, k)
    return tuple(s[:total] for s in resynthesise(padded, stitched, g, k))
