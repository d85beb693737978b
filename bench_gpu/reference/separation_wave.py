"""Continuous separation of one recording by a time-domain model,
plainly: sliding windows, the model's waveforms a window, the boundary
permutations from the samples neighbouring windows share, and the
proceed-margin assembly.

For a 1-channel recording at 16 kHz under the pipeline settings of the
configuration (``pipeline``: the reference repo's ``config_1ch.yaml``
schema):

1. the recording is zero-padded so that windows of ``eval_win`` s plus 256
   samples at a hop of ``eval_hop`` s cover it (``separation.windows``);
2. each window goes through the model as it is, giving K waveforms of the
   window's length (zero-padded where the decoder's frames end short of
   it);
3. stitching: windows b and b+1 share ``win - hop`` samples, window b's
   from ``hop`` on and window b+1's first; d[b, i, j] = sum over them of
   sqrt|prev_j - next_i|; the boundary permutation p minimises sum_i
   d[b, i, p(i)] (ties to the identity, the table's first row); window
   n's stream order is composed from window 0's, and each window's
   streams are put in that order;
4. the ordered windows are assembled as ``separation.resynthesise`` does:
   window 0's first ``proceed_margin`` seconds, then each later window's
   hop ending ``proceed_margin`` s into it, the last window to its end,
   and each stream scaled to a peak of 0.9.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from bench_gpu.reference.separation import (EXTRA_SAMPLES, PEAK,
                                            _permutations, windows)


def geometry(pipe: Dict, sr: int = 16000) -> Dict[str, int]:
    sep, bf = pipe["separation"], pipe["beamforming"]
    return {"win": int(sep["eval_win"] * sr) + EXTRA_SAMPLES,
            "hop": int(sep["eval_hop"] * sr),
            "proceed": int(bf["proceed_margin"] * sr)}


def boundary_perms(wins: torch.Tensor, hop: int, k: int) -> torch.Tensor:
    """wins (B, K, N) -> (B-1, K): row b maps window b+1's stream i to
    window b's stream row[i]."""
    prev = wins[:-1, :, hop:]  # (B-1, K, M)
    nxt = wins[1:, :, : wins.shape[-1] - hop]
    d = torch.sqrt(torch.abs(prev[:, None, :, :] - nxt[:, :, None, :])
                   ).sum(-1)  # (B-1, i of next, j of prev)
    table = _permutations(k, wins.device)
    rows = torch.arange(k, device=wins.device)
    return table[torch.argmin(d[:, rows, table].sum(-1), dim=-1)]


def order(perms: torch.Tensor, k: int) -> torch.Tensor:
    """(B-1, K) boundary permutations -> (B, K): row n the window's local
    stream of each global stream."""
    rows = [torch.arange(k)]
    for p in perms.cpu():
        rows.append(torch.argsort(p)[rows[-1]])
    return torch.stack(rows).to(perms.device)


def assemble(wins: torch.Tensor, total: int, g: Dict) -> torch.Tensor:
    """Ordered windows of one stream (B, N) -> (total,), before the
    peak."""
    lo = g["proceed"] - g["hop"]
    if wins.shape[0] == 1:
        res = wins[0, :total]
    else:
        res = torch.cat([wins[0, :g["proceed"]],
                         wins[1:-1, lo:g["proceed"]].reshape(-1),
                         wins[-1, lo:]])[:total]
    return F.pad(res, (0, total - res.shape[0]))


def model_windows(wav: torch.Tensor, wave_fn: Callable, g: Dict,
                  block: int = 32) -> torch.Tensor:
    """wav (T,) -> the model's streams of every window (B, K, N), the
    windows going through ``wave_fn(windows (B, N))`` ``block`` at a
    time."""
    wins = windows(wav, g["win"], g["hop"])  # (B, N)
    n = wins.shape[-1]
    outs = []
    for lo in range(0, wins.shape[0], block):
        s = wave_fn(wins[lo:lo + block])
        outs.append(F.pad(s, (0, n - s.shape[-1])))
    return torch.cat(outs)


def stitched(outs: torch.Tensor, total: int, g: Dict, k: int
             ) -> Tuple[torch.Tensor, ...]:
    """The windows' streams (B, K, N) of a recording of ``total`` samples
    -> K streams (total,): ordered, assembled and peak-normalised."""
    idx = order(boundary_perms(outs, g["hop"], k), k)
    routed = torch.gather(outs, 1, idx[:, :, None].expand_as(outs))
    padded = (outs.shape[0] - 1) * g["hop"] + g["win"]
    streams = []
    for s in range(k):
        res = assemble(routed[:, s], padded, g)
        streams.append((res * PEAK / torch.clamp(res.abs().max(),
                                                 min=1e-12))[:total])
    return tuple(streams)


@torch.no_grad()
def separate(wav: torch.Tensor, wave_fn: Callable, pipe: Dict, k: int,
             block: int = 32) -> Tuple[torch.Tensor, ...]:
    """wav (T,) float32 -> K streams (T,). ``wave_fn(windows (B, N))``
    gives the model's (B, K, N') streams."""
    g = geometry(pipe)
    return stitched(model_windows(wav, wave_fn, g, block), wav.shape[-1],
                    g, k)
