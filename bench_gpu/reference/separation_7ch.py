"""Continuous separation of one 7-channel recording, plainly: IPD
features, the DOA merge, the window stitcher and Souden MVDR.

For a (7, T) recording at 16 kHz from the LibriCSS 7-mic circular array
under the pipeline settings of the configuration (``pipeline``: the
reference repo's ``config_7ch.yaml`` schema), in plain float32 PyTorch.
The conventions kept, each with its source:

1. windows: the 1-channel reference's (``separation.geometry``,
   ``separation.windows``): ``eval_win`` s plus 256 samples at a hop of
   ``eval_hop`` s, the recording zero-padded to be covered;
2. features (desh2608/css ``css/executor/feature.py``, ``STFT`` :33-82,
   ``IPDFeature`` :85-134, ``FeatureExtractor`` :137-175), the windows
   ``batch_size`` at a time as the pipeline batches them: the uncentered
   STFT of every channel as the conv-STFT computes it, frames (periodic
   Hann, 512 at a hop of 256) times one kernel of 257 real and 257
   imaginary columns, w[n] exp(-2 pi i n k / 512) evaluated from its
   definition in float64 and rounded to float32 (``dft_matrix``); the
   phase atan2(imag, real) (:80-82); channel 0's magnitude floored at
   float32's eps and MVN'd over the window's frames; then for each pair
   (l, r) of ``ipd`` ("1,0;...;6,0") the phase difference
   as the unit vector (cos, sin), its mean over the frames subtracted,
   and the angle of what is left (:123-130), pair by pair, 257 bins a
   pair, after the magnitude (:133, :172-174); the model's masks clipped
   at 1 (``separator.py`` :100-104);
3. the DOA merge (``css/executor/separator.py``: ``steervec_7ch``
   :113-163, ``angle_merge`` :165-200, ``doa_likelihood`` :202-250): the
   array is the centre and six mics on a circle of radius 4.25 cm at
   -30, 30, 90, 150, -150 and -90 degrees, in that order; 30 azimuths
   2 pi a / 30; a plane wave from azimuth theta reaches mic m
   (r_m . u_theta) / 340 m/s early, so its steering vector is
   exp(i pi f (r_m . u_theta) sr / (340 (F - 1))) / sqrt(7) in bin f.
   Per window, each speaker mask binarised at 0.5; per frame and bin of
   80-2000 Hz, the mixture's power left after the projection on each
   steering vector, sum_c |X_c|^2 - |sum_c conj(X_c) sv_c|^2, floored at
   0, to the power 0.5 and negated, summed under the binary mask: the
   stream's DOA is the azimuth of the largest sum (the first on a tie).
   Where the two DOAs lie within ``merge_threshold`` degrees (on the
   circle), the stream of the lower masked channel-0 magnitude (the
   binary mask times |X_0| over every frame and bin; the first on a tie)
   is killed: its mask set to 1e-12;
4. stitching: the 1-channel reference's ``separation.stitch``, on
   channel 0's magnitudes;
5. Souden MVDR per window (``css/executor/beamformer.py`` :126-182 with
   asteroid's ``compute_scm`` and ``SoudenMVDRBeamformer``;
   ``css/utils/mvdr_util.py`` :45-61): the centered STFT of every
   channel (``torch.stft(center=True)``, reflect padding); the window's
   stitched masks, on the uncentered frames (frame u centred on sample
   u * hop + n_fft / 2), moved onto the centered ones (frame t centred
   on t * hop): t takes u = t - 1, the edges held; from here to the
   rescale in float64 (below); each SCM the sum over frames of mask *
   x x^H plus 1e-15 I (unnormalised: the normalisation by the mask's sum
   cancels in the ratio below); W = solve(noise SCM, target SCM) / its
   trace, taken at channel 0 (the trace plus 1e-15); y = sum_c conj(W_c)
   X_c; y rescaled to the energy (the RMS over the window's frames and
   bins) of the masked channel 0; back in the spectrum's precision, the
   1-channel reference's dedup (``separation._dedup``);
   ``torch.istft(center=True)`` to the window's length;
6. assembly: window 0's first ``proceed_margin`` seconds, each later
   window's hop ending ``proceed_margin`` s into it, the last window to
   its end, each stream scaled to a peak of 0.9.

Every stage works through the windows ``block`` at a time, so that a
600 s session fits a card beside nothing else.

Where float32 cannot decide: the IPD is an angle, and where a pair's
re-centred (cos, sin) lies on the negative real axis it is +-pi by the
sign of a rounding; a model takes it as it stands, so an entry on the
other side of the cut (2 pi away) moves the masks of its whole window,
and a merge decision that follows can swap the streams for the rest of
the session. At bin N/2 that is the rule: the exact DFT of a real
signal is real there, and the sines of the definition's matrix (sin(-pi
n) in float64) leave a residue of ~1e-13 in its imaginary column whose
sign every frame's phase follows (feature.py's rfft(eye(512)) kernel
has an exact 0 there; the program's STFT, the JAX package's, keeps the
residue, as this reference does). Elsewhere the cut falls where the two
sides' spectra round apart: computed as rfft's, or as two products, the
spectra part by ~1e-7 and a 600 s session's IPD by ~20 entries on the
card; about one session in 30 then swapped its streams from one window
on (``frame_p50`` ~1 against ~2e-5). Computed as the conv-STFT's one
product in the pipeline's batches, from the definition's matrix, the
spectra round as the program's do and the cuts fall alike.

The Souden stage runs in float64, here and in the program: the sessions'
noise (40 dB below the talkers, no diffuse field) leaves the noise SCMs'
condition numbers at 1e6-1e8, where float32 decides a stream no better
than ~1e-2 (a 600 s session on the card: float32 against float64 of the
same masks up to 8e-4 by the median frame, and two float32 runs of the
program 1.2e-2 apart on one session of ~100; float64 on both sides,
4-7e-6). It is the SCMs' precision that decides: float32 SCMs solved in
float64 read as float32 throughout, float64 SCMs applied in float32 as
float64. ``souden`` sets the stage's complex dtype, so that the check's
second control, the stage in complex64 as a float32 program would run
it, can be read (``scripts/torch_7ch_controls.py``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bench_gpu.reference import dsp
from bench_gpu.reference.separation import (PEAK, _dedup, geometry, stitch,
                                            windows)

SOUND_M_S = 340.0
RADIUS_M = 0.0425
MIC_DEGREES = (-30.0, 30.0, 90.0, 150.0, -150.0, -90.0)  # after the centre
AZIMUTHS = 30
BAND_HZ = (80.0, 2000.0)
BINARIZE = 0.5
KILLED = 1e-12
DIAG_LOADING = 1e-15
TRACE_EPS = 1e-15


def ipd_pairs(spec: str) -> List[Tuple[int, int]]:
    """'1,0;2,0' -> [(1, 0), (2, 0)]."""
    return [tuple(int(c) for c in p.split(",")) for p in spec.split(";")]


def dft_matrix(frame_len: int, device) -> torch.Tensor:
    """(frame_len, frame_len // 2 + 1) complex64: w[n] exp(-2 pi i n k /
    frame_len), from the definition in float64 (numpy's cosine and sine,
    correctly rounded to the last bit or nearly)."""
    n = np.arange(frame_len, dtype=np.float64)[:, None]
    k = np.arange(frame_len // 2 + 1, dtype=np.float64)[None, :]
    angle = -2.0 * math.pi * n * k / frame_len
    w = torch.hann_window(frame_len, periodic=True,
                          dtype=torch.float64).numpy()[:, None]
    return torch.complex(torch.as_tensor(np.cos(angle) * w).float(),
                         torch.as_tensor(np.sin(angle) * w).float()
                         ).to(device)


def features(wins: torch.Tensor, pairs, g: Dict
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Windows (B, C, N) -> (the uncentered spectrum (B, C, T, F), channel
    0's magnitude (B, T, F), features (B, T, F * (1 + M)))."""
    frames = wins.unfold(-1, g["frame_len"], g["frame_hop"])
    dft = dft_matrix(g["frame_len"], wins.device)
    bins = dft.shape[-1]
    # the conv-STFT's one kernel: the real rows, then the imaginary ones
    out = frames @ torch.cat([dft.real, dft.imag], dim=-1)
    spec = torch.complex(out[..., :bins], out[..., bins:])
    mag = torch.abs(spec[:, 0])
    feats = [dsp.mvn(torch.clamp(mag, min=dsp.EPSILON), dim=-2)]
    phase = torch.atan2(spec.imag, spec.real)
    for left, right in pairs:
        dif = phase[:, left] - phase[:, right]
        c, s = torch.cos(dif), torch.sin(dif)
        feats.append(torch.atan2(s - s.mean(dim=-2, keepdim=True),
                                 c - c.mean(dim=-2, keepdim=True)))
    return spec, mag, torch.cat(feats, dim=-1)


def steering(bins: int, sr: int, device) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """(steering vectors (bins, A, 7) complex64, azimuths (A,) degrees)."""
    theta = 2.0 * math.pi * torch.arange(AZIMUTHS, dtype=torch.float64,
                                         device=device) / AZIMUTHS
    phi = torch.deg2rad(torch.tensor(MIC_DEGREES, dtype=torch.float64,
                                     device=device))
    # r_m . u_theta, metres; the centre mic at the origin
    ahead = RADIUS_M * torch.cos(theta[:, None] - phi[None, :])
    ahead = torch.cat([torch.zeros_like(ahead[:, :1]), ahead], dim=1)
    f = torch.arange(bins, dtype=torch.float64, device=device)
    phase = (math.pi * f[:, None, None] / (bins - 1)
             * (ahead * sr / SOUND_M_S)[None])
    sv = torch.polar(torch.ones_like(phase), phase) / math.sqrt(7.0)
    return sv.to(torch.complex64), torch.rad2deg(theta).float()


def merge(spec: torch.Tensor, masks: torch.Tensor, pipe: Dict,
          sr: int = 16000) -> Tuple[torch.Tensor, torch.Tensor]:
    """spec (B, C, T, F) uncentered; masks (B, T, F, S) -> (kill (B, 2)
    bool, doa (B, 2) degrees) over the two speaker streams."""
    bins = spec.shape[-1]
    step = (sr // 2) / (bins - 1)
    lo = int(math.floor(BAND_HZ[0] / step))
    hi = int(math.ceil(BAND_HZ[1] / step))
    sv, az = steering(bins, sr, spec.device)
    x = spec[..., lo:hi].permute(0, 2, 3, 1)  # (B, T, F', C)
    power = torch.square(torch.abs(x)).sum(dim=-1)  # (B, T, F')
    proj = torch.square(torch.abs(torch.einsum(
        "btfc,fac->btfa", x.conj(), sv[lo:hi])))  # (B, T, F', A)
    lik_tf = -torch.sqrt(torch.clamp(power[..., None] - proj, min=0.0))
    binary = (masks[..., :2] > BINARIZE).float()  # (B, T, F, 2)
    lik = torch.einsum("btfs,btfa->bsa", binary[:, :, lo:hi], lik_tf)
    doa = az[torch.argmax(lik, dim=-1)]  # (B, 2)
    gap = torch.remainder(doa[:, 0] - doa[:, 1], 360.0)
    same = torch.minimum(gap, 360.0 - gap) <= float(
        pipe["separation"]["merge_threshold"])
    energy = (binary * torch.abs(spec[:, 0])[..., None]).sum(dim=(1, 2))
    weaker = torch.argmin(energy, dim=-1)  # (B,)
    kill = same[:, None] & (torch.arange(2, device=spec.device)[None]
                            == weaker[:, None])
    return kill, doa


def _centered(masks: torch.Tensor, frames: int) -> torch.Tensor:
    """(..., Tw, F) on the uncentered frames -> (..., frames, F) on the
    centered ones: centered frame t takes uncentered frame t - 1, the
    edges held."""
    u = torch.clamp(torch.arange(frames, device=masks.device) - 1, 0,
                    masks.shape[-2] - 1)
    return masks[..., u, :]


def _scm(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """x (B, C, T, F), mask (B, T, F) -> (B, F, C, C)."""
    scm = torch.einsum("btf,bctf,bdtf->bfcd", mask.to(x.dtype), x, x.conj())
    return scm + DIAG_LOADING * torch.eye(x.shape[1], dtype=x.dtype,
                                          device=x.device)


def mvdr(wins: torch.Tensor, speech: torch.Tensor, noise: torch.Tensor,
         g: Dict, souden: torch.dtype = torch.complex128) -> torch.Tensor:
    """Windows (B, C, N); the stitched speaker masks of each window (B, K,
    Tw, F) and its noise mask (B, Tw, F), uncentered frames -> beamformed,
    deduplicated window streams (B, K, N), in the windows' precision (the
    Souden stage in ``souden``, complex128 by default)."""
    b, c, n = wins.shape
    k = speech.shape[1]
    n_fft = g["frame_len"]
    window = dsp.hann(n_fft, wins.device).to(wins.dtype)
    spec = torch.stft(wins.reshape(b * c, n), n_fft, g["frame_hop"],
                      window=window, center=True, pad_mode="reflect",
                      return_complex=True)
    spec = spec.reshape(b, c, *spec.shape[-2:]).transpose(-1, -2)
    t = spec.shape[2]  # (B, C, T, F)
    x = spec.to(souden)
    speech = _centered(speech, t).to(x.real.dtype)
    noise_scm = _scm(x, _centered(noise, t).to(x.real.dtype))
    outs = []
    for s in range(k):
        # no check for a singular system: it would wait for the device,
        # and the program's solve gives what LU gives there too
        num, _ = torch.linalg.solve_ex(noise_scm, _scm(x, speech[:, s]),
                                       check_errors=False)
        tr = torch.diagonal(num, dim1=-2, dim2=-1).sum(-1)
        w = num[..., 0] / (tr[..., None] + TRACE_EPS)  # (B, F, C)
        y = torch.einsum("bfc,bctf->btf", w.conj(), x)
        ref = speech[:, s] * x[:, 0]
        ref_e = torch.sqrt(torch.square(torch.abs(ref)).mean(dim=(1, 2)))
        y_e = torch.sqrt(torch.square(torch.abs(y)).mean(dim=(1, 2)))
        outs.append(y / torch.clamp(y_e, min=1e-12)[:, None, None]
                    * ref_e[:, None, None])
    out = _dedup(torch.stack(outs, dim=1).to(spec.dtype))  # (B, K, T, F)
    wav = torch.istft(out.transpose(-1, -2).reshape(b * k, -1, t), n_fft,
                      g["frame_hop"], window=window, center=True, length=n)
    return wav.reshape(b, k, n)


def assemble(wavs: torch.Tensor, total: int, g: Dict) -> torch.Tensor:
    """Window streams (B, N) -> (total,) on the proceed-margin partition,
    peak 0.9."""
    if wavs.shape[0] == 1:
        res = wavs[0, :total]
    else:
        lo = g["proceed"] - g["hop"]
        res = torch.cat([wavs[0, :g["proceed"]],
                         wavs[1:-1, lo:g["proceed"]].reshape(-1),
                         wavs[-1, lo:]])[:total]
    res = F.pad(res, (0, total - res.shape[0]))
    return res * PEAK / torch.clamp(res.abs().max(), min=1e-12)


@torch.no_grad()
def masks_of(wav: torch.Tensor, mask_fn: Callable, pipe: Dict,
             block: int = None) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """wav (C, T) -> (the windows' masks (B, T', F, S) after the merge,
    channel 0's magnitudes (B, T', F), the merge's kills (B, 2) bool);
    the windows ``block`` at a time, by default the pipeline's
    ``batch_size``."""
    g = geometry(pipe)
    sep = pipe["separation"]
    block = block or int(sep["batch_size"])
    pairs = ipd_pairs(sep["ipd"])
    wins = windows(wav, g["win"], g["hop"]).transpose(0, 1)  # (B, C, N)
    masks, mags, kills = [], [], []
    for lo in range(0, wins.shape[0], block):
        spec, mag, feats = features(wins[lo:lo + block], pairs, g)
        m = torch.clamp(mask_fn(feats), max=1.0)
        kill = torch.zeros(m.shape[0], 2, dtype=torch.bool, device=m.device)
        if sep.get("merge"):
            kill, _ = merge(spec, m, pipe)
            m = torch.cat([torch.where(kill[:, None, None], KILLED,
                                       m[..., :2]), m[..., 2:]], dim=-1)
        masks.append(m)
        mags.append(mag)
        kills.append(kill)
    return torch.cat(masks), torch.cat(mags), torch.cat(kills)


@torch.no_grad()
def separate(wav: torch.Tensor, mask_fn: Callable, pipe: Dict, k: int,
             block: int = None, souden: torch.dtype = torch.complex128
             ) -> Tuple[torch.Tensor, ...]:
    """wav (7, T) float32 -> K streams (T,). ``mask_fn(features (B, T,
    F'))`` gives the model's masks; windows go through every stage
    ``block`` at a time, by default the pipeline's ``batch_size``; the
    Souden stage in ``souden``."""
    g = geometry(pipe)
    total = wav.shape[-1]
    block = block or int(pipe["separation"]["batch_size"])
    masks, mags, _ = masks_of(wav, mask_fn, pipe, block)
    stitched = stitch(masks, mags, g, k)  # (Tt, F, S)
    wins = windows(wav, g["win"], g["hop"]).transpose(0, 1)  # (B, C, N)
    mw = stitched.permute(2, 0, 1).unfold(1, g["mask_win"],
                                          g["hop_frames"])  # (S, B, F, Tw)
    b = min(wins.shape[0], mw.shape[1])
    mw = mw[:, :b].permute(1, 0, 3, 2)  # (B, S, Tw, F)
    wavs = torch.cat([mvdr(wins[lo:lo + block], mw[lo:lo + block, :k],
                           mw[lo:lo + block, k], g, souden)
                      for lo in range(0, b, block)])  # (B, K, N)
    padded = (wins.shape[0] - 1) * g["hop"] + g["win"]
    return tuple(assemble(wavs[:, s], padded, g)[:total] for s in range(k))
