"""On-device mixing: training batches synthesised on the card from
recipes (port of ``css_tpu/data/device_mixer.py``).

The utterance, RIR and noise pools go to the card once; the host draws
only the mixing decisions (``MixtureSynthesizer.sample_recipe``: utterance
ids, window offsets, augmentation draws, about 100 bytes a window instead
of the window's samples), ``DeviceMixer.encode`` packs them into two
small arrays, and ``DeviceMixer.materialize`` rebuilds the batch on the
card in the train step: window slices of the flat utterance pool, RIR
reverb as an
rFFT product (exact linear convolution: the FFT length covers window plus
RIR), SNR-scaled additive noise, and for a ``SpatialMixer`` the 7-mic
far-field rendering (per-mic phase ramps, one irFFT, sensor noise). The
FFTs are ``torch.fft``, as the JAX package's are ``jnp.fft``.

Pool layout: the utterances are concatenated into one flat float32 vector
with ``max_win`` zeros before, between and after them. A window whose
start is clamped to [utt_start - win, utt_start + utt_len] reads its own
utterance and gap zeros only, so what lies outside the utterance comes out
as silence without masking: the zero-padded placement of the host mixer.

Sensor noise cannot be the JAX package's bits (``jax.random.normal`` of a
per-row key): each row draws it from a ``torch.Generator`` on the card
seeded with the row's seed from the recipe, so the same recipe gives the
same noise, and rows with different seeds independent noise.
"""

from __future__ import annotations

import threading
from typing import Dict

import numpy as np
import torch

from css_tpu_torch.data.augment import NoiseMix, ReverbWithImpulseResponse
from css_tpu_torch.data.spatial import (MIC_OFFSETS, RADIUS, SOUND_VELOCITY,
                                        SpatialMixer)
from css_tpu_torch.device import resolve_device


def _flatten_pool(arrays, gap: int):
    """Concatenate 1-D float32 arrays with ``gap`` zeros before, between
    and after them; returns (flat, starts int32, lengths int32)."""
    starts = np.zeros(len(arrays), np.int64)
    lens = np.array([len(a) for a in arrays], np.int64)
    pos = gap
    parts = [np.zeros(gap, np.float32)]
    for i, a in enumerate(arrays):
        starts[i] = pos
        parts.append(np.asarray(a, np.float32))
        parts.append(np.zeros(gap, np.float32))
        pos += len(a) + gap
    flat = np.concatenate(parts)
    if flat.nbytes > 2**31:
        raise ValueError(
            f"device pool too large ({flat.nbytes / 2**30:.1f} GiB); "
            "shard the corpus or use the host mixing path")
    return flat, starts.astype(np.int32), lens.astype(np.int32)


class DeviceMixer:
    """Pools on ``device`` and the recipe encoder for one mixer: a
    ``MixtureSynthesizer``, or a ``SpatialMixer`` wrapping one, whose
    recipes then also carry each source's azimuth and a sensor-noise seed
    per row."""

    def __init__(self, mixer, device="cuda"):
        self.device = resolve_device(device)
        self.spatial = None
        # producer threads share this mixer (each wraps its own content
        # mixer, ``wrap``), and numpy Generators are not thread-safe: the
        # spatial draws are serialised
        self._spatial_lock = threading.Lock()
        if isinstance(mixer, SpatialMixer):
            self.spatial = mixer
            mixer = mixer.mixer
        self.mixer = mixer
        self.num_speakers = mixer.num_speakers
        self.max_win = int(max(mixer.window_buckets) * mixer.sr)
        utts = [u.load() for u in mixer.corpus.utterances]
        flat, self._utt_start, self._utt_len = _flatten_pool(
            utts, self.max_win)
        self.host_pools: Dict[str, np.ndarray] = {"utt_flat": flat}
        self.rir_norm = True
        self._noise_start = None
        for tr in mixer.transforms:
            if isinstance(tr, ReverbWithImpulseResponse):
                lr = max(len(r) for r in tr.rir_pool)
                mat = np.zeros((len(tr.rir_pool), lr), np.float32)
                for i, r in enumerate(tr.rir_pool):
                    mat[i, : len(r)] = r
                self.host_pools["rir_mat"] = mat
                self.rir_norm = bool(tr.normalize_output)
            elif isinstance(tr, NoiseMix):
                # short cuts tiled to >= max_win, so that entry[:win] is the
                # host path's np.tile(noise, reps)[:win] for every bucket
                tiled = []
                for nz in tr.noise_pool:
                    if len(nz) < self.max_win:
                        nz = np.tile(nz, -(-self.max_win // len(nz)))
                    tiled.append(np.asarray(nz, np.float32))
                nflat, self._noise_start, _ = _flatten_pool(tiled, 0)
                self.host_pools["noise_flat"] = nflat
        self.sr = mixer.sr
        self.noise_level = (float(self.spatial.noise_level)
                            if self.spatial is not None else 0.0)
        self._device_pools = None

    def device_pools(self) -> Dict[str, torch.Tensor]:
        """The pools as tensors on the device, copied once."""
        if self._device_pools is None:
            self._device_pools = {k: torch.as_tensor(v, device=self.device)
                                  for k, v in self.host_pools.items()}
            if self.spatial is not None:
                self._device_pools["mic_off"] = torch.tensor(
                    MIC_OFFSETS[1:], dtype=torch.float32, device=self.device)
        return self._device_pools

    def materialize(self, batch) -> Dict[str, torch.Tensor]:
        """An encoded recipe (``dm_i``, ``dm_f`` and ``win``, on the
        device) -> {mix, source1..K}, the host mixer's arithmetic on the
        card: ``mix`` is (B, win), or (B, 7, win) for a SpatialMixer."""
        pools = self.device_pools()
        win = int(batch["win"])
        ints, flts = batch["dm_i"], batch["dm_f"]
        k = self.num_speakers
        srcs = _windows(pools["utt_flat"], ints[:, :k], win)  # (B, K, win)
        out = {f"source{i + 1}": srcs[:, i] for i in range(k)}
        if self.spatial is not None:
            az = flts[:, 3:3 + k]  # (B, K) radians
            coef = RADIUS / SOUND_VELOCITY * self.sr  # delay in samples
            nfft = 1 << (win - 1).bit_length()
            deltas = torch.cat(
                [torch.zeros(az.shape + (1,), device=az.device),
                 coef * torch.cos(az[..., None] + pools["mic_off"])],
                dim=-1)  # (B, K, 7)
            freqs = torch.arange(nfft // 2 + 1, dtype=torch.float32,
                                 device=az.device)
            phase = (2.0 * np.pi / nfft) * deltas[..., None] * freqs
            ramp = torch.polar(torch.ones_like(phase), phase)  # (B,K,7,F)
            spec = torch.fft.rfft(srcs, nfft)  # (B, K, F)
            mix_spec = torch.einsum("bkf,bkcf->bcf", spec, ramp)
            mix = torch.fft.irfft(mix_spec, nfft)[..., :win]  # (B, 7, win)
            if self.noise_level > 0:
                seeds = ints[:, k + 2].tolist()
                mix = mix + self.noise_level * sensor_noise(seeds, win,
                                                            mix.device)
            out["mix"] = mix.contiguous()
            return out
        mix = srcs.sum(dim=1)
        if "rir_mat" in pools:
            rir_mat = pools["rir_mat"]
            nfft = 1 << (win + rir_mat.shape[-1] - 2).bit_length()
            spec = torch.fft.rfft(mix, nfft)
            rspec = torch.fft.rfft(rir_mat, nfft)
            rev = torch.fft.irfft(spec * rspec[ints[:, k].long()],
                                  nfft)[:, :win]
            if self.rir_norm:
                in_e = torch.sqrt(torch.mean(mix ** 2, -1, keepdim=True)
                                  + 1e-16)
                out_e = torch.sqrt(torch.mean(rev ** 2, -1, keepdim=True)
                                   + 1e-16)
                rev = rev * (in_e / out_e)
            mix = torch.where(flts[:, 0:1] > 0, rev, mix)
        if "noise_flat" in pools:
            noise = _windows(pools["noise_flat"], ints[:, k + 1], win)
            sig_p = torch.mean(mix ** 2, -1, keepdim=True) + 1e-12
            noi_p = torch.mean(noise ** 2, -1, keepdim=True) + 1e-12
            scale = torch.sqrt(sig_p / (noi_p * 10.0 ** (flts[:, 2:3] / 10.0)))
            mix = torch.where(flts[:, 1:2] > 0, mix + scale * noise, mix)
        out["mix"] = mix
        return out

    def encode(self, recipe) -> Dict:
        """A recipe -> the arrays ``materialize`` reads; the index
        arithmetic happens here, on the host.

        ``dm_i`` int32 (B, K+2): the pool offsets of the K source windows,
        the RIR row, the noise pool offset; ``dm_f`` float32 (B, 3): reverb
        on, noise on, SNR in dB. Columns of an absent augmentation stay 0.
        Spatial recipes add ``dm_i[:, K+2]``, the sensor-noise seed, and
        ``dm_f[:, 3:3+K]``, each source's azimuth in radians. ``win`` is
        the window length and ``ovl`` the overlap ratio."""
        win = int(recipe["win"])
        u = recipe["utt"]
        a = np.clip(recipe["start"], -win, self._utt_len[u])
        src = (self._utt_start[u] + a).astype(np.int32)
        n, k = src.shape
        spatial = self.spatial is not None
        ints = np.zeros((n, k + 2 + (1 if spatial else 0)), np.int32)
        flts = np.zeros((n, 3 + (k if spatial else 0)), np.float32)
        ints[:, :k] = src
        if "rir_mat" in self.host_pools:
            ints[:, k] = recipe["rir_idx"]
            flts[:, 0] = recipe["rir_on"]
        if "noise_flat" in self.host_pools:
            ints[:, k + 1] = (self._noise_start[recipe["noise_idx"]]
                              + recipe["noise_start"])
            flts[:, 1] = recipe["noise_on"]
            flts[:, 2] = recipe["snr"]
        if spatial:
            with self._spatial_lock:
                az = self.spatial._draw_azimuths(n, k)  # degrees
                seeds = self.spatial.rng.integers(2**31, size=n,
                                                  dtype=np.int32)
            flts[:, 3:3 + k] = np.deg2rad(az)
            ints[:, k + 2] = seeds
        return {"dm_i": ints, "dm_f": flts, "win": win, "ovl": recipe["ovl"]}

    def __iter__(self):
        return self

    def __next__(self) -> Dict:
        return self.encode(self.mixer.sample_recipe())

    def wrap(self, mixer) -> "_RecipeIterator":
        """Encoded recipes of another mixer (one per producer thread, each
        with its own seed) on this mixer's pools. It must sample the same
        corpus object: utterance ids are positions in
        ``corpus.utterances``."""
        if mixer.corpus is not self.mixer.corpus:
            raise ValueError("wrapped mixer must share the pool corpus")
        return _RecipeIterator(self, mixer)


class _RecipeIterator:
    def __init__(self, dmix: DeviceMixer, mixer):
        self._dmix = dmix
        self._mixer = mixer

    def __iter__(self):
        return self

    def __next__(self):
        return self._dmix.encode(self._mixer.sample_recipe())


def _windows(flat: torch.Tensor, starts: torch.Tensor,
             win: int) -> torch.Tensor:
    """flat[s : s + win] for every start in ``starts`` (any shape)."""
    return flat.unfold(0, win, 1)[starts.long()]


def sensor_noise(seeds, win: int, device) -> torch.Tensor:
    """(B, 7, win) standard normal noise, row b from a ``torch.Generator``
    on ``device`` seeded with seeds[b]."""
    rows = []
    for s in seeds:
        gen = torch.Generator(device).manual_seed(int(s))
        rows.append(torch.randn((7, win), generator=gen, device=device))
    return torch.stack(rows)
