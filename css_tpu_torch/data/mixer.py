"""On-the-fly K-speaker mixture synthesis (copy of
``css_tpu/data/mixer.py``).

Per batch: one window size from a small set of buckets; until the batch is
full, K distinct speakers and one utterance each, the longest anchoring
the mixture and the others offset uniformly in [0, dur/2]; the mixture and
the sources cut into equal windows (ragged tail dropped); the augmentations
on the mixture windows only; the cumulative overlap ratio. Batches are raw
waveforms: the trainer featurizes them on the device. From the same seed
the batches are bit-equal to the JAX package's with ``use_native=False``
(tests/test_torch_train_data.py).

``use_native`` (on by default, as in the JAX package) places and windows
the utterances with the native core (``ops/native.py``, the port's build
of ``mixcore.cpp``): the same copies and sums, so the same bits. Where the
core is unavailable the numpy path runs and each mixture it places is
counted in ``native.fallbacks``.

The recipe protocol: ``sample_recipe`` draws one batch's mixing decisions
(utterance ids, window offsets, augmentation draws) with the same rng
calls in the same order as ``__next__``, and ``materialize_recipe_host``
turns a recipe into the batch ``__next__`` would have given.
``data/device_mixer.py`` materialises the same recipes on the card.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from css_tpu_torch.data.augment import NoiseMix, ReverbWithImpulseResponse
from css_tpu_torch.data.corpus import Corpus
from css_tpu_torch.ops import native


def default_window_buckets(min_window: float, max_window: float,
                           step: float = 0.5, frame_align: int = 0,
                           sr: int = 16000, frame_len: int = 512,
                           frame_hop: int = 256) -> List[float]:
    buckets = []
    w = min_window
    while w <= max_window + 1e-9:
        buckets.append(round(w, 3))
        w += step
    if frame_align > 0:
        # snap each bucket to the nearest window whose UNCENTERED frame
        # count is a multiple of `frame_align` (128 = one TPU lane tile:
        # attention scores are (B, H, T, T), so a T that is not a
        # 128-multiple pads up and burns the padding — measured 13%
        # throughput at T=155 vs T=128, scripts/step_shapes.py)
        aligned = []
        for w in buckets:
            frames = (int(w * sr) - frame_len) // frame_hop + 1
            f = max(round(frames / frame_align), 1) * frame_align
            aligned.append(round(((f - 1) * frame_hop + frame_len) / sr, 4))
        buckets = sorted(set(aligned))
    return buckets


class MixtureSynthesizer:
    """Infinite iterator of training batches of raw waveforms."""

    @staticmethod
    def add_args(parser):
        parser.add_argument("--min-window-size", type=float, default=2.0)
        parser.add_argument("--window-seed", type=int, default=None)
        parser.add_argument("--max-window-size", type=float, default=4.0)
        parser.add_argument("--window-bucket-step", type=float, default=0.5)
        parser.add_argument("--align-window-frames", type=int, default=0,
                            help="snap window buckets to multiples of this "
                                 "many STFT frames (128 = TPU lane tile; "
                                 "T=155 windows pad attention to 256 lanes "
                                 "and waste ~13% step throughput — "
                                 "scripts/step_shapes.py). 0 keeps the raw "
                                 "buckets (reference-parity shapes). "
                                 "CAUTION: in [2,4]s this collapses the 5 "
                                 "default buckets to {2.064, 4.112}s and "
                                 "the distribution shift cost ~3 dB "
                                 "held-out SI-SNRi at flagship scale "
                                 "(BASELINE.md round 4) — use for "
                                 "throughput experiments, not quality "
                                 "recipes")
        parser.add_argument("--min-snr", type=float, default=5.0)
        parser.add_argument("--max-snr", type=float, default=20.0)
        parser.add_argument("--hard-pair-frac", type=float, default=0.0,
                            help="fraction of mixtures whose speakers are "
                                 "forced to a close-f0 pair (curriculum "
                                 "for the hardest separation regime; "
                                 "needs corpus f0 metadata)")
        parser.add_argument("--hard-pair-df0", type=float, default=80.0,
                            help="|f0_a - f0_b| ceiling in Hz defining a "
                                 "'hard' pair")

    @classmethod
    def build_dataset(cls, corpus, conf):
        return cls(
            corpus,
            batch_size=int(conf.get("batch_size", 32)),
            min_window=float(conf.get("min_window_size", 2.0)),
            max_window=float(conf.get("max_window_size", 4.0)),
            bucket_step=float(conf.get("window_bucket_step", 0.5)),
            frame_align=int(conf.get("align_window_frames", 0)),
            min_snr=float(conf.get("min_snr", 5.0)),
            max_snr=float(conf.get("max_snr", 20.0)),
            rir_pool=conf.get("rir_pool"),
            noise_pool=conf.get("noise_pool"),
            seed=int(conf.get("seed", 0)),
            num_speakers=int(conf.get("num_spk", 2)),
            window_group=int(conf.get("steps_per_dispatch", 1)),
            window_seed=(int(conf["window_seed"])
                         if conf.get("window_seed") is not None else None),
            hard_pair_frac=float(conf.get("hard_pair_frac", 0.0)),
            hard_pair_df0=float(conf.get("hard_pair_df0", 80.0)),
        )

    def __init__(self, corpus: Corpus, batch_size: int = 32,
                 min_window: float = 2.0, max_window: float = 4.0,
                 bucket_step: float = 0.5, frame_align: int = 0,
                 rir_pool=None, noise_pool=None,
                 min_snr: float = 5.0, max_snr: float = 20.0,
                 reverb_p: float = 0.5, noise_p: float = 0.5,
                 seed: int = 0, use_native: bool = True,
                 num_speakers: int = 2, window_group: int = 1,
                 window_seed=None, hard_pair_frac: float = 0.0,
                 hard_pair_df0: float = 80.0):
        # K-speaker generalization of the reference's 2-speaker sampling
        # (separation.py:184-189): K distinct speakers, the longest
        # utterance anchors, the rest offset uniformly in [0, dur_base/2]
        if len(corpus.speakers) < num_speakers:
            raise ValueError(
                f"need at least {num_speakers} speakers, corpus has "
                f"{len(corpus.speakers)}")
        self.num_speakers = num_speakers
        self._want_native = use_native
        self._use_native = use_native and native.available()
        self.corpus = corpus
        self.sr = corpus.sample_rate
        self.batch_size = batch_size
        self.window_buckets = default_window_buckets(
            min_window, max_window, bucket_step, frame_align=frame_align,
            sr=self.sr)
        # hold each sampled window bucket for `window_group` consecutive
        # batches so Trainer.train_one_epoch(steps_per_dispatch=G) can stack
        # G same-shape batches into one scanned device program; the marginal
        # window distribution is unchanged
        self.window_group = max(int(window_group), 1)
        self._group_left = 0
        self._group_window = None
        self.rng = np.random.default_rng(seed)
        # hard-pair curriculum: oversample close-f0 speaker pairs — the
        # separation regime where trained masks measurably fail (chunked
        # SI-SNRi of close-pair sessions stays negative while far pairs
        # reach +8 dB, BASELINE.md). Zero extra rng draws when off, so
        # frac=0.0 is bit-identical to the historical stream.
        self.hard_pair_frac = float(hard_pair_frac)
        self.hard_pair_df0 = float(hard_pair_df0)
        self._hard_neighbors = None
        if self.hard_pair_frac > 0.0:
            f0s = getattr(corpus, "f0_by_speaker", None)
            if not f0s:
                raise ValueError(
                    "--hard-pair-frac needs per-speaker f0 metadata "
                    "(corpus.f0_by_speaker); this corpus has none")
            vals = np.array([f0s[s] for s in corpus.speakers])
            close = np.abs(vals[:, None] - vals[None, :]) <= hard_pair_df0
            np.fill_diagonal(close, False)
            self._hard_neighbors = [np.flatnonzero(row) for row in close]
            if not any(len(n) for n in self._hard_neighbors):
                raise ValueError(
                    f"no speaker pair is within {hard_pair_df0} Hz — "
                    "raise --hard-pair-df0 or disable the curriculum")
        # window-bucket draws can come from a DEDICATED stream so that
        # cooperating processes (multi-host DP / replica averaging) sample
        # identical bucket sequences — the global batch must assemble with
        # ONE shape per step — while their content streams stay disjoint.
        # Default: draw from the content rng (original single-process
        # stream, pinned by the recipe-parity tests).
        self._window_rng = (np.random.default_rng(window_seed)
                            if window_seed is not None else self.rng)
        self.transforms = []
        if rir_pool:
            self.transforms.append(
                ReverbWithImpulseResponse(rir_pool, p=reverb_p))
        if noise_pool:
            self.transforms.append(
                NoiseMix(noise_pool, p=noise_p, min_snr=min_snr,
                         max_snr=max_snr))

    def __iter__(self):
        return self

    def _next_window_bucket(self) -> float:
        """Sample the batch's window size (held for `window_group` batches)."""
        if self._group_left <= 0:
            self._group_window = self.window_buckets[
                self._window_rng.integers(len(self.window_buckets))]
            self._group_left = self.window_group
        self._group_left -= 1
        return self._group_window

    def _sample_mixture(self, rng, window_size: float):
        """One mixture draw: K distinct speakers, one cut each, offsets.

        Returns (cuts, offs, mix_end_t) or None when the mixture cannot
        fill one window. Pure decision sampling — no audio is decoded
        (lengths come from `Utterance.num_samples`), so the same draw
        feeds both host materialization and device-side materialization
        with an identical rng stream.
        """
        if (self._hard_neighbors is not None
                and rng.uniform() < self.hard_pair_frac):
            # anchor on a speaker that HAS a close-f0 neighbour, force one
            # neighbour in, fill the rest uniformly (K > 2)
            anchors = [i for i, n in enumerate(self._hard_neighbors)
                       if len(n)]
            a = anchors[rng.integers(len(anchors))]
            b = self._hard_neighbors[a][
                rng.integers(len(self._hard_neighbors[a]))]
            spk_idx = [a, b]
            if self.num_speakers > 2:
                rest = [i for i in range(len(self.corpus.speakers))
                        if i not in (a, b)]
                extra = rng.choice(len(rest), self.num_speakers - 2,
                                   replace=False)
                spk_idx += [rest[i] for i in extra]
            spk_idx = np.asarray(spk_idx)
        else:
            spk_idx = rng.choice(len(self.corpus.speakers),
                                 self.num_speakers, replace=False)
        cuts = []
        for si in spk_idx:
            utts = self.corpus.by_speaker[self.corpus.speakers[si]]
            cuts.append(utts[rng.integers(len(utts))])
        # the longest utterance anchors the mixture (separation.py:187-189)
        cuts.sort(key=lambda c: -c.duration)
        base = cuts[0]
        # others start uniformly in [0, base_dur/2] (separation.py:192)
        offs = [0] + [int(rng.uniform(0, base.duration / 2) * self.sr)
                      for _ in cuts[1:]]
        mix_len = max(o + c.num_samples() for o, c in zip(offs, cuts))
        mix_end_t = mix_len / self.sr
        if mix_end_t < window_size:
            return None
        return cuts, offs, mix_end_t

    def _batch_fill_error(self, window_size: float) -> RuntimeError:
        return RuntimeError(
            f"could not fill a batch: no sampled mixture reaches the "
            f"{window_size:.2f}s window (longest utterances are "
            f"shorter than the window?) — lower --min-window-size "
            f"or provide longer utterances")

    def _accumulate_overlap(self, cuts, offs):
        """Overlap seconds of the non-anchor cuts against the anchor."""
        base = cuts[0]
        return sum(min(c.duration, base.duration - o / self.sr)
                   for c, o in zip(cuts[1:], offs[1:]))

    def __next__(self) -> Dict[str, np.ndarray]:
        rng = self.rng
        window_size = self._next_window_bucket()
        win = int(window_size * self.sr)
        k_spk = self.num_speakers
        mixes = []
        srcs = [[] for _ in range(k_spk)]
        total_length = 0.0
        total_overlap = 0.0
        failed_attempts = 0
        while len(mixes) < self.batch_size:
            if failed_attempts > 10000:
                raise self._batch_fill_error(window_size)
            drawn = self._sample_mixture(rng, window_size)
            if drawn is None:
                failed_attempts += 1
                continue
            cuts, offs, mix_end_t = drawn
            # accumulate stats only for ACCEPTED draws so 'ovl' reflects
            # the audio actually emitted
            total_length += mix_end_t
            total_overlap += self._accumulate_overlap(cuts, offs)
            waves = [c.load() for c in cuts]
            num_windows = int(mix_end_t / window_size)
            usable = num_windows * win
            mix_len = max(o + len(w) for o, w in zip(offs, waves))
            if self._use_native:
                mixw, srcs_arr = native.mix_and_window_k(
                    waves, offs, win, num_windows)
                src_windows = [srcs_arr[i] for i in range(k_spk)]
            else:
                if self._want_native:
                    native.count_fallback()
                length = max(mix_len, usable)
                padded = []
                for o, w in zip(offs, waves):
                    s = np.zeros(length, np.float32)
                    s[o : o + len(w)] = w
                    padded.append(s)
                mix = np.sum(padded, axis=0)
                mixw = mix[:usable].reshape(num_windows, win)
                src_windows = [s[:usable].reshape(num_windows, win)
                               for s in padded]
            for wi in range(num_windows):
                m = mixw[wi]
                for tr in self.transforms:  # mixture only (separation.py:233)
                    m = tr(m, rng)
                mixes.append(m)
                for s_list, sw in zip(srcs, src_windows):
                    s_list.append(sw[wi])
                if len(mixes) >= self.batch_size:
                    break
        batch = {
            "mix": np.stack(mixes),
            "lens": np.full(self.batch_size, win, np.int32),
            "ovl": np.float32(total_overlap / max(total_length, 1e-9)),
        }
        for i, s_list in enumerate(srcs):
            batch[f"source{i + 1}"] = np.stack(s_list)
        return batch

    # ------------------------------------------------------- recipe protocol
    def _utt_global_index(self, cut) -> int:
        """A cut's position in ``corpus.utterances``."""
        if not hasattr(self, "_utt_idx_map"):
            self._utt_idx_map = {
                id(u): i for i, u in enumerate(self.corpus.utterances)}
        return self._utt_idx_map[id(cut)]

    def sample_recipe(self) -> Dict[str, np.ndarray]:
        """One batch of mixing decisions; no audio is touched.

        The rng calls of ``__next__`` in its order: per window the K
        utterance ids and the window's start in each utterance's
        coordinates, the augmentation decisions (RIR index; noise index,
        start and SNR), the window length ``win`` and the overlap ratio.
        """
        rng = self.rng
        window_size = self._next_window_bucket()
        win = int(window_size * self.sr)
        b, k = self.batch_size, self.num_speakers
        utt = np.zeros((b, k), np.int32)
        start = np.zeros((b, k), np.int32)
        rir_on = np.zeros(b, bool)
        rir_idx = np.zeros(b, np.int32)
        noise_on = np.zeros(b, bool)
        noise_idx = np.zeros(b, np.int32)
        noise_start = np.zeros(b, np.int32)
        snr = np.zeros(b, np.float32)
        total_length = 0.0
        total_overlap = 0.0
        failed_attempts = 0
        rows = 0
        while rows < b:
            if failed_attempts > 10000:
                raise self._batch_fill_error(window_size)
            drawn = self._sample_mixture(rng, window_size)
            if drawn is None:
                failed_attempts += 1
                continue
            cuts, offs, mix_end_t = drawn
            total_length += mix_end_t
            total_overlap += self._accumulate_overlap(cuts, offs)
            ids = [self._utt_global_index(c) for c in cuts]
            num_windows = int(mix_end_t / window_size)
            for wi in range(num_windows):
                utt[rows] = ids
                start[rows] = [wi * win - o for o in offs]
                for tr in self.transforms:  # rng order == __next__'s
                    d = tr.sample(rng, win)
                    if isinstance(tr, ReverbWithImpulseResponse):
                        if d is not None:
                            rir_on[rows], rir_idx[rows] = True, d
                    elif isinstance(tr, NoiseMix):
                        if d is not None:
                            noise_on[rows] = True
                            noise_idx[rows], noise_start[rows], snr[rows] = d
                rows += 1
                if rows >= b:
                    break
        return {
            "utt": utt, "start": start,
            "rir_on": rir_on, "rir_idx": rir_idx,
            "noise_on": noise_on, "noise_idx": noise_idx,
            "noise_start": noise_start, "snr": snr,
            "win": win,
            "ovl": np.float32(total_overlap / max(total_length, 1e-9)),
        }

    def materialize_recipe_host(self, recipe) -> Dict[str, np.ndarray]:
        """The numpy batch of a recipe: what ``__next__`` gives from the
        same rng stream."""
        win = int(recipe["win"])
        b, k = recipe["utt"].shape
        srcs = np.zeros((k, b, win), np.float32)
        mix = np.zeros((b, win), np.float32)
        for bi in range(b):
            for ki in range(k):
                w = self.corpus.utterances[int(recipe["utt"][bi, ki])].load()
                a = int(recipe["start"][bi, ki])
                lo, hi = max(0, a), min(len(w), a + win)
                if hi > lo:
                    srcs[ki, bi, lo - a : hi - a] = w[lo:hi]
            m = srcs[:, bi].sum(axis=0)
            for tr in self.transforms:
                if isinstance(tr, ReverbWithImpulseResponse):
                    m = tr.apply(m, int(recipe["rir_idx"][bi])
                                 if recipe["rir_on"][bi] else None)
                elif isinstance(tr, NoiseMix):
                    m = tr.apply(m, (int(recipe["noise_idx"][bi]),
                                     int(recipe["noise_start"][bi]),
                                     float(recipe["snr"][bi]))
                                 if recipe["noise_on"][bi] else None)
            mix[bi] = m
        batch = {
            "mix": mix,
            "lens": np.full(b, win, np.int32),
            "ovl": recipe["ovl"],
        }
        for ki in range(k):
            batch[f"source{ki + 1}"] = srcs[ki]
        return batch
