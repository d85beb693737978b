"""The port's data modules against css_tpu's numpy path, bit for bit.

``SyntheticCorpus``, the RIR and noise pools, and the mixer's batches
(window buckets, speakers, offsets, reverb, noise, overlap ratio) from the
same seeds must be equal to css_tpu's with ``use_native=False``: the
port copies the numpy code. css_tpu's ``NoiseMix`` takes the native core
by default even under a numpy mixer, so its transforms are switched to
numpy too.
"""

import numpy as np
import pytest
import torch

from css_tpu.data import corpus as jcorpus
from css_tpu.data import mixer as jmixer
from css_tpu_torch.data import corpus as tcorpus
from css_tpu_torch.data import mixer as tmixer
from css_tpu_torch.data.loader import PrefetchLoader


def _corpus_pair(seed, voice):
    kw = dict(num_speakers=4, utts_per_speaker=2, min_dur=1.5, max_dur=3.0,
              seed=seed, voice=voice)
    return jcorpus.SyntheticCorpus(**kw), tcorpus.SyntheticCorpus(**kw)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_corpus_and_pools_bit_equal(seed):
    j, t = _corpus_pair(seed, "formant" if seed == 1 else "harmonic")
    assert [u.utt_id for u in j.utterances] == [u.utt_id for u in
                                                t.utterances]
    assert j.f0_by_speaker == t.f0_by_speaker
    for a, b in zip(j.utterances, t.utterances):
        assert (a.speaker, a.duration, a.text) == (b.speaker, b.duration,
                                                   b.text)
        np.testing.assert_array_equal(a.array, b.array)
    for name, kw in (("synthetic_rir_pool", dict(num=4, seed=seed)),
                     ("synthetic_noise_pool", dict(num=2, seed=seed))):
        for a, b in zip(getattr(jcorpus, name)(**kw),
                        getattr(tcorpus, name)(**kw)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mixer_batches_bit_equal(seed):
    j, t = _corpus_pair(seed + 10, "harmonic")
    conf = dict(batch_size=5, min_window_size=1.0, max_window_size=2.0,
                window_bucket_step=0.5, seed=seed, steps_per_dispatch=2,
                rir_pool=jcorpus.synthetic_rir_pool(4, seed=seed),
                noise_pool=jcorpus.synthetic_noise_pool(2, seed=seed),
                num_spk=2 + (seed == 2), align_window_frames=(
                    16 if seed == 1 else 0))
    jds = jmixer.MixtureSynthesizer.build_dataset(j, conf)
    jds._use_native = False
    for tr in jds.transforms:
        tr.use_native = False
    tds = tmixer.MixtureSynthesizer.build_dataset(t, conf)
    assert tds.window_buckets == jds.window_buckets
    for _ in range(4):
        a, b = next(jds), next(tds)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_window_buckets_match():
    for args in [(2.0, 4.0), (2.0, 4.0, 0.5, 128), (1.0, 3.0, 0.25, 16)]:
        assert tmixer.default_window_buckets(*args) == \
            jmixer.default_window_buckets(*args)


def test_prefetch_loader_yields_the_stream_in_order():
    t = tcorpus.SyntheticCorpus(num_speakers=3, utts_per_speaker=2,
                                min_dur=1.5, max_dur=2.5, seed=4)
    want = tmixer.MixtureSynthesizer(t, batch_size=2, min_window=1.0,
                                     max_window=1.0, seed=5)
    got = PrefetchLoader(tmixer.MixtureSynthesizer(
        t, batch_size=2, min_window=1.0, max_window=1.0, seed=5),
        prefetch=2, device="cpu")
    try:
        for _ in range(3):
            a, b = next(want), next(got)
            assert isinstance(b["mix"], torch.Tensor)
            np.testing.assert_array_equal(b["mix"].numpy(), a["mix"])
            np.testing.assert_array_equal(b["source2"].numpy(), a["source2"])
            assert b["ovl"] == a["ovl"]
    finally:
        got.close()
    assert not any(th.is_alive() for th in got.threads)


def test_prefetch_loader_surfaces_producer_errors():
    def broken():
        yield {"mix": np.zeros((1, 4), np.float32)}
        raise RuntimeError("producer failed")

    loader = PrefetchLoader(broken())
    try:
        next(loader)
        with pytest.raises(RuntimeError, match="producer failed"):
            next(loader)
    finally:
        loader.close()
