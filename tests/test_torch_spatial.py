"""css_tpu_torch.data.spatial against css_tpu.data.spatial, bit for bit.

The port copies the numpy host path: the phase ramps, the array images,
the sessions with sensor noise, the azimuth draws with their minimum
separation, and ``SpatialMixer``'s batches from the same seeds must all
be equal to the JAX package's (tolerance 0: the same numpy calls in the
same order).
"""

import numpy as np
import pytest

from css_tpu.data import corpus as jcorpus
from css_tpu.data import mixer as jmixer
from css_tpu.data import spatial as jsp
from css_tpu.trainer import probe as jprobe
from css_tpu_torch.data import corpus as tcorpus
from css_tpu_torch.data import mixer as tmixer
from css_tpu_torch.data import spatial as tsp


def test_geometry_and_images_bit_equal():
    az = np.array([0.0, 17.5, 123.4, 300.0])
    np.testing.assert_array_equal(
        tsp._phase_ramps(az, 33, 64, 0.0425, 340.0, 16000),
        jsp._phase_ramps(az, 33, 64, 0.0425, 340.0, 16000))
    rng = np.random.default_rng(0)
    waves = rng.standard_normal((3, 1000)).astype(np.float32)
    np.testing.assert_array_equal(
        tsp._spatialize_batch(waves, az[:3]),
        jsp._spatialize_batch(waves, az[:3]))
    np.testing.assert_array_equal(tsp.spatialize_7ch(waves[0], 77.0),
                                  jsp.spatialize_7ch(waves[0], 77.0))
    for level in (0.0, 0.003):
        np.testing.assert_array_equal(
            tsp.spatial_session(waves[:2], [40.0, 200.0], level, seed=5),
            jsp.spatial_session(waves[:2], [40.0, 200.0], level, seed=5))


@pytest.mark.parametrize("k,sep", [(2, 20.0), (3, 90.0)])
def test_azimuth_draws_bit_equal_and_separated(k, sep):
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(20):
        got = tsp.draw_azimuths(a, k, sep)
        np.testing.assert_array_equal(got, jprobe._draw_azimuths(b, k, sep))
        d = np.abs(got[:, None] - got[None, :])
        d = np.minimum(d, 360.0 - d)[np.triu_indices(k, 1)]
        assert d.min() >= sep


def _mixers(seed, k=2, level=0.003, **extra):
    kw = dict(num_speakers=4, utts_per_speaker=2, min_dur=1.5, max_dur=3.0,
              seed=seed + 20)
    conf = dict(batch_size=4, min_window_size=1.0, max_window_size=1.5,
                seed=seed, num_spk=k, **extra)
    jm = jmixer.MixtureSynthesizer.build_dataset(
        jcorpus.SyntheticCorpus(**kw), conf)
    jm._use_native = False
    tm = tmixer.MixtureSynthesizer.build_dataset(
        tcorpus.SyntheticCorpus(**kw), conf)
    return (jsp.SpatialMixer(jm, noise_level=level, seed=seed + 31),
            tsp.SpatialMixer(tm, noise_level=level, seed=seed + 31))


@pytest.mark.parametrize("seed,k,level", [(0, 2, 0.003), (1, 3, 0.003),
                                          (2, 2, 0.0)])
def test_spatial_mixer_batches_bit_equal(seed, k, level):
    j, t = _mixers(seed, k, level)
    for _ in range(3):
        a, b = next(j), next(t)
        assert sorted(a) == sorted(b)
        assert b["mix"].shape == (4, 7, b["source1"].shape[-1])
        assert b["mix"].dtype == np.float32
        for key in a:
            np.testing.assert_array_equal(b[key], a[key])


def test_spatial_mixer_needs_a_transform_free_mixer():
    corpus = tcorpus.SyntheticCorpus(num_speakers=4, utts_per_speaker=2)
    mixer = tmixer.MixtureSynthesizer(
        corpus, batch_size=2, noise_pool=tcorpus.synthetic_noise_pool(2))
    with pytest.raises(ValueError, match="transform-free"):
        tsp.SpatialMixer(mixer)
