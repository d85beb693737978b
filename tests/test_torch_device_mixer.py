"""On-device mixing: css_tpu_torch.data.device_mixer and the recipe
protocol against css_tpu's, on the CPU.

Tolerances:
  * ``sample_recipe``, ``encode`` and ``materialize_recipe_host``: bit
    for bit (the same numpy calls in the same order). The host batch of a
    recipe is the batch ``__next__`` gives from the same stream: its
    sources and overlap ratio bit for bit, its mixture to 1e-5 (scipy's
    float32 FFT convolution of the reverb rounds the two paths' windows
    differently, by ~1e-8; css_tpu's tests/test_device_mixer.py holds its
    own pair to the same 1e-5).
  * ``materialize`` against css_tpu's ``materialize`` and against the host
    batch of the same recipe: 1e-5 absolute on waveforms of peak ~1, with
    the sensor noise at 0. The sources are slices (exact); the mixture
    goes through float32 FFTs (reverb, the 7-mic phase ramps) in another
    library, which moves it by ~1e-6.
  * Sensor noise on (it cannot be css_tpu's bits): over a batch its
    standard deviation is within 2% of the level (the card check allows
    5%); two rows' noises correlate by less than 0.02 in magnitude
    (independent rows, 448k samples each: the standard error is 1.5e-3);
    materialising one recipe twice gives the same bits, and other seeds
    other noise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from css_tpu.data import corpus as jcorpus
from css_tpu.data import device_mixer as jdm
from css_tpu.data import mixer as jmixer
from css_tpu.data import spatial as jsp
from css_tpu_torch.data import corpus as tcorpus
from css_tpu_torch.data import device_mixer as tdm
from css_tpu_torch.data import mixer as tmixer
from css_tpu_torch.data import spatial as tsp

ATOL = 1e-5


def _pair(seed, transforms=True, k=2, hard=0.0, batch=4):
    ckw = dict(num_speakers=5, utts_per_speaker=2, min_dur=1.5, max_dur=3.0,
               seed=seed + 40)
    conf = dict(batch_size=batch, min_window_size=1.0, max_window_size=2.0,
                seed=seed, num_spk=k, hard_pair_frac=hard,
                steps_per_dispatch=2)
    if transforms:
        conf["rir_pool"] = jcorpus.synthetic_rir_pool(3, seed=seed)
        conf["noise_pool"] = jcorpus.synthetic_noise_pool(2, seed=seed)
    jm = jmixer.MixtureSynthesizer.build_dataset(
        jcorpus.SyntheticCorpus(**ckw), conf)
    jm._use_native = False
    for tr in jm.transforms:
        tr.use_native = False
    tm = tmixer.MixtureSynthesizer.build_dataset(
        tcorpus.SyntheticCorpus(**ckw), conf)
    return jm, tm


@pytest.mark.parametrize("seed,transforms,k,hard", [
    (0, True, 2, 0.0), (1, False, 3, 0.0), (2, True, 2, 0.5)])
def test_recipes_bit_equal(seed, transforms, k, hard):
    jm, tm = _pair(seed, transforms, k, hard)
    for _ in range(3):
        a, b = jm.sample_recipe(), tm.sample_recipe()
        assert sorted(a) == sorted(b)
        for key in a:
            np.testing.assert_array_equal(b[key], a[key])
        for key, val in tm.materialize_recipe_host(b).items():
            np.testing.assert_array_equal(
                val, jm.materialize_recipe_host(a)[key])


@pytest.mark.parametrize("native", [False, True])
def test_host_batch_of_a_recipe_is_the_mixers_batch(native):
    """The same stream, consumed by ``__next__`` or by ``sample_recipe``
    then ``materialize_recipe_host``, gives the same batches (the rng
    order of the recipe protocol)."""
    _, a = _pair(3)
    _, b = _pair(3)
    a._use_native = b._use_native = native and a._use_native
    for _ in range(3):
        want = next(a)
        got = b.materialize_recipe_host(b.sample_recipe())
        assert sorted(got) == sorted(want)
        for key in want:
            if key == "mix":
                np.testing.assert_allclose(got[key], want[key], atol=ATOL)
            else:
                np.testing.assert_array_equal(got[key], want[key])


def _to_torch(enc):
    return {"dm_i": torch.as_tensor(enc["dm_i"]),
            "dm_f": torch.as_tensor(enc["dm_f"]), "win": enc["win"]}


def _jax_materialize(jd, enc):
    batch = {k: jnp.asarray(v) for k, v in enc.items() if k != "ovl"}
    return {k: np.asarray(v) for k, v in
            jdm.materialize(jd.device_pools(), batch).items()}


@pytest.mark.parametrize("seed,transforms,k", [(0, True, 2), (1, False, 3)])
def test_materialize_1ch(seed, transforms, k):
    jm, tm = _pair(seed, transforms, k)
    jd, td = jdm.DeviceMixer(jm), tdm.DeviceMixer(tm, device="cpu")
    assert sorted(td.host_pools) == sorted(
        p for p in jd.host_pools if p != "rir_norm")
    for name, pool in td.host_pools.items():
        np.testing.assert_array_equal(pool, jd.host_pools[name])
    flags = 0
    for _ in range(2):
        ra, rb = jm.sample_recipe(), tm.sample_recipe()
        ea, eb = jd.encode(ra), td.encode(rb)
        flags = flags + eb["dm_f"][:, :2].sum(0)
        for key in ("dm_i", "dm_f", "ovl"):
            np.testing.assert_array_equal(eb[key], ea[key])
        assert eb["win"] == ea["dm_winmark"].shape[-1]
        got = {key: v.numpy() for key, v in
               td.materialize(_to_torch(eb)).items()}
        want = _jax_materialize(jd, ea)
        host = tm.materialize_recipe_host(rb)
        assert sorted(got) == sorted(want)
        for key in got:
            np.testing.assert_allclose(got[key], want[key], atol=ATOL)
            np.testing.assert_allclose(got[key], host[key], atol=ATOL)
    # the recipes switch reverb and noise on in some rows, not all
    if transforms:
        assert ((0 < flags) & (flags < 8)).all(), flags


def _spatial_pair(seed, level):
    jm, tm = _pair(seed, transforms=False)
    jsm = jsp.SpatialMixer(jm, noise_level=level, seed=seed + 31)
    tsm = tsp.SpatialMixer(tm, noise_level=level, seed=seed + 31)
    return jsm, tsm


@pytest.mark.parametrize("seed", [0, 1])
def test_materialize_spatial_noise_off(seed):
    jsm, tsm = _spatial_pair(seed, 0.0)
    jd, td = jdm.DeviceMixer(jsm), tdm.DeviceMixer(tsm, device="cpu")
    for _ in range(2):
        ra, rb = jsm.mixer.sample_recipe(), tsm.mixer.sample_recipe()
        ea, eb = jd.encode(ra), td.encode(rb)
        for key in ("dm_i", "dm_f"):
            np.testing.assert_array_equal(eb[key], ea[key])
        got = {key: v.numpy() for key, v in
               td.materialize(_to_torch(eb)).items()}
        assert got["mix"].shape == (4, 7, eb["win"])
        want = _jax_materialize(jd, ea)
        # the host rendering of the same recipe at the same azimuths
        host = tsm.spatialize_batch(tsm.mixer.materialize_recipe_host(rb),
                                    az=np.rad2deg(eb["dm_f"][:, 3:5]))
        for key in got:
            np.testing.assert_allclose(got[key], want[key], atol=ATOL)
            np.testing.assert_allclose(got[key], host[key], atol=ATOL)


def test_sensor_noise_statistics_and_reproducibility():
    level = 0.003
    _, quiet = _spatial_pair(4, 0.0)
    _, noisy = _spatial_pair(4, level)
    td0 = tdm.DeviceMixer(quiet, device="cpu")
    td = tdm.DeviceMixer(noisy, device="cpu")
    recipe = noisy.mixer.sample_recipe()
    enc = td.encode(recipe)
    clean = td0.materialize(_to_torch(enc))
    noise = (td.materialize(_to_torch(enc))["mix"] - clean["mix"]).numpy()
    std = float(noise.std())
    assert abs(std / level - 1.0) < 0.02, std
    rows = noise.reshape(noise.shape[0], -1)
    corr = np.corrcoef(rows)[np.triu_indices(len(rows), 1)]
    assert np.abs(corr).max() < 0.02, corr
    again = td.materialize(_to_torch(enc))["mix"].numpy()
    np.testing.assert_array_equal(again, td.materialize(_to_torch(enc))
                                  ["mix"].numpy())
    other = dict(enc, dm_i=enc["dm_i"].copy())
    other["dm_i"][:, 4] += 1
    moved = td.materialize(_to_torch(other))["mix"].numpy()
    assert all(not np.array_equal(m, a) for m, a in zip(moved, again))


def test_wrap_needs_the_pool_corpus():
    _, tm = _pair(5)
    _, other = _pair(6)
    td = tdm.DeviceMixer(tm, device="cpu")
    with pytest.raises(ValueError, match="share the pool corpus"):
        td.wrap(other)
    it = td.wrap(tm)
    assert next(it)["dm_i"].shape == (4, 4)
