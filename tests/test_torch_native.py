"""The port's build of the native mixing core (``ops/native.py``,
``csrc/mixcore.cpp``) against css_tpu.native, and the native switches of
the port's mixer and augmentations.

The port builds its own copy with g++ into ``css_tpu_torch/_build/`` and
never loads ``css_tpu/native/libmixcore.so``. Without a g++ the tests
skip, in a fixture, not at collection.

Tolerances (those tests/test_native.py gives css_tpu's core, unless
said otherwise):
  * placing and windowing (``mix_and_window``, ``mix_and_window_k``):
    bit for bit, to css_tpu's core and to numpy;
  * ``add_noise_snr``: 1e-6 absolute against css_tpu's core and 1e-4
    against numpy's float32 powers;
  * ``fft_convolve_trunc``: 2e-4 of the output's peak against css_tpu's
    core, and 2e-3 of the peak against scipy. The two cores run the same
    radix-2 FFT, but css_tpu's is built with ``-march=native``, which
    fuses multiply-adds in the twiddle recurrence, and the port's with
    portable flags and contraction off: on these inputs they differ by
    4.3e-5 of the peak (1.8e-5 normalised);
  * the mixer's batches, native against numpy: bit for bit (the mixer
    only places and sums); with the native noise 1e-6 absolute on the
    mixture, as tests/test_native.py holds css_tpu's; with the native
    reverb 2e-3 of each window's peak, the core's FFT against scipy's.
A mixer asked for the native path without the library runs numpy and
counts each fall-back in ``native.fallbacks``.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest

from css_tpu import native as jnative
from css_tpu_torch.data import augment as taug
from css_tpu_torch.data.corpus import (SyntheticCorpus, synthetic_noise_pool,
                                       synthetic_rir_pool)
from css_tpu_torch.data.mixer import MixtureSynthesizer
from css_tpu_torch.ops import native

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native core cannot be built here")
    if native.load() is None:
        pytest.fail(f"the native core did not build: {native.error}")
    return native.load()


def test_builds_the_ports_copy_into_its_build_dir(lib):
    path = Path(lib._name).resolve()
    assert path.parent == (REPO / "css_tpu_torch" / "_build").resolve()
    assert path.name.startswith("libmixcore_")
    assert native.SOURCE == REPO / "css_tpu_torch" / "csrc" / "mixcore.cpp"
    assert lib.mixcore_abi_version() == native.ABI == jnative._ABI


def test_mix_and_window_bit_equal(lib):
    rng = np.random.default_rng(3)
    w1 = rng.standard_normal(50000).astype(np.float32)
    w2 = rng.standard_normal(30000).astype(np.float32)
    for got, want in zip(native.mix_and_window(w1, w2, 12345, 16000, 3),
                         jnative.mix_and_window(w1, w2, 12345, 16000, 3)):
        np.testing.assert_array_equal(got, want)
    waves = [rng.standard_normal(n).astype(np.float32)
             for n in (40000, 25000, 9000)]
    offs = [0, 7000, 30000]
    for got, want in zip(native.mix_and_window_k(waves, offs, 16000, 3),
                         jnative.mix_and_window_k(waves, offs, 16000, 3)):
        np.testing.assert_array_equal(got, want)


def test_add_noise_snr_matches(lib):
    rng = np.random.default_rng(2)
    wav = rng.standard_normal(32000).astype(np.float32)
    for n, start in ((20000, 100), (48000, 100)):  # tiled, then sliced
        noise = rng.standard_normal(n).astype(np.float32) * 3.0
        got = native.add_noise_snr(wav, noise, start=start, snr_db=10.0)
        np.testing.assert_allclose(
            got, jnative.add_noise_snr(wav, noise, start, 10.0), atol=1e-6)
    # numpy's path slices a noise at least as long as the window
    np.testing.assert_allclose(
        got, taug.NoiseMix([noise]).apply(wav, (0, start, 10.0)), atol=1e-4)


@pytest.mark.parametrize("normalize,cached", [(False, False), (True, True)])
def test_fft_convolve_matches(lib, normalize, cached):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(38656).astype(np.float32)
    h = (rng.standard_normal(3001) * 0.1).astype(np.float32)
    rid = 7 if cached else None
    got = native.fft_convolve_trunc(x, h, normalize=normalize, rir_id=rid)
    want = jnative.fft_convolve_trunc(x, h, normalize=normalize, rir_id=rid)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 2e-4 * scale
    ref = taug.ReverbWithImpulseResponse(
        [h], normalize_output=normalize).apply(x, 0)
    assert np.abs(got - ref).max() <= 2e-3 * np.abs(ref).max()


def _mixer(use_native, reverb_native=False, noise_native=False, seed=7):
    corpus = SyntheticCorpus(num_speakers=4, utts_per_speaker=2, seed=seed)
    m = MixtureSynthesizer(corpus, batch_size=6, seed=seed,
                           rir_pool=synthetic_rir_pool(3, seed=seed),
                           noise_pool=synthetic_noise_pool(2, seed=seed),
                           use_native=use_native)
    m.transforms = [
        taug.ReverbWithImpulseResponse(synthetic_rir_pool(3, seed=seed),
                                       use_native=reverb_native),
        taug.NoiseMix(synthetic_noise_pool(2, seed=seed),
                      use_native=noise_native)]
    return m


def test_mixer_native_path_bit_equal_to_numpy(lib):
    calls, fallbacks = native.calls, native.fallbacks
    a, b = _mixer(True), _mixer(False)
    assert a._use_native and not b._use_native
    for _ in range(2):
        got, want = next(a), next(b)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
    assert native.calls > calls and native.fallbacks == fallbacks


@pytest.mark.parametrize("reverb", [False, True])
def test_native_augmentations_match_numpy(lib, reverb):
    a = _mixer(True, reverb_native=reverb, noise_native=True)
    b = _mixer(False)
    assert [tr.use_native for tr in a.transforms] == [reverb, True]
    for _ in range(2):
        got, want = next(a), next(b)
        np.testing.assert_array_equal(got["source1"], want["source1"])
        if not reverb:
            np.testing.assert_allclose(got["mix"], want["mix"], atol=1e-6)
            continue
        err = np.abs(got["mix"] - want["mix"]).max(axis=1)
        assert (err <= 2e-3 * np.abs(want["mix"]).max(axis=1)).all()


def test_pools_never_share_cached_spectra(lib):
    """The core caches RIR spectra per process by id; two pools with the
    same indices must not read each other's."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal(16000).astype(np.float32)
    pools = [[(rng.standard_normal(800) * 0.1).astype(np.float32)]
             for _ in range(2)]
    for pool in pools:
        tr = taug.ReverbWithImpulseResponse(pool, use_native=True)
        want = taug.ReverbWithImpulseResponse(pool).apply(x, 0)
        np.testing.assert_allclose(tr.apply(x, 0), want,
                                   atol=2e-3 * np.abs(want).max())


def test_fallback_is_counted(monkeypatch):
    monkeypatch.setattr(native, "_TRIED", True)
    monkeypatch.setattr(native, "_LIB", None)
    before = native.fallbacks
    a = _mixer(True, reverb_native=True, noise_native=True)
    b = _mixer(False)
    assert not a._use_native
    assert not any(tr.use_native for tr in a.transforms)
    got, want = next(a), next(b)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    assert native.fallbacks > before
    with pytest.raises(RuntimeError, match="unavailable"):
        native.add_noise_snr(np.zeros(4, np.float32),
                             np.ones(4, np.float32), 0, 10.0)
