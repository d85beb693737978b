"""Windowing, Separator, Stitcher and Beamformer (masking) against css_tpu.

Numpy inputs from fixed seeds go to both packages. Float32 tolerances:
stitched masks 1e-5 (the same sums in another order); beamformed streams
1e-4 absolute on a 0.9 peak (STFT, dedup and iSTFT through matrix
products, each ~1e-6 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from css_tpu.executor import beamformer as jbf
from css_tpu.executor import stitcher as jst
from css_tpu.executor import windowing as jwin
from css_tpu.models.conformer import Conformer as JaxConformer
from tests.test_7ch_pipeline import _make_7ch_recording
from css_tpu_torch.executor import beamformer as tbf
from css_tpu_torch.executor import stitcher as tst
from css_tpu_torch.executor import windowing as twin
from css_tpu_torch.executor.separator import Separator
from css_tpu_torch.models.conformer import Conformer, params_from_jax
from css_tpu_torch.utils.permutations import permutations_array

SMALL = dict(attention_dim=64, attention_heads=4, linear_units=128,
             num_blocks=2, kernel_size=7)


@pytest.mark.parametrize("t", [5000, 38656, 100000])
def test_unfold_and_pad_for_windows_match(t):
    x = np.random.default_rng(0).standard_normal(t).astype(np.float32)
    got = twin.pad_for_windows(torch.as_tensor(x), 38656, 12800)
    want = jwin.pad_for_windows(x, 38656, 12800)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        twin.unfold(torch.as_tensor(x), 38656, 12800).numpy(),
        jwin.unfold(x, 38656, 12800))
    with pytest.raises(ValueError):
        twin.unfold(torch.as_tensor(x[:100]), 38656, 12800, pad_to_one=False)


@pytest.mark.parametrize("t", [5000, 100000])
def test_unfold_and_pad_for_windows_carry_channels(t):
    """(C, T) recordings -> (B, C, N) windows, as in the reference."""
    x = np.random.default_rng(1).standard_normal((7, t)).astype(np.float32)
    got = twin.pad_for_windows(torch.as_tensor(x), 38656, 12800)
    want = jwin.pad_for_windows(x, 38656, 12800)
    np.testing.assert_array_equal(got.numpy(), want)
    win = twin.unfold(got, 38656, 12800)
    assert win.shape[1:] == (7, 38656)
    np.testing.assert_array_equal(win.numpy(), jwin.unfold(want, 38656, 12800))
    np.testing.assert_array_equal(win[:, 3].numpy(),
                                  twin.unfold(got[3], 38656, 12800).numpy())


@pytest.mark.parametrize("k", [2, 3])
def test_permutations_array_identity_first(k):
    from css_tpu.ops.pit import permutations_array as jperm

    np.testing.assert_array_equal(permutations_array(k), jperm(k))
    np.testing.assert_array_equal(permutations_array(k)[0], np.arange(k))


def test_beamformer_size_identities():
    """A 2.4 s window + 256 samples is 38656 samples; its uncentered STFT
    has T = 150 frames, the mask window is int(2.4*16000/256) = 150 frames,
    and (T+1)*256 == 38656: the masks and the synthesis need no padding."""
    bf = tbf.Beamformer("masking", device="cpu")
    assert bf.win == 38656
    assert bf.mask_win == 150
    t = (bf.win - bf.n_fft) // bf.hop_length + 1
    assert t == 150 == bf.mask_win
    assert (t + 1) * bf.hop_length == bf.win
    sep = Separator(torch.nn.Identity(), device="cpu")
    assert sep.win == bf.win and sep.hop == bf.hop == 12800
    # a 60 s recording: 73 windows, 3 separator batches of 32
    n = twin.pad_for_windows(torch.zeros(960000), sep.win, sep.hop).shape[0]
    assert (n - sep.win) // sep.hop + 1 == 73


def _masks(rng, b, t=150, f=257, s=3):
    m = rng.uniform(0.0, 1.0, (b, t, f, s)).astype(np.float32)
    mags = rng.gamma(2.0, 1.0, (b, t, f)).astype(np.float32)
    return m, mags


@pytest.mark.parametrize("k", [2, 3])
def test_stitcher_matches(k):
    rng = np.random.default_rng(k)
    masks, mags = _masks(rng, 7, s=k + 1)
    # make window 3 a swapped copy of a continuation so a non-identity
    # permutation wins at that boundary
    masks[3, :, :, :k] = masks[3, :, :, :k][..., ::-1]
    want = jst.Stitcher(num_spk=k)(masks, mags)
    got = tst.Stitcher(num_spk=k, device="cpu")(torch.as_tensor(masks),
                                                 torch.as_tensor(mags))
    assert len(got) == len(want) == k + 1
    perms_w = np.asarray(jst.Stitcher(num_spk=k).get_stitch(
        jnp.asarray(masks), jnp.asarray(mags)))
    perms_g = tst.Stitcher(num_spk=k, device="cpu").get_stitch(
        torch.as_tensor(masks), torch.as_tensor(mags)).numpy()
    np.testing.assert_array_equal(perms_g, perms_w)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (6 * 50 + 150, 257)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_stitcher_follows_a_flip():
    """Window 1 carries window 0's streams swapped; the stitcher routes
    them back, so the stitched stream 0 is speaker A throughout."""
    rng = np.random.default_rng(9)
    # constant over time, so the overlap-average keeps them as they are
    a = np.tile(rng.uniform(0.6, 1.0, 257).astype(np.float32), (150, 1))
    b = np.tile(rng.uniform(0.0, 0.4, 257).astype(np.float32), (150, 1))
    noise = np.full((150, 257), 0.01, np.float32)
    masks = np.stack([np.stack([a, b, noise], -1),
                      np.stack([b, a, noise], -1)])
    mags = np.ones((2, 150, 257), np.float32)
    st = tst.Stitcher(num_spk=2, device="cpu")
    perms = st.get_stitch(torch.as_tensor(masks), torch.as_tensor(mags))
    np.testing.assert_array_equal(perms.numpy(), [[1, 0]])
    s0, s1, _ = st(torch.as_tensor(masks), torch.as_tensor(mags))
    np.testing.assert_allclose(s0.numpy(), a[:1].repeat(200, 0), rtol=1e-6)
    # stream 1 loses every bin: winner-take-all floors it
    np.testing.assert_allclose(s1.numpy(), 1e-4, rtol=1e-6)


@pytest.mark.parametrize("seconds", [2.0, 3.3, 8.0])
def test_beamformer_masking_matches(seconds):
    rng = np.random.default_rng(int(seconds * 10))
    wav = (rng.standard_normal(int(seconds * 16000)) * 0.1).astype(np.float32)
    wav = jwin.pad_for_windows(wav, 38656, 12800)
    n_win = (len(wav) - 38656) // 12800 + 1
    t_total = (n_win - 1) * 50 + 150
    masks = [rng.uniform(0, 1, (t_total, 257)).astype(np.float32)
             for _ in range(3)]
    masks[1][:, :100] *= 1e-3  # one quiet stream exercises the dedup
    want = jbf.Beamformer("masking").continuous_process(wav, masks)
    got = tbf.Beamformer("masking", device="cpu").continuous_process(
        torch.as_tensor(wav), [torch.as_tensor(m) for m in masks])
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape == wav.shape
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4)
        assert abs(float(g.abs().max()) - 0.9) < 1e-5


def test_beamformer_dedup_matches():
    rng = np.random.default_rng(3)
    s = (rng.standard_normal((4, 2, 150, 257))
         + 1j * rng.standard_normal((4, 2, 150, 257))).astype(np.complex64)
    s[1, 1] *= 1e-2  # 40 dB down: ducked
    s[2, 0] *= 0.5  # 6 dB down: kept
    want = np.asarray(jbf.Beamformer("masking")._dedup(jnp.asarray(s)))
    got = tbf.Beamformer("masking", device="cpu")._dedup(torch.as_tensor(s))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_beamformer_refuses_mvdr():
    """Named before the 7ch slice, when Souden MVDR raised. Now the
    reference's type names map as in css_tpu (its asteroid class name and
    the default to souden_mvdr). An unknown type, which css_tpu fails on
    only at the first call, the port refuses at once."""
    for name, want in [("SoudenMVDRBeamformer", "souden_mvdr"),
                       ("souden_mvdr", "souden_mvdr"),
                       ("masking", "masking"), ("Masking", "masking")]:
        assert tbf.Beamformer(name, device="cpu").bf_type == want
        assert jbf.Beamformer(name).bf_type == want
    assert tbf.Beamformer(device="cpu").bf_type == jbf.Beamformer().bf_type
    with pytest.raises(ValueError, match="unknown beamformer"):
        tbf.Beamformer("delay_and_sum", device="cpu")


@pytest.mark.parametrize("seconds,n", [(8, 7), (8.5, 8)],
                         ids=["partial", "full"])
def test_separator_matches_and_pads_batches(seconds, n):
    """Batches of 4 windows: 7 windows (a last batch of 3, padded) and 8
    (two full batches). Full batches reach the forward as cut from the
    windows view; only a partial last one is padded with zero windows."""
    rng = np.random.default_rng(4)
    jm = JaxConformer(**SMALL)
    f = np.abs(rng.standard_normal((1, 150, 257))).astype(np.float32)
    v = jax.tree.map(np.asarray,
                     jm.init({"params": jax.random.PRNGKey(1)},
                             jnp.asarray(f)))
    from css_tpu.executor.separator import Separator as JaxSeparator

    wav = (rng.standard_normal(int(16000 * seconds)) * 0.1).astype(
        np.float32)
    m_want, g_want = JaxSeparator(jm, v, batch_size=4).separate(wav)
    tm = Conformer(**SMALL)
    tm.load_state_dict(params_from_jax(v["params"], v["batch_stats"]))
    sep = Separator(tm.eval(), batch_size=4, device="cpu")
    forward, batches = sep.forward, []

    def recorded(batch):
        batches.append(batch)
        return forward(batch)
    sep.forward = recorded
    masks, mags = sep.separate(wav)
    assert masks.shape == m_want.shape and masks.shape[0] == n
    windows = torch.as_tensor(wav).unfold(0, sep.win, sep.hop)
    assert len(batches) == -(-n // 4)
    for i, batch in enumerate(batches):
        real = min(4, n - 4 * i)
        assert batch.shape == (4, sep.win)
        assert batch._is_view() == (real == 4)
        torch.testing.assert_close(batch[:real], windows[4 * i:4 * i + real],
                                   atol=0, rtol=0)
        assert not batch[real:].any()
    assert float(masks.max()) <= 1.0
    np.testing.assert_allclose(masks.numpy(), m_want, atol=1e-4)
    np.testing.assert_allclose(mags.numpy(), g_want, atol=1e-4, rtol=1e-4)
    # the padding of the last batch does not change results
    masks2, _ = Separator(tm, batch_size=64, device="cpu").separate(wav)
    np.testing.assert_allclose(masks.numpy(), masks2.numpy(), atol=1e-5)


def _check_separator_7ch(key):
    from css_tpu.executor.separator import Separator as JaxSeparator

    ipd = "1,0;2,0;3,0;4,0;5,0;6,0"
    jm = JaxConformer(idim=7 * 257, **SMALL)
    v = jax.tree.map(np.asarray, jm.init(
        {"params": jax.random.PRNGKey(key)}, jnp.ones((1, 150, 7 * 257))))
    wav = jwin.pad_for_windows(_make_7ch_recording(), 38656, 12800)
    m_want, g_want = JaxSeparator(jm, v, batch_size=4, ipd_index=ipd,
                                  merge=True).separate(wav)
    tm = Conformer(idim=7 * 257, **SMALL)
    tm.load_state_dict(params_from_jax(v["params"], v["batch_stats"]))
    sep = Separator(tm.eval(), batch_size=4, ipd_index=ipd, merge=True,
                    device="cpu")
    masks, mags = sep.separate(torch.as_tensor(wav))
    assert masks.shape == m_want.shape and masks.shape[0] == 6  # 4 + 2
    np.testing.assert_allclose(masks.numpy(), m_want, atol=1e-3)
    np.testing.assert_allclose(mags.numpy(), g_want, atol=1e-4, rtol=1e-4)
    killed = (masks[..., :2] == np.float32(1e-12)).all(dim=1).all(dim=1)
    killed_want = (m_want[..., :2] == np.float32(1e-12)).all(axis=(1, 2))
    np.testing.assert_array_equal(killed.numpy(), killed_want)
    assert int(sep.merge_kills) == int(killed_want.any(axis=-1).sum())
    return tm


def test_separator_7ch_with_merge_matches():
    """IPD features and the DOA merge on the JAX package's own 7ch
    fixture, a (7, T) recording (tests/test_7ch_pipeline.py): the masks
    agree to 1e-3 (the IPD angles carry the phase noise of small bins,
    tests/test_torch_features.py; measured 3.0e-4) and every window's kill
    decision is the reference's."""
    tm = _check_separator_7ch(2)
    with pytest.raises(ValueError, match="num_spk"):
        Separator(tm, merge=True, num_spk=3, device="cpu")


@pytest.mark.parametrize("key", [0, 1])
def test_separator_7ch_with_merge_at_other_keys(key):
    """As above under init key 0, the JAX package's own 7ch tests' key,
    and key 1 (measured 1.4e-4 and 2.2e-4)."""
    _check_separator_7ch(key)
