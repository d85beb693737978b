"""Full width: the committed flagship checkpoint (16 blocks x 256, 4 heads,
kernel 33) and the committed 7ch checkpoint (the same Conformer on IPD
features, idim 1799) in both packages, float32, on 2 windows of a numpy
mixture. Float32 with full-precision matmuls on both sides: the products
are summed in other orders through 16 blocks, so masks (of order 1) agree
to 2e-3 absolute (measured 3e-4 for the flagship and 3.5e-4 for the 7ch
model, whose IPD inputs also carry the phase noise of small bins).

The 7ch checkpoint also goes through both packages' whole 7ch pipeline
(configs/infer_7ch.yaml) on 8 s of chip_smoke.py's two voices on the
7-mic array: at chip_smoke.py's azimuths, which the checkpoint separates,
the streams agree to 1e-3 on the 0.9-peak streams (measured 3.2e-4); with
one voice at 30 degrees, which it does not separate, the streams differ
by 2.7e-3, and the test shows where: in the winner-take-all of the
stitcher, on bins where two streams' masks lie within the masks' float32
tolerance of each other."""

import jax.numpy as jnp
import numpy as np
import torch

import pytest

from css_tpu.data.spatial import spatial_session
from css_tpu.executor.pipeline import CssPipeline as JaxPipeline
from css_tpu.executor.windowing import pad_for_windows
from css_tpu.models.conformer import Conformer as JaxConformer
from css_tpu.ops.features import FeatureExtractor as JaxFeatures
from css_tpu.trainer.checkpoint import load_checkpoint as jax_load
from css_tpu_torch.cli.separate import load_model
from css_tpu_torch.executor.pipeline import CssPipeline
from css_tpu_torch.ops.features import FeatureExtractor

FLAGSHIP = "checkpoints/h2ft_masksnr_best.mdl"
SEVEN_CH = "checkpoints/s7_mse_best.mdl"
IPD_7CH = "1,0;2,0;3,0;4,0;5,0;6,0"


def test_flagship_masks_match_float32():
    rng = np.random.default_rng(11)
    windows = (rng.standard_normal((2, 38656)) * 0.1).astype(np.float32)

    ck = jax_load(FLAGSHIP)
    conf = dict(ck["conf"], bf16=False)
    jm = JaxConformer.build_model(conf)
    _, feats = JaxFeatures()(jnp.asarray(windows))[:2]
    variables = {"params": ck["params"], "batch_stats": ck["batch_stats"]}
    _, want = jm.apply(variables, feats)

    model = load_model(FLAGSHIP)
    assert model.compute_dtype == torch.bfloat16  # the flagship's own conf
    model.compute_dtype = torch.float32
    _, tfeats = FeatureExtractor()(torch.as_tensor(windows))
    with torch.no_grad():
        _, got = model.eval()(tfeats)
    assert got.shape == (2, 150, 257, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3)


def test_7ch_masks_match_float32():
    """Two noise sources at 40 and 200 degrees on the 7-mic array with
    0.003 sensor noise (the checkpoint's training sensor noise), two
    windows 0.8 s apart."""
    rng = np.random.default_rng(12)
    n = 38656
    srcs = rng.standard_normal((2, n + 12800)) * 0.1
    rec = spatial_session(srcs, [40.0, 200.0], noise_level=0.003, seed=3)
    windows = np.stack([rec[:, :n], rec[:, 12800:12800 + n]]).astype(
        np.float32)

    ck = jax_load(SEVEN_CH)
    assert ck["conf"]["idim"] == 7 * 257
    conf = dict(ck["conf"], bf16=False)
    jm = JaxConformer.build_model(conf)
    _, feats, _ = JaxFeatures(ipd_index=IPD_7CH)(jnp.asarray(windows))
    variables = {"params": ck["params"], "batch_stats": ck["batch_stats"]}
    _, want = jm.apply(variables, feats)

    model = load_model(SEVEN_CH)
    assert model.compute_dtype == torch.bfloat16  # the checkpoint's conf
    model.compute_dtype = torch.float32
    _, tfeats = FeatureExtractor(ipd_index=IPD_7CH)(torch.as_tensor(windows))
    assert tfeats.shape == (2, 150, 7 * 257)
    with torch.no_grad():
        _, got = model.eval()(tfeats)
    assert got.shape == (2, 150, 257, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3)


@pytest.fixture(scope="module")
def seven_ch_models():
    """The 7ch checkpoint in both packages, float32."""
    ck = jax_load(SEVEN_CH)
    jm = JaxConformer.build_model(dict(ck["conf"], bf16=False))
    variables = {"params": ck["params"], "batch_stats": ck["batch_stats"]}
    model = load_model(SEVEN_CH)
    model.compute_dtype = torch.float32
    return jm, variables, model


def _voices_7ch(azimuths, seconds=8):
    """chip_smoke.py's two voices at ``azimuths`` with its sensor noise:
    the (7, T) recording and the (2, T) dry voices."""
    import chip_smoke

    _, srcs = chip_smoke.synthetic_session(seconds, 16000, chip_smoke.SEED)
    from css_tpu_torch.data.spatial import spatialize

    rec = spatialize(srcs, azimuths, noise_level=chip_smoke.SENSOR_NOISE,
                     rng=np.random.default_rng(7))
    return rec, srcs


def test_7ch_checkpoint_pipeline_matches_reference(seven_ch_models):
    import chip_smoke

    jm, variables, model = seven_ch_models
    rec, srcs = _voices_7ch(chip_smoke.AZIMUTHS_7CH)
    want = JaxPipeline(jm, variables, chip_smoke.CONFIG_7CH).process(rec)
    got = CssPipeline(model, chip_smoke.CONFIG_7CH, device="cpu").process(rec)
    for g, w in zip(got, want):
        assert g.shape == w.shape == rec.shape[1:]
        np.testing.assert_allclose(g, w, atol=1e-3)
    # the checkpoint separates this material, as chip_smoke.py requires on
    # its 60 s session (measured 17.1 dB here)
    sep = chip_smoke.best_pair_si_snr(got, srcs)
    mix = np.mean([chip_smoke.si_snr_db(rec[0], s_) for s_ in srcs])
    assert sep - mix >= chip_smoke.SI_SNRI_7CH_DB


def test_7ch_checkpoint_gap_lies_in_the_stitchers_ties(seven_ch_models):
    """One voice at 30 degrees: the separator's masks agree to 2e-3 with
    the same merge decisions and the same stitch permutations, and the
    port's stitcher and beamformer on css_tpu's masks give css_tpu's
    streams to 1e-3. The winner-take-all of the stitcher keeps each bin's
    largest mask, so where two masks lie within rounding of each other
    the packages can keep different ones: every bin where they do has its
    two largest masks within 2e-3 of each other (measured: masks 3.6e-4
    apart, 5 such bins, their two largest masks within 6.3e-5; streams
    2.7e-3 apart end to end, 2.6e-4 from the same masks)."""
    jm, variables, model = seven_ch_models
    import chip_smoke

    rec, _ = _voices_7ch((30.0, 150.0))
    jp = JaxPipeline(jm, variables, chip_smoke.CONFIG_7CH)
    pipe = CssPipeline(model, chip_smoke.CONFIG_7CH, device="cpu")
    wav = pad_for_windows(rec, jp.separator.win, jp.separator.hop)
    m_want, g_want = jp.separator.separate(wav)
    masks, mags = pipe.separator.separate(torch.as_tensor(wav))
    np.testing.assert_allclose(masks.numpy(), m_want, atol=2e-3)
    dead = np.float32(1e-12)
    np.testing.assert_array_equal(
        (masks[..., :2] == dead).all(dim=1).all(dim=1).numpy(),
        (m_want[..., :2] == dead).all(axis=(1, 2)))
    np.testing.assert_array_equal(
        pipe.stitcher.get_stitch(masks, mags).numpy(),
        np.asarray(jp.stitcher.get_stitch(m_want, g_want)))
    flips = masks.numpy().argmax(-1) != m_want.argmax(-1)
    top2 = np.sort(m_want, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0])[flips].max(initial=0.0) <= 2e-3

    want = jp.beamformer.continuous_process(
        wav, [np.asarray(m) for m in jp.stitcher(m_want, g_want)])
    got = pipe.beamformer.continuous_process(
        torch.as_tensor(wav), pipe.stitcher(torch.as_tensor(m_want),
                                            torch.as_tensor(g_want)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-3)
