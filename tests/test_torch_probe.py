"""The held-out probe (``trainer/probe.py``), the synthetic sessions and
the metrics against css_tpu's, on the CPU.

Small models from css_tpu's initialisers: a Conformer of 2 blocks x 64
(kernel 7; 257 inputs, 1799 for the 7ch features), a Conv-TasNet of 2 x 2
blocks of 32 channels. Two sessions of 6 s from a held-out corpus seed.

Tolerances:
  * sessions, the probe's windows, mixtures and references, and the
    metrics: bit for bit / 1e-12 (the same numpy code in float64);
  * SI-SNRi: 0.02 dB of css_tpu's;
  * stitched masks: 1e-4 absolute from the same per-window masks
    (css_tpu's fed to the port's stitcher; float32 summed in another
    order, as tests/test_torch_executor.py). From each package's own
    masks, MASK_ATOL on every time-frequency bin but the located gap
    below (an overlap-average of per-window masks is as close as they
    are).
The located gap. The two packages' float32 STFT magnitudes differ by
~5e-6 absolute; the per-bin MVN of the features divides that by the bin's
standard deviation over the window, ~5e-4 near 8 kHz on this corpus, so
the features differ by up to ~4e-3 and the per-window masks by up to
~2e-3 (MASK_ATOL holds them to 5e-3). Where a window's two largest masks
are closer than that, the winner-take-all picks another stream, and the
stitched masks of the frames and bins that window covers differ by up to
~0.9. The test finds every such flip, checks that css_tpu's top two masks
there are within twice the largest per-window mask difference (a near
tie), and holds the stitched masks to MASK_ATOL everywhere else.
The probe must leave the model as it found it: its mode, its dropout
generator's state and its BatchNorm statistics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from css_tpu.data import sessions as jsessions
from css_tpu.data.corpus import SyntheticCorpus as JCorpus
from css_tpu.models import conformer as jc
from css_tpu.models import conv_tasnet as jt
from css_tpu.trainer import probe as jprobe
from css_tpu.utils import metrics as jmetrics
from css_tpu_torch.data import sessions as tsessions
from css_tpu_torch.data.corpus import SyntheticCorpus as TCorpus
from css_tpu_torch.models import build_model, from_jax
from css_tpu_torch.models.conformer import set_dropout_generator
from css_tpu_torch.trainer import probe as tprobe
from css_tpu_torch.utils import metrics as tmetrics

IPD_7CH = "1,0;2,0;3,0;4,0;5,0;6,0"
CONFORMER = {"conformer_attention_dim": 64, "conformer_attention_heads": 4,
             "conformer_linear_units": 128, "conformer_num_blocks": 2,
             "conformer_kernel_size": 7, "conformer_dropout_rate": 0.1}
TASNET = {"conv_tasnet_num_filters": 32, "conv_tasnet_conv_channels": 32,
          "conv_tasnet_bottleneck_channels": 16, "conv_tasnet_num_blocks": 2,
          "conv_tasnet_num_layers": 2}
CORPUS = dict(num_speakers=4, utts_per_speaker=3, seed=456)
PROBE = dict(sessions=2, session_sec=6.0, seed=456)
MASK_ATOL = 5e-3


@pytest.mark.parametrize("pair,k", [(None, 2), ("pair", 2), (None, 3)])
def test_sessions_bit_equal(pair, k):
    j, t = JCorpus(**CORPUS), TCorpus(**CORPUS)
    forced = tuple(j.speakers[1:3]) if pair else None
    a, b = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(2):
        want = jsessions.make_session(j, a, 8.0, pair=forced, num_spk=k)
        got = tsessions.make_session(t, b, 8.0, pair=forced, num_spk=k)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    # the rng is consumed the same way with and without a forced pair
    assert a.integers(2**31) == b.integers(2**31)


def test_metrics_match():
    rng = np.random.default_rng(1)
    refs = rng.standard_normal((2, 4000))
    ests = refs[::-1] + 0.3 * rng.standard_normal((2, 4000))
    mix = refs.sum(0)
    for fn, args in ((tmetrics.si_snr_db, (ests[0], refs[1])),
                     (tmetrics.pit_si_snr_db, (ests, refs)),
                     (tmetrics.si_snr_improvement_db, (ests, refs, mix))):
        want = getattr(jmetrics, fn.__name__)(*args)
        assert abs(fn(*args) - want) <= 1e-12


def _models(kind):
    """(css_tpu model, its variables, the port's model) on one weights."""
    if kind == "time":
        jm = jt.ConvTasNet.build_model(TASNET)
        x = jnp.zeros((1, 4000), jnp.float32)
        v = jax.tree.map(np.asarray, jax.jit(jm.init)(
            jax.random.PRNGKey(3), x))
        tm = build_model("ConvTasNet", TASNET)
        tm.load_state_dict(from_jax(tm, v["params"]))
        return jm, v, tm
    conf = dict(CONFORMER, idim=257 * (7 if kind == "spatial" else 1))
    jm = jc.Conformer.build_model(conf)
    x = jnp.zeros((1, 20, conf["idim"]), jnp.float32)
    v = jax.tree.map(np.asarray, jax.jit(jm.init)(
        {"params": jax.random.PRNGKey(2)}, x))
    rng = np.random.default_rng(5)
    v["batch_stats"] = jax.tree.map(  # running statistics off their init
        lambda a: a + rng.uniform(0.1, 0.3, a.shape).astype(np.float32),
        v["batch_stats"])
    tm = build_model("Conformer", conf)
    tm.load_state_dict(from_jax(tm, v["params"], v["batch_stats"]))
    return jm, v, tm


def _probes(mode):
    kw = dict(PROBE, mode=mode,
              ipd_index=IPD_7CH if mode == "spatial" else None)
    return (jprobe.HeldOutProbe(JCorpus(**CORPUS), **kw),
            tprobe.HeldOutProbe(TCorpus(**CORPUS), device="cpu", **kw))


def _jax_masks(jp, apply, s):
    mag, f, _ = jp.features(jp.windows[s])
    return np.asarray(jnp.minimum(apply(f)[1], 1.0)), mag


def _flipped_bins(tp, got, want):
    """(T_total, F) bool: the frames and bins of every window, frame and
    bin where the two packages' per-window masks have different sets of
    largest streams (the winner-take-all keeps every stream equal to the
    largest, as two masks clamped at 1); each must be a near tie in
    css_tpu's masks."""
    diff = np.abs(got - want).max()
    flips = ((got == got.max(-1, keepdims=True))
             != (want == want.max(-1, keepdims=True))).any(-1)  # (W, T, F)
    top2 = np.sort(want, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0])[flips].max(initial=0.0) <= 2 * diff
    w, t, f = want.shape[:3]
    hop = tp.stitcher.hop_frames
    out = np.zeros(((w - 1) * hop + t, f), bool)
    for wi, ti, fi in zip(*np.nonzero(flips)):
        out[wi * hop + ti, fi] = True
    return out


@pytest.mark.parametrize("mode", ["mask", "spatial", "time"])
def test_probe_matches(mode):
    jp, tp = _probes(mode)
    for name in ("mixes", "refs", "windows") + (
            ("ref_windows",) if mode == "time" else ()):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)))
    assert tp.total == jp.total
    jm, v, tm = _models(mode)
    if mode != "time":
        with torch.no_grad():
            stitched, _ = tp.stitched_masks(tm.eval())
            s, w = tp.windows.shape[:2]
            _, feats = tp.features(tp.windows.reshape(
                (s * w,) + tuple(tp.windows.shape[2:])))
            own = torch.clamp(tm(feats)[1], max=1.0).reshape(
                s, w, *feats.shape[1:2], -1, 3).numpy()
        apply = jax.jit(lambda f: jm.apply(v, f, train=False))
        for si in range(s):
            want_masks, jmag = _jax_masks(jp, apply, si)
            want = [np.asarray(m) for m in
                    jp.stitcher._stitch_impl(want_masks, jmag)]
            np.testing.assert_allclose(own[si], want_masks, atol=MASK_ATOL)
            # the port's stitcher on css_tpu's masks
            same = tp.stitcher(torch.tensor(want_masks),
                               torch.tensor(np.asarray(jmag)))
            for g, wnt in zip(same, want):
                np.testing.assert_allclose(g.numpy(), wnt, atol=1e-4)
            # each package on its own masks, the located flips left out
            keep = ~_flipped_bins(tp, own[si], want_masks)
            assert keep.mean() > 0.99
            for g, wnt in zip(stitched[si], want):
                np.testing.assert_allclose(g.numpy()[keep], wnt[keep],
                                           atol=MASK_ATOL)
    got, want = tp(tm), jp(jm, v)
    assert np.isfinite(got)
    assert abs(got - want) <= 0.02, (got, want)


def test_probe_leaves_the_model_as_it_found_it():
    _, tp = _probes("mask")
    _, _, tm = _models("mask")
    gen = torch.Generator().manual_seed(11)
    set_dropout_generator(tm, gen)
    tm.train()
    state = {k: v.clone() for k, v in tm.state_dict().items()}
    gen_state = gen.get_state()
    assert np.isfinite(tp(tm))
    assert tm.training
    assert torch.equal(gen.get_state(), gen_state)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, state[k]), k
    tm.eval()
    tp(tm)
    assert not tm.training
