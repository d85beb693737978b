"""The slices as a whole: CssPipeline of both packages on the same numpy
recordings and the same small random-init Conformers (1ch: an ~8 s
session; 7ch: the JAX package's own 6 s 7ch fixture), with and without
stream re-anchoring, and the port's separate CLI on the CPU.

Float32 end to end. 1ch: every stage agrees to ~1e-6 relative, so the
peak-normalised (0.9) streams agree to 1e-4 absolute (measured ~1e-6).
7ch: SEVEN_CH_ATOL = 1e-3 absolute on the 0.9-peak streams. The Souden
MVDR solves amplify float32 rounding by the noise SCMs' condition
number, and the IPD angles carry the phase noise of small bins. On the
JAX package's own 7ch fixture (tests/test_7ch_pipeline.py) the port is
held to SEVEN_CH_ATOL under init key 2, the 1ch tests' key (measured
2.6e-4), and key 0, the JAX 7ch tests' own (measured 8.2e-4). Under key 1
float32 does not decide the streams: the noise SCMs' condition numbers
reach 6.6e6, css_tpu itself is 2.8e-2 from a float64 evaluation of its
beamformer, and one ulp of change to its input moves its streams by
2.9e-2. There the port (1.6e-2 from css_tpu) is held to lie within
css_tpu's own spread, and upstream of the beamformer to the tolerances
of the separator test (tests/test_torch_executor.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from css_tpu.data.corpus import SyntheticCorpus
from css_tpu.data.sessions import make_session
from css_tpu.executor.pipeline import CssPipeline as JaxPipeline
from css_tpu.executor.windowing import pad_for_windows, unfold
from css_tpu.models.conformer import Conformer as JaxConformer
from css_tpu.trainer.checkpoint import save_checkpoint_dict
from css_tpu_torch.data.wav_io import read_wav, write_wav
from css_tpu_torch.executor.pipeline import CssPipeline
from css_tpu_torch.models.conformer import Conformer, params_from_jax

CONF = {"conformer_attention_dim": 64, "conformer_attention_heads": 4,
        "conformer_linear_units": 128, "conformer_num_blocks": 2,
        "conformer_kernel_size": 7}
CONF_7CH = dict(CONF, idim=7 * 257)
SEVEN_CH_ATOL = 1e-3


@pytest.fixture(scope="module")
def small_model():
    jm = JaxConformer.build_model(CONF)
    f = np.ones((1, 150, 257), np.float32)
    v = jax.tree.map(np.asarray,
                     jm.init({"params": jax.random.PRNGKey(2)},
                             jnp.asarray(f)))
    return jm, v


def _model_7ch(key):
    jm = JaxConformer.build_model(CONF_7CH)
    f = np.ones((1, 150, 7 * 257), np.float32)
    v = jax.tree.map(np.asarray,
                     jm.init({"params": jax.random.PRNGKey(key)},
                             jnp.asarray(f)))
    return jm, v


@pytest.fixture(scope="module")
def small_model_7ch():
    return _model_7ch(2)


def _torch_model(v, conf=CONF):
    tm = Conformer.build_model(conf)
    tm.load_state_dict(params_from_jax(v["params"], v["batch_stats"]))
    return tm


@pytest.fixture(scope="module")
def recording_7ch():
    from tests.test_7ch_pipeline import _make_7ch_recording

    return _make_7ch_recording(seconds=6)


def _config_7ch(batch_size=4, reanchor=False):
    with open("configs/infer_7ch.yaml") as fh:
        config = yaml.safe_load(fh)
    config["separation"]["batch_size"] = batch_size
    config["stitching"]["reanchor"] = reanchor
    return config


@pytest.fixture(scope="module")
def session():
    corpus = SyntheticCorpus(num_speakers=4, utts_per_speaker=3, min_dur=1.5,
                             max_dur=3.0, seed=5, voice="formant")
    mix, _ = make_session(corpus, np.random.default_rng(6), 8.0)
    return mix


def _config(batch_size=4):
    with open("configs/infer_1ch.yaml") as fh:
        config = yaml.safe_load(fh)
    config["separation"]["batch_size"] = batch_size
    return config


def test_pipeline_matches_reference(small_model, session, tmp_path):
    jm, v = small_model
    want = JaxPipeline(jm, v, _config()).process(session)
    tm = Conformer.build_model(CONF)
    tm.load_state_dict(params_from_jax(v["params"], v["batch_stats"]))
    pipe = CssPipeline(tm, _config(), device="cpu")
    got = pipe.process_recording("rec", session, tmp_path)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape == session.shape and g.dtype == np.float32
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=1e-4)
        assert abs(np.abs(g).max() - 0.9) < 1e-5
    back, sr = read_wav(tmp_path / "rec_0.wav")
    assert sr == 16000 and back.shape == session.shape
    # 16-bit PCM: truncation (1/32767) plus the 32767-in, 32768-out scale
    np.testing.assert_allclose(back, got[0], atol=2.0 / 32767)


def test_pipeline_refuses_unported_options(small_model, session):
    """``separation.sharded: true``, once refused, is now the port of the
    JAX package's sharded pipeline: its windows split over 8 shards (the
    JAX package's 8-device mesh; the port's 8 shards on the CPU), and the
    same streams as css_tpu's sharded pipeline and as the port's
    default path."""
    jm, v = small_model
    config = _config()
    config["separation"]["sharded"] = True
    want = JaxPipeline(jm, v, config).process(session)
    tm = _torch_model(v)
    pipe = CssPipeline(tm, config, device="cpu", shard_devices=["cpu"] * 8)
    assert pipe.sharded is not None and pipe.sharded.n_shards == 8
    got = pipe.process(session)
    default = CssPipeline(_torch_model(v), _config(),
                          device="cpu").process(session)
    assert len(got) == len(want) == 2
    for g, w, d in zip(got, want, default):
        assert g.shape == w.shape == session.shape
        np.testing.assert_allclose(g, w, atol=1e-4)
        np.testing.assert_allclose(g, d, atol=1e-4)


def test_multichannel_recording_separates_channel_0(small_model, session):
    """A (C, T) recording under the 1ch config: the reference separates it
    from channel 0 (features and masking beamformer read channel 0 only);
    the port must give the same streams."""
    jm, v = small_model
    rng = np.random.default_rng(7)
    others = 0.1 * rng.standard_normal((2, session.shape[0]))
    rec = np.concatenate([session[None], others.astype(np.float32)])
    want = JaxPipeline(jm, v, _config()).process(rec)
    tm = Conformer.build_model(CONF)
    tm.load_state_dict(params_from_jax(v["params"], v["batch_stats"]))
    got = CssPipeline(tm, _config(), device="cpu").process(rec)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape == session.shape
        np.testing.assert_allclose(g, w, atol=1e-4)


def test_default_beamformer_is_the_references(small_model, session):
    """Without beamforming.type the reference runs Souden MVDR (on one
    channel, an energy rescale of the mixture); the port takes the same
    default and gives the same streams."""
    jm, v = small_model
    config = _config()
    del config["beamforming"]["type"]
    short = session[:48000]
    want = JaxPipeline(jm, v, config).process(short)
    assert len(want) == 2 and all(np.isfinite(w).all() for w in want)
    pipe = CssPipeline(_torch_model(v), config, device="cpu")
    assert pipe.beamformer.bf_type == "souden_mvdr"
    got = pipe.process(short)
    for g, w in zip(got, want):
        assert g.shape == w.shape == short.shape
        np.testing.assert_allclose(g, w, atol=1e-4)


def test_pipeline_refuses_ipd_features(small_model_7ch, session):
    """IPD features read every channel: a config with IPD refuses a 1ch
    recording, as the reference does (both raise ValueError)."""
    jm, v = small_model_7ch
    config = _config_7ch()
    with pytest.raises(ValueError, match="multi-channel"):
        JaxPipeline(jm, v, config).process(session[:48000])
    pipe = CssPipeline(_torch_model(v, CONF_7CH), config, device="cpu")
    assert pipe.reads_all_channels
    with pytest.raises(ValueError, match="multi-channel"):
        pipe.process(session[:48000])


def _check_7ch_pipeline(jm, v, rec, reanchor):
    config = _config_7ch(reanchor=reanchor)
    want = JaxPipeline(jm, v, config).process(rec)
    pipe = CssPipeline(_torch_model(v, CONF_7CH), config, device="cpu")
    assert pipe.reanchor == reanchor
    got = pipe.process(rec)
    assert int(pipe.separator.merge_kills) >= 0
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape == rec.shape[1:]
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=SEVEN_CH_ATOL)


@pytest.mark.parametrize("reanchor", [False, True],
                         ids=["plain", "reanchor"])
def test_7ch_pipeline_matches_reference(small_model_7ch, recording_7ch,
                                        reanchor):
    """configs/infer_7ch.yaml (IPD, DOA merge, Souden MVDR) on a (7, T)
    recording."""
    jm, v = small_model_7ch
    _check_7ch_pipeline(jm, v, recording_7ch, reanchor)


@pytest.mark.parametrize("reanchor", [False, True],
                         ids=["plain", "reanchor"])
def test_7ch_pipeline_at_the_reference_key(recording_7ch, reanchor):
    """As above, under init key 0, the key of the JAX package's own 7ch
    tests (measured 8.2e-4)."""
    jm, v = _model_7ch(0)
    _check_7ch_pipeline(jm, v, recording_7ch, reanchor)


def _gap(a, b):
    return max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
               for x, y in zip(a, b))


def _nudged(x, rng):
    """x with every entry moved by one ulp, up or down at random."""
    to = np.where(rng.random(x.shape) < 0.5, -np.inf, np.inf)
    return np.nextafter(x, to.astype(x.dtype)).astype(x.dtype)


def _mvdr_streams_f64(wav, masks, n_fft=512, hop=256):
    """The Souden MVDR continuous beamformer of both packages, written
    anew in numpy float64 from its definition: centered STFT (reflect
    padding, periodic Hann), masks moved one frame onto the centered
    frames with the edges replicated, SCMs with 1e-15 diagonal loading,
    W = solve(noise, target)[:, 0] / (trace + 1e-15), the output rescaled
    to the masked channel 0's energy, dedup (15 dB, -40 dB floor), the
    centered iSTFT (window-envelope normalised where it is >= 1e-2), the
    proceed-margin assembly and the 0.9 peak normalisation."""
    win, step, margin = 38656, 12800, 32000
    total = wav.shape[-1]
    ww = unfold(np.asarray(wav, np.float64), win, step)  # (B, D, N)
    mw = [unfold(np.asarray(m, np.float64).T, 150, 50).transpose(0, 2, 1)
          for m in masks]  # (B, T, F) each
    b = min([ww.shape[0]] + [m.shape[0] for m in mw])
    ww, mw = ww[:b], [m[:b] for m in mw]
    pad, w = n_fft // 2, 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft)
                                             / n_fft)
    xp = np.pad(ww, [(0, 0), (0, 0), (pad, pad)], mode="reflect")
    n_frames = (xp.shape[-1] - n_fft) // hop + 1
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None]
    x = np.fft.rfft(xp[..., idx] * w, axis=-1)  # (B, D, T', F)
    t = x.shape[2]
    shift = np.clip(np.arange(t) - 1, 0, mw[0].shape[1] - 1)
    speech = np.stack(mw[:-1], axis=1)[:, :, shift]  # (B, K, T', F)
    noise = mw[-1][:, None, shift]

    def scm(m):
        return (np.einsum("bctf,bdtf,bktf->bkfcd", x, x.conj(), m)
                + 1e-15 * np.eye(x.shape[1]))

    tgt = scm(speech)
    num = np.linalg.solve(np.broadcast_to(scm(noise), tgt.shape), tgt)
    wts = num[..., 0] / (np.trace(num, axis1=-2, axis2=-1)[..., None]
                         + 1e-15)
    out = np.einsum("bctf,bkfc->bktf", x, wts.conj())
    target_e = np.sqrt(np.mean(np.abs(speech * x[:, None, 0]) ** 2,
                               axis=(2, 3), keepdims=True))
    out_e = np.sqrt(np.mean(np.abs(out) ** 2, axis=(2, 3), keepdims=True))
    out = out / np.maximum(out_e, 1e-12) * target_e
    pow_db = 10 * np.log10(np.sum(np.abs(out) ** 2, axis=(2, 3)) + 1e-30)
    gain = np.abs(out) / np.maximum(np.abs(out).max(axis=1, keepdims=True),
                                    1e-30)
    duck = (pow_db.max(axis=1, keepdims=True) - pow_db > 15.0)
    out = np.where(duck[:, :, None, None],
                   np.maximum(gain, 10 ** (-40 / 20)) * out, out)
    frames = np.fft.irfft(out, n_fft, axis=-1) * w  # (B, K, T', n_fft)
    length = (t - 1) * hop + n_fft
    sig, env = np.zeros(out.shape[:2] + (length,)), np.zeros(length)
    for i in range(t):
        sig[..., i * hop:i * hop + n_fft] += frames[:, :, i]
        env[i * hop:i * hop + n_fft] += w * w
    sig = np.where(env >= 1e-2, sig / np.maximum(env, 1e-2), 0.0)
    sig = sig[..., pad:length - pad]
    n = ww.shape[-1]
    sig = np.pad(sig, [(0, 0)] * 2 + [(0, max(0, n - sig.shape[-1]))])
    outs = []
    for k in range(sig.shape[1]):
        wk = sig[:b, k, :n]
        lo = margin - step
        res = (wk[0, :total] if b == 1 else np.concatenate(
            [wk[0, :margin], wk[1:-1, lo:margin].reshape(-1), wk[-1, lo:]]))
        res = np.pad(res[:total], (0, max(0, total - res.shape[0])))
        outs.append(res * 0.9 / max(np.abs(res).max(), 1e-12))
    return outs


def _reference_stitched(jm, v, rec):
    """css_tpu's padded recording and its stitched masks under the 7ch
    config."""
    jp = JaxPipeline(jm, v, _config_7ch())
    wav = pad_for_windows(rec, jp.separator.win, jp.separator.hop)
    masks, mags = jp.separator.separate(wav)
    return jp, wav, [np.asarray(m) for m in jp.stitcher(masks, mags)]


@pytest.mark.parametrize("key", [0, 2])
def test_7ch_beamformer_matches_float64(recording_7ch, key):
    """Where float32 decides the streams (init keys 0 and 2), the port's
    beamformer on css_tpu's stitched masks lies within SEVEN_CH_ATOL of
    a float64 evaluation written from the definition, sharing no code
    with either package, and so does css_tpu's (measured: the port 5.2e-4
    and 3.1e-4, css_tpu 2.7e-4 and 1.5e-4)."""
    jp, wav, stitched = _reference_stitched(*_model_7ch(key), recording_7ch)
    exact = _mvdr_streams_f64(wav, stitched)
    want = jp.beamformer.continuous_process(wav, stitched)
    got = CssPipeline(_torch_model(_model_7ch(key)[1], CONF_7CH),
                      _config_7ch(), device="cpu").beamformer.\
        continuous_process(torch.as_tensor(wav),
                           [torch.as_tensor(m) for m in stitched])
    assert _gap(want, exact) <= SEVEN_CH_ATOL
    assert _gap([g.numpy() for g in got], exact) <= SEVEN_CH_ATOL


def test_7ch_where_float32_does_not_decide(recording_7ch):
    """Init key 1: the port's streams are 1.6e-2 from css_tpu's. The
    separator's masks still agree to 1e-3 with equal merge decisions, so
    the gap arises in the beamformer, whose noise SCMs reach condition
    numbers of 6.6e6: css_tpu itself lies 2.8e-2 from the float64
    evaluation, and one ulp of change to its masks or to its recording
    moves its own streams by 4.2e-2 or 2.9e-2 (measured). The port is held
    to lie within that spread, at both points."""
    jm, v = _model_7ch(1)
    jp, wav, stitched = _reference_stitched(jm, v, recording_7ch)
    pipe = CssPipeline(_torch_model(v, CONF_7CH), _config_7ch(),
                       device="cpu")
    m_want, _ = jp.separator.separate(wav)
    masks, _ = pipe.separator.separate(torch.as_tensor(wav))
    np.testing.assert_allclose(masks.numpy(), m_want, atol=1e-3)
    dead = np.float32(1e-12)
    np.testing.assert_array_equal(
        (masks[..., :2] == dead).all(dim=1).all(dim=1).numpy(),
        (m_want[..., :2] == dead).all(axis=(1, 2)))

    want_bf = jp.beamformer.continuous_process(wav, stitched)
    assert _gap(want_bf, _mvdr_streams_f64(wav, stitched)) > 1e-2
    rng = np.random.default_rng(0)
    spread_bf = _gap(jp.beamformer.continuous_process(
        wav, [_nudged(m, rng) for m in stitched]), want_bf)
    got_bf = pipe.beamformer.continuous_process(
        torch.as_tensor(wav), [torch.as_tensor(m) for m in stitched])
    assert _gap([g.numpy() for g in got_bf], want_bf) <= spread_bf

    want = jp.process(recording_7ch)
    spread = _gap(jp.process(_nudged(recording_7ch, rng)), want)
    assert spread > SEVEN_CH_ATOL
    assert _gap(pipe.process(recording_7ch), want) <= spread


def test_1ch_pipeline_with_reanchor_matches_reference(small_model, session):
    """stitching.reanchor on the 1ch path (masking): the host pass sees
    the same streams in both packages, so 1e-4 holds as without it."""
    jm, v = small_model
    config = _config()
    config["stitching"]["reanchor"] = True
    want = JaxPipeline(jm, v, config).process(session)
    got = CssPipeline(_torch_model(v), config, device="cpu").process(session)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4)


def test_separate_cli_on_cpu(small_model, session, tmp_path):
    from css_tpu_torch.cli import separate

    jm, v = small_model
    ckpt = tmp_path / "model.mdl"
    save_checkpoint_dict(str(ckpt), {"params": v["params"],
                                     "batch_stats": v["batch_stats"],
                                     "conf": CONF})
    cfg = tmp_path / "infer.yaml"
    cfg.write_text(yaml.safe_dump(_config()))
    recs = tmp_path / "recs"
    recs.mkdir()
    write_wav(recs / "sessA.wav", session)
    write_wav(recs / "sessB.wav", session[:40000])
    out = tmp_path / "out"
    separate.main(["--config", str(cfg), "--checkpoint", str(ckpt),
                   "--corpus-dir", str(recs), "--out-dir", str(out),
                   "--session", "sessA", "--device", "cpu"])
    assert sorted(p.name for p in out.iterdir()) == ["sessA_0.wav",
                                                     "sessA_1.wav"]
    got, sr = read_wav(out / "sessA_1.wav")
    assert got.shape == session.shape and np.isfinite(got).all()
    want = JaxPipeline(jm, v, _config()).process(read_wav(recs / "sessA.wav")[0])
    np.testing.assert_allclose(got, want[1], atol=2.0 / 32767)  # as above


def test_separate_cli_7ch_on_cpu(small_model_7ch, recording_7ch, tmp_path):
    """A 7-channel wav through the CLI: read as (7, T), separated under
    configs/infer_7ch.yaml, against css_tpu on the same read wav. The
    written streams are 16-bit PCM: SEVEN_CH_ATOL plus two PCM steps."""
    from css_tpu_torch.cli import separate

    jm, v = small_model_7ch
    ckpt = tmp_path / "model7.mdl"
    save_checkpoint_dict(str(ckpt), {"params": v["params"],
                                     "batch_stats": v["batch_stats"],
                                     "conf": CONF_7CH})
    cfg = tmp_path / "infer7.yaml"
    cfg.write_text(yaml.safe_dump(_config_7ch()))
    recs = tmp_path / "recs"
    recs.mkdir()
    write_wav(recs / "sess7.wav", recording_7ch)
    read, _ = read_wav(recs / "sess7.wav")
    assert read.shape == recording_7ch.shape
    out = tmp_path / "out"
    separate.main(["--config", str(cfg), "--checkpoint", str(ckpt),
                   "--corpus-dir", str(recs), "--out-dir", str(out),
                   "--device", "cpu"])
    assert sorted(p.name for p in out.iterdir()) == ["sess7_0.wav",
                                                     "sess7_1.wav"]
    want = JaxPipeline(jm, v, _config_7ch()).process(read)
    for i in range(2):
        got, sr = read_wav(out / f"sess7_{i}.wav")
        assert sr == 16000 and got.shape == read.shape[1:]
        np.testing.assert_allclose(got, want[i],
                                   atol=SEVEN_CH_ATOL + 2.0 / 32767)
