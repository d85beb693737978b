"""The 1ch slice as a whole: CssPipeline of both packages on the same ~8 s
numpy session and the same small random-init Conformer, and the port's
separate CLI on the CPU.

Float32 end to end; every stage agrees to ~1e-6 relative, so the
peak-normalised (0.9) streams agree to 1e-4 absolute (measured ~1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

from css_tpu.data.corpus import SyntheticCorpus
from css_tpu.data.sessions import make_session
from css_tpu.executor.pipeline import CssPipeline as JaxPipeline
from css_tpu.models.conformer import Conformer as JaxConformer
from css_tpu.trainer.checkpoint import save_checkpoint_dict
from css_tpu_torch.data.wav_io import read_wav, write_wav
from css_tpu_torch.executor.pipeline import CssPipeline
from css_tpu_torch.models.conformer import Conformer, params_from_jax

CONF = {"conformer_attention_dim": 64, "conformer_attention_heads": 4,
        "conformer_linear_units": 128, "conformer_num_blocks": 2,
        "conformer_kernel_size": 7}


@pytest.fixture(scope="module")
def small_model():
    jm = JaxConformer.build_model(CONF)
    f = np.ones((1, 150, 257), np.float32)
    v = jax.tree.map(np.asarray,
                     jm.init({"params": jax.random.PRNGKey(2)},
                             jnp.asarray(f)))
    return jm, v


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


def test_pipeline_refuses_unported_options(small_model):
    tm = Conformer.build_model(CONF)
    for section, key, item in [("separation", "sharded", "item 10"),
                               ("stitching", "reanchor", "item 5b")]:
        config = _config()
        config[section][key] = True
        with pytest.raises(NotImplementedError, match=item):
            CssPipeline(tm, config, device="cpu")


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
    """Without beamforming.type the reference runs Souden MVDR; the port
    takes the same default, which raises until the 7ch slice lands."""
    jm, v = small_model
    config = _config()
    del config["beamforming"]["type"]
    short = session[:48000]
    want = JaxPipeline(jm, v, config).process(short)
    assert len(want) == 2 and all(np.isfinite(w).all() for w in want)
    tm = Conformer.build_model(CONF)
    with pytest.raises(NotImplementedError, match="item 6"):
        CssPipeline(tm, config, device="cpu")


def test_pipeline_refuses_ipd_features(small_model):
    """IPD features read every channel: the 7ch slice (item 6)."""
    tm = Conformer.build_model(CONF)
    config = _config()
    config["separation"]["ipd"] = "1,0;2,0"
    with pytest.raises(NotImplementedError, match="item 6"):
        CssPipeline(tm, config, device="cpu")


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
