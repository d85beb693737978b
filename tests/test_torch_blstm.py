"""The ported BLSTM against the Flax one; cumulative_mvn; the 1ch pipeline
and the separate CLI with a BLSTM through both packages.

Small size (hidden 256, i.e. 128 per direction, 2 layers). Flax
random-init parameters, with the zero biases and unit LayerNorm scales
drawn away from their init values, are carried across by
``params_from_jax``; inputs come from numpy seeds.

Tolerances. float32: the JAX package pins float32 matmuls to full
precision, so only summation order differs: 1e-4 absolute and relative on
masks of order 1-5 (measured < 2e-5). bfloat16: the JAX package's CPU
path (its scan) keeps the LSTM cell state c in bf16, while the port runs
the TPU kernel's numerics (c in float32, only h rounded to bf16), and the
two round the input projections and LayerNorm outputs at other places:
they differ by about as much as bf16 differs from float32 (measured max
0.035, mean 3e-3 on masks up to 4.4): 0.1 max and 1e-2 mean absolute, the
Conformer's bf16 bounds.
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
from css_tpu.models import blstm as jb
from css_tpu.ops import features as jf
from css_tpu.trainer.checkpoint import save_checkpoint_dict
from css_tpu_torch.data.wav_io import read_wav, write_wav
from css_tpu_torch.executor.pipeline import CssPipeline
from css_tpu_torch.models import blstm as tb
from css_tpu_torch.models import build_model
from css_tpu_torch.ops import features as tf

CONF = {"blstm_hdim": 256, "blstm_num_layers": 2}
ATOL = RTOL = 1e-4


def _flax_params(conf, seed):
    """Flax init, with every bias and LayerNorm parameter moved off its
    init value (zeros and ones would hide a mislabelled one)."""
    rng = np.random.default_rng(seed)
    f = np.ones((1, 20, 257), np.float32)
    v = jb.BLSTM.build_model(conf).init(
        {"params": jax.random.PRNGKey(seed)}, jnp.asarray(f))

    def perturb(path, a):
        a = np.asarray(a, np.float32)
        name = jax.tree_util.keystr(path)
        if "'b_" in name or "bias" in name or "scale" in name:
            a = a + rng.uniform(-0.3, 0.3, a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(perturb, v["params"])


@pytest.fixture(scope="module")
def params():
    return _flax_params(CONF, 0)


def _f(shape, seed):
    return np.abs(np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32)


def _both(conf, params, f):
    jm = jb.BLSTM.build_model(conf)
    y_want, m_want = jm.apply({"params": params}, jnp.asarray(f))
    tm = build_model("BLSTM", conf)
    tm.load_state_dict(tb.params_from_jax(params))
    with torch.no_grad():
        y_got, m_got = tm.eval()(torch.as_tensor(f))
    return (y_got.numpy(), m_got.numpy(), np.asarray(y_want),
            np.asarray(m_want), tm)


def test_params_from_jax_covers_the_model(params):
    sd = tb.params_from_jax(params)
    tm = tb.BLSTM.build_model(CONF)
    assert set(sd) == set(tm.state_dict())
    assert sd["encoders.1.w_ih_bwd"].shape == (512, 256)
    assert sd["encoders.0.w_hh_fwd"].shape == (512, 128)
    assert sd["embed_linear.weight"].shape == (256, 257)
    assert sd["linear.weight"].shape == (771, 256)
    np.testing.assert_array_equal(sd["linear.weight"].numpy(),
                                  params["linear"]["kernel"].T)
    np.testing.assert_array_equal(sd["encoders.1.layer_norm.weight"].numpy(),
                                  params["encoders_1"]["layer_norm"]["scale"])


@pytest.mark.parametrize("t", [40, 150])
def test_blstm_matches_float32(params, t):
    y, m, y_want, m_want, _ = _both(CONF, params, _f((2, t, 257), t))
    assert m.shape == (2, t, 257, 3) and y.shape == (2, 2, t, 257)
    np.testing.assert_allclose(m, m_want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(y, y_want, atol=ATOL, rtol=RTOL)


def test_blstm_matches_bfloat16(params):
    conf = dict(CONF, bf16=True)
    f = _f((2, 150, 257), 5)
    y, m, y_want, m_want, tm = _both(conf, params, f)
    assert tm.compute_dtype == torch.bfloat16 and m.dtype == np.float32
    np.testing.assert_allclose(m, m_want, atol=0.1)
    assert np.abs(m - m_want).mean() < 1e-2
    # and bf16 is not silently float32
    m32 = _both(CONF, params, f)[1]
    assert np.abs(m32 - m).max() > 1e-4


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bfloat16"])
def test_causal_offline_forward_matches(bf16):
    conf = dict(CONF, blstm_causal=True, bf16=bf16)
    params = _flax_params(conf, 1)
    assert params["encoders_0"]["w_hh_fwd"].shape == (1024, 256)
    assert "w_hh_bwd" not in params["encoders_0"]
    f = _f((2, 60, 257), 6)
    y, m, y_want, m_want, _ = _both(conf, params, f)
    if bf16:
        np.testing.assert_allclose(m, m_want, atol=0.1)
        assert np.abs(m - m_want).mean() < 1e-2
    else:
        np.testing.assert_allclose(m, m_want, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(y, y_want, atol=ATOL, rtol=RTOL)
    # causal: the first frames do not see the later ones
    tm = build_model("BLSTM", conf)
    tm.load_state_dict(tb.params_from_jax(params))
    g = f.copy()
    g[:, 30:] *= 3.0
    with torch.no_grad():
        m_cut = tm.eval()(torch.as_tensor(g))[1].numpy()
    np.testing.assert_array_equal(m_cut[:, :30], m[:, :30])


def test_cumulative_mvn_matches():
    x = np.random.default_rng(2).gamma(2.0, 1.0, (3, 50, 20)).astype(
        np.float32)
    out_w, carry_w = jf.cumulative_mvn(jnp.asarray(x))
    out, carry = tf.cumulative_mvn(torch.as_tensor(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_w), atol=ATOL,
                               rtol=RTOL)
    for a, b in zip(carry, carry_w):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5)
    # with a carry: the second chunk of a chained pair, both packages, and
    # the chain equals the whole
    first, c1 = tf.cumulative_mvn(torch.as_tensor(x[:, :20]))
    second, _ = tf.cumulative_mvn(torch.as_tensor(x[:, 20:]), c1)
    _, c1_w = jf.cumulative_mvn(jnp.asarray(x[:, :20]))
    second_w, _ = jf.cumulative_mvn(jnp.asarray(x[:, 20:]), c1_w)
    np.testing.assert_allclose(second.numpy(), np.asarray(second_w),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(torch.cat([first, second], 1).numpy(),
                               out.numpy(), atol=ATOL, rtol=RTOL)


def test_init_params_families():
    conf = dict(CONF, blstm_causal=False)
    p = tb.init_params(3, conf)
    flax_shapes = jax.tree.map(np.shape, _flax_params(conf, 0))
    assert jax.tree.map(np.shape, p) == flax_shapes
    assert jax.tree.map(lambda a: a.dtype, p) == jax.tree.map(
        lambda a: np.dtype(np.float32), p)
    w_hh = p["encoders_1"]["w_hh_bwd"]  # (4h, h), orthonormal columns
    np.testing.assert_allclose(w_hh.T @ w_hh, np.eye(128), atol=1e-5)
    w_ih = p["encoders_0"]["w_ih_fwd"]  # flax's fan_in: axis -2 (4h = 512)
    assert abs(w_ih.std() - np.sqrt(1 / 512)) < 0.05 * np.sqrt(1 / 512)
    assert np.abs(w_ih).max() <= 2 * np.sqrt(1 / 512) / 0.87962566 + 1e-7
    k = p["embed_linear"]["kernel"]
    assert abs(k.std() - np.sqrt(1 / 257)) < 0.05 * np.sqrt(1 / 257)
    assert not p["encoders_0"]["b_fwd"].any()
    assert (p["embed_norm"]["scale"] == 1).all()
    same = tb.init_params(3, conf)
    np.testing.assert_array_equal(same["linear"]["kernel"],
                                  p["linear"]["kernel"])
    tm = tb.BLSTM.build_model(conf)
    tm.load_state_dict(tb.params_from_jax(p))


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


def test_pipeline_matches_reference(params, session):
    """The whole 1ch slice with a BLSTM: float32 end to end; the
    peak-normalised (0.9) streams agree to 1e-4 absolute."""
    want = JaxPipeline(jb.BLSTM.build_model(CONF), {"params": params},
                       _config()).process(session)
    tm = build_model("BLSTM", CONF)
    tm.load_state_dict(tb.params_from_jax(params))
    got = CssPipeline(tm, _config(), device="cpu").process(session)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape == session.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=1e-4)


def test_separate_cli_blstm_matches_css_tpu(params, session, tmp_path):
    """A css_tpu-written BLSTM checkpoint through both packages' separate
    CLIs: the 16-bit wavs agree within 2 PCM steps (each side truncates
    its float stream, which agree to ~1e-6)."""
    from css_tpu.cli import separate as jax_separate
    from css_tpu_torch.cli import separate

    ckpt = tmp_path / "blstm.mdl"
    save_checkpoint_dict(str(ckpt), {"params": params, "conf": CONF})
    cfg = tmp_path / "infer.yaml"
    cfg.write_text(yaml.safe_dump(_config()))
    recs = tmp_path / "recs"
    recs.mkdir()
    write_wav(recs / "sessA.wav", session)
    args = ["--config", str(cfg), "--checkpoint", str(ckpt), "--model",
            "BLSTM", "--corpus-dir", str(recs)]
    jax_separate.main(args + ["--out-dir", str(tmp_path / "jax")])
    separate.main(args + ["--out-dir", str(tmp_path / "torch"),
                          "--device", "cpu"])
    for i in range(2):
        want, sr_w = read_wav(tmp_path / "jax" / f"sessA_{i}.wav")
        got, sr = read_wav(tmp_path / "torch" / f"sessA_{i}.wav")
        assert sr == sr_w == 16000 and got.shape == want.shape == session.shape
        assert np.abs(got).max() > 0.5
        np.testing.assert_allclose(got, want, atol=2.0 / 32767)
