"""The port's hop-granular HopStreamingPipeline against css_tpu's.

Causal models from css_tpu's random init carried across by
``params_from_jax``: a BLSTM (hidden 32, 2 layers) and a Conformer (2
blocks x 64, 4 heads, kernel 9, left context 16), as
tests/test_hop_streaming.py sizes them; white-noise input from numpy
seeds, float32 on the CPU.

Tolerances. Against css_tpu on the same pushes: 1e-4 absolute on the
emitted samples (magnitude ~0.1-0.5; the masks differ by summation order
only, ~1e-6; measured < 1e-6). Push-size invariance within the port:
1e-4 / 1e-5 (rtol / atol), the bound of tests/test_hop_streaming.py. The
carried overlap-add against one overlap-add of the same frames: 1e-4 /
1e-6, as there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from css_tpu.executor.hop_streaming import HopStreamingPipeline as JHop
from css_tpu.models import blstm as jb
from css_tpu.models import conformer as jc
from css_tpu_torch.executor.hop_streaming import HopStreamingPipeline
from css_tpu_torch.models import build_model, from_jax
from css_tpu_torch.ops import stft as stft_ops

CFG = {
    "sampling_rate": 16000,
    "separation": {"frame_length": 512, "frame_shift": 256, "num_spk": 2},
    "beamforming": {"wta_thresh": 1e-4},
}
MODELS = {
    "blstm": (jb.BLSTM, {"blstm_hdim": 32, "blstm_num_layers": 2,
                         "blstm_causal": True}),
    "conformer": (jc.Conformer, {
        "conformer_attention_dim": 64, "conformer_attention_heads": 4,
        "conformer_linear_units": 128, "conformer_num_blocks": 2,
        "conformer_kernel_size": 9, "conformer_causal": True,
        "conformer_left_context": 16}),
}


def _pair(name):
    family, conf = MODELS[name]
    jm = family.build_model(conf)
    v = jax.tree.map(np.asarray, jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 20, 257)),
        train=False))
    tm = build_model(type(jm).__name__, conf)
    tm.load_state_dict(from_jax(tm, v["params"], v.get("batch_stats")))
    return jm, v, tm, conf


def _wav(seed, seconds):
    return (np.random.default_rng(seed).standard_normal(int(16000 * seconds))
            .astype(np.float32) * 0.1)


def _run(pipe, wav, sizes):
    outs, pos = [], 0
    for n in sizes:
        outs.append(pipe.push(wav[pos: pos + n]))
        pos += n
    outs.append(pipe.push(wav[pos:]))
    outs.append(pipe.flush())
    return outs


@pytest.mark.parametrize("name", sorted(MODELS))
def test_hop_streaming_matches_css_tpu(name):
    """Irregular pushes through both packages: the same samples emitted
    push by push, and the same carried overlap-add tails."""
    jm, v, tm, _ = _pair(name)
    wav = _wav(3, 1.5)
    sizes = [700, 3000, 11, 8000]
    jp = JHop(jm, v, CFG, chunk_frames=4)
    tp = HopStreamingPipeline(tm, CFG, chunk_frames=4, device="cpu")
    want, got = _run(jp, wav, sizes), _run(tp, wav, sizes)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4)
    assert np.concatenate(got, axis=-1).shape == (2, len(wav))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_hop_streaming_push_size_invariance(name):
    _, _, tm, _ = _pair(name)
    wav = _wav(7, 1.0)

    def run(sizes):
        pipe = HopStreamingPipeline(tm, CFG, chunk_frames=4, device="cpu")
        return np.concatenate(_run(pipe, wav, sizes), axis=-1)

    a = run([len(wav)])
    b = run([500, 2500, 13, 9000])
    assert a.shape == (2, len(wav))
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_hop_streaming_matches_one_shot_overlap_add():
    """The carried OLA, envelope and emission bookkeeping equal one
    overlap-add of the same chunk-computed synthesis frames (the device
    steps replayed on a fresh pipeline with the same chunk boundaries)."""
    _, _, tm, _ = _pair("blstm")
    wav = _wav(4, 1.0)
    pipe = HopStreamingPipeline(tm, CFG, chunk_frames=8, device="cpu")
    out = np.concatenate([pipe.push(wav), pipe.flush()], axis=-1)
    assert out.shape == (2, len(wav))
    replay = HopStreamingPipeline(tm, CFG, chunk_frames=8, device="cpu")
    raw, frames_out = wav.copy(), []
    while raw.shape[0] >= 7 * 256 + 512:
        idx = np.arange(8)[:, None] * 256 + np.arange(512)[None, :]
        frames_out.append(replay._step(torch.as_tensor(raw[idx])).numpy())
        raw = raw[8 * 256:]
    while raw.shape[0] >= 512:
        frames_out.append(replay._step(
            torch.as_tensor(raw[None, :512])).numpy())
        raw = raw[256:]
    frames = torch.as_tensor(np.concatenate(frames_out, axis=1))
    sig = stft_ops.overlap_add(frames, 256).numpy()
    win2 = torch.as_tensor(stft_ops.hann_window(512) ** 2)
    env = stft_ops.overlap_add(win2.expand(frames.shape[1], 512), 256).numpy()
    ref = np.where(env >= 1e-2, sig / np.maximum(env, 1e-2), 0.0)
    n = ref.shape[-1]
    np.testing.assert_allclose(out[:, :n], ref, rtol=1e-4, atol=1e-6)
    assert np.allclose(out[:, n:], 0.0)


def test_hop_streaming_refuses_a_model_that_is_not_causal():
    family, conf = MODELS["blstm"]
    tm = build_model("BLSTM", dict(conf, blstm_causal=False))
    with pytest.raises(ValueError, match="causal"):
        HopStreamingPipeline(tm, CFG, device="cpu")


def test_cli_hop_streaming_matches_css_tpu(tmp_path):
    """cli.separate --streaming --stream-mode hop in both packages on the
    same wav and causal BLSTM checkpoint."""
    import yaml

    from css_tpu.cli import separate as jsep
    from css_tpu.trainer import checkpoint as jckpt
    from css_tpu_torch.cli import separate as tsep
    from css_tpu_torch.data.wav_io import read_wav, write_wav

    _, v, _, conf = _pair("blstm")
    ckpt = tmp_path / "m.mdl"
    jckpt.save_checkpoint_dict(str(ckpt), {"params": v["params"],
                                           "conf": conf})
    recs = tmp_path / "recs"
    recs.mkdir()
    wav = _wav(5, 1.2)
    write_wav(recs / "s.wav", wav)
    cfg = tmp_path / "c.yaml"
    cfg.write_text(yaml.safe_dump(CFG))
    args = ["--config", str(cfg), "--checkpoint", str(ckpt), "--model",
            "BLSTM", "--corpus-dir", str(recs), "--streaming",
            "--stream-mode", "hop", "--push-sec", "0.3",
            "--stream-chunk-frames", "4"]
    tsep.main(args + ["--out-dir", str(tmp_path / "t"), "--device", "cpu"])
    jsep.main(args + ["--out-dir", str(tmp_path / "j")])
    for i in range(2):
        got = read_wav(tmp_path / "t" / f"s_{i}.wav")[0]
        want = read_wav(tmp_path / "j" / f"s_{i}.wav")[0]
        assert got.shape == wav.shape and np.isfinite(got).all()
        # 16-bit PCM: two quantisation steps
        np.testing.assert_allclose(got, want, atol=2.0 / 32767 + 1e-4)
