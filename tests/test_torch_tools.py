"""The port's host-side tools against ``css_tpu``'s on the same files:
``cli.prepare`` (all three modes), ``cli.evaluate``, ``cli.wer`` with the
toy ASR as its hook, and ``cli.toy_asr``'s decoder. These are numpy and
stdlib code, so the outputs must be identical: the same jsonl bytes, the
same tokens."""

import json
import sys

import numpy as np
import pytest

from css_tpu.cli import evaluate as jevaluate
from css_tpu.cli import prepare as jprepare
from css_tpu.cli import toy_asr as jtoy
from css_tpu.cli import wer as jwer
from css_tpu.data.corpus import SyntheticCorpus
from css_tpu_torch.cli import evaluate, prepare, toy_asr, wer
from css_tpu_torch.data.wav_io import write_wav

SR = 16000


def _noise(rng, n):
    return rng.standard_normal(n).astype(np.float32) * 0.1


def _librispeech_tree(root, rng):
    for spk in ("19", "26"):
        for chap in ("198", "495"):
            d = root / spk / chap
            d.mkdir(parents=True)
            for i in range(2):
                write_wav(d / f"{spk}-{chap}-{i:04d}.wav",
                          _noise(rng, 8000 + 1600 * i))


def _libricss_tree(root, rng, texts):
    """The LibriCSS release layout: for_release/<COND>/<session dir>/
    {record/raw_recording.wav, transcription/meeting_info.txt}; one
    session without its transcription."""
    sessions = [("OV10", "overlap_ratio_10.0_sil0.1_1.0_session0_actual10.1"),
                ("0L", "overlap_ratio_0.0_sil2.9_3.0_session1_actual0.0"),
                ("0S", "overlap_ratio_0.0_sil0.1_0.5_session2_actual0.0")]
    for i, (cond, name) in enumerate(sessions):
        d = root / cond / name
        (d / "record").mkdir(parents=True)
        write_wav(d / "record" / "raw_recording.wav", _noise(rng, 1600))
        if i < 2:
            (d / "transcription").mkdir()
            rows = "".join(f"{j}.0\t{j + 1}.0\tspk{j}\tutt{j}\t{t}\n"
                           for j, t in enumerate(texts[i]))
            (d / "transcription" / "meeting_info.txt").write_text(
                "start\tend\tspeaker\tutterance_id\ttranscription\n" + rows
                + "9.0\t9.5\tspk9\tutt9\t \n")


@pytest.mark.parametrize("mode,extra", [
    ("utterances", ["--speaker-component", "-1"]),
    ("utterances", ["--speaker-component", "0"]),
    ("recordings", []),
    ("libricss", []),
], ids=["utterances_prefix", "utterances_component", "recordings",
        "libricss"])
def test_prepare_writes_css_tpus_manifests(mode, extra, tmp_path):
    rng = np.random.default_rng(0)
    corpus = tmp_path / "corpus"
    if mode == "libricss":
        _libricss_tree(corpus, rng, [["hello world", "good morning"],
                                     ["W12 W13 W15"]])
    else:
        _librispeech_tree(corpus, rng)
    outs = {}
    for name, cli in (("jax", jprepare), ("torch", prepare)):
        argv = [mode, "--corpus-dir", str(corpus), "--output",
                str(tmp_path / f"{name}.jsonl")] + extra
        if mode == "libricss":
            argv += ["--transcripts-output", str(tmp_path / f"{name}.refs")]
        cli.main(argv)
        outs[name] = [(tmp_path / f"{name}.jsonl").read_bytes()]
        if mode == "libricss":
            outs[name].append((tmp_path / f"{name}.refs").read_bytes())
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][0].count(b"\n") == (3 if mode == "libricss" else 8)


def _eval_tree(tmp_path, rng):
    """Two recordings, two and three speakers: estimates, references and
    mixtures in cli.separate's and cli.evaluate's names."""
    est, ref, mix = (tmp_path / d for d in ("est", "ref", "mix"))
    for d in (est, ref, mix):
        d.mkdir()
    for key, k in (("recA", 2), ("recB", 3)):
        srcs = [_noise(rng, 12000) for _ in range(k)]
        write_wav(mix / f"{key}.wav", sum(srcs))
        for i, s in enumerate(srcs):
            write_wav(ref / f"{key}_src{i}.wav", s)
            # estimates: permuted, with some of the other sources leaking in
            write_wav(est / f"{key}_{(i + 1) % k}.wav",
                      s + 0.3 * srcs[(i + 1) % k])
    return est, ref, mix


@pytest.mark.parametrize("with_mix", [False, True], ids=["si_snr", "si_snri"])
def test_evaluate_writes_css_tpus_results(with_mix, tmp_path):
    est, ref, mix = _eval_tree(tmp_path, np.random.default_rng(1))
    out = {}
    for name, cli in (("jax", jevaluate), ("torch", evaluate)):
        argv = ["--estimates", str(est), "--references", str(ref),
                "--output", str(tmp_path / f"{name}.jsonl")]
        if with_mix:
            argv += ["--mixtures", str(mix)]
        cli.main(argv)
        out[name] = (tmp_path / f"{name}.jsonl").read_bytes()
    assert out["torch"] == out["jax"]
    recs = [json.loads(line) for line in out["torch"].splitlines()]
    assert [r.get("num_spk") for r in recs[:2]] == [2, 3]
    assert recs[-1]["num_recordings"] == 2


def _utterances(n):
    corpus = SyntheticCorpus(num_speakers=4, utts_per_speaker=2, seed=11,
                             min_dur=1.0, max_dur=2.0)
    return corpus.utterances[:n]


def test_toy_asr_decodes_css_tpus_tokens():
    for utt in _utterances(6):
        wav = utt.load()
        assert toy_asr.decode_tokens(wav) == jtoy.decode_tokens(wav)
    # a mixture of two, and silence
    a, b = (u.load() for u in _utterances(2))
    n = min(len(a), len(b))
    assert toy_asr.decode_tokens(a[:n] + b[:n]) == jtoy.decode_tokens(
        a[:n] + b[:n])
    assert toy_asr.decode_tokens(np.zeros(8000)) == jtoy.decode_tokens(
        np.zeros(8000)) == []


def test_wer_with_the_toy_asr_writes_css_tpus_results(tmp_path):
    """Two recordings of two streams (synthetic utterances, one stream with
    another's syllables mixed in), the transcripts as references, each
    package's wer CLI with its own toy ASR as the hook."""
    utts = _utterances(4)
    est = tmp_path / "est"
    est.mkdir()
    refs = []
    for r, key in enumerate(("sess0", "sess0b")):
        u0, u1 = utts[2 * r], utts[2 * r + 1]
        w0, w1 = u0.load(), u1.load()
        n = min(len(w0), len(w1))
        write_wav(est / f"{key}_0.wav", w0)
        write_wav(est / f"{key}_1.wav", w1[:n] + 0.5 * w0[:n])
        refs.append({"key": key, "texts": [u0.text, u1.text]})
    (tmp_path / "refs.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in refs))
    out = {}
    for name, cli, hook in (("jax", jwer, "css_tpu.cli.toy_asr"),
                            ("torch", wer, "css_tpu_torch.cli.toy_asr")):
        summary = cli.main([
            "--estimates", str(est), "--references",
            str(tmp_path / "refs.jsonl"), "--asr-cmd",
            f"{sys.executable} -m {hook} {{wav}}", "--output",
            str(tmp_path / f"{name}.jsonl")])
        out[name] = ((tmp_path / f"{name}.jsonl").read_bytes(), summary)
    assert out["torch"] == out["jax"]
    assert out["torch"][1]["ref_words"] > 0
    assert 0.0 <= out["torch"][1]["wer"] < 1.0


def test_edit_distance_and_normalisation_are_css_tpus():
    rng = np.random.default_rng(2)
    for _ in range(20):
        ref = list(rng.choice(["a", "b", "c", "d"], rng.integers(0, 7)))
        hyp = list(rng.choice(["a", "b", "c", "e"], rng.integers(0, 7)))
        assert wer.edit_distance(ref, hyp) == jwer.edit_distance(ref, hyp)
    text = " hello  World\tw12 "
    assert wer.normalize(text) == jwer.normalize(text) == [
        "HELLO", "WORLD", "W12"]
