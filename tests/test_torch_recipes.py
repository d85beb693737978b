"""The port's recipes (``recipes/*_torch.sh``): syntax, the LibriCSS
recipe end to end on the CPU (prepare -> css_tpu_torch.cli.separate ->
wer with the toy ASR), and the train recipes' flags: each is known to the
port's parsers, and they are the JAX package's recipes' flags.

The train recipes are run with a stand-in ``python`` first on PATH that
records its arguments instead of training."""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from css_tpu_torch.cli import train, train_parallel
from css_tpu_torch.data.wav_io import write_wav

REPO = Path(__file__).resolve().parent.parent
RECIPES = ["separate_libricss_torch.sh", "train_conformer_torch.sh",
           "train_quality_torch.sh"]


@pytest.mark.parametrize("name", RECIPES)
def test_recipe_parses(name):
    res = subprocess.run(["bash", "-n", str(REPO / "recipes" / name)],
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr


def _libricss(root, sec=4.0):
    """A two-session release tree: synthetic two-talker sessions whose
    meeting_info.txt holds the corpus's pitch-token transcripts."""
    from css_tpu_torch.data.corpus import SyntheticCorpus
    from css_tpu_torch.data.sessions import make_session

    corpus = SyntheticCorpus(num_speakers=4, utts_per_speaker=2, seed=3,
                             min_dur=1.0, max_dur=2.0)
    for i, (cond, name) in enumerate([
            ("OV10", "overlap_ratio_10.0_sil0.1_1.0_session0_actual10.1"),
            ("0L", "overlap_ratio_0.0_sil2.9_3.0_session1_actual0.0")]):
        d = root / cond / name
        (d / "record").mkdir(parents=True)
        (d / "transcription").mkdir()
        mix, _ = make_session(corpus, np.random.default_rng(10 + i), sec)
        write_wav(d / "record" / "raw_recording.wav", mix)
        texts = [u.text for u in corpus.utterances[2 * i: 2 * i + 2]]
        (d / "transcription" / "meeting_info.txt").write_text(
            "start\tend\tspeaker\tutterance_id\ttranscription\n" + "".join(
                f"{j}.0\t{j + 1}.0\tspk{j}\tutt{j}\t{t}\n"
                for j, t in enumerate(texts)))


def _tiny_checkpoint(path):
    from css_tpu_torch.models import blstm
    from css_tpu_torch.trainer.checkpoint import save_checkpoint_dict

    conf = {"blstm_hdim": 16, "blstm_num_layers": 1}
    save_checkpoint_dict(str(path), {"params": blstm.init_params(5, conf),
                                     "conf": conf})


def _run_separation(tmp_path, checkpoint):
    env = dict(os.environ, PYTHONPATH=str(REPO), device="cpu", model="BLSTM",
               SESSIONS="session0 session1",
               ASR_CMD=f"{sys.executable} -m css_tpu_torch.cli.toy_asr {{wav}}")
    return subprocess.run(
        ["bash", "recipes/separate_libricss_torch.sh",
         str(tmp_path / "for_release"), str(checkpoint),
         str(tmp_path / "out")], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=600)


def test_separate_libricss_recipe_on_the_cpu(tmp_path):
    _libricss(tmp_path / "for_release")
    _tiny_checkpoint(tmp_path / "tiny.mdl")
    res = _run_separation(tmp_path, tmp_path / "tiny.mdl")
    assert res.returncode == 0, res.stderr[-3000:]
    out = tmp_path / "out"
    assert sorted(p.name for p in out.glob("*.wav")) == [
        "session0_OV10_0.wav", "session0_OV10_1.wav", "session1_0L_0.wav",
        "session1_0L_1.wav"]
    lines = [json.loads(line) for line in open(out / "wer.jsonl")]
    assert [r["key"] for r in lines[:2]] == ["session0_OV10", "session1_0L"]
    assert lines[-1]["ref_words"] > 0 and math.isfinite(lines[-1]["wer"])
    stages = [line.split()[1] for line in res.stdout.splitlines()
              if line.startswith("stage ")]
    assert stages == ["prepare:", "separate:", "wer:"]


def test_separate_libricss_recipe_fails_when_a_separation_fails(tmp_path):
    _libricss(tmp_path / "for_release", sec=1.0)
    res = _run_separation(tmp_path, tmp_path / "missing.mdl")
    assert res.returncode != 0
    assert not (tmp_path / "out" / "wer.jsonl").exists()


def _capture(tmp_path, recipe, args=(), env=None):
    """Run a recipe with a stand-in python that records each call's
    arguments; returns them, one list per call."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    calls = tmp_path / "calls.jsonl"
    calls.unlink(missing_ok=True)
    stub = bin_dir / "python"
    stub.write_text(
        f"#!/bin/sh\nexec {sys.executable} -c 'import json, sys; "
        f"open(sys.argv[1], \"a\").write(json.dumps(sys.argv[2:]) + "
        f"\"\\n\")' {calls} \"$@\"\n")
    stub.chmod(0o755)
    run_env = dict(os.environ, PATH=f"{bin_dir}:{os.environ['PATH']}",
                   **(env or {}))
    res = subprocess.run(["bash", str(REPO / "recipes" / recipe), *args],
                         cwd=tmp_path, env=run_env, capture_output=True,
                         text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    return [json.loads(line) for line in open(calls)]


def _flags(tokens):
    """The (flag, value) pairs of an argument list, --expdir and --device
    left out."""
    pairs, i = [], 0
    while i < len(tokens):
        flag, value = tokens[i], None
        if i + 1 < len(tokens) and not tokens[i + 1].startswith("--"):
            value = tokens[i + 1]
            i += 1
        if flag not in ("--expdir", "--device"):
            pairs.append((flag, value))
        i += 1
    return sorted(pairs)


def _train_args(call):
    """The cli.train arguments of a recorded call, by the route the
    recipe took, each parsed by the port's parser of that route."""
    module = call[1]
    if module == "css_tpu_torch.cli.train":
        return call[2:]
    if module == "css_tpu_torch.parallel.launch":
        # the launcher's own flags come before "--": its parser's
        assert call[2:4] == ["--num-processes", "1"] and call[4] == "--"
        return call[5:]
    assert module == "css_tpu_torch.cli.train_parallel"
    parsed = train_parallel.parse_arguments(call[2:])
    assert parsed.nj_init >= 1 and parsed.num_epochs == 100
    return ["--expdir", parsed.expdir, "--num-epochs", "1"] + [
        a for a in parsed.train_args if a != "--"]


def _known_to_the_port(argv):
    """cli.train's two-phase parser takes every flag: nothing unknown."""
    parser_args, unknown = None, None
    try:
        parser_args = train.parse_arguments(argv)
    except SystemExit as exc:  # an unknown flag or a bad value
        unknown = exc
    assert unknown is None and parser_args is not None, argv
    return parser_args


@pytest.mark.parametrize("strategy", ["dp", "single", "jobs", "parity"])
def test_train_conformer_recipe_flags(strategy, tmp_path):
    env = ({"parity": "1"} if strategy == "parity"
           else {"strategy": strategy})
    (torch_call,) = _capture(tmp_path, "train_conformer_torch.sh",
                             ["exp/c"], env)
    argv = _train_args(torch_call)
    args = _known_to_the_port(argv)
    assert args.device == "cuda" and args.bf16 and args.lr == 1e-4
    # the JAX recipe's hyperparameters, flag for flag
    (jax_call,) = _capture(tmp_path, "train_conformer.sh", [],
                           {"parity": "1"} if strategy == "parity" else {})
    assert jax_call[1] == "css_tpu.cli.train"
    want = [p for p in _flags(jax_call[2:]) if p[0] != "--strategy"]
    got = [p for p in _flags(argv) if p[0] not in ("--strategy",)]
    if strategy == "jobs":  # the driver runs one epoch a job
        want = [p for p in want if p[0] != "--num-epochs"]
        got = [p for p in got if p[0] != "--num-epochs"]
    assert got == want


@pytest.mark.parametrize("phase", ["base", "decay", "masksnr"])
def test_train_quality_recipe_flags(phase, tmp_path):
    env = {"INIT": "init.mdl"}
    (torch_call,) = _capture(tmp_path, "train_quality_torch.sh",
                             [phase, "exp/q"], env)
    assert torch_call[1] == "css_tpu_torch.cli.train"
    args = _known_to_the_port(torch_call[2:])
    assert args.device_mix and args.probe_sessions == 4
    (jax_call,) = _capture(tmp_path, "train_quality.sh", [phase, "exp/q"],
                           env)
    assert _flags(torch_call[2:]) == _flags(jax_call[2:])
