"""Checkpoints across the two packages, and the training CLIs.

A checkpoint the port's trainer saves resumes in css_tpu and one css_tpu
saves resumes in the port: the restored leaves are equal, and one more
step on each side agrees (the tolerances of tests/test_torch_train_trainer
.py, with the step fed css_tpu's features there too). Averaging and
garbage collection agree with css_tpu's on the same files. A tiny
``cli.train --device cpu`` run writes css_tpu's file set, and css_tpu's
``cli.separate`` on the port-trained checkpoint gives the port's streams
within 1e-4 (tests/test_torch_pipeline.py's 1ch tolerance) on 0.9-peak
streams; the written wavs to two 16-bit steps.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from css_tpu.cli import train as jtrain
from css_tpu.models import conformer as jc
from css_tpu.objectives.mse import MeanSquaredError as JMse
from css_tpu.trainer import LRSchedule as JSchedule
from css_tpu.trainer import Trainer as JTrainer
from css_tpu.trainer import checkpoint as jckpt
from css_tpu_torch.cli import combine as tcombine
from css_tpu_torch.cli import train as ttrain
from css_tpu_torch.data.corpus import SyntheticCorpus
from css_tpu_torch.data.mixer import MixtureSynthesizer
from css_tpu_torch.data.wav_io import read_wav, write_wav
from css_tpu_torch.models import conformer as tc
from css_tpu_torch.objectives.mse import MeanSquaredError
from css_tpu_torch.trainer import checkpoint as tckpt
from css_tpu_torch.trainer.lr_schedule import LRSchedule
from css_tpu_torch.trainer.loop import Trainer

CONF = {"conformer_attention_dim": 64, "conformer_attention_heads": 4,
        "conformer_linear_units": 128, "conformer_num_blocks": 2,
        "conformer_kernel_size": 7, "conformer_dropout_rate": 0.0}
SCHED = dict(lr=1e-3, warmup=2, min_lr=1e-4)
TINY = ["--synthetic-data", "--synthetic-speakers", "4", "--synthetic-utts",
        "2", "--batch-size", "2", "--batches-per-epoch", "3",
        "--num-epochs", "2", "--optim", "adam", "--lr", "1e-3",
        "--weight-decay", "1e-2", "--grad-thresh", "5.0", "--warmup", "2",
        "--conformer-num-blocks", "2", "--conformer-attention-dim", "64",
        "--conformer-linear-units", "128", "--conformer-kernel-size", "7",
        "--min-window-size", "1.0", "--max-window-size", "1.0",
        "--validate-batches", "2", "--keep-best", "--keep-last", "1",
        "--mse-noise-weight", "0.3", "--num-workers", "1"]


@pytest.fixture(scope="module")
def batches():
    corpus = SyntheticCorpus(num_speakers=4, utts_per_speaker=2,
                             min_dur=2.0, max_dur=3.0, seed=8)
    ds = MixtureSynthesizer(corpus, batch_size=2, min_window=1.0,
                            max_window=1.0, seed=9)
    return [{k: v for k, v in next(ds).items() if k not in ("ovl", "lens")}
            for _ in range(3)]


@pytest.fixture(scope="module")
def jax_trainer():
    return JTrainer(jc.Conformer.build_model(CONF), JMse(noise_weight=0.3),
                    JSchedule(**SCHED), optim="adam", weight_decay=1e-2,
                    grad_thresh=0.05, donate=False)


def _port_trainer():
    tm = tc.Conformer.build_model(CONF)
    return Trainer(tm, MeanSquaredError(noise_weight=0.3),
                   LRSchedule(**SCHED), optim="adam", weight_decay=1e-2,
                   grad_thresh=0.05, device="cpu")


def _feed(jt, tt, batch):
    feats = {k: torch.as_tensor(np.array(v)) for k, v in
             jt._featurize(jax.tree.map(jnp.asarray, batch)).items()}
    tt.featurize = lambda _batch: feats


def _leaves_equal(port_state, jstate):
    got = (tckpt.tree_leaves(port_state.params)
           + tckpt.tree_leaves(port_state.batch_stats)
           + list(port_state.opt_state))
    want = [np.asarray(x) for x in jax.tree.leaves(
        (jstate.params, jstate.batch_stats, jstate.opt_state))]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert port_state.step == int(jstate.step)


def _next_step_agrees(jt, jstate, tt, batch):
    jstate, jm = jt._train_step(jstate, batch, jax.random.PRNGKey(0))
    _feed(jt, tt, batch)
    tm = tt.train_step(batch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    assert tt.step == int(jstate.step)
    assert int(tt.state().opt_state[0]) == int(
        jax.tree.leaves(jstate.opt_state)[0])


def test_port_checkpoint_resumes_in_css_tpu(batches, jax_trainer, tmp_path):
    jt = jax_trainer
    tt = _port_trainer()
    jstate = jt.init_state(jax.random.PRNGKey(0), batches[0])
    tt.load_state(tckpt.TrainState(
        0, jax.tree.map(np.asarray, jstate.params),
        jax.tree.map(np.asarray, jstate.batch_stats),
        [np.asarray(x) for x in jax.tree.leaves(jstate.opt_state)]))
    for b in batches[:2]:
        _feed(jt, tt, b)
        tt.train_step(b)
    path = tmp_path / "port.mdl"
    tckpt.save_checkpoint(path, tt.state(), epoch=4, loss=0.5,
                          conf=dict(CONF))
    ck = jckpt.load_checkpoint(str(path))
    assert (ck["epoch"], ck["step"], ck["conf"]) == (4, 2, CONF)
    restored = jckpt.restore_state(ck, jstate)
    _leaves_equal(tt.state(), restored)
    _next_step_agrees(jt, restored, tt, batches[2])


def test_css_tpu_checkpoint_resumes_in_the_port(batches, jax_trainer,
                                                tmp_path):
    jt = jax_trainer
    jstate = jt.init_state(jax.random.PRNGKey(1), batches[0])
    for b in batches[:2]:
        jstate, _ = jt._train_step(jstate, b, jax.random.PRNGKey(0))
    path = tmp_path / "jax.mdl"
    jckpt.save_checkpoint(str(path), jstate, epoch=2, loss=0.25, conf=CONF)
    tt = _port_trainer()
    ck = tckpt.load_checkpoint(path)
    tt.load_state(tckpt.restore_state(ck, tt.state()))
    _leaves_equal(tt.state(), jstate)
    _next_step_agrees(jt, jstate, tt, batches[2])
    with pytest.raises(ValueError, match="optimiser leaves"):
        sgd = Trainer(tc.Conformer.build_model(CONF), MeanSquaredError(),
                      LRSchedule(1e-3), optim="sgd", device="cpu")
        tckpt.restore_state(ck, sgd.state())


def _write_jobs(tmp_path, n=3):
    rng = np.random.default_rng(5)
    paths = []
    for j in range(n):
        p = tmp_path / f"7.{j + 1}.mdl"
        tckpt.save_checkpoint_dict(p, {
            "params": {"a": {"kernel": rng.standard_normal(
                (3, 4)).astype(np.float32)}, "b": np.float32(rng.uniform(
                    size=5)).astype(np.float32)},
            "batch_stats": {"bn": {"mean": rng.standard_normal(4).astype(
                np.float32)}},
            "opt_state": [np.int32(j + 3), rng.standard_normal(2).astype(
                np.float32)],
            "step": 10 + j, "epoch": 7, "loss": 0.1 * j, "conf": {"j": j}})
        paths.append(str(p))
    return paths


def test_average_checkpoints_match(tmp_path):
    paths = _write_jobs(tmp_path) + [str(tmp_path / "missing.mdl")]
    want = jckpt.average_checkpoints(paths)
    got = tckpt.average_checkpoints(paths, "cpu")
    assert (got["step"], got["conf"], got["loss"]) == (
        want["step"], want["conf"], want["loss"])
    for key in ("params", "batch_stats", "opt_state"):
        g, w = tckpt.tree_leaves(got[key]), jax.tree.leaves(want[key])
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, b)
    out = tmp_path / "merged.mdl"
    tcombine.main([str(out), "--models"] + paths + ["--device", "cpu"])
    assert out.exists() and not any(os.path.exists(p) for p in paths)
    jout = jckpt.load_checkpoint(str(out))
    np.testing.assert_array_equal(jout["params"]["a"]["kernel"],
                                  want["params"]["a"]["kernel"])


@pytest.mark.parametrize("job", [None, 2])
def test_gc_checkpoints_match(tmp_path, job):
    suffix = f".{job}.mdl" if job else ".mdl"
    for d in ("port", "jax"):
        (tmp_path / d).mkdir()
        for e in range(1, 46):
            (tmp_path / d / f"{e}{suffix}").write_bytes(b"x")
        (tmp_path / d / f"best{suffix}").write_bytes(b"x")
    tckpt.gc_checkpoints(tmp_path / "port", keep_every=20, keep_last=3,
                         job=job)
    jckpt.gc_checkpoints(tmp_path / "jax", keep_every=20, keep_last=3,
                         job=job)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax"))


def test_bf16_tensors_are_written_as_raw_bits(tmp_path):
    x = torch.tensor([1.5, -2.25, 3e-3]).bfloat16()
    p = tmp_path / "bf16.mdl"
    tckpt.save_checkpoint_dict(p, {"params": {"w": x}})
    back = jckpt.load_checkpoint(str(p))["params"]["w"]
    assert back.dtype.name == "bfloat16"
    np.testing.assert_array_equal(back.astype(np.float32), x.float().numpy())


def test_cli_train_writes_css_tpu_file_set_and_separates(tmp_path):
    ttrain.main(TINY + ["--expdir", str(tmp_path / "port"),
                        "--device", "cpu"])
    jtrain.main(TINY + ["--expdir", str(tmp_path / "jax"),
                        "--strategy", "single", "--steps-per-dispatch", "1"])
    port, ref = tmp_path / "port", tmp_path / "jax"
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref)) == [
        "2.1.mdl", "best.1.mdl", "conf.1.json", "train.1.jsonl"]
    with open(port / "train.1.jsonl") as a, open(ref / "train.1.jsonl") as b:
        ra, rb = [yaml.safe_load(x) for x in a], [yaml.safe_load(x)
                                                  for x in b]
    assert len(ra) == len(rb) and [sorted(r) for r in ra] == [
        sorted(r) for r in rb]
    ck = jckpt.load_checkpoint(str(port / "2.1.mdl"))
    assert ck["epoch"] == 2 and ck["step"] == 6
    # resume the port's run in the port, and in css_tpu
    ttrain.main(TINY + ["--expdir", str(port), "--device", "cpu",
                        "--resume", "2.1.mdl", "--num-epochs", "1"])
    assert tckpt.load_checkpoint(port / "3.1.mdl")["step"] == 9
    # css_tpu.cli.separate and the port's on the port-trained checkpoint
    from css_tpu.cli import separate as jsep
    from css_tpu_torch.cli import separate as tsep

    rng = np.random.default_rng(11)
    session = (0.1 * rng.standard_normal(48000)).astype(np.float32)
    recs = tmp_path / "recs"
    recs.mkdir()
    write_wav(recs / "s.wav", session)
    with open("configs/infer_1ch.yaml") as fh:
        config = yaml.safe_load(fh)
    config["separation"]["batch_size"] = 4
    cfg = tmp_path / "infer.yaml"
    cfg.write_text(yaml.safe_dump(config))
    args = ["--config", str(cfg), "--checkpoint", str(port / "3.1.mdl"),
            "--corpus-dir", str(recs)]
    tsep.main(args + ["--out-dir", str(tmp_path / "o_port"),
                      "--device", "cpu"])
    jsep.main(args + ["--out-dir", str(tmp_path / "o_jax")])
    for i in range(2):
        got = read_wav(tmp_path / "o_port" / f"s_{i}.wav")[0]
        want = read_wav(tmp_path / "o_jax" / f"s_{i}.wav")[0]
        assert np.isfinite(got).all() and got.shape == session.shape
        np.testing.assert_allclose(got, want, atol=2.0 / 32767 + 1e-4)
    # and the port's checkpoint resumes in css_tpu's CLI
    jtrain.main(TINY + ["--expdir", str(port), "--resume", "3.1.mdl",
                        "--num-epochs", "1", "--steps-per-dispatch", "1"])
    assert jckpt.load_checkpoint(str(port / "4.1.mdl"))["step"] == 12


def test_cli_train_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """Item 10's flags, which the port refused before it had parallel
    training, are accepted: --strategy dp and replica_avg (one process, a
    world-1 gloo group), --tp under the single strategy (ignored there, as
    css_tpu ignores it) and --multihost with one process. What they refuse
    is what css_tpu's CLI refuses, word for word: css_tpu is shown two
    processes by its jax.process_count, the port by --num-processes 2
    (it refuses before it joins the group)."""
    from css_tpu_torch.parallel import launch

    quick = ["--num-epochs", "1", "--batches-per-epoch", "1",
             "--validate-batches", "1"]
    for i, extra in enumerate((
            ["--strategy", "dp"], ["--strategy", "replica_avg"],
            ["--tp", "2"],
            ["--strategy", "dp", "--multihost", "--num-processes", "1",
             "--process-id", "0", "--coordinator",
             f"localhost:{launch.free_port()}"])):
        expdir = tmp_path / f"accepted{i}"
        ttrain.main(TINY + quick + extra + ["--expdir", str(expdir),
                                            "--device", "cpu"])
        assert (expdir / "1.1.mdl").exists()
        assert not torch.distributed.is_initialized()
    two = ["--multihost", "--num-processes", "2", "--process-id", "0",
           "--coordinator", "localhost:1"]
    for extra, message, n_proc in (
            (["--strategy", "dp", "--batch-size", "3"],
             "--batch-size 3 must be divisible by 2 processes", 2),
            (["--spatialize-channels", "7", "--device-mix"],
             "--spatialize-channels with --device-mix is single-process "
             "for now", 2),
            (["--device-mix"], "--device-mix with multiple processes "
             "requires --strategy dp or replica_avg", 2),
            (["--strategy", "dp", "--tp", "2", "--model", "BLSTM"],
             "--tp>1 currently supports Conformer only", 1)):
        args = ["--synthetic-data", "--synthetic-speakers", "4",
                "--synthetic-utts", "2", "--batch-size", "2",
                "--min-window-size", "1.0", "--max-window-size", "1.0",
                "--num-workers", "1", "--expdir", str(tmp_path)] + extra
        with pytest.raises(SystemExit) as port:
            ttrain.main(args + ["--device", "cpu"]
                        + (two if n_proc > 1 else []))
        with monkeypatch.context() as mp:
            mp.setattr(jax, "process_count", lambda: n_proc)
            with pytest.raises(SystemExit) as ref:
                jtrain.main(args)
        assert str(port.value) == str(ref.value) == message
    # spatial training, device mixing and the probe are ported (items
    # 8a-8c): what they refuse now is what css_tpu's CLI refuses
    for extra, message in (
            [["--spatialize-channels", "7", "--synthetic-rirs"],
             "incompatible with --synthetic-rirs"],
            [["--spatialize-channels", "7", "--model", "ConvTasNet"],
             "needs a mask model"],
            [["--average-probe-top", "2"], "requires --probe-sessions"]):
        args = ["--synthetic-data", "--expdir", str(tmp_path)] + extra
        with pytest.raises(SystemExit, match=message):
            ttrain.main(args + ["--device", "cpu"])
        with pytest.raises(SystemExit, match=message):
            jtrain.main(args)


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="is_available"):
        ttrain.main(TINY + ["--expdir", "unused"])
    with pytest.raises(RuntimeError, match="is_available"):
        tcombine.main(["out.mdl", "--models", "a.mdl"])
