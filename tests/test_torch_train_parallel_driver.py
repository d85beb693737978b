"""The port's per-epoch driver (``css_tpu_torch.cli.train_parallel``)
with real worker processes on the CPU: the two cases of
tests/test_train_parallel_driver.py. Job 2 of an epoch crashes mid-epoch
and its retry crashes too: ``elastic`` finishes from the survivors'
averages, ``abort`` exits non-zero and leaves the ``.error`` sentinel."""

import os
import subprocess
import sys
from pathlib import Path

from css_tpu_torch.trainer.checkpoint import load_checkpoint

REPO = Path(__file__).resolve().parent.parent
# the workers share the test run's cores with the other test processes
ENV = dict(os.environ, OMP_NUM_THREADS="2")

TRAIN_ARGS = [
    "--device", "cpu", "--synthetic-data", "--synthetic-speakers", "4",
    "--synthetic-utts", "2", "--model", "BLSTM", "--objective", "MSE",
    "--batch-size", "4", "--batches-per-epoch", "3", "--optim", "adam",
    "--lr", "1e-3", "--warmup", "2", "--blstm-hdim", "32",
    "--blstm-num-layers", "1", "--min-window-size", "2",
    "--max-window-size", "2", "--validate-batches", "1",
    "--num-workers", "1",
]


def run_driver(expdir, extra):
    cmd = [sys.executable, "-m", "css_tpu_torch.cli.train_parallel",
           "--expdir", str(expdir), "--num-epochs", "2", "--nj-init", "2",
           "--nj-final", "2", "--retry", "1", *extra, "--", *TRAIN_ARGS]
    return subprocess.run(cmd, cwd=str(REPO), capture_output=True,
                          text=True, env=ENV, timeout=300)


def test_elastic_survivor_averaging(tmp_path):
    expdir = tmp_path / "exp"
    res = run_driver(expdir, ["--inject-failure", "2.2:1"])
    assert res.returncode == 0, res.stderr[-3000:] + res.stdout[-2000:]
    assert (expdir / "2.mdl").exists()
    assert (expdir / ".error.2.2").exists()
    assert not (expdir / "2.2.mdl").exists()
    assert (expdir / "log" / "train.2.1.log").exists()
    assert (expdir / "log" / "train.2.2.log").exists()
    ck = load_checkpoint(expdir / "2.mdl")
    assert ck["epoch"] == 2 and "params" in ck
    # epoch 2's average is job 1's checkpoint alone, resumed from epoch 1's
    assert ck["step"] == 6
    assert "survivors" in res.stderr or "survivors" in res.stdout


def test_abort_mode_fails_fast(tmp_path):
    expdir = tmp_path / "exp"
    res = run_driver(expdir, ["--inject-failure", "1.2:1",
                              "--on-failure", "abort"])
    assert res.returncode != 0
    assert (expdir / ".error.1.2").exists()
    assert not (expdir / "1.mdl").exists()
