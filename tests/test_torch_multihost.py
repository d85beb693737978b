"""``cli.train --multihost`` of the port at world 2 (two gloo processes
on the CPU started by ``python -m css_tpu_torch.parallel.launch``),
against one process training the same global batches: each rank's
recipe stream (its own content seed, the shared window seed) rebuilt
here and concatenated, materialised by one DeviceMixer, one port Trainer
on all the rows; tests/mh_worker.py's model (BLSTM hidden 64, Adam, the
MSE noise term). The tolerances of tests/test_multihost.py: losses and
parameters rtol 1e-3 / atol 1e-5 (reduction order, through Adam
steps). Also the shape contract that makes the global batch assemble:
mixers with different content seeds and one window seed draw the same
bucket sequence (tests/test_multihost.py's lockstep case)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from css_tpu_torch.cli import train as ttrain
from css_tpu_torch.data.corpus import SyntheticCorpus
from css_tpu_torch.data.device_mixer import DeviceMixer
from css_tpu_torch.data.mixer import MixtureSynthesizer
from css_tpu_torch.models import MODELS, from_jax, init_variables
from css_tpu_torch.objectives import OBJECTIVES
from css_tpu_torch.parallel.dp import SEED_STRIDE
from css_tpu_torch.trainer import checkpoint
from css_tpu_torch.trainer.loop import Trainer
from css_tpu_torch.trainer.lr_schedule import LRSchedule

REPO = Path(__file__).resolve().parent.parent
# the workers share the test run's cores with the other test processes
ENV = dict(os.environ, OMP_NUM_THREADS="2")
STEPS = 3
ARGS = ["--synthetic-data", "--synthetic-speakers", "4",
        "--synthetic-utts", "2", "--batch-size", "4",
        "--batches-per-epoch", str(STEPS), "--num-epochs", "1",
        "--optim", "adam", "--lr", "1e-3", "--warmup", "2",
        "--model", "BLSTM", "--blstm-hdim", "64", "--blstm-num-layers", "1",
        "--blstm-dropout-rate", "0", "--grad-thresh", "5.0",
        "--min-window-size", "1.0", "--max-window-size", "2.0",
        "--validate-batches", "1", "--mse-noise-weight", "0.3",
        "--strategy", "dp", "--device-mix", "--device", "cpu",
        "--dist-timeout", "60"]


def test_two_process_dp_matches_one_process(tmp_path):
    expdir, report = tmp_path / "exp", tmp_path / "report"
    res = subprocess.run(
        [sys.executable, "-m", "css_tpu_torch.parallel.launch",
         "--num-processes", "2", "--timeout", "240", "--", *ARGS,
         "--expdir", str(expdir), "--rank-report", str(report)],
        cwd=str(REPO), capture_output=True, text=True, env=ENV, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:] + res.stdout[-2000:]
    ranks = [json.loads((report / f"rank{r}.json").read_text())
             for r in range(2)]
    assert [r["backend"] for r in ranks] == ["gloo", "gloo"]
    # rank 0 alone writes; both end bit-equal
    assert sorted(ranks[0]["written"]) == ["1.1.mdl", "conf.1.json",
                                           "train.1.jsonl"]
    assert ranks[1]["written"] == []
    assert ranks[0]["state_digest"] == ranks[1]["state_digest"]
    assert ranks[0]["in_sync"] and ranks[1]["in_sync"]

    # the oracle: both ranks' recipe streams, one process, all the rows
    args = ttrain.parse_arguments(ARGS + ["--expdir", "unused"])
    corpus, _ = ttrain.build_corpus(args)
    base = dict(vars(args), batch_size=2,
                window_seed=args.seed + 1000 * args.job + 104729)
    streams = []
    for rank in range(2):
        conf = dict(base, seed=args.seed + 1000 * args.job
                    + SEED_STRIDE * rank)
        mixer = MixtureSynthesizer.build_dataset(corpus, conf)
        dmix = DeviceMixer(mixer, device="cpu")
        streams.append(dmix.wrap(mixer))
    conf = dict(vars(args), bf16=False)
    model = MODELS["BLSTM"].build_model(conf)
    model.load_state_dict(from_jax(model, *init_variables(model,
                                                           args.seed)))
    trainer = Trainer(model, OBJECTIVES["MSE"].build_objective(conf),
                      LRSchedule.from_conf(conf), optim="adam",
                      weight_decay=args.weight_decay,
                      grad_thresh=args.grad_thresh, device="cpu",
                      seed=args.seed)
    losses = []
    for _ in range(STEPS):
        a, b = (next(s) for s in streams)
        assert a["win"] == b["win"]  # lockstep buckets
        batch = {"dm_i": np.concatenate([a["dm_i"], b["dm_i"]]),
                 "dm_f": np.concatenate([a["dm_f"], b["dm_f"]]),
                 "win": a["win"]}
        losses.append(float(trainer.train_step(batch, dmix)["loss"]))
    np.testing.assert_allclose(ranks[0]["epoch_losses"][0], np.mean(losses),
                               rtol=1e-3, atol=1e-5)
    got = checkpoint.load_checkpoint(str(expdir / "1.1.mdl"))
    want = trainer.state()
    flat_got = checkpoint._flatten_dict(got["params"])
    flat_want = checkpoint._flatten_dict(want.params)
    assert sorted(flat_got) == sorted(flat_want)
    for k, v in flat_want.items():
        np.testing.assert_allclose(flat_got[k], v, rtol=1e-3, atol=1e-5,
                                   err_msg=k)
    assert not torch.distributed.is_initialized()


def test_window_bucket_lockstep():
    corpus = SyntheticCorpus(num_speakers=4, utts_per_speaker=2, seed=1)
    a = MixtureSynthesizer(corpus, batch_size=2, min_window=2.0,
                           max_window=4.0, seed=11, window_seed=5)
    b = MixtureSynthesizer(corpus, batch_size=2, min_window=2.0,
                           max_window=4.0, seed=22, window_seed=5)
    wins_a = [next(a)["mix"].shape[-1] for _ in range(8)]
    wins_b = [next(b)["mix"].shape[-1] for _ in range(8)]
    assert wins_a == wins_b
    assert len(set(wins_a)) > 1
    assert np.abs(next(a)["mix"] - next(b)["mix"]).max() > 1e-3


def test_tp_cli_matches_single_process_cli(tmp_path):
    """``--strategy dp --tp 2`` through the launcher (data 1 x model 2: both
    ranks draw the single process's rows) against one process of the same
    flags: the checkpoint gathered to full shapes, and the same parameters
    after SGD steps (rtol 1e-3 / atol 1e-5)."""
    flags = ["--synthetic-data", "--synthetic-speakers", "4",
             "--synthetic-utts", "2", "--batch-size", "4",
             "--batches-per-epoch", "2", "--num-epochs", "1",
             "--conformer-num-blocks", "1", "--conformer-attention-dim", "32",
             "--conformer-attention-heads", "2",
             "--conformer-linear-units", "64", "--conformer-kernel-size", "5",
             "--conformer-dropout-rate", "0", "--min-window-size", "1.0",
             "--max-window-size", "1.0", "--window-seed", "5",
             "--validate-batches", "1", "--num-workers", "1",
             "--device", "cpu"]
    res = subprocess.run(
        [sys.executable, "-m", "css_tpu_torch.parallel.launch",
         "--num-processes", "2", "--timeout", "240", "--", *flags,
         "--strategy", "dp", "--tp", "2", "--dist-timeout", "60",
         "--expdir", str(tmp_path / "tp")],
        cwd=str(REPO), capture_output=True, text=True, env=ENV, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:] + res.stdout[-2000:]
    ttrain.main(flags + ["--expdir", str(tmp_path / "single")])
    got = checkpoint._flatten_dict(checkpoint.load_checkpoint(
        str(tmp_path / "tp" / "1.1.mdl"))["params"])
    want = checkpoint._flatten_dict(checkpoint.load_checkpoint(
        str(tmp_path / "single" / "1.1.mdl"))["params"])
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        np.testing.assert_allclose(got[k], v, rtol=1e-3, atol=1e-5,
                                   err_msg=k)
