"""Training CLI (port of ``css_tpu/cli/train.py``, strategy ``single``).

    python -m css_tpu_torch.cli.train --expdir exp/run --synthetic-data \\
        --model Conformer --objective MSE --optim adam --lr 1e-4 ...

The same flags as the JAX package's CLI and the same files in --expdir:
``conf.<job>.json``, ``train.<job>.jsonl`` (one JSON object per logged
step), ``<epoch>.<job>.mdl`` checkpoints (npz, readable by both packages;
garbage-collected by --keep-every/--keep-last), ``best.<job>.mdl`` with
--keep-best; --resume continues a run (from either package's checkpoint),
--init warm-starts the params. Training runs on ``--device`` (default
cuda; it raises without a card and never falls back to the CPU). The JAX
package's --platform, --prng-impl and --debug-nans have no counterpart
here. Options whose ROADMAP.md item is still open raise and name it.
"""

from __future__ import annotations

import argparse
import json
import os
import time as _time
from pathlib import Path

import numpy as np
import torch

from css_tpu_torch.data.corpus import (Corpus, SyntheticCorpus,
                                       synthetic_noise_pool,
                                       synthetic_rir_pool)
from css_tpu_torch.data.loader import PrefetchLoader
from css_tpu_torch.data.mixer import MixtureSynthesizer
from css_tpu_torch.device import resolve_device
from css_tpu_torch.models import MODELS, from_jax, init_variables
from css_tpu_torch.objectives import OBJECTIVES
from css_tpu_torch.trainer import checkpoint
from css_tpu_torch.trainer.loop import Trainer
from css_tpu_torch.trainer.lr_schedule import LRSchedule
from css_tpu_torch.utils.logging import MetricsLogger, get_logger

log = get_logger(__name__)


def _mask_model_args(parser):
    for flag, default in [("--idim", 257), ("--num-bins", 257),
                          ("--num-spk", 2), ("--num-noise", 1)]:
        parser.add_argument(flag, type=int, default=default)


def _conformer_args(parser):
    _mask_model_args(parser)
    parser.add_argument("--conformer-attention-dim", type=int, default=256)
    parser.add_argument("--conformer-attention-heads", type=int, default=4)
    parser.add_argument("--conformer-linear-units", type=int, default=1024)
    parser.add_argument("--conformer-num-blocks", type=int, default=16)
    parser.add_argument("--conformer-kernel-size", type=int, default=33)
    parser.add_argument("--conformer-dropout-rate", type=float, default=0.1)
    parser.add_argument("--conformer-relative-pos-emb", type=bool,
                        default=True)
    parser.add_argument("--conformer-causal", action="store_true",
                        help="the causal Conformer: ROADMAP.md Queue 1 "
                             "item 9, not ported (raises)")
    parser.add_argument("--conformer-left-context", type=int, default=128)


def _blstm_args(parser):
    _mask_model_args(parser)
    parser.add_argument("--blstm-hdim", type=int, default=1024)
    parser.add_argument("--blstm-num-layers", type=int, default=3)
    parser.add_argument("--blstm-dropout-rate", type=float, default=0.1)
    parser.add_argument("--blstm-causal", action="store_true",
                        help="unidirectional LSTM + cumulative MVN")


def _conv_tasnet_args(parser):
    parser.add_argument("--num-spk", type=int, default=2)
    parser.add_argument("--num-noise", type=int, default=1)
    parser.add_argument("--conv-tasnet-num-filters", type=int, default=256)
    parser.add_argument("--conv-tasnet-filter-length", type=int, default=16)
    parser.add_argument("--conv-tasnet-bottleneck-channels", type=int,
                        default=128)
    parser.add_argument("--conv-tasnet-conv-channels", type=int, default=256)
    parser.add_argument("--conv-tasnet-kernel-size", type=int, default=3)
    parser.add_argument("--conv-tasnet-num-blocks", type=int, default=8)
    parser.add_argument("--conv-tasnet-num-layers", type=int, default=3)
    parser.add_argument("--conv-tasnet-norm", type=str, default="gln",
                        choices=["gln", "cln"])


MODEL_ARGS = {"Conformer": _conformer_args, "BLSTM": _blstm_args,
              "ConvTasNet": _conv_tasnet_args}


def _dataset_args(parser):
    parser.add_argument("--min-window-size", type=float, default=2.0)
    parser.add_argument("--window-seed", type=int, default=None)
    parser.add_argument("--max-window-size", type=float, default=4.0)
    parser.add_argument("--window-bucket-step", type=float, default=0.5)
    parser.add_argument("--align-window-frames", type=int, default=0,
                        help="snap window buckets to multiples of this many "
                             "STFT frames; 0 keeps the raw buckets")
    parser.add_argument("--min-snr", type=float, default=5.0)
    parser.add_argument("--max-snr", type=float, default=20.0)
    parser.add_argument("--hard-pair-frac", type=float, default=0.0,
                        help="fraction of mixtures forced to a close-f0 "
                             "speaker pair")
    parser.add_argument("--hard-pair-df0", type=float, default=80.0)


# flags of the JAX package's CLI whose feature waits for a ROADMAP.md item:
# (flag, is it set?, the item)
NOT_PORTED = [
    ("--strategy dp|replica_avg", lambda a: a.strategy != "single",
     "Queue 1 item 10"),
    ("--tp > 1", lambda a: a.tp > 1, "Queue 1 item 10"),
    ("--multihost", lambda a: a.multihost, "Queue 1 item 10"),
    ("--device-mix", lambda a: a.device_mix, "Queue 1 item 8b"),
    ("--probe-sessions > 0", lambda a: a.probe_sessions > 0,
     "Queue 1 item 8c"),
    ("--average-probe-top > 0", lambda a: a.average_probe_top > 0,
     "Queue 1 item 8c"),
    ("--spatialize-channels > 0", lambda a: a.spatialize_channels > 0,
     "Queue 1 item 8a"),
]


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(
        description="Train a separation model on the card (the port of "
                    "css_tpu.cli.train, strategy single).")
    parser.add_argument("--train-manifest", type=str, default=None)
    parser.add_argument("--dev-manifest", type=str, default=None)
    parser.add_argument("--synthetic-data", action="store_true",
                        help="use the built-in synthetic corpus")
    parser.add_argument("--synthetic-rirs", action="store_true",
                        help="augment with synthetic RIR/noise pools")
    parser.add_argument("--synthetic-speakers", type=int, default=8)
    parser.add_argument("--synthetic-utts", type=int, default=6)
    parser.add_argument("--synthetic-f0-max", type=float, default=None)
    parser.add_argument("--synthetic-voice", default="harmonic",
                        choices=("harmonic", "formant"))
    parser.add_argument("--spatialize-channels", type=int, default=0,
                        choices=(0, 7),
                        help="7-mic spatial training: ROADMAP.md Queue 1 "
                             "item 8a, not ported (raises)")
    parser.add_argument("--sensor-noise-level", type=float, default=0.003)
    parser.add_argument("--train-ipd-index",
                        default="1,0;2,0;3,0;4,0;5,0;6,0")
    parser.add_argument("--expdir", type=str, required=True)
    parser.add_argument("--model", default="Conformer",
                        choices=sorted(MODELS))
    parser.add_argument("--objective", default="MSE",
                        choices=sorted(OBJECTIVES))
    parser.add_argument("--dataset", default="css", choices=["css"])
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--grad-thresh", type=float, default=30.0)
    parser.add_argument("--optim", default="sgd", choices=["sgd", "adam"])
    parser.add_argument("--lr", type=float, default=0.001)
    parser.add_argument("--weight-decay", type=float, default=1e-8)
    parser.add_argument("--bf16", action="store_true",
                        help="bf16 model compute over float32 parameters")
    parser.add_argument("--resume", default=None)
    parser.add_argument("--init", default=None)
    parser.add_argument("--replace-output", action="store_true",
                        help="with --init, re-initialise output layers")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--job", type=int, default=1)
    parser.add_argument("--num-epochs", type=int, default=10)
    parser.add_argument("--batches-per-epoch", type=int, default=500)
    parser.add_argument("--steps-per-dispatch", type=int, default=4,
                        help="the mixer holds each window bucket for this "
                             "many batches, as in css_tpu; the port runs "
                             "the steps one after another (css_tpu scans "
                             "them in one device program), with the same "
                             "results")
    parser.add_argument("--strategy", default="single",
                        choices=["single", "dp", "replica_avg"],
                        help="dp and replica_avg: ROADMAP.md Queue 1 item "
                             "10, not ported (raise)")
    parser.add_argument("--tp", type=int, default=1)
    parser.add_argument("--num-replicas", type=int, default=None)
    parser.add_argument("--nj-init", type=int, default=None)
    parser.add_argument("--keep-every", type=int, default=20)
    parser.add_argument("--keep-last", type=int, default=2)
    parser.add_argument("--multihost", action="store_true")
    parser.add_argument("--coordinator", default=None)
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--profile-dir", default=None,
                        help="write a torch.profiler trace of epoch 1 here")
    parser.add_argument("--keep-best", action="store_true",
                        help="also save best.{job}.mdl whenever the "
                             "validation loss improves")
    parser.add_argument("--probe-sessions", type=int, default=0,
                        help="held-out SI-SNRi probe: ROADMAP.md Queue 1 "
                             "item 8c, not ported (raises when > 0)")
    parser.add_argument("--probe-session-sec", type=float, default=12.0)
    parser.add_argument("--probe-stratify-f0", action="store_true")
    parser.add_argument("--average-probe-top", type=int, default=0)
    parser.add_argument("--probe-seed", type=int, default=456)
    parser.add_argument("--probe-speakers", type=int, default=6)
    parser.add_argument("--probe-utts", type=int, default=4)
    parser.add_argument("--validate-batches", type=int, default=100)
    parser.add_argument("--num-workers", type=int, default=2,
                        help="producer threads for mixture synthesis")
    parser.add_argument("--device-mix", action="store_true",
                        help="on-device mixing: ROADMAP.md Queue 1 item "
                             "8b, not ported (raises)")
    parser.add_argument("--fail-after-batches", type=int, default=None,
                        help="crash this process (exit 17, no checkpoint) "
                             "after N batches")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")

    # two-phase parsing: the chosen components add their flags
    args, _ = parser.parse_known_args(argv)
    MODEL_ARGS[args.model](parser)
    _dataset_args(parser)
    OBJECTIVES[args.objective].add_args(parser)
    LRSchedule.add_args(parser)
    parser.parse_args(argv, namespace=args)
    return args


def _pin_dev_windows(conf):
    """Validation conf: one fixed mid-range window bucket and a fixed
    seed, so validation losses compare across epochs."""
    lo = float(conf.get("min_window_size", 2.0))
    hi = float(conf.get("max_window_size", 4.0))
    mid = (lo + hi) / 2
    return {**conf, "seed": 12345, "min_window_size": mid,
            "max_window_size": mid}


def build_corpus(args):
    if args.synthetic_data or not args.train_manifest:
        corpus = SyntheticCorpus(seed=args.seed,
                                 num_speakers=args.synthetic_speakers,
                                 utts_per_speaker=args.synthetic_utts,
                                 f0_max=args.synthetic_f0_max,
                                 voice=args.synthetic_voice)
        dev = SyntheticCorpus(seed=args.seed + 1000, num_speakers=4,
                              utts_per_speaker=2, voice=args.synthetic_voice)
    else:
        corpus = Corpus.from_manifest(args.train_manifest)
        dev = (Corpus.from_manifest(args.dev_manifest)
               if args.dev_manifest else None)
    return corpus, dev


def _simple(conf):
    return {k: v for k, v in conf.items()
            if isinstance(v, (str, int, float, bool, type(None)))}


def main(argv=None):
    args = parse_arguments(argv)
    for flag, is_set, item in NOT_PORTED:
        if is_set(args):
            raise NotImplementedError(
                f"{flag} is not ported yet: ROADMAP.md {item}")
    device = resolve_device(args.device)
    expdir = Path(args.expdir)
    expdir.mkdir(parents=True, exist_ok=True)
    np.random.seed(args.seed)

    conf_path = expdir / f"conf.{args.job}.json"
    if args.resume is not None and conf_path.exists():
        with open(conf_path) as fh:
            conf = json.load(fh)
    else:
        conf = vars(args).copy()
        conf["epoch"] = 0
        with open(conf_path, "w") as fh:
            json.dump(conf, fh, indent=4, default=str)

    corpus, dev_corpus = build_corpus(args)
    conf["seed"] = args.seed + 1000 * args.job
    if args.synthetic_rirs:
        conf["rir_pool"] = synthetic_rir_pool()
        conf["noise_pool"] = synthetic_noise_pool()
    if args.num_workers > 1 and conf.get("window_seed") is None:
        # producer threads must draw the same window-bucket sequence; the
        # offset keeps this stream apart from every content seed
        conf["window_seed"] = args.seed + 1000 * args.job + 104729

    def make_train_stream(i=0):
        return MixtureSynthesizer.build_dataset(
            corpus, {**conf, "seed": conf["seed"] + 7 * i})

    if args.num_workers > 1:
        dataset = PrefetchLoader(factory=make_train_stream,
                                 num_threads=args.num_workers, device=device)
    else:
        dataset = make_train_stream()
    dev_dataset = (MixtureSynthesizer.build_dataset(
        dev_corpus, _pin_dev_windows(conf)) if dev_corpus else None)
    if args.fail_after_batches is not None:
        def _crashing(it, n=args.fail_after_batches):
            for i, b in enumerate(it):
                if i >= n:
                    os._exit(17)  # abrupt death mid-epoch, like SIGKILL
                yield b
        dataset = _crashing(iter(dataset))

    conf["bf16"] = args.bf16
    model = MODELS[args.model].build_model(conf)
    model.load_state_dict(from_jax(model, *init_variables(model, args.seed)))
    objective = OBJECTIVES[args.objective].build_objective(conf)
    trainer = Trainer(model, objective, LRSchedule.from_conf(conf),
                      optim=args.optim, weight_decay=args.weight_decay,
                      grad_thresh=args.grad_thresh,
                      input_domain=("time" if args.model == "ConvTasNet"
                                    else "stft"),
                      device=device, seed=args.seed)
    n_params = sum(p.numel() for p in model.parameters())
    log.info("Training %s with %d parameters (single strategy on %s)",
             args.model, n_params, torch.cuda.get_device_name(device)
             if device.type == "cuda" else "cpu")

    start_epoch = 0
    if args.resume is not None:
        ckpt = checkpoint.load_checkpoint(expdir / args.resume)
        trainer.load_state(checkpoint.restore_state(ckpt, trainer.state()))
        start_epoch = ckpt["epoch"]
        log.info("Resumed from %s at epoch %d", args.resume, start_epoch)
    if args.init is not None:
        ckpt = checkpoint.load_checkpoint(args.init)
        state = trainer.state()
        state.params = checkpoint.warm_start(
            state.params, ckpt["params"], replace_output=args.replace_output)
        trainer.load_state(state)
        log.info("Warm-started from %s (replace_output=%s)", args.init,
                 args.replace_output)

    metrics_log = MetricsLogger(expdir / f"train.{args.job}.jsonl",
                                echo_every=50)
    best_val = float("inf")
    profiler = None
    if args.profile_dir:
        from torch.profiler import ProfilerActivity, profile

        profiler = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
        profiler.start()
    for e in range(start_epoch, start_epoch + args.num_epochs):
        avg_loss = trainer.train_one_epoch(dataset, args.batches_per_epoch,
                                           metrics_log)
        t_val = _time.perf_counter()
        val = None
        if dev_dataset is not None:
            val = trainer.validate(dev_dataset,
                                   num_batches=args.validate_batches)
            log.info("Epoch %d :: train loss %.5f valid loss %.5f "
                     "(validate %.1fs)", e + 1, avg_loss, val,
                     _time.perf_counter() - t_val)
        else:
            log.info("Epoch %d :: train loss %.5f", e + 1, avg_loss)
        if (args.keep_best and val is not None and np.isfinite(val)
                and val < best_val):
            best_val = val
            log.info("New best validation loss %.5f (epoch %d)", val, e + 1)
            checkpoint.save_checkpoint(
                expdir / f"best.{args.job}.mdl", trainer.state(),
                epoch=e + 1, loss=float(val), conf=_simple(conf))
        if profiler is not None:  # exactly one epoch
            profiler.stop()
            Path(args.profile_dir).mkdir(parents=True, exist_ok=True)
            profiler.export_chrome_trace(
                str(Path(args.profile_dir) / "trace.json"))
            profiler = None
            log.info("Profiler trace written to %s", args.profile_dir)
        if not np.isnan(avg_loss):  # NaN epochs are not checkpointed
            t_save = _time.perf_counter()
            checkpoint.save_checkpoint(
                expdir / f"{e + 1}.{args.job}.mdl", trainer.state(),
                epoch=e + 1, loss=avg_loss, conf=_simple(conf))
            checkpoint.gc_checkpoints(expdir, keep_every=args.keep_every,
                                      keep_last=args.keep_last, job=args.job)
            log.info("Checkpoint %d.%d saved (%.1fs)", e + 1, args.job,
                     _time.perf_counter() - t_save)
    if isinstance(dataset, PrefetchLoader):
        dataset.close()
    metrics_log.close()
    log.info("Done.")
    return trainer


if __name__ == "__main__":
    main()
