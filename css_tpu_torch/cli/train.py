"""Training CLI (port of ``css_tpu/cli/train.py``).

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
here.

--strategy dp (with --tp N, the Conformer's tensor parallelism) and
--strategy replica_avg (--num-replicas, the --nj-init ramp of alive
replicas) run one process per card (``parallel/``): in one process a
world-1 process group, with --multihost one rank of --num-processes
joined at --coordinator (``python -m css_tpu_torch.parallel.launch
--num-processes N -- ...`` starts them). Each process draws its own
mixtures (seed + 7919 * its data rank) of --batch-size / processes rows,
window buckets in lockstep (a shared window seed), with one producer
thread; rank 0 alone writes files and runs validation and the probe
(every rank under --tp > 1, whose forward needs them all). --rank-report
DIR makes each rank write what it did to DIR/rank<r>.json.

--spatialize-channels 7 trains the 7ch (IPD-featured) model on mixtures
rendered on the 7-mic array (``data/spatial.SpatialMixer``, sensor noise
--sensor-noise-level, IPD pairs --train-ipd-index). --device-mix mixes on
the card from encoded recipes (``data/device_mixer.py``). --probe-sessions
N scores every epoch with the held-out probe (``trainer/probe.py``), which
then selects ``best.<job>.mdl`` under --keep-best; --average-probe-top N
keeps the N best-probed epochs and averages them into
``avgtop.<job>.mdl``, or ships the best single epoch where the average
probes worse or not finite.
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
from css_tpu_torch.data.device_mixer import DeviceMixer
from css_tpu_torch.data.loader import PrefetchLoader
from css_tpu_torch.data.mixer import MixtureSynthesizer
from css_tpu_torch.data.spatial import SpatialMixer
from css_tpu_torch.device import resolve_device
from css_tpu_torch.models import MODELS, from_jax, init_variables
from css_tpu_torch.objectives import OBJECTIVES
from css_tpu_torch.ops import istft_cuda, lstm_cuda, stft_mag_cuda
from css_tpu_torch.parallel import launch, mesh as mesh_mod
from css_tpu_torch.parallel.dp import (SEED_STRIDE, DataParallel,
                                       ReplicaAveraging, state_digest)
from css_tpu_torch.trainer import checkpoint
from css_tpu_torch.trainer.loop import Trainer
from css_tpu_torch.trainer.lr_schedule import LRSchedule
from css_tpu_torch.trainer.probe import HeldOutProbe
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
                        help="banded left-context attention + causal conv "
                             "+ cumulative MVN: hop-granular streaming "
                             "inference with carried KV caches "
                             "(cli.separate --stream-mode hop)")
    parser.add_argument("--conformer-left-context", type=int, default=128,
                        help="attention window (frames) of the causal "
                             "model; also the streaming KV cache size")


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


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(
        description="Train a separation model on the card (the port of "
                    "css_tpu.cli.train).")
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
                        help="render training mixtures on the 7-mic "
                             "circular array (far-field delays, per-window "
                             "azimuths) and train the IPD-featured model")
    parser.add_argument("--sensor-noise-level", type=float, default=0.003,
                        help="white sensor noise added per channel by "
                             "--spatialize-channels")
    parser.add_argument("--train-ipd-index",
                        default="1,0;2,0;3,0;4,0;5,0;6,0",
                        help="IPD channel pairs for multichannel training "
                             "(config_7ch.yaml 'ipd' syntax)")
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
                        help="train steps launched as one program on the "
                             "card (single strategy; a captured CUDA graph "
                             "of G steps, as css_tpu scans them in one "
                             "device program), with no host "
                             "synchronisation between them; the mixer holds "
                             "each window bucket for this many batches and "
                             "the loader regroups same-shape runs so groups "
                             "stack. 1 = one program per step")
    parser.add_argument("--strategy", default="single",
                        choices=["single", "dp", "replica_avg"],
                        help="dp: synchronous data parallelism over the "
                             "processes (with --tp); replica_avg: one "
                             "independent replica per process, averaged "
                             "every epoch")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel degree (dp strategy)")
    parser.add_argument("--num-replicas", type=int, default=None,
                        help="replica_avg strategy replica count")
    parser.add_argument("--nj-init", type=int, default=None,
                        help="replica_avg: ramp the alive replicas from "
                             "nj_init to num-replicas over the run")
    parser.add_argument("--keep-every", type=int, default=20)
    parser.add_argument("--keep-last", type=int, default=2)
    parser.add_argument("--multihost", action="store_true",
                        help="join a process group of --num-processes at "
                             "--coordinator as --process-id")
    parser.add_argument("--coordinator", default=None,
                        help="host:port of the process group's rendezvous")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--dist-timeout", type=float,
                        default=launch.DEFAULT_TIMEOUT_S,
                        help="seconds a collective may wait before it "
                             "fails")
    parser.add_argument("--rank-report", default=None,
                        help="directory where each rank writes "
                             "rank<r>.json: its kernel launches, the "
                             "files it wrote, a digest of its parameters")
    parser.add_argument("--profile-dir", default=None,
                        help="write a torch.profiler trace of epoch 1 here")
    parser.add_argument("--keep-best", action="store_true",
                        help="also save best.{job}.mdl whenever the "
                             "selection metric improves (the held-out "
                             "probe's SI-SNRi with --probe-sessions, else "
                             "the validation loss)")
    parser.add_argument("--probe-sessions", type=int, default=0,
                        help="score every epoch by the held-out SI-SNRi "
                             "probe on this many fixed synthetic sessions")
    parser.add_argument("--probe-session-sec", type=float, default=12.0)
    parser.add_argument("--probe-stratify-f0", action="store_true",
                        help="spread the probe sessions' speaker pairs "
                             "over the |f0| gap ranking, closest included")
    parser.add_argument("--average-probe-top", type=int, default=0,
                        help="after training, average the N best-probed "
                             "epochs into avgtop.{job}.mdl (needs "
                             "--probe-sessions)")
    parser.add_argument("--probe-seed", type=int, default=456,
                        help="the held-out probe corpus' seed")
    parser.add_argument("--probe-speakers", type=int, default=6)
    parser.add_argument("--probe-utts", type=int, default=4)
    parser.add_argument("--validate-batches", type=int, default=100)
    parser.add_argument("--num-workers", type=int, default=2,
                        help="producer threads for mixture synthesis")
    parser.add_argument("--device-mix", action="store_true",
                        help="mix on the card: the audio pools go to the "
                             "card once and the host streams only the "
                             "mixing decisions")
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


def _check_flags(args):
    """The JAX package's incompatibility errors, before any process group
    is joined."""
    n_proc = (args.num_processes or 1) if args.multihost else 1
    if (n_proc > 1 and args.strategy in ("dp", "replica_avg")
            and args.batch_size % n_proc):
        raise SystemExit(f"--batch-size {args.batch_size} must be "
                         f"divisible by {n_proc} processes")
    if args.spatialize_channels:
        if args.synthetic_rirs:
            raise SystemExit("--spatialize-channels is incompatible with "
                             "--synthetic-rirs (mono-mixture reverb has no "
                             "spatial image; sensor noise is added per "
                             "channel instead)")
        if args.device_mix and n_proc > 1:
            raise SystemExit("--spatialize-channels with --device-mix is "
                             "single-process for now")
        if args.model == "ConvTasNet":
            raise SystemExit("--spatialize-channels needs a mask model "
                             "(Conformer/BLSTM)")
    if args.device_mix and n_proc > 1 and args.strategy == "single":
        raise SystemExit("--device-mix with multiple processes requires "
                         "--strategy dp or replica_avg")
    if args.strategy == "dp" and args.tp > 1:
        if args.model != "Conformer":
            raise SystemExit("--tp>1 currently supports Conformer only")
        if args.average_probe_top > 0:
            raise SystemExit("--average-probe-top with --tp > 1 is not "
                             "supported: rank 0 alone probes the average")
    if args.average_probe_top > 0 and args.probe_sessions <= 0:
        raise SystemExit("--average-probe-top requires --probe-sessions > 0")


def build_probe(args, conf, train_ipd, device) -> HeldOutProbe:
    """The held-out probe in the model family's mode: time for waveform
    models, spatial for 7ch training, else mask."""
    if args.model == "ConvTasNet":
        mode, probe_ipd = "time", None
    elif args.spatialize_channels:
        mode, probe_ipd = "spatial", train_ipd
    else:
        mode, probe_ipd = "mask", None
    corpus = SyntheticCorpus(num_speakers=args.probe_speakers,
                             utts_per_speaker=args.probe_utts,
                             seed=args.probe_seed,
                             f0_max=args.synthetic_f0_max,
                             voice=args.synthetic_voice)
    return HeldOutProbe(corpus, sessions=args.probe_sessions,
                        session_sec=args.probe_session_sec,
                        seed=args.probe_seed,
                        num_spk=int(conf.get("num_spk", 2) or 2),
                        mode=mode, ipd_index=probe_ipd,
                        noise_level=args.sensor_noise_level,
                        stratify_f0=args.probe_stratify_f0, device=device)


def _join(args):
    """(device, rank, processes): --multihost joins its process group, a
    one-process dp/replica_avg run opens a world-1 group (the same code
    as N ranks), --strategy single opens none."""
    if args.multihost:
        device = launch.initialize(args.coordinator, args.num_processes,
                                   args.process_id, args.device,
                                   args.dist_timeout)
    elif args.strategy != "single":
        device = launch.initialize(f"localhost:{launch.free_port()}", 1, 0,
                                   args.device, args.dist_timeout)
    else:
        device = resolve_device(args.device)
    return (device, *mesh_mod.world())


KERNELS = (stft_mag_cuda.stft_mag, istft_cuda.istft, lstm_cuda.lstm_fused)


def main(argv=None):
    args = parse_arguments(argv)
    _check_flags(args)
    device, rank, n_proc = _join(args)
    try:
        return _train(args, device, rank, n_proc)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _train(args, device, rank: int, n_proc: int):
    """Everything after the process group is joined: rank 0 owns the
    files."""
    is_lead = rank == 0
    written = []  # files this rank wrote (--rank-report)
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
        if is_lead:
            with open(conf_path, "w") as fh:
                json.dump(conf, fh, indent=4, default=str)
            written.append(conf_path.name)

    mesh = None
    if args.strategy == "dp":
        mesh = mesh_mod.make_mesh(model=args.tp)
    elif args.strategy == "replica_avg":
        mesh = mesh_mod.make_mesh()
    # the rows a process draws: its data rank's share of the global batch
    data_rank, data_size = ((mesh.data_rank, mesh.data) if mesh is not None
                            else (0, 1))
    corpus, dev_corpus = build_corpus(args)
    conf["seed"] = args.seed + 1000 * args.job
    if n_proc > 1:
        # disjoint mixture streams per data rank (the ranks of one model
        # group draw alike: they hold the same rows)
        conf["seed"] += SEED_STRIDE * data_rank
        if args.strategy in ("dp", "replica_avg"):
            conf["batch_size"] = args.batch_size // data_size
            if args.num_workers > 1:
                log.warning("multi-process strategies need lockstep window "
                            "buckets across processes; forcing "
                            "--num-workers 1")
                args.num_workers = 1
    if args.synthetic_rirs:
        conf["rir_pool"] = synthetic_rir_pool()
        conf["noise_pool"] = synthetic_noise_pool()

    def spatial(ds, seed):
        if not args.spatialize_channels:
            return ds
        return SpatialMixer(ds, noise_level=args.sensor_noise_level,
                            seed=seed)

    dmix = dev_dmix = None
    if args.device_mix:
        # the pools of the training and the validation material, on this
        # rank's card; the spatial draws of device-mixed recipes come from
        # these
        dmix = DeviceMixer(spatial(MixtureSynthesizer.build_dataset(
            corpus, conf), conf["seed"] + 31), device=device)
        if dev_corpus is not None:
            dev_dmix = DeviceMixer(spatial(MixtureSynthesizer.build_dataset(
                dev_corpus, _pin_dev_windows(conf)), 12376), device=device)
    if ((args.num_workers > 1
         or (n_proc > 1 and args.strategy in ("dp", "replica_avg")))
            and conf.get("window_seed") is None):
        # producer threads and cooperating processes must draw the same
        # window-bucket sequence; the offset keeps this stream apart from
        # every content seed
        conf["window_seed"] = args.seed + 1000 * args.job + 104729

    def make_train_stream(i=0):
        ds = MixtureSynthesizer.build_dataset(
            corpus, {**conf, "seed": conf["seed"] + 7 * i})
        if dmix is not None:
            return dmix.wrap(ds)  # spatial rendering happens on the card
        return spatial(ds, conf["seed"] + 7 * i + 31)

    # G same-shape steps a dispatch, single strategy only (as css_tpu)
    group = args.steps_per_dispatch if args.strategy == "single" else 1
    if args.num_workers > 1:
        # with G > 1 the batches stay on the host until a group is whole,
        # and the group moves to the card in one transfer a key
        dataset = PrefetchLoader(
            factory=make_train_stream, num_threads=args.num_workers,
            device=device if group == 1 else None, group=group)
    else:
        dataset = make_train_stream()
    if dev_dmix is not None:
        dev_dataset = dev_dmix
    else:
        dev_dataset = (spatial(MixtureSynthesizer.build_dataset(
            dev_corpus, _pin_dev_windows(conf)), 12376)
            if dev_corpus else None)
    if args.fail_after_batches is not None:
        def _crashing(it, n=args.fail_after_batches):
            for i, b in enumerate(it):
                if i >= n:
                    os._exit(17)  # abrupt death mid-epoch, like SIGKILL
                yield b
        dataset = _crashing(iter(dataset))

    conf["bf16"] = args.bf16
    train_ipd = None
    if args.spatialize_channels:
        train_ipd = args.train_ipd_index
        # [ch0 magnitude, M IPD pairs]: the 7ch separator's feature layout
        conf["idim"] = int(conf.get("num_bins", 257)) * (
            1 + len(train_ipd.split(";")))
    tp = args.tp if args.strategy == "dp" else 1
    model = (MODELS[args.model].build_model(conf, tp_group=mesh.model_group)
             if tp > 1 else MODELS[args.model].build_model(conf))
    # every replica of replica_avg starts from its own draw; every rank of
    # dp from the same one
    init_seed = args.seed + (SEED_STRIDE * rank
                             if args.strategy == "replica_avg" else 0)
    # drawn on the full model (a TP shard's shapes are not the model's)
    whole = MODELS[args.model].build_model(conf) if tp > 1 else model
    full = from_jax(whole, *init_variables(whole, init_seed))
    del whole
    objective = OBJECTIVES[args.objective].build_objective(conf)
    trainer = Trainer(model, objective, LRSchedule.from_conf(conf),
                      optim=args.optim, weight_decay=args.weight_decay,
                      grad_thresh=args.grad_thresh,
                      input_domain=("time" if args.model == "ConvTasNet"
                                    else "stft"),
                      device=device, seed=args.seed, ipd_index=train_ipd)
    strategy = None
    if args.strategy == "dp":
        strategy = DataParallel(trainer, mesh, tp_spec=(
            mesh_mod.conformer_tp_spec(full) if tp > 1 else None))
        strategy.load_full(full)
    else:
        model.load_state_dict(full)
        if args.strategy == "replica_avg":
            strategy = ReplicaAveraging(trainer, mesh,
                                        num_replicas=args.num_replicas)
    # rank 0 owns the files and the checks; under TP every rank runs the
    # forward of validation and the probe, and gathers the state
    evaluates = is_lead or tp > 1
    probe = (build_probe(args, conf, train_ipd, device)
             if args.probe_sessions > 0 and evaluates else None)
    n_params = sum(int(np.prod(v.shape)) for v in full.values())
    log.info("Training %s with %d parameters (%s strategy, rank %d of %d "
             "on %s)", args.model, n_params, args.strategy, rank, n_proc,
             torch.cuda.get_device_name(device)
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

    metrics_log = None
    if is_lead:
        metrics_log = MetricsLogger(expdir / f"train.{args.job}.jsonl",
                                    echo_every=50)
        written.append(f"train.{args.job}.jsonl")
    best_val = float("inf")
    best_probe = float("-inf")
    probe_top = []  # [(probe SI-SNRi, epoch, path)], the best N epochs
    epoch_losses = []
    profiler = None
    if args.profile_dir and is_lead:
        from torch.profiler import ProfilerActivity, profile

        profiler = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
        profiler.start()
    for k in KERNELS:
        k.launches = k.plain_routes = 0
    for e in range(start_epoch, start_epoch + args.num_epochs):
        avg_loss = trainer.train_one_epoch(dataset, args.batches_per_epoch,
                                           metrics_log, dmix=dmix,
                                           steps_per_dispatch=group)
        if args.strategy == "replica_avg":
            alive = _alive(args, strategy.num_replicas, e - start_epoch)
            strategy.average(alive)
            avg_loss = _alive_mean(avg_loss, alive, strategy)
        epoch_losses.append(avg_loss)
        t_val = _time.perf_counter()
        val = None
        if dev_dataset is not None and evaluates:
            val = trainer.validate(dev_dataset,
                                   num_batches=args.validate_batches,
                                   dmix=dev_dmix)
            log.info("Epoch %d :: train loss %.5f valid loss %.5f "
                     "(validate %.1fs)", e + 1, avg_loss, val,
                     _time.perf_counter() - t_val)
        else:
            log.info("Epoch %d :: train loss %.5f", e + 1, avg_loss)
        probe_val = None
        if probe is not None:
            probe_val = probe(trainer.model)
            log.info("Epoch %d :: held-out probe SI-SNRi %+.3f dB",
                     e + 1, probe_val)
            if metrics_log is not None:
                metrics_log({"epoch": e + 1,
                             "probe_si_snri_db": float(probe_val)})
        selection_loss = float(val if val is not None else avg_loss)
        # the full state: a collective under TP (and replica 0's a
        # broadcast), so every rank takes it
        if args.strategy == "replica_avg":
            state = strategy.replica_state(0)
        else:
            state = trainer.state() if evaluates else None
        if (args.average_probe_top > 0 and is_lead and probe_val is not None
                and np.isfinite(probe_val)):
            if (len(probe_top) < args.average_probe_top
                    or probe_val > probe_top[-1][0]):
                p = expdir / f"ptop.{e + 1}.{args.job}.mdl"
                checkpoint.save_checkpoint(
                    p, state, epoch=e + 1, loss=selection_loss,
                    conf=_simple(conf),
                    extra={"probe_si_snri_db": float(probe_val)})
                probe_top.append((float(probe_val), e + 1, p))
                probe_top.sort(key=lambda t: -t[0])
                while len(probe_top) > args.average_probe_top:
                    probe_top.pop()[2].unlink(missing_ok=True)
        if args.keep_best and is_lead:
            # the probe selects where it runs (validation MSE picks the
            # wrong checkpoint, BASELINE.md); else the validation loss
            improved = False
            if probe_val is not None and np.isfinite(probe_val):
                if probe_val > best_probe:
                    best_probe = probe_val
                    improved = True
                    log.info("New best probe SI-SNRi %+.3f dB (epoch %d)",
                             probe_val, e + 1)
            elif val is not None and np.isfinite(val) and val < best_val:
                best_val = val
                improved = True
                log.info("New best validation loss %.5f (epoch %d)",
                         val, e + 1)
            if improved:
                checkpoint.save_checkpoint(
                    expdir / f"best.{args.job}.mdl", state,
                    epoch=e + 1, loss=selection_loss, conf=_simple(conf),
                    extra=({"probe_si_snri_db": float(probe_val)}
                           if probe_val is not None else None))
                written.append(f"best.{args.job}.mdl")
        if profiler is not None:  # exactly one epoch
            profiler.stop()
            Path(args.profile_dir).mkdir(parents=True, exist_ok=True)
            profiler.export_chrome_trace(
                str(Path(args.profile_dir) / "trace.json"))
            profiler = None
            log.info("Profiler trace written to %s", args.profile_dir)
        if is_lead and not np.isnan(avg_loss):  # NaN epochs: no checkpoint
            t_save = _time.perf_counter()
            checkpoint.save_checkpoint(
                expdir / f"{e + 1}.{args.job}.mdl", state,
                epoch=e + 1, loss=avg_loss, conf=_simple(conf))
            written.append(f"{e + 1}.{args.job}.mdl")
            checkpoint.gc_checkpoints(expdir, keep_every=args.keep_every,
                                      keep_last=args.keep_last, job=args.job)
            log.info("Checkpoint %d.%d saved (%.1fs)", e + 1, args.job,
                     _time.perf_counter() - t_save)
    if args.average_probe_top > 0 and probe_top:
        average_probe_top(trainer, probe, probe_top, expdir, args.job,
                          metrics_log)
        written.append(f"avgtop.{args.job}.mdl")
    in_sync = strategy.in_sync() if isinstance(strategy, DataParallel) \
        else None
    if in_sync is False:
        log.warning("rank %d: parameters differ from data rank 0's", rank)
    if args.rank_report:
        report = Path(args.rank_report)
        report.mkdir(parents=True, exist_ok=True)
        (report / f"rank{rank}.json").write_text(json.dumps({
            "rank": rank, "processes": n_proc, "device": str(device),
            "backend": (torch.distributed.get_backend()
                        if torch.distributed.is_initialized() else None),
            "strategy": args.strategy, "epoch_losses": epoch_losses,
            "launches": {k.__name__: k.launches for k in KERNELS},
            "plain_routes": {k.__name__: k.plain_routes for k in KERNELS},
            "written": written, "state_digest": state_digest(trainer),
            "in_sync": in_sync}))
    if isinstance(dataset, PrefetchLoader):
        dataset.close()
    if metrics_log is not None:
        metrics_log.close()
    log.info("Done.")
    return trainer


def _alive(args, replicas: int, done_epochs: int) -> np.ndarray:
    """The alive replicas of an epoch: all, or with --nj-init the linear
    ramp from nj_init to every replica over the run."""
    nj = replicas
    if args.nj_init:
        frac = (done_epochs + 1) / max(args.num_epochs, 1)
        nj = min(replicas, max(args.nj_init, int(
            args.nj_init + frac * (replicas - args.nj_init))))
    alive = np.zeros(replicas, bool)
    alive[:nj] = True
    return alive


def _alive_mean(loss: float, alive: np.ndarray,
                strategy: ReplicaAveraging) -> float:
    """The mean epoch loss over the alive replicas."""
    if strategy.mesh.world == 1:
        return loss
    j = strategy.replica
    w = float(alive[j]) if j is not None else 0.0
    t = torch.tensor([w * loss], device=strategy.trainer.device)
    torch.distributed.all_reduce(t)
    return float(t) / float(alive.sum())


def average_probe_top(trainer, probe, probe_top, expdir: Path, job: int,
                      metrics_log) -> None:
    """Average the probe-top checkpoints (one run, so one basin) into
    ``avgtop.<job>.mdl`` and probe the average; where it probes worse than
    the best single epoch, or not finite, ship that epoch instead. The
    probe-top files are deleted after. The trainer is left as it was."""
    out = expdir / f"avgtop.{job}.mdl"
    merged = checkpoint.average_checkpoints([str(p) for _, _, p in probe_top])
    checkpoint.save_checkpoint_dict(str(out), merged)
    model = trainer.model
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    model.load_state_dict(from_jax(model, merged["params"],
                                   merged.get("batch_stats")))
    try:
        avg_probe = probe(model)
    finally:
        model.load_state_dict(saved)
    log.info("avgtop.%d.mdl: averaged %d probe-top epochs %s (probe %s) -> "
             "probe SI-SNRi %+.3f dB", job, len(probe_top),
             [e for _, e, _ in probe_top],
             ["%+.2f" % v for v, _, _ in probe_top], avg_probe)
    best_val, best_epoch, best_path = probe_top[0]
    if not np.isfinite(avg_probe):
        log.warning("avgtop.%d.mdl: probe of the average is non-finite (%s) "
                    "-- treating as worse than best single epoch", job,
                    avg_probe)
    if not np.isfinite(avg_probe) or avg_probe < best_val:
        checkpoint.save_checkpoint_dict(
            str(out), checkpoint.load_checkpoint(str(best_path)))
        log.info("avgtop.%d.mdl: average (%+.3f) probes WORSE than best "
                 "single epoch %d (%+.3f) -- shipping the single epoch", job,
                 avg_probe, best_epoch, best_val)
        avg_probe, avg_epochs = best_val, [best_epoch]
    else:
        avg_epochs = [e for _, e, _ in probe_top]
    metrics_log({"avgtop_epochs": avg_epochs,
                 "avgtop_probe_si_snri_db": float(avg_probe)})
    for _, _, p in probe_top:
        p.unlink(missing_ok=True)


if __name__ == "__main__":
    main()
