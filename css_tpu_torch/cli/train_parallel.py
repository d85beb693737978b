"""Process-level parallel training driver with fail-fast, retry and
elastic recovery (port of ``css_tpu/cli/train_parallel.py``).

    python -m css_tpu_torch.cli.train_parallel --expdir exp --num-epochs 4 \\
        --nj-init 1 --nj-final 4 -- --synthetic-data --model BLSTM ...

Per epoch it launches ``nj`` independent single-epoch
``css_tpu_torch.cli.train`` processes (the job count ramping from
--nj-init to --nj-final), waits for them all, retries failed ones
(--retry), averages the survivors' checkpoints with
``css_tpu_torch.cli.combine`` (renormalised over the survivors),
garbage-collects old checkpoints and resumes the next epoch from the
average. ``--on-failure elastic`` (default) goes on with the survivors;
``abort`` leaves the ``.error.E.J`` sentinel and exits non-zero.
``--inject-failure E.J[:STEP]`` makes job J of epoch E crash after STEP
batches (default 2). Each job's log is ``expdir/log/train.E.J.log``.
Everything after ``--`` goes to every job; ``--device`` there also
selects where the average is computed.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

from css_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--expdir", required=True)
    parser.add_argument("--num-epochs", type=int, default=10)
    parser.add_argument("--nj-init", type=int, default=1)
    parser.add_argument("--nj-final", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--retry", type=int, default=1,
                        help="re-launch attempts per failed job per epoch")
    parser.add_argument("--on-failure", choices=["elastic", "abort"],
                        default="elastic")
    parser.add_argument("--keep-every", type=int, default=20)
    parser.add_argument("--keep-last", type=int, default=2)
    parser.add_argument("--stagger-sec", type=float, default=0.0,
                        help="delay between job launches")
    parser.add_argument("--inject-failure", default=None,
                        help="E.J[:STEP]: crash job J of epoch E after STEP "
                             "batches")
    parser.add_argument("train_args", nargs=argparse.REMAINDER,
                        help="arguments for css_tpu_torch.cli.train "
                             "(everything after --)")
    return parser.parse_args(argv)


def _train_args(args) -> list:
    return [a for a in args.train_args if a != "--"]


def job_argv(args, epoch: int, job: int, resume: str | None):
    argv = [sys.executable, "-m", "css_tpu_torch.cli.train",
            "--expdir", args.expdir, "--job", str(job), "--num-epochs", "1",
            # deterministic per-(epoch, job) seeds
            "--seed", str(args.seed + 100 * epoch + job), *_train_args(args)]
    if resume:
        argv += ["--resume", resume]
    if args.inject_failure:
        spec, _, step = args.inject_failure.partition(":")
        e, _, j = spec.partition(".")
        if int(e) == epoch and int(j) == job:
            argv += ["--fail-after-batches", step or "2"]
    return argv


def run_epoch_jobs(args, epoch: int, nj: int, resume: str | None) -> list:
    """Launch nj jobs, wait, retry failures; returns the surviving job
    ids."""
    logdir = Path(args.expdir) / "log"
    logdir.mkdir(parents=True, exist_ok=True)
    attempts = {j: 0 for j in range(1, nj + 1)}
    running = {}
    for j in range(1, nj + 1):
        logf = open(logdir / f"train.{epoch}.{j}.log", "w")
        running[j] = (subprocess.Popen(job_argv(args, epoch, j, resume),
                                       stdout=logf, stderr=subprocess.STDOUT),
                      logf)
        if args.stagger_sec:
            time.sleep(args.stagger_sec)
    survivors, dead = [], []
    while running:
        for j, (proc, logf) in list(running.items()):
            rc = proc.poll()
            if rc is None:
                continue
            logf.close()
            del running[j]
            if rc == 0:
                survivors.append(j)
            elif attempts[j] < args.retry:
                attempts[j] += 1
                log.warning("epoch %d job %d failed (rc=%d) -- retry %d/%d",
                            epoch, j, rc, attempts[j], args.retry)
                logf = open(logdir / f"train.{epoch}.{j}.log", "a")
                running[j] = (subprocess.Popen(
                    job_argv(args, epoch, j, resume),
                    stdout=logf, stderr=subprocess.STDOUT), logf)
            else:
                log.error("epoch %d job %d failed permanently (rc=%d)",
                          epoch, j, rc)
                dead.append(j)
                (Path(args.expdir) / f".error.{epoch}.{j}").touch()
        time.sleep(0.05)
    if dead and args.on_failure == "abort":
        raise SystemExit(
            f"epoch {epoch}: jobs {dead} failed -- aborting "
            f"(--on-failure abort; see {logdir})")
    return sorted(survivors)


def _device(args) -> str:
    """The jobs' --device (the last one given), for the averaging."""
    train = _train_args(args)
    dev = "cuda"
    for i, a in enumerate(train[:-1]):
        if a == "--device":
            dev = train[i + 1]
    return dev


def main(argv=None):
    args = parse_arguments(argv)
    expdir = Path(args.expdir)
    expdir.mkdir(parents=True, exist_ok=True)
    from css_tpu_torch.cli import combine
    from css_tpu_torch.trainer.checkpoint import gc_checkpoints

    resume = None
    for epoch in range(1, args.num_epochs + 1):
        # linear job-count ramp
        frac = epoch / max(args.num_epochs, 1)
        nj = min(args.nj_final, max(args.nj_init, int(
            args.nj_init + frac * (args.nj_final - args.nj_init))))
        log.info("epoch %d: launching %d jobs (resume=%s)", epoch, nj, resume)
        survivors = run_epoch_jobs(args, epoch, nj, resume)
        if not survivors:
            raise SystemExit(f"epoch {epoch}: all {nj} jobs failed")
        if len(survivors) < nj:
            log.warning("epoch %d: continuing with %d/%d survivors "
                        "(elastic averaging)", epoch, len(survivors), nj)
        merged = expdir / f"{epoch}.mdl"
        combine.main([str(merged), "--device", _device(args),
                      "--models", *[str(expdir / f"{epoch}.{j}.mdl")
                                    for j in range(1, nj + 1)]])
        gc_checkpoints(expdir, keep_every=args.keep_every,
                       keep_last=args.keep_last, job=None)
        resume = f"{epoch}.mdl"
    log.info("Done: %d epochs -> %s", args.num_epochs,
             expdir / f"{args.num_epochs}.mdl")


if __name__ == "__main__":
    main()
