"""Recipe training on one card: ``Trainer.train_one_epoch`` fed by the
program's ``PrefetchLoader``, as ``cli.train`` runs it with one card.

Set-up builds one trainer from the seed: the configuration's model with
the seed's weights, the MSE objective, Adam and the schedule from the
traffic file's ``train`` settings (the recipe's flags), and the loader:
``num_workers`` producer threads of ``MixtureSynthesizer`` over a
``SyntheticCorpus`` drawn from the seed, with the program's synthetic
RIR and noise pools, regrouped ``steps_per_dispatch`` batches of one
window at a time. The same trainer then takes ``checked_steps`` single
steps through ``train_one_epoch`` (batches of one step each: the
window's own call and feed), whose batches, losses and state the check
reads; then more steps until every program key the window can meet (a
group of G and a single step at each window bucket) has run twice, so
that each is captured before the window opens (``warm``).

Window: one epoch of ``train_one_epoch`` as ``cli.train`` runs it (G-step
groups, a log point every ``log_every`` steps), ended at the first pull
from the loader after ``seconds`` have passed, then a synchronise.
``train_rate`` is the mixture seconds of every step dispatched in the
window, all of which completed by the synchronise, over the window's
wall time. The traced run adds spans around each pull from the loader
and each dispatch.

Check (after the window, with the program freed): the float32 reference
(``reference/training.py``, TF32 off) takes the same weights, re-made
from the seed, and the checked steps' batches, and follows the first
three steps. Compared: each step's loss (``loss_gap``, the largest
relative gap); the first step's gradient as the optimiser got it, m_1 /
(1 - b1) from Adam's first moment (``grad_gap``); the change of the
parameters over the three steps (``change_gap``). The last two by the
worst leaf: | |prog| - |ref| | over the larger of the reference leaf's
norm and the median leaf's. Leaves whose first reference gradient is
under 1e-3 of the median leaf's (a key's bias under softmax) move by
round-off alone and are left out of the change.

``TINY``: the overrides that cut this driver's cells to a CPU test's size.
"""

from __future__ import annotations

import statistics
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from bench_gpu.harness import manifest, readers
from bench_gpu.harness.setup import (Launches, Outcome, free, memory_peak,
                                     program_model, reference, weights_for)
from bench_gpu.reference import training as ref_train
from bench_gpu.reference.precision import strict_float32

NOISE_FLOOR = 1e-3  # of the median leaf's first gradient: left out

TINY = {
    "config": {"widths": {"num_blocks": 1, "num_layers": 1,
                          "hidden_dim": 64},
               "program_conf": {"conformer_num_blocks": 1,
                                "blstm_num_layers": 1,
                                "blstm_hdim": 64}},
    "traffic": {"train": {"batch_size": 4, "min_window_size": 1.0,
                          "max_window_size": 1.5,
                          "synthetic_speakers": 4, "synthetic_utts": 2},
                "max_warm_pulls": 100}}


class Feed:
    """The loader as ``train_one_epoch`` pulls it: a pull inside the
    tracer's ``loader_wait`` span; while ``keep`` is set, a copy of each
    batch pulled; once ``stop()`` holds, the next pull ends the epoch
    (``StopIteration``, which ``until`` catches)."""

    def __init__(self, loader, tracer):
        self.loader, self.tracer = loader, tracer
        self.keep = False
        self.kept: List[Dict] = []
        self.stop = None

    def __iter__(self):
        return self

    def __next__(self):
        if self.stop is not None and self.stop():
            raise StopIteration
        with self.tracer.span("loader_wait"):
            batch = next(self.loader)
        if self.keep:
            self.kept.append({k: np.array(v) for k, v in batch.items()
                              if isinstance(v, np.ndarray)})
        return batch


class Dispatches:
    """Counts the steps the trainer dispatches, by (kind, window
    samples), wrapping the trainer instance's two entry points."""

    def __init__(self, trainer, tracer):
        self.calls: Dict[tuple, int] = {}
        self.steps: Dict[tuple, int] = {}  # (rows, samples) -> steps
        step, group = trainer.train_step, trainer.train_group

        def one(batch, dmix=None):
            self._add("single", 1, *trainer.batch_geometry(batch))
            with tracer.span("dispatch"):
                return step(batch, dmix)

        def many(stacked):
            g, rows, n = stacked["mix"].shape
            self._add("group", g, rows, n)
            with tracer.span("dispatch"):
                return group(stacked)

        trainer.train_step, trainer.train_group = one, many

    def _add(self, kind, g, rows, n):
        self.calls[(kind, n)] = self.calls.get((kind, n), 0) + 1
        self.steps[(rows, n)] = self.steps.get((rows, n), 0) + g

    def reset(self):
        self.calls, self.steps = {}, {}


def build(cell, seed: int, device, tracer):
    from css_tpu_torch.data.corpus import (SyntheticCorpus,
                                           synthetic_noise_pool,
                                           synthetic_rir_pool)
    from css_tpu_torch.data.loader import PrefetchLoader
    from css_tpu_torch.data.mixer import MixtureSynthesizer, \
        default_window_buckets
    from css_tpu_torch.objectives import OBJECTIVES
    from css_tpu_torch.trainer.loop import Trainer
    from css_tpu_torch.trainer.lr_schedule import LRSchedule

    t = cell.traffic["train"]
    # the content from the run's seed; the window buckets from the mix's
    # own fixed seed, so every run trains the same sizes
    conf = {**cell.config["program_conf"], **t, "seed": seed}
    corpus = SyntheticCorpus(seed=seed, num_speakers=t["synthetic_speakers"],
                             utts_per_speaker=t["synthetic_utts"])
    if t.get("synthetic_rirs"):
        conf["rir_pool"] = synthetic_rir_pool()
        conf["noise_pool"] = synthetic_noise_pool()

    def stream(i=0):
        return MixtureSynthesizer.build_dataset(
            corpus, {**conf, "seed": conf["seed"] + 7 * i})

    loader = PrefetchLoader(factory=stream, num_threads=t["num_workers"],
                            device=None, group=t["steps_per_dispatch"])
    model = program_model(cell.config, seed, device, cell.root)
    trainer = Trainer(model, OBJECTIVES[t["objective"]].build_objective(conf),
                      LRSchedule.from_conf(conf), optim=t["optim"],
                      weight_decay=t["weight_decay"],
                      grad_thresh=t["grad_thresh"], device=device, seed=seed)
    buckets = [int(round(w * 16000)) for w in default_window_buckets(
        t["min_window_size"], t["max_window_size"],
        t["window_bucket_step"], frame_align=t["align_window_frames"])]
    return loader, trainer, buckets


def _named(trainer, flat_views: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: v.detach().float().clone()
            for n, v in zip(trainer.names, flat_views)}


def _moments(trainer) -> List[torch.Tensor]:
    """Adam's first moments, one a parameter (``float_leaves``' order:
    parameters, float buffers, then (mu, nu) a parameter)."""
    leaves = trainer.float_leaves()
    n_p = len(trainer.params)
    n_b = sum(1 for b in trainer.model.buffers() if b.is_floating_point())
    return leaves[n_p + n_b::2]


def until(trainer, feed, stop, g_max: int, log_every: int) -> None:
    """One epoch of ``train_one_epoch`` as ``cli.train`` runs it (G-step
    groups, a log point every ``log_every`` steps, which reads the card),
    ended at the first pull after ``stop()`` holds; the batches pulled
    for a group not yet dispatched are dropped. Returns once every step
    dispatched has completed on the card."""
    feed.stop = stop
    try:
        trainer.train_one_epoch(feed, 1 << 40, log_fn=lambda _: None,
                                log_every=log_every,
                                steps_per_dispatch=g_max)
    except StopIteration:
        pass
    finally:
        feed.stop = None
    if trainer.device.type == "cuda":
        torch.cuda.synchronize(trainer.device)


def warm(trainer, feed, disp, buckets, g_max: int, traffic: Dict) -> list:
    """Calls until every program key the window can meet (a single step
    and a group of G at each window bucket) has run twice, eagerly and
    then captured; returns the keys that did not within
    ``max_warm_pulls`` pulls."""
    want = {(kind, n) for kind in ("single", "group") for n in buckets}
    cap = [int(traffic["max_warm_pulls"])]

    def short(kind):
        return [k for k in want if k[0] == kind and disp.calls.get(k, 0) < 2]

    while short("single") and cap[0] > 0:
        cap[0] -= 1
        trainer.train_one_epoch(feed, 1, steps_per_dispatch=g_max)

    def done():
        cap[0] -= 1
        return not short("group") or cap[0] < 0

    until(trainer, feed, done, g_max, int(traffic["log_every"]))
    return sorted(k for k in want if disp.calls.get(k, 0) < 2)


def checked_steps(trainer, feed, n: int, g_max: int) -> Dict:
    """``n`` single steps through ``train_one_epoch`` on fresh batches:
    their batches, losses, the first step's gradient as Adam got it
    (m_1 / (1 - b1)) and the parameters' change over the ``n`` steps, by
    parameter name."""
    p0 = _named(trainer, trainer.params)
    feed.keep = True
    losses, g1 = [], None
    for s in range(n):
        losses.append(trainer.train_one_epoch(feed, 1,
                                              steps_per_dispatch=g_max))
        if s == 0:
            g1 = {k: m / (1 - ref_train.B1) for k, m in
                  _named(trainer, _moments(trainer)).items()}
    feed.keep = False
    change = {k: v - p0[k] for k, v in _named(trainer, trainer.params).items()}
    batches, feed.kept = feed.kept, []
    return {"batches": batches, "losses": losses, "g1": g1,
            "change": change}


def run(cell, seed: int, seconds: float, device, tracer, t0: float,
        hooks: Dict) -> Outcome:
    cfg, traffic = cell.config, cell.traffic
    t = traffic["train"]
    g_max = int(t["steps_per_dispatch"])
    loader, trainer, buckets = build(cell, seed, device, tracer)
    if "trainer" in hooks:  # tests: break the timed path underneath
        hooks["trainer"](trainer)
    feed = Feed(loader, tracer)
    disp = Dispatches(trainer, tracer)

    # the checked steps: single steps through the window's call and feed
    program = checked_steps(trainer, feed, int(traffic["checked_steps"]),
                            g_max)
    warm_missing = warm(trainer, feed, disp, buckets, g_max, traffic)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0

    if tracer.enabled:  # a traced window may be shorter (the trace's size)
        seconds = min(seconds, float(traffic.get("trace_seconds", seconds)))
    disp.reset()
    launches = Launches(cell.root)
    with tracer.window():
        start = time.perf_counter()
        until(trainer, feed, lambda: time.perf_counter() - start >= seconds,
              g_max, int(traffic["log_every"]))
        wall = time.perf_counter() - start
    counts = launches.since()
    peak = memory_peak(device)
    sr = 16000
    audio = sum(rows * n * k for (rows, n), k in disp.steps.items()) / sr
    steps = sum(disp.steps.values())
    rec = None
    if tracer.enabled:
        rec = _record(cell, tracer, disp.steps, counts, launches.missing)
    loader.close()
    del trainer, feed, disp
    free(device)

    numbers = compare(program, reference_run(cfg, traffic, seed,
                                             program["batches"], device,
                                             root=cell.root))
    limits = cfg["limits"]["training"]
    checks = {k: {"value": numbers[k], "limit": v} for k, v in
              limits.items()}
    failed = sum(numbers[k] > v for k, v in limits.items())
    notes = ([f"program keys not warmed before the window: {warm_missing}"]
             if warm_missing else [])
    return Outcome(correct=failed == 0, attempted=steps, failed=0,
                   metrics={"train_rate": audio / wall, "setup_s": setup_s},
                   checks=checks, memory_peak=peak, record=rec,
                   notes=notes)


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              leaves) -> Dict[str, float]:
    """Per leaf: | |prog| - |ref| | over the larger of the reference
    leaf's norm and the median leaf's."""
    norms = {k: float(torch.linalg.vector_norm(ref[k].double()))
             for k in leaves}
    floor = statistics.median(norms.values())
    return {k: abs(float(torch.linalg.vector_norm(prog[k].double()))
                   - norms[k]) / max(norms[k], floor) for k in leaves}


def reference_run(cfg: Dict, traffic: Dict, seed: int, batches: List[Dict],
                  device, mode: str = "f32", root: Path = manifest.ROOT
                  ) -> Dict:
    """The reference's steps on ``batches`` from the seed's weights, in
    precision ``mode``: what ``checked_steps`` gives, and ``moving``, the
    leaves whose first gradient is at least NOISE_FLOOR of the median
    leaf's."""
    strict_float32()
    t = traffic["train"]
    ref = reference(cfg, root)
    widths = cfg["widths"]
    params = weights_for(cfg, seed, device, root)
    hyper = {"lr": t["lr"], "warmup": t["warmup"], "decay": t["decay"],
             "weight_decay": t["weight_decay"], "grad_thresh":
             t["grad_thresh"], "noise_weight": t["mse_noise_weight"],
             "trainable": {k for k in params if "running_" not in k}}
    p0 = {k: params[k].clone() for k in hyper["trainable"]}
    opt = ref_train.Adam({k: params[k] for k in hyper["trainable"]}, hyper)

    def mask_fn(p, mags):
        return ref.masks(p, mags, widths, mode=mode, train=True)

    losses, raw1, g1 = [], None, None
    for s, batch in enumerate(batches):
        b = {k: torch.as_tensor(v, device=device) for k, v in batch.items()
             if k == "mix" or k.startswith("source")}
        out = ref_train.step(params, opt, b, mask_fn, hyper)
        losses.append(out["loss"])
        if s == 0:
            raw1 = out["grads"]
            g1 = {k: m / (1 - ref_train.B1) for k, m in opt.mu.items()}
        del out
    norms = {k: float(torch.linalg.vector_norm(g)) for k, g in raw1.items()}
    floor = statistics.median(norms.values())
    return {"losses": losses, "g1": g1,
            "change": {k: params[k] - p0[k] for k in p0},
            "moving": sorted(k for k, v in norms.items()
                             if v >= NOISE_FLOOR * floor)}


def leaf_diffs(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               leaves) -> Dict[str, float]:
    """Per leaf: |prog - ref| over the larger of the reference leaf's
    norm and the median leaf's."""
    norms = {k: float(torch.linalg.vector_norm(ref[k].double()))
             for k in leaves}
    floor = statistics.median(norms.values())
    return {k: float(torch.linalg.vector_norm((prog[k] - ref[k]).double()))
            / max(norms[k], floor) for k in leaves}


def compare(prog: Dict, ref: Dict) -> Dict:
    """The numbers compared: ``prog``'s steps (``checked_steps``, or a
    control's ``reference_run``) against the reference's: the worst
    leaf's gaps of norms (``grad_gap``, ``change_gap``) and the median
    leaf's (``*_gap_median``), ``*_worst`` naming the worst leaf; and
    ``grad_diff``, the median leaf's |g_prog - g_ref| over the same
    denominator, which sees the direction of the first gradient that a
    gap of norms does not."""
    grad = leaf_gaps(prog["g1"], ref["g1"], sorted(ref["g1"]))
    change = leaf_gaps(prog["change"], ref["change"], ref["moving"])
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(
               prog["losses"], ref["losses"])),
           "left_out": len(ref["g1"]) - len(ref["moving"]),
           "grad_diff": statistics.median(leaf_diffs(
               prog["g1"], ref["g1"], sorted(ref["g1"])).values())}
    for name, gaps in (("grad", grad), ("change", change)):
        worst = max(gaps, key=gaps.get)
        out[f"{name}_gap"] = gaps[worst]
        out[f"{name}_gap_median"] = statistics.median(gaps.values())
        out[f"{name}_worst"] = worst
    return out


def _record(cell, tracer, steps: Dict[tuple, int], counts,
            missing: Dict[str, str]) -> readers.Record:
    cfg = cell.config
    fl = int(cfg["pipeline"]["separation"]["frame_length"])
    fh = int(cfg["pipeline"]["separation"]["frame_shift"])
    cost = manifest.cost(cell.config_name, cell.root)
    k = cfg["widths"]["num_spk"]
    rec = readers.Record(tracer=tracer, config=cfg, root=cell.root,
                         missing=dict(missing))
    rec.counts = {"steps": sum(steps.values()),
                  "model_flops": sum(
                      3 * n_steps * cost.forward_flops(
                          cfg["widths"], rows, (n - fl) // fh + 1)
                      for (rows, n), n_steps in steps.items())}
    # one K3 launch a step, over the mixture and its sources
    rec.work = {"k3": [(n_steps, {"rows": rows * (1 + k), "n": n})
                       for (rows, n), n_steps in steps.items()]}
    if counts["k3"] != rec.counts["steps"]:
        rec.why.append(f"k3: {counts['k3']} launches for "
                       f"{rec.counts['steps']} steps")
        rec.work = {}
    return rec
