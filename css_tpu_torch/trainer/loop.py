"""The training loop (port of ``css_tpu/trainer/loop.py``, strategy
``single``).

One step: featurize the raw waveforms on the device (K3 for every
magnitude, in one launch), the model forward in training mode, the
objective, the backward, then the JAX package's optax chain written out
on the card:
  1. ``clip_by_global_norm``: g * max / |g| when |g| >= max (optax's rule,
     not ``clip_grad_norm_``'s max / (|g| + 1e-6)), as a ``where``;
  2. Adam: the L2 term ``wd * param`` added to the clipped gradient, then
     optax's ``scale_by_adam`` op for op over flat float32 buffers
     (``add_decayed_weights`` before ``scale_by_adam``, not AdamW); SGD:
     no momentum, no weight decay, as ``make_optimizer``;
  3. the learning rate ``schedule(n)`` on the card, n the count of updates
     applied before this one (optax's schedule count).
A step whose loss or pre-clip gradient norm is not finite leaves params,
Adam's moments, the update count and the BatchNorm running statistics as
they were, chosen on the card (``where(finite, new, old)``, as the JAX
package's), but the step counter still advances: the logged ``lr`` reads
the step counter, the applied rate the update count. Both counts live on
the card, so a step reads nothing back to the host.

On the card each step is a captured CUDA graph (``utils/programs.py``),
the counterpart of the JAX package's jitted step: the train step, G
same-shape steps at once (``train_group``, fed by ``train_one_epoch(
steps_per_dispatch=G)`` as ``_train_multi_impl`` is), and the eval step.
Dropout draws from the trainer's ``generator``, registered with every
graph, so each replay draws fresh masks. On the CPU the same functions
run directly.

Batches are (B, N) waveforms, (B, C, N) multichannel waveforms (7ch
training, with ``ipd_index``: the model input is channel 0's raw magnitude
and the IPD of the channel pairs, as the JAX package's), or encoded mixing
recipes (``data/device_mixer.py``), which ``to_device`` materialises on
the device with the ``DeviceMixer`` the step is handed.

``state()``/``load_state()`` convert to and from the JAX package's layout
(``checkpoint.TrainState``): params and batch_stats through the models'
converters, and the optimiser's leaves in ``jax.tree.leaves`` order of the
optax chain -- for Adam [count, mu by sorted parameter path, nu, schedule
count], for SGD [schedule count].

Data and tensor parallelism (``parallel/dp.py``) hook in through
``comm``: the gradients (and the loss) are averaged over the data group
before the clip, so the clip sees the global gradient and every rank
decides the non-finite skip on the same values, the global norm sums the
tensor-parallel shards over their group, and ``state``/``load_state`` see
full tensors where the model holds shards. Collectives are not
captured: under ``comm`` the same step functions run eagerly.
``float_leaves`` are the tensors replica averaging averages.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from css_tpu_torch.device import resolve_device
from css_tpu_torch.models import from_jax, to_jax
from css_tpu_torch.models.conformer import set_dropout_generator
from css_tpu_torch.objectives.base import source_keys
from css_tpu_torch.ops import stft as stft_ops
from css_tpu_torch.ops import stft_mag_cuda
from css_tpu_torch.ops.features import ipd, parse_ipd_index
from css_tpu_torch.trainer.checkpoint import (TrainState, tree_leaves,
                                              tree_unflatten)
from css_tpu_torch.trainer.lr_schedule import LRSchedule
from css_tpu_torch.utils.programs import Program


ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.scale_by_adam's


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(torch.square(t)) for t in tensors))


class Trainer:
    """Train and eval steps for one model and objective on one device."""

    def __init__(self, model, objective, schedule: LRSchedule,
                 optim: str = "adam", weight_decay: float = 0.0,
                 grad_thresh: float = 30.0, input_domain: str = "stft",
                 frame_len: int = 512, frame_hop: int = 256,
                 device="cuda", seed: int = 0, ipd_index: str = None):
        if optim not in ("adam", "sgd"):
            raise ValueError(f"unknown optimizer {optim!r}")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.objective = objective
        self.schedule = schedule
        self.grad_thresh = float(grad_thresh)
        self.input_domain = input_domain
        self.frame_len, self.frame_hop = frame_len, frame_hop
        # the IPD pairs of multichannel batches: [raw ch0 magnitude, IPD]
        # is the model input, whose MVN makes it the separator's features
        self.ipd_pairs = parse_ipd_index(ipd_index) if ipd_index else None
        self.names = [n for n, _ in self.model.named_parameters()]
        self.params = [p for _, p in self.model.named_parameters()]
        self.optim = optim
        # make_optimizer's L2 term belongs to Adam; SGD has none
        self.weight_decay = float(weight_decay) if optim == "adam" else 0.0
        # the optax chain's state on the card: the count of updates
        # applied (Adam's count and the schedule's, int32), the count of
        # steps taken (non-finite ones too), and Adam's moments as flat
        # float32 buffers, one view a parameter
        dev = self.device
        self._count = torch.zeros((), dtype=torch.int32, device=dev)
        self._steps = torch.zeros((), dtype=torch.int32, device=dev)
        n = sum(p.numel() for p in self.params)
        self._mu = (torch.zeros(n, device=dev) if optim == "adam"
                    else None)
        self._nu = torch.zeros_like(self._mu) if optim == "adam" else None
        self.seed = seed
        self.generator = torch.Generator(self.device).manual_seed(seed)
        set_dropout_generator(self.model, self.generator)
        # set by parallel/dp.py: reduce(loss, grads) -> the reduced loss,
        # grad_norm(grads), full(named) and local(named) tensors
        self.comm = None
        gens = (self.generator,)
        self._train_program = Program(self._step_impl, "train_step", gens)
        self._multi_program = Program(self._multi_impl, "train_multi", gens)
        self._eval_program = Program(self._eval_impl, "eval_step")

    @property
    def step(self) -> int:
        """Steps taken, non-finite ones included (reads the card)."""
        return int(self._steps)

    @property
    def updates(self) -> int:
        """Updates applied: optax's counts (reads the card)."""
        return int(self._count)

    # ------------------------------------------------------------ features
    def _mags(self, parts):
        """|STFT| of the row-stacked waveforms in one K3 launch, split back
        into the parts. Magnitudes are loss inputs and targets only, so no
        gradient flows through them."""
        with torch.no_grad():
            mags = stft_mag_cuda.stft_mag(torch.cat(parts).contiguous(),
                                          self.frame_len, self.frame_hop)
        return mags.split([p.shape[0] for p in parts])

    def featurize(self, batch) -> Dict[str, torch.Tensor]:
        """Raw waveforms -> model input and objective targets."""
        src = source_keys(batch)
        if self.input_domain == "time":
            return {"input": batch["mix"], **{k: batch[k] for k in src}}
        mix = batch["mix"]
        if mix.ndim == 3:
            return self._featurize_multichannel(mix, batch, src)
        if getattr(self.objective, "needs_waveforms", False):
            # resynthesis objectives take the waveforms
            out = {"input": self._mags([mix])[0], "mix_wav": mix}
            out.update({k: batch[k] for k in src})
            return out
        fl, fh = self.frame_len, self.frame_hop
        cf = (int(getattr(self.objective, "consistency_frames", 0))
              if getattr(self.objective, "consistency_weight", 0.0) else 0)
        if cf and mix.shape[-1] > 2 * cf * fh + fl:
            # two crops of each window offset by cf frames: one stacked
            # forward of 2B rows; the targets crop like the first
            n = mix.shape[-1] - cf * fh
            mags = self._mags([mix[:, :n], mix[:, cf * fh:]]
                              + [batch[k][:, :n] for k in src])
            out = {"input": torch.cat(mags[:2])}
            out.update(zip(src, mags[2:]))
            return out
        mags = self._mags([mix] + [batch[k] for k in src])
        out = {"input": mags[0]}
        out.update(zip(src, mags[1:]))
        return out

    def _featurize_multichannel(self, mix, batch, src):
        """(B, C, N): channel 0's magnitude (with the sources', one K3
        launch) and the IPD from the matrix-product STFT of every
        channel."""
        if self.ipd_pairs is None:
            raise ValueError(
                "multichannel batches need Trainer(ipd_index=...)")
        waveforms = getattr(self.objective, "needs_waveforms", False)
        mags = self._mags([mix[:, 0]] + ([] if waveforms
                                         else [batch[k] for k in src]))
        with torch.no_grad():
            spec = stft_ops.stft(mix, self.frame_len, self.frame_hop)
            ip = ipd(torch.atan2(spec.imag, spec.real), *self.ipd_pairs)
            b, m, t, f = ip.shape
            ip = ip.transpose(1, 2).reshape(b, t, m * f)
        out = {"input": torch.cat([mags[0], ip], dim=-1)}
        if waveforms:
            out["mix_wav"] = mix[:, 0]
            out.update({k: batch[k] for k in src})
        else:
            out.update(zip(src, mags[1:]))
        return out

    # ---------------------------------------------------------------- step
    def to_device(self, batch, dmix=None) -> Dict[str, torch.Tensor]:
        """A batch's waveforms as float32 tensors on the device; an
        encoded recipe (``dm_i``, ``dm_f``, ``win``) is materialised there
        by its ``DeviceMixer`` ``dmix``."""
        if "dm_i" in batch:
            if dmix is None:
                raise ValueError("an encoded recipe batch needs its "
                                 "DeviceMixer (dmix=)")
            return dmix.materialize({
                "dm_i": torch.as_tensor(batch["dm_i"]).to(
                    self.device, torch.int32, non_blocking=True),
                "dm_f": torch.as_tensor(batch["dm_f"]).to(
                    self.device, torch.float32, non_blocking=True),
                "win": batch["win"]})
        return {k: torch.as_tensor(v).to(self.device, torch.float32,
                                         non_blocking=True)
                for k, v in batch.items() if k not in ("ovl", "lens")}

    def _mode(self) -> tuple:
        """What a program bakes in beside its inputs' shapes."""
        return (getattr(self.model, "compute_dtype", None),)

    def _grads(self, dbatch):
        """The forward and backward on device tensors: (loss, aux, one
        gradient a parameter, zeros for an unused one as jax.grad's). The
        forward moves BatchNorm's running statistics."""
        self.model.train()
        feats = self.featurize(dbatch)
        loss, aux = self.objective(self.model(feats["input"]), feats)
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]
        return loss.detach(), aux, grads

    def compute_grads(self, batch, dmix=None):
        """The forward and backward of a training step: (loss, aux,
        gradient norm), the unclipped gradients left in each parameter's
        ``grad`` (reduced over the data group under ``comm``)."""
        loss, aux, grads = self._grads(self.to_device(batch, dmix))
        for p, g in zip(self.params, grads):
            p.grad = g
        if self.comm is not None:
            loss = self.comm.reduce(loss, grads)
            return loss, aux, self.comm.grad_norm(grads)
        return loss, aux, global_norm(grads)

    def apply_grads(self, loss, aux, norm, stats) -> Dict[str, torch.Tensor]:
        """The update of ``compute_grads``' gradients: clip, optimiser and
        schedule, or for a non-finite loss or norm the BatchNorm
        statistics put back to ``stats``; returns the step's metrics."""
        return self._update(loss, aux, norm, [p.grad for p in self.params],
                            stats)

    def _update(self, loss, aux, norm, grads, stats) -> Dict:
        """optax's chain on the card, every choice a ``where``: the clip,
        Adam (or SGD), the rate from the update count; a non-finite loss or
        norm keeps params, moments, the count and the buffers. Returns the
        step's metrics as device tensors and advances the step counter."""
        with torch.no_grad():
            g = torch.cat([x.reshape(-1) for x in grads]).float()
            if norm is None:
                norm = torch.sqrt(torch.sum(torch.square(g)))
            finite = torch.isfinite(loss) & torch.isfinite(norm)
            keep = norm < self.grad_thresh
            # optax's where(norm < max, g, g / norm * max), to the bit
            g = (g / torch.where(keep, torch.ones_like(norm), norm)
                 * torch.where(keep, 1.0, self.grad_thresh))
            p = torch.cat([x.detach().reshape(-1) for x in self.params])
            lr = self.schedule(self._count)
            if self.optim == "adam":
                if self.weight_decay:
                    g = g + self.weight_decay * p
                mu = (1 - ADAM_B1) * g + ADAM_B1 * self._mu
                nu = (1 - ADAM_B2) * torch.square(g) + ADAM_B2 * self._nu
                c = (self._count + 1).float()
                u = ((mu / (1 - torch.pow(ADAM_B1, c)))
                     / (torch.sqrt(nu / (1 - torch.pow(ADAM_B2, c)))
                        + ADAM_EPS))
                self._mu.copy_(torch.where(finite, mu, self._mu))
                self._nu.copy_(torch.where(finite, nu, self._nu))
            else:
                u = g
            new = torch.where(finite, p + (-lr) * u, p)
            torch._foreach_copy_(
                self.params, [v.view_as(x) for v, x in zip(
                    new.split([x.numel() for x in self.params]),
                    self.params)])
            self._count.copy_(torch.where(finite, self._count + 1,
                                          self._count))
            for b, old in zip(self.model.buffers(), stats):
                b.copy_(torch.where(finite, b, old))
            metrics = {"loss": loss, "grad_norm": norm,
                       "lr": self.schedule(self._steps), "finite": finite}
            metrics.update({k: v.detach() for k, v in aux.items()
                            if k != "perms"})
            self._steps.add_(1)
        return metrics

    def _step_impl(self, dbatch) -> Dict[str, torch.Tensor]:
        """One whole step on device tensors, with no host
        synchronisation: the train program's function."""
        stats = [b.clone() for b in self.model.buffers()]
        loss, aux, grads = self._grads(dbatch)
        norm = None
        if self.comm is not None:
            loss = self.comm.reduce(loss, grads)
            norm = self.comm.grad_norm(grads)
        return self._update(loss, aux, norm, grads, stats)

    def _multi_impl(self, stacked) -> Dict[str, torch.Tensor]:
        """G steps on batches stacked along a leading axis -> metrics
        stacked (G,): the group program's function."""
        g = next(iter(stacked.values())).shape[0]
        metrics = [self._step_impl({k: v[i] for k, v in stacked.items()})
                   for i in range(g)]
        return {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}

    def train_step(self, batch, dmix=None) -> Dict[str, torch.Tensor]:
        """One step on a batch of waveforms (or an encoded recipe and its
        ``DeviceMixer``); returns its metrics as device tensors. On the
        card the step is a captured program; under ``comm`` (collectives,
        which the graphs do not capture) it runs the same function
        eagerly."""
        dbatch = self.to_device(batch, dmix)
        if self.comm is not None:
            return self._step_impl(dbatch)
        return self._train_program(dbatch, mode=self._mode())

    def train_group(self, stacked) -> Dict[str, torch.Tensor]:
        """G steps on ``_stack_group``'s stacked batches, launched with no
        host synchronisation between them (one program on the card)."""
        if self.comm is not None:
            return self._multi_impl(stacked)
        return self._multi_program(stacked, mode=self._mode())

    def _eval_impl(self, dbatch) -> torch.Tensor:
        self.model.eval()
        with torch.no_grad():
            feats = self.featurize(dbatch)
            loss, _ = self.objective(self.model(feats["input"]), feats)
        return loss

    def eval_step(self, batch, dmix=None) -> torch.Tensor:
        dbatch = self.to_device(batch, dmix)
        if self.comm is not None:
            return self._eval_impl(dbatch)
        return self._eval_program(dbatch, mode=self._mode())

    # --------------------------------------------------------------- loops
    @staticmethod
    def batch_geometry(batch):
        """(batch size, window samples) of a waveform or recipe batch."""
        if "dm_i" in batch:
            return batch["dm_i"].shape[0], int(batch["win"])
        return batch["mix"].shape[0], batch["mix"].shape[-1]

    def _stack_group(self, group, dmix=None):
        """Same-shape batches stacked along a new leading axis on the
        device, or None where their keys or shapes differ. Host arrays
        are stacked on the host into page-locked memory and move in one
        transfer a key; tensors on the card are stacked there; encoded
        recipes are materialised one by one, then stacked."""
        keys = group[0].keys()
        if any(b.keys() != keys for b in group[1:]):
            return None
        if any(np.shape(b[k]) != np.shape(group[0][k])
               for b in group[1:] for k in keys):
            return None
        if "dm_i" in group[0]:
            group = [self.to_device(b, dmix) for b in group]
        out = {}
        for k in group[0]:
            if k in ("ovl", "lens"):
                continue
            parts = [b[k] for b in group]
            if all(isinstance(x, np.ndarray) for x in parts):
                host = torch.empty((len(parts),) + parts[0].shape,
                                   pin_memory=self.device.type == "cuda")
                np.stack(parts, out=host.numpy())
                out[k] = host.to(self.device, non_blocking=True)
            else:
                out[k] = torch.stack([torch.as_tensor(x).to(
                    self.device, torch.float32) for x in parts])
        return out

    def train_one_epoch(self, loader, batches_per_epoch: int,
                        log_fn: Optional[Callable] = None, sr: int = 16000,
                        log_every: int = 50, dmix=None,
                        steps_per_dispatch: int = 1) -> float:
        """A fixed-size epoch; returns the mean loss (port of
        ``css_tpu/trainer/loop.py``'s). With ``steps_per_dispatch`` G > 1
        the maximal run of up to G same-geometry batches is taken (a batch
        of another shape is held over to the next group), and a full group
        runs as one program (``train_group``); a shorter one step by step.
        The host reads the card only at a log point and at the end. Every
        ``log_every`` steps (and at the end), at the last step of a group,
        ``log_fn`` gets its loss, grad_norm and lr, the batch size and the
        audio seconds trained per second over the interval
        (``audio_sec_per_sec_per_chip``, one card)."""
        g_max = max(int(steps_per_dispatch), 1)
        it = iter(loader)
        losses = []
        t_interval = time.perf_counter()
        interval_audio = 0.0
        done = 0
        next_log = log_every
        pending = None  # a batch held over from a shape change mid-group
        while done < batches_per_epoch:
            g = min(g_max, batches_per_epoch - done)
            group, ovls = [], []
            while len(group) < g:
                if pending is not None:
                    batch, ovl = pending
                    pending = None
                else:
                    batch = dict(next(it))
                    ovl = batch.pop("ovl", None)
                    batch.pop("lens", None)
                if group and (self.batch_geometry(batch)
                              != self.batch_geometry(group[0])):
                    pending = (batch, ovl)
                    break
                group.append(batch)
                ovls.append(ovl)
            g = len(group)
            stacked = (self._stack_group(group, dmix) if g == g_max > 1
                       else None)
            if stacked is not None:
                metrics = self.train_group(stacked)
                losses.append(metrics["loss"])  # (G,) on the card
            else:
                for batch in group:
                    metrics = self.train_step(batch, dmix)
                    losses.append(metrics["loss"].reshape(1))
            done += g
            bsize = self.batch_geometry(group[-1])[0]
            interval_audio += sum(
                b * n for b, n in map(self.batch_geometry, group)) / sr
            if log_fn is not None and (done >= next_log
                                       or done == batches_per_epoch):
                last = {k: metrics[k].reshape(-1)[-1]
                        for k in ("loss", "grad_norm", "lr")}
                loss = float(last["loss"])  # waits for the card
                dt = time.perf_counter() - t_interval
                log = {"iter": done, "loss": loss,
                       "grad_norm": float(last["grad_norm"]),
                       "lr": float(last["lr"]), "bsize": int(bsize),
                       "audio_sec_per_sec_per_chip": interval_audio / dt}
                if ovls[-1] is not None:
                    log["ovl"] = float(ovls[-1])
                log_fn(log)
                t_interval = time.perf_counter()
                interval_audio = 0.0
                while next_log <= done:
                    next_log += log_every
        return float(torch.cat(losses).sum()) / batches_per_epoch

    def validate(self, loader, num_batches: int = 100, dmix=None) -> float:
        it = iter(loader)
        losses = [self.eval_step(next(it), dmix) for _ in range(num_batches)]
        return float(torch.stack(losses).mean())

    # ---------------------------------------------------------------- state
    def _views(self, flat: torch.Tensor) -> list:
        """A flat moment buffer as one view a parameter."""
        return [v.view_as(p) for v, p in zip(
            flat.split([p.numel() for p in self.params]), self.params)]

    def _moments(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        return dict(zip(self.names, self._views(flat)))

    def _full(self, named: Dict[str, torch.Tensor]) -> Dict:
        return self.comm.full(named) if self.comm is not None else named

    def _local(self, named: Dict[str, torch.Tensor]) -> Dict:
        return self.comm.local(named) if self.comm is not None else named

    def float_leaves(self) -> list:
        """Every float tensor of the training state, in a fixed order:
        the parameters, the float buffers (BatchNorm's running
        statistics) and Adam's two moments (views of the flat buffers).
        Integer leaves (the counts) are not among them."""
        leaves = self.params + [b for b in self.model.buffers()
                                if b.is_floating_point()]
        if self.optim == "adam":
            for mu, nu in zip(self._views(self._mu), self._views(self._nu)):
                leaves += [mu, nu]
        return leaves

    def state(self) -> TrainState:
        """The trainer's state in the JAX package's layout (numpy), full
        tensors under tensor parallelism (a collective: every rank of the
        model group calls it)."""
        params, _ = to_jax(self._full(dict(self.model.named_parameters())))
        _, stats = to_jax(dict(self.model.named_buffers()))
        count = np.asarray(self.updates, np.int32)
        opt = [count]
        if self.optim == "adam":
            opt = ([count]
                   + tree_leaves(to_jax(self._full(
                       self._moments(self._mu)))[0])
                   + tree_leaves(to_jax(self._full(
                       self._moments(self._nu)))[0])
                   + [count])
        return TrainState(step=self.step, params=params, batch_stats=stats,
                          opt_state=opt)

    def load_state(self, state: TrainState) -> None:
        """Set params, BatchNorm statistics, the optimiser state and the
        step counter from a TrainState (``checkpoint.restore_state``)."""
        self.model.load_state_dict(self._local(
            from_jax(self.model, state.params, state.batch_stats)))
        self._steps.fill_(int(state.step))
        opt = state.opt_state
        self._count.fill_(int(opt[-1]))  # the schedule's count
        if self.optim != "adam":
            return
        n = (len(opt) - 2) // 2
        like = to_jax(dict(self.model.named_parameters()))[0]
        for flat, leaves in ((self._mu, opt[1:1 + n]),
                             (self._nu, opt[1 + n:1 + 2 * n])):
            named = self._local(from_jax(self.model, tree_unflatten(
                like, list(leaves))))
            with torch.no_grad():
                for name, view in self._moments(flat).items():
                    view.copy_(named[name].to(view.device, view.dtype))
