"""The training loop (port of ``css_tpu/trainer/loop.py``, strategy
``single``).

One step: featurize the raw waveforms on the device (K3 for every
magnitude, in one launch), the model forward in training mode, the
objective, the backward, then the JAX package's optax chain written out:
  1. ``clip_by_global_norm``: g * max / |g| when |g| >= max (optax's rule,
     not ``clip_grad_norm_``'s max / (|g| + 1e-6));
  2. Adam: the L2 term ``wd * param`` added to the clipped gradient, then
     Adam's moments (``torch.optim.Adam(weight_decay=wd)`` does exactly
     this; optax's ``add_decayed_weights`` before ``scale_by_adam``, not
     AdamW); SGD: no momentum, no weight decay, as ``make_optimizer``;
  3. the learning rate ``schedule(n)``, n the count of updates applied
     before this one (optax's schedule count).
A step whose loss or pre-clip gradient norm is not finite leaves params,
the optimiser state (counts too) and the BatchNorm running statistics as
they were, but the step counter still advances: the logged ``lr`` reads
the step counter, the applied rate the update count, as in the JAX
package. Telling the host whether a step is finite costs one
synchronisation a step.

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
full tensors where the model holds shards. ``float_leaves`` are the
tensors replica averaging averages.
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


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(torch.square(t)) for t in tensors))


def clip_by_global_norm(grads, norm: torch.Tensor, max_norm: float) -> None:
    """In place, optax's rule: where(norm < max, g, g / norm * max)."""
    if not float(norm) < max_norm:
        for g in grads:
            g.div_(norm).mul_(max_norm)


class Trainer:
    """Train and eval steps for one model and objective on one device."""

    def __init__(self, model, objective, schedule: LRSchedule,
                 optim: str = "adam", weight_decay: float = 0.0,
                 grad_thresh: float = 30.0, input_domain: str = "stft",
                 frame_len: int = 512, frame_hop: int = 256,
                 device="cuda", seed: int = 0, ipd_index: str = None):
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
        params = [p for _, p in self.model.named_parameters()]
        if optim == "adam":
            self.optimizer = torch.optim.Adam(params, lr=schedule(0),
                                              weight_decay=weight_decay)
        elif optim == "sgd":
            self.optimizer = torch.optim.SGD(params, lr=schedule(0))
        else:
            raise ValueError(f"unknown optimizer {optim!r}")
        self.optim = optim
        self.step = 0  # steps taken, non-finite ones included
        self.updates = 0  # updates applied: optax's counts
        self.seed = seed
        self.generator = torch.Generator(self.device).manual_seed(seed)
        set_dropout_generator(self.model, self.generator)
        # set by parallel/dp.py: reduce(loss, grads) -> the reduced loss,
        # grad_norm(grads), full(named) and local(named) tensors
        self.comm = None

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

    def compute_grads(self, batch, dmix=None):
        """The forward and backward of a training step: (loss, aux,
        gradient norm), the unclipped gradients left in each parameter's
        ``grad``. The forward moves BatchNorm's running statistics."""
        self.model.train()
        feats = self.featurize(self.to_device(batch, dmix))
        loss, aux = self.objective(self.model(feats["input"]), feats)
        self.optimizer.zero_grad(set_to_none=False)
        loss.backward()
        for p in self.model.parameters():
            if p.grad is None:  # unused: a zero gradient, as jax.grad's
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.model.parameters()]
        if self.comm is not None:
            loss = self.comm.reduce(loss.detach(), grads)
            return loss, aux, self.comm.grad_norm(grads)
        return loss, aux, global_norm(grads)

    def train_step(self, batch, dmix=None) -> Dict[str, torch.Tensor]:
        """One step on a batch of waveforms (or an encoded recipe and its
        ``DeviceMixer``); returns its metrics."""
        stats = [b.clone() for b in self.model.buffers()]
        loss, aux, norm = self.compute_grads(batch, dmix)
        return self.apply_grads(loss, aux, norm, stats)

    def apply_grads(self, loss, aux, norm, stats) -> Dict[str, torch.Tensor]:
        """The update of ``compute_grads``' gradients: clip, optimiser and
        schedule, or for a non-finite loss or norm the BatchNorm
        statistics put back to ``stats``; returns the step's metrics."""
        grads = [p.grad for p in self.model.parameters()]
        finite = bool(torch.isfinite(loss) & torch.isfinite(norm))
        if finite:
            clip_by_global_norm(grads, norm, self.grad_thresh)
            for group in self.optimizer.param_groups:
                group["lr"] = self.schedule(self.updates)
            self.optimizer.step()
            self.updates += 1
        else:
            with torch.no_grad():
                for b, old in zip(self.model.buffers(), stats):
                    b.copy_(old)
        metrics = {"loss": loss.detach(), "grad_norm": norm,
                   "lr": self.schedule(self.step), "finite": finite}
        metrics.update({k: v.detach() for k, v in aux.items()
                        if k != "perms"})
        self.step += 1
        return metrics

    def eval_step(self, batch, dmix=None) -> torch.Tensor:
        self.model.eval()
        with torch.no_grad():
            feats = self.featurize(self.to_device(batch, dmix))
            loss, _ = self.objective(self.model(feats["input"]), feats)
        return loss

    # --------------------------------------------------------------- loops
    @staticmethod
    def batch_geometry(batch):
        """(batch size, window samples) of a waveform or recipe batch."""
        if "dm_i" in batch:
            return batch["dm_i"].shape[0], int(batch["win"])
        return batch["mix"].shape[0], batch["mix"].shape[-1]

    def train_one_epoch(self, loader, batches_per_epoch: int,
                        log_fn: Optional[Callable] = None, sr: int = 16000,
                        log_every: int = 50, dmix=None) -> float:
        """A fixed-size epoch; returns the mean loss. Every ``log_every``
        steps (and at the end) ``log_fn`` gets the last step's loss,
        grad_norm and lr, the batch size and the audio seconds trained per
        second over the interval (``audio_sec_per_sec_per_chip``, one
        card)."""
        it = iter(loader)
        losses = []
        t_interval = time.perf_counter()
        interval_audio = 0.0
        for done in range(1, batches_per_epoch + 1):
            batch = next(it)
            ovl = batch.get("ovl")
            metrics = self.train_step(batch, dmix)
            losses.append(metrics["loss"])
            bsize, n = self.batch_geometry(batch)
            interval_audio += bsize * n / sr
            if log_fn is not None and (done % log_every == 0
                                       or done == batches_per_epoch):
                loss = float(metrics["loss"])  # waits for the card
                dt = time.perf_counter() - t_interval
                log = {"iter": done, "loss": loss,
                       "grad_norm": float(metrics["grad_norm"]),
                       "lr": float(metrics["lr"]), "bsize": int(bsize),
                       "audio_sec_per_sec_per_chip": interval_audio / dt}
                if ovl is not None:
                    log["ovl"] = float(ovl)
                log_fn(log)
                t_interval = time.perf_counter()
                interval_audio = 0.0
        return float(torch.stack(losses).sum()) / batches_per_epoch

    def validate(self, loader, num_batches: int = 100, dmix=None) -> float:
        it = iter(loader)
        losses = [self.eval_step(next(it), dmix) for _ in range(num_batches)]
        return float(torch.stack(losses).mean())

    # ---------------------------------------------------------------- state
    def _moments(self, key: str) -> Dict[str, torch.Tensor]:
        out = {}
        for name, p in self.model.named_parameters():
            st = self.optimizer.state.get(p, {})
            out[name] = st.get(key, torch.zeros_like(p))
        return out

    def _full(self, named: Dict[str, torch.Tensor]) -> Dict:
        return self.comm.full(named) if self.comm is not None else named

    def _local(self, named: Dict[str, torch.Tensor]) -> Dict:
        return self.comm.local(named) if self.comm is not None else named

    def float_leaves(self) -> list:
        """Every float tensor of the training state, in a fixed order:
        the parameters, the float buffers (BatchNorm's running
        statistics) and Adam's two moments (made, as zeros, where no step
        has made them yet). Integer leaves (the counts) are not among
        them."""
        params = list(self.model.parameters())
        leaves = params + [b for b in self.model.buffers()
                           if b.is_floating_point()]
        if self.optim == "adam":
            for p in params:
                st = self.optimizer.state[p]
                if not st:
                    st.update(step=torch.tensor(0.0),
                              exp_avg=torch.zeros_like(p),
                              exp_avg_sq=torch.zeros_like(p))
                leaves += [st["exp_avg"], st["exp_avg_sq"]]
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
                       self._moments("exp_avg")))[0])
                   + tree_leaves(to_jax(self._full(
                       self._moments("exp_avg_sq")))[0])
                   + [count])
        return TrainState(step=self.step, params=params, batch_stats=stats,
                          opt_state=opt)

    def load_state(self, state: TrainState) -> None:
        """Set params, BatchNorm statistics, the optimiser state and the
        step counter from a TrainState (``checkpoint.restore_state``)."""
        self.model.load_state_dict(self._local(
            from_jax(self.model, state.params, state.batch_stats)))
        self.step = int(state.step)
        opt = state.opt_state
        self.updates = int(opt[-1])  # the schedule's count
        if self.optim != "adam":
            return
        n = (len(opt) - 2) // 2
        like = to_jax(dict(self.model.named_parameters()))[0]
        named = dict(self.model.named_parameters())
        mu = self._local(from_jax(self.model, tree_unflatten(
            like, list(opt[1:1 + n]))))
        nu = self._local(from_jax(self.model, tree_unflatten(
            like, list(opt[1 + n:1 + 2 * n]))))
        self.optimizer.state.clear()
        for name, p in named.items():
            self.optimizer.state[p] = {
                "step": torch.tensor(float(opt[0])),
                "exp_avg": mu[name].to(p.device, p.dtype),
                "exp_avg_sq": nu[name].to(p.device, p.dtype)}
