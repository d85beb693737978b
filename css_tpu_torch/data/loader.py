"""Asynchronous batch prefetching (port of ``css_tpu/data/loader.py``).

Producer threads run the mixture synthesizer ahead of the training loop
(its numpy and scipy work releases the GIL) into a bounded queue. On a
CUDA device each producer pins its batch's arrays in page-locked memory,
and the consumer copies them to the card with ``non_blocking=True``, so
the copy overlaps the step the card is running. With on-device mixing a
producer is ``DeviceMixer.wrap(mixer_i)``, and what it stages is an
encoded recipe: the small ``dm_i``/``dm_f`` arrays, pinned and copied the
same way.

``group=G`` regroups the batches into runs of G of one window shape, as
``css_tpu``'s loader does for its multi-step dispatch
(``Trainer.train_one_epoch(steps_per_dispatch=G)``): producer threads
interleave, so G consecutive batches rarely share a shape even when every
producer holds its window bucket for G draws. Best effort, with bounded
buffering: a group whose shape does not arrive within 2G pulls is given
up.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch


class PrefetchLoader:
    """Yields batches produced ahead by background threads, their arrays
    as tensors on ``device`` (None: numpy, as produced).

    Pass either one iterator (one producer thread) or a ``factory``
    ``seed_index -> iterator`` for several producer threads, each with its
    own synthesizer state."""

    def __init__(self, it=None,
                 factory: Optional[Callable[[int], Iterator]] = None,
                 prefetch: int = 4, num_threads: int = 1, device=None,
                 group: int = 1):
        if (it is None) == (factory is None):
            raise ValueError("pass exactly one of it= or factory=")
        if factory is None and num_threads > 1:
            raise ValueError("multiple threads need factory= (independent "
                             "iterator states)")
        self.queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self.device = torch.device(device) if device is not None else None
        self._pin = self.device is not None and self.device.type == "cuda"
        self.group = max(int(group), 1)
        self._pending: dict = {}  # window shape -> batches held back
        self._current_key = None
        self._current_left = 0
        self._stop = threading.Event()
        self.threads = []
        iterators = ([it] if factory is None
                     else [factory(i) for i in range(num_threads)])
        for producer_it in iterators:
            t = threading.Thread(target=self._producer, args=(producer_it,),
                                 daemon=True)
            t.start()
            self.threads.append(t)

    def _stage(self, batch):
        """numpy arrays -> tensors (page-locked for a card); scalars stay."""
        if self.device is None:
            return batch
        out = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray) and v.ndim:
                v = torch.from_numpy(v)
                if self._pin:
                    v = v.pin_memory()
            out[k] = v
        return out

    def _producer(self, it):
        try:
            for batch in it:
                if self._stop.is_set():
                    return
                batch = self._stage(batch)
                while not self._stop.is_set():
                    try:
                        self.queue.put(batch, timeout=0.5)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except Exception as e:  # surface producer errors to the consumer
            self.queue.put(e)

    def __iter__(self) -> Iterator:
        return self

    def _get(self):
        item = self.queue.get()
        if isinstance(item, Exception):
            raise item
        return item

    @staticmethod
    def _shape_key(batch):
        """The window length: of the waveforms, or of an encoded recipe
        (the port's ``win``)."""
        for k in ("mix", "dm_winmark"):
            if isinstance(batch, dict) and k in batch:
                return batch[k].shape[-1]
        if isinstance(batch, dict) and "win" in batch:
            return int(batch["win"])
        return None

    def _get_grouped(self):
        """The next batch of the current same-shape group (port of
        ``css_tpu/data/loader.py``'s ``_get_grouped``)."""
        if self._current_left > 0:
            buf = self._pending.get(self._current_key)
            if buf:
                self._current_left -= 1
                return buf.pop(0)
            # pull until the current shape arrives (bounded buffering)
            cap = 2 * self.group
            while sum(map(len, self._pending.values())) < cap:
                b = self._get()
                k = self._shape_key(b)
                if k == self._current_key:
                    self._current_left -= 1
                    return b
                self._pending.setdefault(k, []).append(b)
            self._current_left = 0  # give up on this group
        # a new group from the deepest backlog, else a fresh pull
        if any(self._pending.values()):
            self._current_key = max(self._pending,
                                    key=lambda k: len(self._pending[k]))
        else:
            b = self._get()
            self._current_key = self._shape_key(b)
            self._pending.setdefault(self._current_key, []).append(b)
        self._current_left = self.group - 1
        return self._pending[self._current_key].pop(0)

    def __next__(self):
        item = self._get_grouped() if self.group > 1 else self._get()
        if self.device is None:
            return item
        return {k: (v.to(self.device, non_blocking=self._pin)
                    if isinstance(v, torch.Tensor) else v)
                for k, v in item.items()}

    def close(self):
        self._stop.set()
        try:
            while True:
                self.queue.get_nowait()
        except queue.Empty:
            pass
        for t in self.threads:
            t.join(timeout=5.0)
