"""Asynchronous batch prefetching (port of ``css_tpu/data/loader.py``).

Producer threads run the mixture synthesizer ahead of the training loop
(its numpy and scipy work releases the GIL) into a bounded queue. On a
CUDA device each producer pins its batch's arrays in page-locked memory,
and the consumer copies them to the card with ``non_blocking=True``, so
the copy overlaps the step the card is running.
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
                 prefetch: int = 4, num_threads: int = 1, device=None):
        if (it is None) == (factory is None):
            raise ValueError("pass exactly one of it= or factory=")
        if factory is None and num_threads > 1:
            raise ValueError("multiple threads need factory= (independent "
                             "iterator states)")
        self.queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self.device = torch.device(device) if device is not None else None
        self._pin = self.device is not None and self.device.type == "cuda"
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

    def __next__(self):
        item = self.queue.get()
        if isinstance(item, Exception):
            raise item
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
