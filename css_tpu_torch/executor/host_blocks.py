"""Page-locked host blocks that a session's separated streams come back
through.

A CUDA copy into pageable host memory goes through CUDA's own staging
buffer, and into memory fresh from the allocator it also faults in every
page as it lands: a 600 s session's two streams are 76.8 MB, which came
off an H100 at about 2 GB/s that way. ``HostBlocks.to_host`` copies the K
streams of a session into the rows of one (K, n) float32 block that the
pool keeps page-locked (``cudaHostRegister``) from session to session, and
hands out views of its rows.

A block is handed out again only when no array from it lives: every numpy
view of a returned array, however derived, keeps the block itself as its
``base``, so the block's reference count says whether a caller still holds
one. A block too short for a session is dropped, which unpins it, and a
longer one pinned. The pool holds at most ``BLOCKS`` blocks; with every one
of them held, the session is copied to pageable memory as before, so a
caller that keeps every session's streams pins no more than ``BLOCKS``
blocks.

Counters (``utils/trace.py``), one per call: ``to_host_reused`` (copied
into a block already pinned), ``to_host_pinned`` (into a block pinned
anew), ``to_host_pageable`` (every block held: the pageable copy).
"""

from __future__ import annotations

import sys
import weakref
from typing import List, Optional, Sequence

import numpy as np
import torch

from css_tpu_torch.utils import trace

# the benchmark's loop holds up to three sessions' streams (the two it
# keeps for its check and the last one returned) while a fourth is made
BLOCKS = 4


def _unpin(ptr: int) -> None:
    torch.cuda.cudart().cudaHostUnregister(ptr)


def _block(k: int, n: int, pin: bool) -> np.ndarray:
    """A (k, n) float32 block, page-locked if ``pin``; unpinned when it is
    freed."""
    block = np.empty((k, n), np.float32)
    if pin:
        ptr = block.ctypes.data
        torch.cuda.check_error(
            torch.cuda.cudart().cudaHostRegister(ptr, block.nbytes, 0))
        weakref.finalize(block, _unpin, ptr)
    return block


class HostBlocks:
    """Up to ``BLOCKS`` host blocks reused across sessions (module
    docstring). Pins where the streams are on a CUDA device; elsewhere the
    blocks are plain host memory."""

    def __init__(self):
        self._blocks: List[np.ndarray] = []

    def _held(self, i: int) -> bool:
        # the references are the pool's list entry and this call's argument
        return sys.getrefcount(self._blocks[i]) > 2

    def to_host(self, streams: Sequence[torch.Tensor],
                n: int) -> List[np.ndarray]:
        """The first ``n`` samples of each stream as float32 numpy arrays,
        rows of one block; on a CUDA device the copies run on the current
        stream, which is synchronised before they are returned."""
        block = self._take(len(streams), n, streams[0].is_cuda)
        if block is None:
            trace.count("to_host_pageable")
            return [s[:n].cpu().numpy() for s in streams]
        rows = [block[k, :n] for k in range(len(streams))]
        for row, s in zip(rows, streams):
            torch.from_numpy(row).copy_(s[:n], non_blocking=True)
        if streams[0].is_cuda:
            torch.cuda.current_stream(streams[0].device).synchronize()
        return rows

    def _take(self, k: int, n: int, pin: bool) -> Optional[np.ndarray]:
        """A free block of k rows of at least n samples, pinned anew where
        none is free and long enough; None where every block is held or
        no page-locked memory is to be had."""
        free = [i for i in range(len(self._blocks)) if not self._held(i)]
        for i in free:
            rows, length = self._blocks[i].shape
            if rows == k and length >= n:
                trace.count("to_host_reused")
                return self._blocks[i]
        if free:  # too short: dropping it unpins it
            del self._blocks[free[0]]
        elif len(self._blocks) == BLOCKS:
            return None
        try:
            block = _block(k, n, pin)
        except torch.cuda.CudaError:
            return None
        self._blocks.append(block)
        trace.count("to_host_pinned")
        return block
