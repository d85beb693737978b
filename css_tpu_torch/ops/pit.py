"""Permutation-invariant training (PIT) loss.

Port of ``css_tpu/ops/pit.py``: a static (K!, K) permutation table
(``utils.permutations``, the same order), one gather that builds every
permuted estimate, the pairwise loss mapped over the permutation axis with
``torch.func.vmap`` and the minimum taken per example. A ``loss_fn`` takes
one example's (K, ...) estimate and target and returns a scalar, as in the
JAX package.
"""

from __future__ import annotations

import functools
from typing import Callable, Tuple

import torch

from css_tpu_torch.utils.permutations import permutations_array

__all__ = ["permutations_array", "mse_pairwise", "l1_pairwise", "pit_loss",
           "batch_pit_loss"]


def mse_pairwise(est: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Mean squared error over all axes."""
    return torch.mean(torch.square(est - ref))


def l1_pairwise(est: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(est - ref))


@functools.lru_cache(maxsize=None)
def _perm_table(k: int, device: torch.device) -> torch.Tensor:
    """The (K!, K) permutation table on ``device``, made once (a captured
    program cannot copy it from the host)."""
    return torch.as_tensor(permutations_array(k), device=device,
                           dtype=torch.long)


def _perm_losses(estimate, target, loss_fn):
    """estimate, target (B, K, ...) -> the (B, K!) losses and the table."""
    perms = _perm_table(estimate.shape[1], estimate.device)
    permuted = estimate[:, perms]  # (B, K!, K, ...)
    per_example = torch.func.vmap(loss_fn, in_dims=(0, None))
    losses = torch.func.vmap(per_example)(permuted, target)
    return losses, perms


def pit_loss(estimate: torch.Tensor, target: torch.Tensor, axis: int = 0,
             loss_fn: Callable = mse_pairwise,
             return_permutation: bool = False):
    """Minimum of ``loss_fn(permuted estimate, target)`` over the K!
    permutations of ``estimate``'s speaker axis ``axis`` (one example);
    optionally also the winning permutation's row."""
    losses, perms = _perm_losses(torch.movedim(estimate, axis, 0)[None],
                                 torch.movedim(target, axis, 0)[None],
                                 loss_fn)
    best = torch.argmin(losses[0])
    if return_permutation:
        return losses[0, best], perms[best]
    return losses[0, best]


def batch_pit_loss(estimate: torch.Tensor, target: torch.Tensor,
                   loss_fn: Callable = mse_pairwise
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PIT over a batch: (B, K, ...) inputs -> (mean loss, (B, K) perms).
    Ties go to the first permutation, as ``jnp.argmin``."""
    losses, perms = _perm_losses(estimate, target, loss_fn)
    best = torch.argmin(losses, dim=1)
    chosen = losses.gather(1, best[:, None])[:, 0]
    return torch.mean(chosen), perms[best]
