"""Objective contract (``css_tpu/objectives/base.py``): an objective is a
callable ``objective(outputs, batch) -> (loss, aux)`` on model outputs; it
does not run the model. ``aux`` holds tensors for logging (``perms``, the
chosen PIT permutations, and the objective's own terms)."""

from __future__ import annotations

from typing import Dict, List

# name -> objective class (add_args, build_objective); filled by the package
OBJECTIVES: Dict[str, type] = {}


def source_keys(batch) -> List[str]:
    """source1..sourceK keys of a batch, in order."""
    keys = [k for k in batch if k.startswith("source") and k[6:].isdigit()]
    return sorted(keys, key=lambda k: int(k[6:]))
