"""The run's result line and the checks before it is printed."""

from __future__ import annotations

import json
import sys
from typing import Dict, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "css_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole: ``css_tpu_torch`` is not ``css_tpu``."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def device_info(device, chips: int, memory_peak: int,
                tracer=None) -> Dict:
    import torch

    if device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": chips, "memory_peak_bytes": int(memory_peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": int(memory_peak)}
    if tracer is not None and tracer.enabled:
        if tracer.busy_s is not None:
            info["busy_s"] = tracer.busy_s
        info["window_s"] = tracer.window_s
    return info


def checks_lines(checks: Dict[str, Dict]) -> list:
    """One line a number compared: its name, value and limit."""
    return [f"{k} {v['value']!r} limit {v['limit']!r}"
            for k, v in checks.items()]


def line(correct: bool, attempted: int, failed: int, metrics: Dict,
         device: Dict, checks: Dict[str, Dict],
         breakdown: Optional[Dict] = None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks  # last, as the contract asks
    return json.dumps(out)
