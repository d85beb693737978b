"""Structured training logging (copy of ``css_tpu/utils/logging.py``): a
jsonl stream with one JSON object per logged step, the same fields as the
JAX package's, echoed to the console."""

from __future__ import annotations

import json
import logging
import time
from typing import Optional

logging.basicConfig(
    format="%(asctime)s %(levelname)-8s %(message)s",
    level=logging.INFO,
    datefmt="%Y-%m-%d %H:%M:%S",
)


def get_logger(name: str = "css_tpu_torch") -> logging.Logger:
    return logging.getLogger(name)


class MetricsLogger:
    """Writes one JSON object per step to a file and/or the console."""

    def __init__(self, path: Optional[str] = None, echo_every: int = 1):
        self.fh = open(path, "a") if path else None
        self.echo_every = echo_every
        self.log = get_logger()

    def __call__(self, record: dict):
        record = dict(record)
        record.setdefault("time", time.time())
        if self.fh is not None:
            self.fh.write(json.dumps(record) + "\n")
            self.fh.flush()
        it = record.get("iter")
        if it is None or self.echo_every <= 0 or it % self.echo_every == 0:
            parts = []
            for k, v in record.items():
                if k == "time":
                    continue
                parts.append(f"{k}: {v:0.5g}" if isinstance(v, float)
                             else f"{k}: {v}")
            self.log.info(" ".join(parts))

    def close(self):
        if self.fh is not None:
            self.fh.close()
