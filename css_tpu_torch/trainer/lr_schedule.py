"""Three-phase LR schedule: linear warmup -> hold -> exponential decay
(port of ``css_tpu/trainer/lr_schedule.py``).

A plain function of the count n of completed updates:
  n <= warmup:           min_lr + (lr - min_lr) * n / warmup
  n <= warmup + fixed:   lr
  else:                  lr * exp(-decay * (n - warmup - fixed))
With warmup > 0 the first update runs at min_lr. Computed in float32, in
the JAX package's order of operations, so both packages apply the same
rate.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

f32 = np.float32


@dataclass(frozen=True)
class LRSchedule:
    lr: float
    warmup: int = 0
    fixed: int = 0
    decay: float = 0.0
    min_lr: float = 1e-9

    @staticmethod
    def add_args(parser):
        parser.add_argument("--warmup", type=int, default=0)
        parser.add_argument("--decay", type=float, default=0.0)
        parser.add_argument("--fixed", type=int, default=0)
        parser.add_argument("--min-lr", type=float, default=1e-9)

    @classmethod
    def from_conf(cls, conf):
        return cls(
            lr=float(conf.get("lr", 1e-3)),
            warmup=int(conf.get("warmup", 0)),
            fixed=int(conf.get("fixed", 0)),
            decay=float(conf.get("decay", 0.0)),
            min_lr=float(conf.get("min_lr", 1e-9)),
        )

    def __call__(self, step: int) -> float:
        """The rate of the update that follows ``step`` completed ones."""
        n = f32(step)
        if n > self.warmup + self.fixed:
            rate = f32(self.lr) * np.exp(
                f32(-self.decay) * (n - f32(self.warmup + self.fixed)))
        else:
            rate = f32(self.lr)
        if self.warmup > 0 and n <= self.warmup:
            rate = (f32(self.min_lr) + f32(self.lr - self.min_lr) * n
                    / f32(self.warmup))
        return float(f32(rate))
