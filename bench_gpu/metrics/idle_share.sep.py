"""Percent of the traced window with no device operation running
(1 - the union of device intervals over the window)."""

from bench_gpu.harness.readers import idle_share


def read(rec):
    return idle_share(rec)
