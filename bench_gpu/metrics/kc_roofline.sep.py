"""KC's share of its roofline in the traced window (device trace,
costs/kc.py), percent."""

from bench_gpu.harness.readers import kernel_roofline


def read(rec):
    return kernel_roofline(rec, "kc")
