"""Percent of the separator's batch slots that held a window: the
program's ``windows`` over its ``batch_slots`` counter (the last batch of
a session is padded to the batch size)."""

from bench_gpu.harness.readers import counter


def read(rec):
    windows, slots = counter(rec, "windows"), counter(rec, "batch_slots")
    if not windows or not slots:
        return None
    return 100.0 * windows / slots
