"""Percent of the window's sessions whose streams came back to the host
through a page-locked block the program had pinned before: its
``to_host_reused`` counter over its ``sessions``. Absent where the program
counts none of ``to_host_reused``, ``to_host_pinned`` and
``to_host_pageable`` (no reused host blocks)."""

from bench_gpu.harness.readers import counter

WAYS = ("to_host_reused", "to_host_pinned", "to_host_pageable")


def read(rec):
    got = (rec.tracer.program or {}).get("counters", {})
    if not any(w in got for w in WAYS):
        rec.why.append("to_host_reuse: the program counted no host block")
        return None
    sessions = counter(rec, "sessions")
    if not sessions:
        return None
    return 100.0 * got.get("to_host_reused", 0) / sessions
