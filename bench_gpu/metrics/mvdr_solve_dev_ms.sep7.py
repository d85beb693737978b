"""Device milliseconds a session launched under the program's
``css.beamformer.solve`` span: the Souden coefficients, one batched
solve of windows x streams x bins 7 x 7 complex systems and the trace.
From the device trace (``harness/spans.py``); None where the program
marks no such span."""

from bench_gpu.harness.readers import device_ms


def read(rec):
    return device_ms(rec, "beamformer.solve", "sessions")
