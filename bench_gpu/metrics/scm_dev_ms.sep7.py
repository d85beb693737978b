"""Device milliseconds a session launched under the program's
``css.beamformer.scm`` span: the target and noise spatial covariance
matrices of every window (the mask-weighted spectra and their products).
From the device trace (``harness/spans.py``); None where the program
marks no such span."""

from bench_gpu.harness.readers import device_ms


def read(rec):
    return device_ms(rec, "beamformer.scm", "sessions")
