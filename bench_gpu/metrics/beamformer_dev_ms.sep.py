"""Device milliseconds a session launched under the program's
``css.beamformer`` span: the beamformer: the masked spectra, the dedup
and K1. From the device trace, each operation charged to the span open
on the host when it was launched (``harness/spans.py``)."""

from bench_gpu.harness.readers import device_ms


def read(rec):
    return device_ms(rec, "beamformer", "sessions")
