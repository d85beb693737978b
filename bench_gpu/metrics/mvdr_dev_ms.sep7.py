"""Device milliseconds a session launched under the program's
``css.beamformer.mvdr`` span: Souden MVDR over every window of the
recording (the centered 7-channel STFT, both SCMs, the batched 7 x 7
solves, the apply and the energy rescale). From the device trace, each
operation charged to the span open on the host when it was launched
(``harness/spans.py``); None where the program marks no such span."""

from bench_gpu.harness.readers import device_ms


def read(rec):
    return device_ms(rec, "beamformer.mvdr", "sessions")
