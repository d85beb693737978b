"""css_tpu_torch — the PyTorch/CUDA port of css_tpu for one NVIDIA H100.

A second package beside ``css_tpu`` (the JAX/Pallas reference, which it
never imports): the same continuous speech separation pipeline
(separator -> stitcher -> beamformer) written in PyTorch, with every
Pallas kernel on its path replaced by a CUDA C++ kernel written for
Hopper (``csrc/``, built at first use by ``ops/_build.py``).

Entry points take ``device`` and default to ``"cuda"``; they raise when no
card is present unless the caller asks for ``"cpu"`` (as the tests do).
"""

__version__ = "0.1.0"
