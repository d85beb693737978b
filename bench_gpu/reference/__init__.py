"""The benchmark's plain reference: float32 PyTorch, TF32 off.

Straightforward copies of what the program under test computes, written
from the published model descriptions and the pipeline's documented
semantics: the STFT and iSTFT, the CSS Conformer and BLSTM mask
estimators, the window stitcher, masking resynthesis, PIT-MSE and Adam.
Parameters are a flat dict keyed like the program's state_dict, so the
harness hands both sides the same weights, which it makes itself.

This package imports torch and numpy only: never the program
(``css_tpu_torch``), the JAX package or JAX.

Every matrix product goes through ``precision.mm``, whose ``mode`` rounds
the operands: ``"f32"`` (none) is the reference; ``"tf32"`` and ``"fp8"``
are the lower-precision controls that the output check must reject.
"""
