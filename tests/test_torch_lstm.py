"""K2's plain version (css_tpu_torch.ops.lstm_cuda.lstm_plain) against the
TPU kernel run in interpret mode and against css_tpu's scan; the kernel
wrapper's argument checks on a device without the kernel.

Inputs from numpy seeds at the TPU kernel test's sizes (batch 8-16,
12 steps, hidden 128), as tests/test_lstm_pallas.py runs them.

Tolerances. float32: both compute the same recurrence in float32 (the JAX
package pins full float32 precision), summing the h @ W_hh products in
another order: 1e-6 absolute and relative on hidden states in (-1, 1)
(measured < 3e-7). bfloat16: h is rounded to bf16 every step in both, so
a value that lands near a rounding boundary can round one bf16 step
(2^-9 to 2^-8 on |h| in [0.25, 1)) the other way and carry that into
later steps: 1e-2 absolute (measured 2e-3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from css_tpu.models.blstm import lstm_scan as jax_lstm_scan
from css_tpu.ops.lstm_pallas import lstm_fused as pallas_lstm_fused
from css_tpu_torch.models.blstm import lstm_scan
from css_tpu_torch.ops import lstm_cuda

H = 128
DTYPES = {"float32": (jnp.float32, torch.float32, 8, 1e-6),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 16, 1e-2)}


def _inputs(b, t, h, seed):
    rng = np.random.default_rng(seed)
    xw = rng.standard_normal((b, t, 4 * h)).astype(np.float32)
    w_hh = (rng.standard_normal((h, 4 * h)) * 0.1).astype(np.float32)
    return xw, w_hh


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_matches_pallas_interpret(dtype, reverse):
    jdt, tdt, b, tol = DTYPES[dtype]
    xw, w_hh = _inputs(b, 12, H, seed=3 + reverse)
    want = pallas_lstm_fused(jnp.asarray(xw, jdt), jnp.asarray(w_hh, jdt), H,
                             reverse=reverse, interpret=True)
    got = lstm_cuda.lstm_plain(torch.as_tensor(xw).to(tdt),
                               torch.as_tensor(w_hh).to(tdt), H, reverse)
    assert got.dtype == tdt and got.shape == (b, 12, H)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol if dtype == "float32" else 0)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_plain_matches_css_tpu_scan_float32(reverse):
    xw, w_hh = _inputs(8, 12, H, seed=7)
    want = jax_lstm_scan(jnp.asarray(xw), jnp.asarray(w_hh), H,
                         reverse=reverse)
    got = lstm_cuda.lstm_plain(torch.as_tensor(xw), torch.as_tensor(w_hh), H,
                               reverse)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


def test_cpu_tensors_take_the_plain_version():
    xw, w_hh = _inputs(5, 9, 32, seed=11)  # ragged sizes: no tiling gate
    before = lstm_cuda.lstm_fused.launches
    got = lstm_scan(torch.as_tensor(xw), torch.as_tensor(w_hh), 32,
                    reverse=True)
    want = lstm_cuda.lstm_plain(torch.as_tensor(xw), torch.as_tensor(w_hh),
                                32, reverse=True)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert lstm_cuda.lstm_fused.launches == before


def test_kernel_path_refuses_what_the_kernel_does_not_take():
    """On a device other than the CPU the wrapper checks its operands before
    it looks for the kernel; the meta device runs those checks here."""
    meta = torch.device("meta")
    xw = torch.empty((4, 10, 4 * 64), device=meta)
    w_hh = torch.empty((64, 4 * 64), device=meta)
    before = lstm_cuda.lstm_fused.launches
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        lstm_cuda.lstm_fused(xw.double(), w_hh.double(), 64)
    with pytest.raises(TypeError, match="one dtype"):
        lstm_cuda.lstm_fused(xw, w_hh.bfloat16(), 64)
    with pytest.raises(ValueError, match="4h"):
        lstm_cuda.lstm_fused(xw, w_hh, 32)
    with pytest.raises(ValueError, match="4h"):
        lstm_cuda.lstm_fused(xw[0], w_hh, 64)
    with pytest.raises(ValueError, match="contiguous"):
        lstm_cuda.lstm_fused(xw.transpose(0, 1), w_hh, 64)
    with pytest.raises(ValueError, match="contiguous"):
        lstm_cuda.lstm_fused(xw, w_hh.t().contiguous().t(), 64)
    with pytest.raises(ValueError, match="unsupported device"):
        lstm_cuda.lstm_fused(xw, w_hh, 64)
    with pytest.raises(ValueError, match="unsupported device"):
        lstm_cuda.lstm_fused(xw.bfloat16(), w_hh.bfloat16(), 64, reverse=True)
    assert lstm_cuda.lstm_fused.launches == before


@pytest.mark.parametrize("kwargs,item", [
    ({"differentiable": True, "return_state": True}, "item 9"),
    ({"return_state": True}, "item 9"),
    ({"state": (torch.zeros(2, 8), torch.zeros(2, 8))}, "item 9"),
])
def test_scan_refuses_training_and_carried_state(kwargs, item):
    """Carried state (streaming, item 9) is refused, in training too; the
    differentiable scan itself (training) is tests/test_torch_train_models
    .py's."""
    xw, w_hh = _inputs(2, 3, 8, seed=0)
    with pytest.raises(NotImplementedError, match=item):
        lstm_scan(torch.as_tensor(xw), torch.as_tensor(w_hh), 8, **kwargs)
