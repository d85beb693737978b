"""The launch plans of the CUDA kernels' wrappers, on the CPU: how rows and
batches are split across launches, K2's shared-memory layout, and which
shapes take the plain route. These decide from the shape alone, before any
launch, so they are pure functions that need no card."""

import math

import numpy as np
import pytest
import torch

from css_tpu_torch.ops import _build, lstm_cuda, stft_mag_cuda
from css_tpu_torch.ops import stft as stft_ops


@pytest.mark.parametrize("n,limit", [(0, 5), (1, 1), (5, 5), (6, 5),
                                     (300, 256), (129, 128), (70000, 65535),
                                     (131071, 65535), (10, 3)])
def test_split_rows_covers_evenly(n, limit):
    parts = _build.split_rows(n, limit)
    assert len(parts) == math.ceil(n / limit)
    if parts:
        assert parts[0][0] == 0 and parts[-1][1] == n
        assert [lo for lo, _ in parts[1:]] == [hi for _, hi in parts[:-1]]
    sizes = [hi - lo for lo, hi in parts]
    assert all(0 < s <= limit for s in sizes)
    assert not sizes or max(sizes) - min(sizes) <= 1


def test_split_rows_refuses_an_empty_limit():
    with pytest.raises(ValueError, match="limit"):
        _build.split_rows(3, 0)


@pytest.mark.parametrize("elem", [4, 2], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("hidden", [1, 3, 8, 64, 99, 120, 121, 128, 256, 512,
                                    777, 1024, 1100, 1192])
def test_lstm_plan_fits_the_kernel(hidden, elem):
    """Every plan fits a block's shared memory, keeps the kernel's layout
    rules (csrc/lstm.cu checks the same before it launches) and stays
    within the fixed grid: whole clusters of 8, at most 15 of them."""
    plan = lstm_cuda.lstm_plan(hidden, elem)
    k_step = 32 // elem
    npad = -(-4 * plan.units // 8) * 8
    w_bytes = plan.hpad * plan.wstride * elem
    h_bytes = lstm_cuda.MAX_BATCH * plan.hstride * elem
    part = lstm_cuda.WARPS * lstm_cuda.MAX_BATCH * npad * 4
    assert plan.smem == w_bytes + 16 + max(h_bytes, part)
    assert plan.smem <= lstm_cuda.SMEM_OPTIN
    assert plan.blocks % lstm_cuda.CLUSTER == 0 and lstm_cuda.CLUSTER == 8
    assert plan.blocks <= lstm_cuda.MAX_BLOCKS == 120
    assert plan.blocks * plan.units >= hidden
    # no block without a unit of its own
    assert (plan.blocks - lstm_cuda.CLUSTER) * plan.units < hidden
    assert npad <= lstm_cuda.MAX_COLS
    assert plan.wstride >= npad and plan.wstride % 32 in (8, 24)
    assert plan.hpad >= hidden and plan.hpad % k_step == 0
    assert plan.hstride * elem % 128 == 16
    assert plan.hstride >= min(plan.chunk, plan.hpad)
    assert plan.chunk % k_step == 0
    assert plan.chunk >= plan.hpad or plan.chunk % 32 == 0


@pytest.mark.parametrize("batch,launches", [(1, 1), (32, 1), (33, 2),
                                            (129, 5), (300, 10)])
def test_lstm_batch_split(batch, launches):
    """Two 16-row mma tiles a launch: larger batches are split."""
    assert len(_build.split_rows(batch, lstm_cuda.MAX_BATCH)) == launches


def test_lstm_plan_main_shapes():
    """The BLSTM's hidden 512 and the causal 1024 on the H100's 15
    co-resident clusters of 8: 5 and 9 units a block; h_{t-1} whole in
    shared memory at 512, in two chunks at 1024 in float32."""
    p = lstm_cuda.lstm_plan(512, 4)
    assert (p.units, p.blocks, p.chunk) == (5, 104, 512)
    p = lstm_cuda.lstm_plan(1024, 4)
    assert (p.units, p.blocks) == (9, 120)
    assert math.ceil(p.hpad / p.chunk) == 2
    assert lstm_cuda.lstm_plan(1024, 2).chunk == 1024


@pytest.mark.parametrize("hidden,elem,first", [
    (1193, 4, True), (1536, 4, False), (1441, 2, True), (2048, 2, False)])
def test_lstm_plan_routes_an_oversize_hidden_to_plain(hidden, elem, first):
    """The plain route from 1193 units (float32) and 1441 (bf16) on 120
    blocks."""
    assert lstm_cuda.lstm_plan(hidden, elem) is None
    if first:
        assert lstm_cuda.lstm_plan(hidden - 1, elem) is not None


@pytest.mark.parametrize("frame_len,hop,kernel", [
    (512, 256, True), (400, 200, True), (2048, 1024, True), (4, 2, True),
    (512, 128, False), (4096, 2048, False), (2, 1, False)])
def test_stft_mag_route(frame_len, hop, kernel):
    assert stft_mag_cuda.takes_kernel(frame_len, hop) is kernel


def test_stft_mag_tables():
    """K3's twiddles are W^j = e^{-2 pi i j / n_fft} rounded once to
    float32 from float64: the split step's W^k, k < M = n_fft/2, then each
    radix-2 stage's W^{pos * M / 2^s}, pos < 2^s; its window is the plain
    version's."""
    twid, window = stft_mag_cuda._tables(400, torch.device("cpu"))
    n_fft, m = 512, 256
    j = np.concatenate([np.arange(m)] + [np.arange(1 << s) * (m >> s)
                                         for s in range(8)])
    want = np.exp(-2j * np.pi * j / n_fft)
    assert twid.shape == (2 * m - 1, 2) and twid.dtype == torch.float32
    # stage 7's twiddles are W^{2 pos}: the table's last entry is W^254
    np.testing.assert_allclose(twid[-1].numpy(), [np.cos(-np.pi * 254 / 256),
                                                  np.sin(-np.pi * 254 / 256)],
                               atol=1e-7)
    np.testing.assert_array_equal(twid[:, 0].numpy(),
                                  want.real.astype(np.float32))
    np.testing.assert_array_equal(twid[:, 1].numpy(),
                                  want.imag.astype(np.float32))
    np.testing.assert_allclose(window.numpy(), stft_ops.hann_window(400),
                               atol=1e-7)

