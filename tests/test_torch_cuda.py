"""The CUDA kernels on the card, against their plain versions.

These need an NVIDIA Hopper card and nvcc; elsewhere they skip. Where the
card is, JAX need not be, so run them without the repo's conftest (which
imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Float32 with TF32 off; kernel and plain version sum the same products in
another order: 2e-4 absolute, 1e-4 relative (the tolerance of
tests/test_istft_pallas.py for the TPU kernel). K2 in bfloat16: h is
rounded to bf16 every step in both, so a value near a rounding boundary
can land one bf16 step (up to 2^-8 on |h| < 1) the other way and carry
into later steps: 3e-2 absolute (about 8 such steps). K2 in float32 is
held also to 5e-6 absolute (chip_smoke.py's LSTM_F32_MAX_ERR): its 3xTF32
product keeps ~21 of float32's 24 bits, and a single-TF32 product of the
same function fails that bound (test_lstm_f32_bound_catches_single_tf32).
"""

import numpy as np
import pytest
import torch

from css_tpu_torch.ops import istft_cuda, lstm_cuda, stft_mag_cuda
from css_tpu_torch.ops import stft as stft_ops

pytestmark = pytest.mark.cuda
ATOL, RTOL = 2e-4, 1e-4
LSTM_BF16_ATOL = 3e-2
LSTM_F32_MAX_ERR = 5e-6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the card with "
                    "`python -m pytest --noconftest -m cuda "
                    "tests/test_torch_cuda.py`")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _signal(shape, seed, dev):
    x = np.random.default_rng(seed).standard_normal(shape) * 0.1
    return torch.as_tensor(x.astype(np.float32), device=dev)


@pytest.mark.parametrize("rows,n", [(1, 512), (3, 5000), (7, 2816),
                                    (32, 38400), (32, 38656)])
def test_stft_mag_kernel_matches_plain(card, rows, n):
    x = _signal((rows, n), rows, card)
    before = stft_mag_cuda.stft_mag.launches
    got = stft_mag_cuda.stft_mag(x)
    torch.cuda.synchronize()
    assert stft_mag_cuda.stft_mag.launches == before + 1
    want = stft_mag_cuda.stft_mag_plain(x)
    assert got.shape == want.shape == (rows, (n - 512) // 256 + 1, 257)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("frame,hop", [(4, 2), (64, 32), (400, 200),
                                       (1024, 512), (2048, 1024)])
def test_stft_mag_kernel_other_framings(card, frame, hop):
    """Every FFT length the kernel takes, and a frame shorter than its FFT
    (400 in 512: the frame is zero-padded)."""
    x = _signal((3, 9 * hop + frame), frame, card)
    before = stft_mag_cuda.stft_mag.launches
    got = stft_mag_cuda.stft_mag(x, frame, hop)
    torch.cuda.synchronize()
    assert stft_mag_cuda.stft_mag.launches == before + 1
    want = stft_mag_cuda.stft_mag_plain(x, frame, hop)
    assert got.shape == want.shape == (3, 10, stft_ops.num_fft_bins(frame))
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("rows,n", [(1, 512), (5, 5120), (146, 38656)])
def test_istft_kernel_matches_plain(card, rows, n):
    spec = stft_ops.stft(_signal((rows, n), rows, card))
    spec = (spec * torch.rand(spec.shape, device=card)).contiguous()
    before = istft_cuda.istft.launches
    got = istft_cuda.istft(spec)
    torch.cuda.synchronize()
    assert istft_cuda.istft.launches == before + 1
    want = istft_cuda.istft_plain(spec)
    assert got.shape == want.shape == (rows, (spec.shape[1] + 1) * 256)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("frame,hop", [(4, 2), (64, 32), (400, 200),
                                       (1024, 512), (2048, 1024)])
def test_istft_kernel_other_framings(card, frame, hop):
    """Every FFT length the kernel takes, and a frame shorter than its FFT
    (400 in 512: the irfft is cut to the frame)."""
    spec = stft_ops.stft(_signal((3, 9 * hop + frame), frame, card), frame,
                         hop)
    spec = (spec * torch.rand(spec.shape, device=card)).contiguous()
    before = istft_cuda.istft.launches
    got = istft_cuda.istft(spec, frame, hop)
    torch.cuda.synchronize()
    assert istft_cuda.istft.launches == before + 1
    want = istft_cuda.istft_plain(spec, frame, hop)
    assert got.shape == want.shape == (3, 11 * hop)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("rows,frames", [(5, 19), (4, 1)])
def test_istft_kernel_random_spectrum(card, rows, frames):
    """A random complex spectrum with imaginary parts in the DC and Nyquist
    bins, which the irfft ignores and the split step must too; and T = 1,
    a recording of one frame (slot 0 and slot T only)."""
    rng = np.random.default_rng(rows)
    spec = (rng.standard_normal((rows, frames, 257))
            + 1j * rng.standard_normal((rows, frames, 257))) * 0.1
    spec = torch.as_tensor(spec.astype(np.complex64), device=card)
    assert float(spec[..., [0, 256]].imag.abs().min()) > 0
    before = istft_cuda.istft.launches
    got = istft_cuda.istft(spec)
    torch.cuda.synchronize()
    assert istft_cuda.istft.launches == before + 1
    want = istft_cuda.istft_plain(spec)
    assert got.shape == want.shape == (rows, (frames + 1) * 256)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("rows,n,length", [(146, 38656, 38656),
                                           (4, 5120, 5000),
                                           (3, 2816, 4000)])
def test_istft_centered_entry_matches_plain(card, rows, n, length):
    """K1 through its centered entry (the Souden MVDR path's synthesis):
    one launch, then the centering trim and the cut or pad to length."""
    spec = stft_ops.stft(_signal((rows, n), rows + 1, card), center=True)
    spec = (spec * torch.rand(spec.shape, device=card)).contiguous()
    before = istft_cuda.istft.launches
    got = istft_cuda.istft_centered(spec, 512, 256, length)
    torch.cuda.synchronize()
    assert istft_cuda.istft.launches == before + 1
    want = stft_ops.istft(spec, 512, 256, center=True, length=length)
    assert got.shape == want.shape == (rows, length)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


def _recording_7ch(seconds, seed):
    """Two noise sources at 30 and 150 degrees on the 7-mic array with
    0.03 sensor noise, so that float32 determines the Souden weights
    (tests/test_torch_mvdr.py)."""
    from css_tpu_torch.data.spatial import spatialize

    rng = np.random.default_rng(seed)
    srcs = rng.standard_normal((2, int(seconds * 16000))) * 0.1
    return spatialize(srcs, [30.0, 150.0], noise_level=0.03, rng=rng), rng


def test_mvdr_on_the_card_matches_the_cpu(card):
    """ops.mvdr on the card (batched complex einsums and
    torch.linalg.solve_ex) against the same on the CPU: the SCMs to 1e-5
    of their largest entry, the beamformed spectrum to 1e-4 of its."""
    from css_tpu_torch.ops import mvdr

    rec, rng = _recording_7ch(38656 * 3 / 16000, 1)
    wins = torch.as_tensor(np.ascontiguousarray(
        rec.reshape(7, 3, 38656).transpose(1, 0, 2)))
    spec = stft_ops.stft(wins, center=True)  # (3, 7, 152, 257)
    tgt_m, noi_m = (torch.as_tensor(rng.uniform(0, 1, (3, 152, 257))
                                    .astype(np.float32)) for _ in range(2))
    scm = mvdr.compute_scm(spec.to(card), tgt_m.to(card)).cpu()
    want = mvdr.compute_scm(spec, tgt_m)
    assert float((scm - want).abs().max()) <= 1e-5 * float(want.abs().max())
    got = mvdr.souden_mvdr(spec.to(card), tgt_m.to(card), noi_m.to(card))
    want = mvdr.souden_mvdr(spec, tgt_m, noi_m)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * float(
        want.abs().max())


@pytest.mark.parametrize("seconds", [3.3, 8.0])
def test_mvdr_beamformer_on_the_card_matches_the_cpu(card, seconds):
    """The Souden MVDR beamformer on a (7, T) recording, on the card (K1
    through the centered entry, one launch) and on the CPU (the plain
    versions): the 0.9-peak streams to 1e-3 (tests/test_torch_mvdr.py)."""
    from css_tpu_torch.executor.beamformer import Beamformer
    from css_tpu_torch.executor.windowing import pad_for_windows

    rec, rng = _recording_7ch(seconds, 2)
    wav = pad_for_windows(torch.as_tensor(rec), 38656, 12800)
    n_win = (wav.shape[-1] - 38656) // 12800 + 1
    masks = [torch.as_tensor(rng.uniform(0, 1, ((n_win - 1) * 50 + 150, 257))
                             .astype(np.float32)) for _ in range(3)]
    want = Beamformer(device="cpu").continuous_process(wav, masks)
    before = istft_cuda.istft.launches
    got = Beamformer(device=card).continuous_process(
        wav.to(card), [m.to(card) for m in masks])
    torch.cuda.synchronize()
    assert istft_cuda.istft.launches == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, atol=1e-3, rtol=0.0)


def test_kernels_refuse_what_they_do_not_take(card):
    """Wrong layouts and types raise; a framing other than frame_len ==
    2*hop takes the plain route, counted, with no launch."""
    x = _signal((4, 6000), 0, card)
    with pytest.raises(ValueError, match="contiguous"):
        stft_mag_cuda.stft_mag(x[:, ::2])
    with pytest.raises(TypeError):
        stft_mag_cuda.stft_mag(x.double())
    launches, routes = (stft_mag_cuda.stft_mag.launches,
                        stft_mag_cuda.stft_mag.plain_routes)
    got = stft_mag_cuda.stft_mag(x, 512, 128)
    assert stft_mag_cuda.stft_mag.launches == launches
    assert stft_mag_cuda.stft_mag.plain_routes == routes + 1
    torch.testing.assert_close(got, stft_mag_cuda.stft_mag_plain(x, 512, 128),
                               atol=0, rtol=0)
    spec = stft_ops.stft(x)
    with pytest.raises(ValueError, match="contiguous"):
        istft_cuda.istft(spec.transpose(0, 1))
    with pytest.raises(TypeError):
        istft_cuda.istft(spec.to(torch.complex128))
    launches, routes = istft_cuda.istft.launches, istft_cuda.istft.plain_routes
    got = istft_cuda.istft(spec, 512, 128)
    assert istft_cuda.istft.launches == launches
    assert istft_cuda.istft.plain_routes == routes + 1
    torch.testing.assert_close(got, istft_cuda.istft_plain(spec, 512, 128),
                               atol=0, rtol=0)


def test_kernels_split_rows_beyond_one_launch(card):
    """70000 rows, more than gridDim.y takes: two launches, exact."""
    rows = 70000
    x = _signal((rows, 768), 1, card)
    before = stft_mag_cuda.stft_mag.launches
    got = stft_mag_cuda.stft_mag(x)
    torch.cuda.synchronize()
    assert stft_mag_cuda.stft_mag.launches == before + 2
    torch.testing.assert_close(got, stft_mag_cuda.stft_mag_plain(x),
                               atol=ATOL, rtol=RTOL)
    spec = stft_ops.stft(x)
    spec = (spec * torch.rand(spec.shape, device=card)).contiguous()
    before = istft_cuda.istft.launches
    got = istft_cuda.istft(spec)
    torch.cuda.synchronize()
    assert istft_cuda.istft.launches == before + 2
    assert got.shape == (rows, 3 * 256)
    torch.testing.assert_close(got, istft_cuda.istft_plain(spec),
                               atol=ATOL, rtol=RTOL)


def _lstm_inputs(b, t, h, dtype, seed, dev):
    rng = np.random.default_rng(seed)
    xw = rng.standard_normal((b, t, 4 * h)).astype(np.float32)
    # recurrent weights of order 1/sqrt(h) (the BLSTM's orthogonal W_hh:
    # 1/sqrt(4h)), so the recurrence neither vanishes nor saturates
    w_hh = (rng.standard_normal((h, 4 * h)) / np.sqrt(h)).astype(np.float32)
    return (torch.as_tensor(xw, device=dev).to(dtype),
            torch.as_tensor(w_hh, device=dev).to(dtype))


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,h", [(32, 150, 512), (32, 150, 1024),
                                   (5, 37, 128), (3, 4, 99)])
def test_lstm_kernel_matches_plain(card, b, t, h, dtype, reverse):
    xw, w_hh = _lstm_inputs(b, t, h, dtype, b + h, card)
    before = lstm_cuda.lstm_fused.launches
    got = lstm_cuda.lstm_fused(xw, w_hh, h, reverse=reverse)
    torch.cuda.synchronize()
    assert lstm_cuda.lstm_fused.launches == before + 1
    want = lstm_cuda.lstm_plain(xw, w_hh, h, reverse=reverse)
    assert got.shape == want.shape == (b, t, h) and got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
        assert float((got - want).abs().max()) <= LSTM_F32_MAX_ERR
    else:
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=LSTM_BF16_ATOL, rtol=0)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,h,n_launch", [(300, 20, 512, 10),
                                            (300, 12, 1024, 10)])
def test_lstm_kernel_splits_the_batch(card, b, t, h, n_launch, dtype,
                                      reverse):
    """A batch beyond one launch's limit (32 rows: two 16-row mma tiles)
    is split across launches, exactly."""
    xw, w_hh = _lstm_inputs(b, t, h, dtype, b + h, card)
    before = lstm_cuda.lstm_fused.launches
    got = lstm_cuda.lstm_fused(xw, w_hh, h, reverse=reverse)
    torch.cuda.synchronize()
    assert lstm_cuda.lstm_fused.launches == before + n_launch
    want = lstm_cuda.lstm_plain(xw, w_hh, h, reverse=reverse)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
        assert float((got - want).abs().max()) <= LSTM_F32_MAX_ERR
    else:
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=LSTM_BF16_ATOL, rtol=0)


def _carry(b, h, dtype, seed, dev):
    """A stream's carried (h0 in dtype, c0 float32), h0 in (-1, 1)."""
    rng = np.random.default_rng(seed)
    h0 = np.tanh(rng.standard_normal((b, h))).astype(np.float32)
    c0 = rng.standard_normal((b, h)).astype(np.float32)
    return (torch.as_tensor(h0, device=dev).to(dtype),
            torch.as_tensor(c0, device=dev))


def _lstm_close(got, want, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
        assert float((got - want).abs().max()) <= LSTM_F32_MAX_ERR
    else:
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=LSTM_BF16_ATOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,h,n_launch", [(1, 8, 1024, 1),
                                            (5, 37, 128, 1),
                                            (40, 9, 512, 2)])
def test_lstm_kernel_carried_state_matches_plain(card, b, t, h, n_launch,
                                                 dtype):
    """A carried (h0, c0) in and the final (h, c) out (streaming's chunk
    shape (1, 8, 4096) at hidden 1024 first): kernel against the plain
    version, the batch split across launches with each part's rows of h0
    and c0."""
    xw, w_hh = _lstm_inputs(b, t, h, dtype, b + h + 1, card)
    state = _carry(b, h, dtype, b + h + 2, card)
    before = lstm_cuda.lstm_fused.launches
    got, (h_t, c_t) = lstm_cuda.lstm_fused(xw, w_hh, h, state=state,
                                           return_state=True)
    torch.cuda.synchronize()
    assert lstm_cuda.lstm_fused.launches == before + n_launch
    want, (wh, wc) = lstm_cuda.lstm_plain(xw, w_hh, h, state=state,
                                          return_state=True)
    assert c_t.dtype == torch.float32 and h_t.dtype == dtype
    _lstm_close(got, want, dtype)
    _lstm_close(h_t, wh, dtype)
    torch.testing.assert_close(c_t, wc, atol=LSTM_BF16_ATOL
                               if dtype == torch.bfloat16 else ATOL,
                               rtol=0 if dtype == torch.bfloat16 else RTOL)
    # the state changes the result (step 0 ran its product)
    assert float((got.float() - lstm_cuda.lstm_fused(
        xw, w_hh, h).float()).abs().max()) > 1e-2


@pytest.mark.parametrize("h", [512, 1024])
def test_lstm_kernel_chained_chunks_equal_one_launch(card, h):
    """Launches chained over 8-frame chunks through the returned state
    equal one launch over the whole sequence (float32 carry; expected bit
    for bit, held to the tight float32 bound)."""
    xw, w_hh = _lstm_inputs(1, 40, h, torch.float32, h + 5, card)
    whole, (h_w, c_w) = lstm_cuda.lstm_fused(xw, w_hh, h, return_state=True)
    state, parts = None, []
    for lo in range(0, 40, 8):
        hs, state = lstm_cuda.lstm_fused(xw[:, lo:lo + 8].contiguous(), w_hh,
                                         h, state=state, return_state=True)
        parts.append(hs)
    got = torch.cat(parts, dim=1)
    assert float((got - whole).abs().max()) <= LSTM_F32_MAX_ERR
    assert float((state[1] - c_w).abs().max()) <= LSTM_F32_MAX_ERR
    with pytest.raises(ValueError, match="reverse"):
        lstm_cuda.lstm_fused(xw, w_hh, h, reverse=True, state=state)


@pytest.mark.parametrize("h", [512, 1024])
def test_lstm_f32_bound_catches_single_tf32(card, h):
    """The control for the tight float32 bound: the plain version with its
    product in single TF32 (torch's TF32 matmul) misses it."""
    xw, w_hh = _lstm_inputs(32, 150, h, torch.float32, 32 + h, card)
    want = lstm_cuda.lstm_plain(xw, w_hh, h)
    torch.backends.cuda.matmul.allow_tf32 = True
    ctrl = lstm_cuda.lstm_plain(xw, w_hh, h)
    torch.backends.cuda.matmul.allow_tf32 = False
    assert float((ctrl - want).abs().max()) > LSTM_F32_MAX_ERR


def test_lstm_kernel_refuses_a_grid_that_cannot_all_be_resident(
        card, monkeypatch):
    """A plan with more clusters than the card holds at once raises and
    names the shape; it never falls back to the plain version. 128 blocks
    at hidden 1024 in float32 (8 units, one block per SM) are 16 clusters
    of 8, one more than the H100 holds."""
    monkeypatch.setattr(lstm_cuda, "MAX_BLOCKS", 128)
    assert lstm_cuda.lstm_plan(1024, 4).blocks == 128
    xw, w_hh = _lstm_inputs(4, 3, 1024, torch.float32, 0, card)
    launches, routes = (lstm_cuda.lstm_fused.launches,
                        lstm_cuda.lstm_fused.plain_routes)
    with pytest.raises(ValueError, match=r"\(4, 3, 4096\).*resident"):
        lstm_cuda.lstm_fused(xw, w_hh, 1024)
    assert lstm_cuda.lstm_fused.launches == launches
    assert lstm_cuda.lstm_fused.plain_routes == routes


def test_lstm_phase_split(card):
    """The optional clock64() phase record: positive cycles per step in
    each phase, and the launch's result unchanged."""
    xw, w_hh = _lstm_inputs(32, 20, 512, torch.float32, 3, card)
    split = lstm_cuda.phase_split(xw, w_hh, 512)
    assert set(split) == {"wait", "stage", "product", "gates"}
    assert all(v > 0 for v in split.values())


def test_lstm_kernel_refuses_what_it_does_not_take(card):
    """Wrong layouts and types raise; batch 129 at hidden 1024 is split
    into five launches; a hidden size whose W_hh slice does not fit in
    shared memory takes the plain route, counted, with no launch."""
    xw, w_hh = _lstm_inputs(4, 6, 64, torch.float32, 0, card)
    with pytest.raises(ValueError, match="contiguous"):
        lstm_cuda.lstm_fused(xw.transpose(0, 1), w_hh, 64)
    with pytest.raises(TypeError):
        lstm_cuda.lstm_fused(xw.half(), w_hh.half(), 64)
    with pytest.raises(ValueError, match="4h"):
        lstm_cuda.lstm_fused(xw, w_hh, 32)
    big, w_big = _lstm_inputs(129, 2, 1024, torch.float32, 0, card)
    before = lstm_cuda.lstm_fused.launches
    got = lstm_cuda.lstm_fused(big, w_big, 1024)
    assert lstm_cuda.lstm_fused.launches == before + 5
    torch.testing.assert_close(got, lstm_cuda.lstm_plain(big, w_big, 1024),
                               atol=ATOL, rtol=RTOL)
    wide, w_wide = _lstm_inputs(2, 3, 1536, torch.float32, 0, card)
    launches, routes = (lstm_cuda.lstm_fused.launches,
                        lstm_cuda.lstm_fused.plain_routes)
    got = lstm_cuda.lstm_fused(wide, w_wide, 1536)
    assert lstm_cuda.lstm_fused.launches == launches
    assert lstm_cuda.lstm_fused.plain_routes == routes + 1
    torch.testing.assert_close(got, lstm_cuda.lstm_plain(wide, w_wide, 1536),
                               atol=0, rtol=0)


# the training path's K3 shapes: one launch over the row-stacked mix and
# two sources of a batch of 32 (96 rows), at every window bucket of the
# recipe (2.0-4.0 s by 0.5) and the two of --align-window-frames 128
@pytest.mark.parametrize("n", [32000, 40000, 48000, 56000, 64000, 33024,
                               65792])
def test_stft_mag_kernel_at_the_training_buckets(card, n):
    x = _signal((96, n), n, card)
    before = stft_mag_cuda.stft_mag.launches
    got = stft_mag_cuda.stft_mag(x)
    torch.cuda.synchronize()
    assert stft_mag_cuda.stft_mag.launches == before + 1
    want = stft_mag_cuda.stft_mag_plain(x)
    assert got.shape == want.shape == (96, (n - 512) // 256 + 1, 257)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


def test_relative_position_gradient_is_deterministic(card):
    """The Conformer's relative-position gather differentiates into pe_k
    by index_put_(accumulate=True); on the card two backward passes at the
    longest training window give bit-equal gradients."""
    from css_tpu_torch.models.conformer import ConformerEncoder

    enc = ConformerEncoder(num_blocks=1).to(card)
    torch.nn.init.normal_(enc.pe_k)
    g = torch.Generator(card).manual_seed(0)
    upstream = torch.randn((249, 249, 64), generator=g, device=card)
    grads = []
    for _ in range(2):
        enc.pe_k.grad = None
        (enc.rel_pos(249) * upstream).sum().backward()
        grads.append(enc.pe_k.grad.clone())
    assert torch.equal(grads[0], grads[1])
    assert grads[0].abs().sum() > 0


def _parallel_spec(tmp_path, world, strategy="dp"):
    """A small Conformer's DP steps through css_tpu_torch.parallel.runner,
    its ranks sharing the card over gloo."""
    from css_tpu_torch.models import build_model, init_variables
    from css_tpu_torch.parallel import runner
    from css_tpu_torch.trainer.checkpoint import save_checkpoint_dict

    # one speaker: permutation-invariant training over two near-equal
    # random-init outputs can pick the other order for an example on a
    # rounding difference, which moves its gradient by a finite step
    conf = {"conformer_attention_dim": 64, "conformer_attention_heads": 4,
            "conformer_linear_units": 128, "conformer_num_blocks": 2,
            "conformer_kernel_size": 7, "conformer_dropout_rate": 0.0,
            "num_spk": 1}
    params, stats = init_variables(build_model("Conformer", conf), 3)
    save_checkpoint_dict(str(tmp_path / "init.mdl"),
                         {"params": params, "batch_stats": stats})
    rng = np.random.default_rng(4)
    runner.save_batches(tmp_path / "b.npz", [
        {k: (rng.standard_normal((8, 32000)) * 0.1).astype(np.float32)
         for k in ("mix", "source1")} for _ in range(2)])
    return {"strategy": strategy, "world": world, "device": "cuda",
            "model": {"name": "Conformer", "conf": conf},
            "objective": {"name": "MSE"},
            "trainer": {"optim": "sgd", "lr": 1e-3, "grad_thresh": 5.0},
            "init": str(tmp_path / "init.mdl"),
            "batches": str(tmp_path / "b.npz"), "steps": 2,
            "timeout_s": 120.0}


def test_gloo_collectives_on_cuda_tensors(card, tmp_path):
    """Two ranks on the one card: gloo takes CUDA tensors for all_reduce
    and broadcast, the port's only collectives (and its gather)."""
    from css_tpu_torch.parallel import runner

    res = runner.run({"strategy": "collectives", "world": 2,
                      "device": "cuda", "timeout_s": 60.0}, tmp_path)
    for r in res:
        assert r["backend"] == "gloo" and r["device"].startswith("cuda")
        assert r["all_reduce"] == [3.0] * 4
        assert r["broadcast"] == [1.0] * 3
        assert r["gather"] == [[0.0, 1.0], [0.0, 1.0]]


def test_dp_step_at_world_2_on_the_card(card, tmp_path):
    """Two DP ranks (4 of the 8 rows each) against one process
    on all the rows: loss 1e-5 relative, gradients rel-L2 1e-5, K3 once a
    step on each rank with no plain route, ranks bit-equal."""
    from css_tpu_torch.parallel import runner

    spec = _parallel_spec(tmp_path, 2)
    single = runner.run(dict(spec, strategy="single", world=1),
                        tmp_path / "single")[0]
    res = runner.run(spec, tmp_path / "dp")
    g1 = {k: v for k, v in single["arrays"].items() if k.startswith("grad/")}
    for r in res:
        assert r["backend"] == "gloo" and r["in_sync"]
        assert r["launches"]["stft_mag"] == 2
        assert not any(r["plain_routes"].values())
        np.testing.assert_allclose(r["losses"], single["losses"], rtol=1e-5)
        num = sum(float(np.sum((r["arrays"][k] - v) ** 2))
                  for k, v in g1.items())
        den = sum(float(np.sum(v ** 2)) for v in g1.values())
        assert np.sqrt(num / den) <= 1e-5


@pytest.mark.parametrize("case", ["fwd", "rev", "state", "bf16"])
def test_lstm_op_cuda_kernel_passes_opcheck(card, case):
    """torch.library.opcheck on K2's registered op with its CUDA kernel:
    schema, fake kernel, no aliasing, dispatch; every call launches."""
    dtype = torch.bfloat16 if case == "bf16" else torch.float32
    xw, w_hh = _lstm_inputs(3, 5, 64, dtype, 11, card)
    h0 = c0 = None
    if case == "state":
        h0, c0 = _carry(3, 64, dtype, 12, card)
    before, routes = (lstm_cuda.lstm_fused.launches,
                      lstm_cuda.lstm_fused.plain_routes)
    torch.library.opcheck(lstm_cuda.lstm_op,
                          (xw, w_hh, 64, case == "rev", h0, c0))
    assert lstm_cuda.lstm_fused.launches > before
    assert lstm_cuda.lstm_fused.plain_routes == routes


def test_exported_blstm_launches_k2_on_the_card(card, tmp_path):
    """A small BLSTM exported with torch.export and served from the
    artifact on the card: one K2 launch per (layer, direction), the live
    forward's masks (the same kernels on the same inputs)."""
    from css_tpu_torch.cli import export
    from css_tpu_torch.models import blstm

    conf = {"blstm_hdim": 128, "blstm_num_layers": 2}
    model = blstm.BLSTM.build_model(conf)
    model.load_state_dict(blstm.params_from_jax(blstm.init_params(7, conf)))
    program = export.export_forward(model, 4, 150, 257, card)
    torch.export.save(program, tmp_path / "b.pt2")
    served = export.load_exported(tmp_path / "b.pt2")
    f = _signal((4, 150, 257), 8, card).abs()
    before = lstm_cuda.lstm_fused.launches
    with torch.no_grad():
        got = served(f)
        torch.cuda.synchronize()
        assert lstm_cuda.lstm_fused.launches == before + 4
        want = torch.clamp(model(f)[1], max=1.0)
    assert lstm_cuda.lstm_fused.launches == before + 8
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def test_hop_stream_launches_k2_three_times_a_chunk(card):
    """The causal BLSTM's carried-state stream, 3 layers: each 8-frame
    chunk launches K2 once a layer through the op, and the chained chunks
    give the offline causal forward's masks (tests/test_hop_streaming.py's
    bounds)."""
    from css_tpu_torch.models import blstm

    conf = {"blstm_hdim": 128, "blstm_num_layers": 3, "blstm_causal": True}
    model = blstm.BLSTM.build_model(conf)
    model.load_state_dict(blstm.params_from_jax(blstm.init_params(9, conf)))
    model = model.to(card).eval()
    f = _signal((1, 40, 257), 10, card).abs()
    carry = model.stream_init(1)
    chunks = []
    for lo in range(0, 40, 8):
        before = lstm_cuda.lstm_fused.launches
        masks, carry = model.stream(f[:, lo:lo + 8], carry)
        assert lstm_cuda.lstm_fused.launches == before + 3
        chunks.append(masks)
    with torch.no_grad():
        want = model(f)[1]
    torch.testing.assert_close(torch.cat(chunks, dim=1), want, atol=2e-5,
                               rtol=2e-4)
