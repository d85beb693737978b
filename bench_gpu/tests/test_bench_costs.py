"""Operation and byte counts against hand counts, and against the bound
column of the port's kernel table (PERF.md, PR 11-15) where the peak is
the same."""

import pytest

from bench_gpu.costs import (blstm_css1024x3, conformer_css16x256, k1, k2,
                             k3, kc, peaks)


def test_k3_small_shape():
    flops, nbytes = k3.work(rows=2, n=16, frame_len=8, hop=4)
    frames, bins = 3, 5
    assert nbytes == 4 * (2 * 16 + 8 + 2 * 7 + 2 * frames * bins)
    assert flops == 2 * frames * (2.5 * 8 * 3 + 8 + 3 * bins)


def test_k1_small_shape():
    flops, nbytes = k1.work(rows=2, frames=3, bins=5, hop=4)
    assert nbytes == 8 * 2 * 3 * 5 + 4 * (8 + 14 + 12) + 4 * 2 * 4 * 4
    assert flops == 2 * 3 * (2.5 * 8 * 3 + 16) + 2 * 4 * 4


def test_k2_small_shape():
    flops, nbytes = k2.work(batch=2, steps=3, hidden=4, elem=4)
    assert flops == 2 * 2 * 3 * 4 * 16
    assert nbytes == 4 * (2 * 3 * 16 + 4 * 16 + 2 * 3 * 4)


def test_kc_small_shape():
    flops, nbytes = kc.work(batch=2, frames=3, channels=4, taps=5, elem=2)
    assert flops == 2 * 2 * 3 * 4 * 5
    assert nbytes == 2 * 2 * 2 * 3 * 4 + 4 * (4 * (2 + 5 + 1 + 4) + 6)


def test_bounds_against_the_kernel_table():
    # bytes-bound at 3.35 TB/s, as the table: K3 0.0029 ms, K1 0.0202 ms
    assert k3.bound_seconds(rows=32, n=38656) * 1e3 == pytest.approx(
        0.0029, abs=1e-4)
    assert k1.bound_seconds(rows=146, frames=150) * 1e3 == pytest.approx(
        0.0202, abs=1e-4)
    # KC bytes-bound at the separator's batch: 0.00147 / 0.00293 ms in
    # bf16 / float32
    for elem, ms in ((2, 0.00147), (4, 0.00293)):
        shape = dict(batch=32, frames=150, channels=256, taps=33, elem=elem)
        assert kc.bound_seconds(**shape) * 1e3 == pytest.approx(ms,
                                                                 abs=2e-5)
        flops, nbytes = kc.work(**shape)
        assert kc.bound_seconds(**shape) == nbytes / peaks.HBM_BYTES
    # K2: the table held the products to 165 TFLOP/s (0.061 ms); here to
    # TF32's published 495, a third of that time
    flops, _ = k2.work(batch=32, steps=150, hidden=512)
    assert flops == pytest.approx(10.07e9, rel=1e-3)
    assert k2.bound_seconds(batch=32, steps=150, hidden=512) == \
        pytest.approx(flops / peaks.TF32_FLOPS)
    assert k2.bound_seconds(batch=32, steps=150, hidden=512) * 3e3 == \
        pytest.approx(0.061, abs=1e-3)


def test_model_flops_by_hand():
    w = dict(idim=3, num_bins=3, num_spk=2, num_noise=1, attention_dim=4,
             linear_units=8, num_blocks=1, kernel_size=3, attention_heads=2)
    b, t = 2, 5
    bt = b * t
    block = 4 * (2 * bt * 4 * 8) + 4 * (2 * bt * 4 * 4) \
        + 3 * (2 * b * t * t * 4) + 2 * bt * 4 * 3
    assert conformer_css16x256.forward_flops(w, b, t) == \
        2 * bt * 3 * 4 + block + 2 * bt * 4 * 9
    wb = dict(idim=3, num_bins=3, num_spk=2, num_noise=1, hidden_dim=4,
              num_layers=1)
    layer = 2 * (2 * bt * 4 * 8 + 2 * bt * 2 * 8)
    assert blstm_css1024x3.forward_flops(wb, b, t) == \
        2 * bt * 3 * 4 + layer + 2 * bt * 4 * 9


@pytest.mark.parametrize("config", ["conformer_css16x256",
                                    "blstm_css1024x3"])
def test_launch_shapes_at_the_cells_geometry(config):
    """Each kernel's ``shape`` at a 600 s session's separation geometry
    (748 windows in 24 batches of 32, 150 frames a window): the shapes the
    separation driver wrote out kernel by kernel before the cost files
    gave them; K2 and KC none for a model without an LSTM or a conv
    module."""
    import json

    from bench_gpu.harness import manifest

    cfg = json.loads((manifest.BENCH_DIR / "configs" / f"{config}.json")
                     .read_text())
    elem = {"bfloat16": 2, "float32": 4}[cfg["dtype"]]
    geo = {"batch": 32, "win": 38656, "hop": 12800, "frames": 150,
           "windows": 748, "batches": 24, "samples": 9600000,
           "channels": 1, "streams": 2, "elem": elem}
    assert k3.shape(cfg, geo) == {"rows": 32, "n": 38656}
    assert k1.shape(cfg, geo) == {"rows": 1496, "frames": 150}
    lstm = {"batch": 32, "steps": 150, "hidden": 512, "elem": 4}
    conv = {"batch": 32, "frames": 150, "channels": 256, "taps": 33,
            "elem": 2}
    blstm = config.startswith("blstm")
    assert k2.shape(cfg, geo) == (lstm if blstm else None)
    assert kc.shape(cfg, geo) == (None if blstm else conv)
    for mod in (k1, k2, k3, kc):
        shape = mod.shape(cfg, geo)
        if shape is not None:
            assert mod.bound_seconds(**shape) > 0
    # Souden MVDR synthesises through K1's centered entry: a window's
    # centered frames, (146, 152, 257) for a 60 s session
    cfg["pipeline"]["beamforming"]["type"] = "souden_mvdr"
    assert k1.shape(cfg, {**geo, "windows": 73}) == {"rows": 146,
                                                     "frames": 152}
