"""The plain reference against the program in float32 on the CPU, at
small widths, on the same seed's weights: the masks, the separated
streams and a training step agree to float32 rounding. (The reference
imports nothing of the program; this test holds the two side by side.)"""

import numpy as np
import pytest
import torch

from bench_gpu.drivers import separation, training
from bench_gpu.harness import manifest
from bench_gpu.harness.setup import program_model, reference, weights_for
from bench_gpu.reference import dsp

SMALL = {
    "conformer_css16x256": {
        "widths": {"num_blocks": 2, "attention_dim": 64, "linear_units": 96},
        "program_conf": {"conformer_num_blocks": 2,
                         "conformer_attention_dim": 64,
                         "conformer_linear_units": 96, "bf16": False}},
    "blstm_css1024x3": {
        "widths": {"num_layers": 2, "hidden_dim": 96},
        "program_conf": {"blstm_num_layers": 2, "blstm_hdim": 96}},
}


def _cell(config: str, traffic: str, root=manifest.ROOT):
    from bench_gpu.run import _merge

    cell = manifest.load_cell(f"{config}.{traffic}", root=root)
    cell.config = _merge(cell.config, SMALL[config])
    return cell


@pytest.mark.parametrize("config", sorted(SMALL))
def test_masks_and_streams(config):
    cell = _cell(config, "sep_libricss10min")
    dev = torch.device("cpu")
    traffic = dict(cell.traffic, pool=1,
                   session=dict(cell.traffic["session"], seconds=6))
    wav = separation.make_pool(traffic, 3, dev)[0]
    from css_tpu_torch.executor.pipeline import CssPipeline

    pipe = CssPipeline(program_model(cell.config, 3, dev),
                       cell.config["pipeline"], device=dev)
    feats = dsp.mvn(torch.clamp(dsp.stft_mag(torch.as_tensor(
        wav[:38656])[None]), min=dsp.EPSILON))
    with torch.no_grad():
        _, prog = pipe.model(feats)
        ref = reference(cell.config).masks(weights_for(cell.config, 3, dev),
                                           feats, cell.config["widths"])
    assert torch.allclose(prog, ref, atol=2e-5, rtol=1e-4)
    streams = pipe.process(wav)
    refs = separation.reference_streams(cell.config, weights_for(
        cell.config, 3, dev), wav, dev)
    for y, r in zip(streams, refs):
        np.testing.assert_allclose(y, r.numpy(), atol=2e-5)


@pytest.mark.parametrize("config", sorted(SMALL))
def test_training_steps(config, tiny, train_root):
    from bench_gpu.harness.trace import Tracer
    from bench_gpu.run import _merge

    cell = _cell(config, "train_recipe_speed", train_root)
    cell.traffic = _merge(cell.traffic, tiny["training"]["traffic"])
    dev = torch.device("cpu")
    off = Tracer(False, dev)
    loader, trainer, _ = training.build(cell, 5, dev, off)
    try:
        prog = training.checked_steps(trainer, training.Feed(loader, off), 3,
                                      4)
    finally:
        loader.close()
    ref = training.reference_run(cell.config, cell.traffic, 5,
                                 prog["batches"], dev)
    nums = training.compare(prog, ref)
    assert nums["loss_gap"] < 1e-5
    assert nums["grad_gap"] < 1e-3
    # three steps at the recipe's warm-up rates (1e-9 to 1e-8) move each
    # parameter by a few float32 ulps, so the change's norm carries the
    # rounding of those last bits
    assert nums["change_gap"] < 1e-2
