"""The output check's control comes out not correct: the plain reference
in the precision below the configuration's (fp8 for the bf16 Conformer,
TF32 for the float32 BLSTM), put in the program's place and judged by
the cell's own comparison and limits, at the published widths and depth
on a size a CPU holds (one short session; a training batch of 4)."""

import pytest
import torch

from bench_gpu.drivers import separation, training
from bench_gpu.harness import manifest
from bench_gpu.harness.setup import weights_for
from bench_gpu.run import _merge

CONFIGS = ["conformer_css16x256", "blstm_css1024x3"]


@pytest.mark.parametrize("config", CONFIGS)
def test_separation_control_fails(config):
    cell = manifest.load_cell(f"{config}.sep_libricss10min")
    cfg = cell.config
    traffic = _merge(cell.traffic, {"pool": 1, "session": {"seconds": 8}})
    dev = torch.device("cpu")
    wav = separation.make_pool(traffic, 21, dev)[0]
    ctrl = separation.reference_streams(
        cfg, weights_for(cfg, 21, dev), wav, dev,
        cfg["limits"]["controls"]["separation"])
    nums = separation.judge(cfg, traffic, 21,
                            [(0, tuple(s.numpy() for s in ctrl))], [wav],
                            dev)[0]
    limits = cfg["limits"]["separation"]
    assert any(nums[k] > v for k, v in limits.items()), nums


@pytest.mark.parametrize("config", CONFIGS)
def test_training_control_fails(config, tiny, train_root):
    cell = manifest.load_cell(f"{config}.train_recipe_speed", root=train_root)
    traffic = _merge(cell.traffic, tiny["training"]["traffic"])
    cfg = cell.config
    dev = torch.device("cpu")
    gen = torch.Generator().manual_seed(22)
    n = int(1.0 * 16000)
    batches = [{k: torch.randn(4, n, generator=gen).numpy() * 0.1
                for k in ("mix", "source1", "source2")} for _ in range(3)]
    for b in batches:
        b["mix"] = b["source1"] + b["source2"] + 0.1 * b["mix"]
    ref = training.reference_run(cfg, traffic, 22, batches, dev)
    ctrl = training.reference_run(cfg, traffic, 22, batches, dev,
                                  cfg["limits"]["controls"]["training"])
    nums = training.compare(ctrl, ref)
    limits = cfg["limits"]["training"]
    assert any(nums[k] > v for k, v in limits.items()), nums
