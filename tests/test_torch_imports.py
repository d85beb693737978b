"""The port runs where the card is: with torch and numpy, and none of JAX,
Flax, Optax, ml_dtypes, PyYAML or the css_tpu package."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import yaml

REPO = Path(__file__).resolve().parent.parent
BLOCKED = ["jax", "jaxlib", "flax", "optax", "ml_dtypes", "yaml", "css_tpu"]
SOURCES = sorted((REPO / "css_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def test_every_module_imports_with_the_reference_stack_blocked():
    code = f"""
import importlib, pkgutil, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None
import css_tpu_torch
names = [m.name for m in pkgutil.walk_packages(css_tpu_torch.__path__,
                                               "css_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert not any(m in sys.modules and sys.modules[m] is not None
               for m in {BLOCKED!r})
print(len(names))
print(" ".join(names))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert res.returncode == 0, res.stderr
    count, names = res.stdout.strip().splitlines()
    assert int(count) >= 20
    # the 7ch slice's modules, the training slices', the streaming
    # slice's, the parallel slice's and the tools slice's are among them
    for name in ("executor.doa", "executor.reanchor", "ops.mvdr",
                 "data.spatial", "ops.pit", "objectives", "objectives.base",
                 "objectives.mse", "objectives.snr", "objectives.masksnr",
                 "trainer.lr_schedule", "trainer.loop", "trainer.checkpoint",
                 "models.conv_tasnet", "data.corpus", "data.augment",
                 "data.mixer", "data.loader", "utils.logging", "cli.train",
                 "cli.combine", "data.device_mixer", "data.sessions",
                 "ops.native", "trainer.probe", "utils.metrics",
                 "executor.streaming", "executor.hop_streaming",
                 "parallel", "parallel.mesh", "parallel.dp",
                 "parallel.launch", "parallel.runner", "executor.sharded",
                 "cli.train_parallel", "utils.config", "cli.export",
                 "cli.import_torch", "cli.evaluate", "cli.prepare",
                 "cli.wer", "cli.toy_asr"):
        assert "css_tpu_torch." + name in names.split()


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_import_of_the_reference_stack(path):
    text = path.read_text()
    assert not re.search(r"\b(import|from)\s+(jax|jaxlib|flax|optax|ml_dtypes)"
                         r"\b", text)
    assert not re.search(r"\b(import|from)\s+css_tpu(?!_torch)\b", text)
    # no PyYAML anywhere: configs go through utils/config.py
    assert not re.search(r"\b(import|from)\s+yaml\b", text)


def test_chip_smoke_config_is_infer_1ch_yaml():
    import chip_smoke

    with open(REPO / "configs" / "infer_1ch.yaml") as fh:
        assert chip_smoke.CONFIG == yaml.safe_load(fh)


def test_chip_smoke_config_7ch_is_infer_7ch_yaml():
    import chip_smoke

    with open(REPO / "configs" / "infer_7ch.yaml") as fh:
        assert chip_smoke.CONFIG_7CH == yaml.safe_load(fh)


def test_port_spatialisation_is_the_references():
    """chip_smoke.py's 7ch session uses the port's own copy of the array
    geometry; it must be css_tpu.data.spatial's."""
    import numpy as np

    from css_tpu.data import spatial as jsp
    from css_tpu_torch.data import spatial as tsp

    assert tsp.MIC_OFFSETS == jsp.MIC_OFFSETS
    az = np.array([0.0, 30.0, 123.4, 300.0])
    np.testing.assert_array_equal(tsp.mic_delays(az), jsp.mic_delays(az))
    srcs = np.random.default_rng(0).standard_normal((2, 20000)) * 0.1
    np.testing.assert_allclose(tsp.spatialize(srcs, [30.0, 150.0]),
                               jsp.spatial_session(srcs, [30.0, 150.0]),
                               atol=1e-6)
