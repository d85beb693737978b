"""What each side may import, checked in a fresh process by whole
top-level module names: ``css_tpu_torch`` is not ``css_tpu``."""

import json
import subprocess
import sys

from bench_gpu.harness import manifest

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
{imports}
print(json.dumps(sorted({{m.split('.', 1)[0] for m in sys.modules}})))
"""


def _top_level(imports: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(manifest.ROOT),
                                            imports=imports)],
        capture_output=True, text=True, check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_timed_side_imports_no_jax():
    mods = _top_level(
        "import bench_gpu.run, bench_gpu.calibrate\n"
        "import bench_gpu.drivers.separation, bench_gpu.drivers.training\n"
        "import css_tpu_torch.executor.pipeline, css_tpu_torch.trainer.loop\n"
        "import css_tpu_torch.data.loader, css_tpu_torch.data.mixer\n"
        "import css_tpu_torch.data.corpus, css_tpu_torch.objectives\n"
        "import css_tpu_torch.models")
    assert "css_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "css_tpu"}


def test_reference_imports_nothing_of_the_program():
    mods = _top_level(
        "import bench_gpu.reference.conformer, bench_gpu.reference.blstm\n"
        "import bench_gpu.reference.separation\n"
        "import bench_gpu.reference.training")
    assert not mods & {"jax", "jaxlib", "flax", "css_tpu", "css_tpu_torch"}


def test_forbidden_modules_compares_whole_names():
    from bench_gpu.harness.result import forbidden_modules

    sys.modules["css_tpu_torch_probe_x"] = object()
    try:
        assert "css_tpu_torch_probe_x" not in forbidden_modules()
    finally:
        del sys.modules["css_tpu_torch_probe_x"]
