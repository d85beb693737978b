"""The benchmark's CPU tests: the checkout's root on the import path, and
the tiny sizes, each driver's own, that run a cell end to end on the plain
route (the CUDA kernels' plain versions) in seconds."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_gpu.harness import manifest  # noqa: E402

# driver kind -> the overrides that cut its cells so that a CPU runs them in
# seconds: each driver's own ``TINY``
TINY = {name: manifest.driver_module(name).TINY
        for name in manifest.names("drivers")}


# the training cells as a later benchmark PR would add them: built and
# checked (bench_gpu/drivers/training.py), left out of BENCHMARK.json for
# the spread of their runs on the card (PERF.md §7)
TRAINING_ENTRIES = {
    "workloads": [
        {
            "name": "conformer_css16x256.train_recipe_speed",
            "config": "conformer_css16x256",
            "traffic": "train_recipe_speed",
            "chips": 1,
            "why": "the recipe's default step on one card: batch 64 at 2.064 / 4.112 s, host mixing with RIRs, G = 4 steps a replay; the train step and data layer work, stitcher and K1 bypassed"
        },
        {
            "name": "blstm_css1024x3.train_recipe_speed",
            "config": "blstm_css1024x3",
            "traffic": "train_recipe_speed",
            "chips": 1,
            "why": "the same recipe with the BLSTM in float32: autograd's per-frame LSTM loop, never K2, so a K2 change shows nothing here"
        }
    ],
    "end_to_end": [
        {
            "name": "train_rate",
            "unit": "audio-s/s",
            "better": "higher",
            "bound": 0.05,
            "source": "host_clock",
            "workloads": [
                "conformer_css16x256.train_recipe_speed",
                "blstm_css1024x3.train_recipe_speed"
            ]
        }
    ],
    "per_layer": [
        {
            "name": "loader_wait_ms.train",
            "unit": "ms",
            "better": "lower",
            "source": "program_span",
            "layer": "data",
            "moves": "train_rate",
            "workloads": [
                "conformer_css16x256.train_recipe_speed",
                "blstm_css1024x3.train_recipe_speed"
            ]
        },
        {
            "name": "k3_roofline.train",
            "unit": "%",
            "better": "higher",
            "source": "device_trace",
            "layer": "kernels",
            "moves": "train_rate",
            "workloads": [
                "conformer_css16x256.train_recipe_speed",
                "blstm_css1024x3.train_recipe_speed"
            ]
        },
        {
            "name": "mfu.train",
            "unit": "%",
            "better": "higher",
            "source": "host_clock",
            "layer": "train step",
            "moves": "train_rate",
            "workloads": [
                "conformer_css16x256.train_recipe_speed",
                "blstm_css1024x3.train_recipe_speed"
            ]
        },
        {
            "name": "idle_share.train",
            "unit": "%",
            "better": "lower",
            "source": "device_trace",
            "layer": "device",
            "moves": "train_rate",
            "workloads": [
                "conformer_css16x256.train_recipe_speed",
                "blstm_css1024x3.train_recipe_speed"
            ]
        }
    ]
}
TRAINING_CELLS = [w["name"] for w in TRAINING_ENTRIES["workloads"]]


def training_root(base: Path) -> Path:
    """A checkout root under ``base`` whose BENCHMARK.json holds the
    training cells too, its bench_gpu the real one (a link)."""
    import json

    bench = manifest.load_benchmark()
    for key, extra in TRAINING_ENTRIES.items():
        bench[key] = bench[key] + extra
    (base / "BENCHMARK.json").write_text(json.dumps(bench))
    (base / "bench_gpu").symlink_to(manifest.BENCH_DIR)
    return base


@pytest.fixture
def train_root(tmp_path):
    return training_root(tmp_path)


@pytest.fixture
def tiny():
    """driver kind -> the overrides of a tiny CPU run."""
    import copy

    return copy.deepcopy(TINY)
