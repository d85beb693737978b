"""A cell, a configuration, a traffic mix and a per-layer metric are added
by adding files and entries: the harness finds each by its name."""

import json
import shutil

from bench_gpu import run
from bench_gpu.harness import manifest
from bench_gpu.tests.conftest import TINY


def test_new_files_are_picked_up(tmp_path):
    root = tmp_path
    shutil.copytree(manifest.BENCH_DIR, root / "bench_gpu",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = manifest.load_benchmark()
    b = root / "bench_gpu"
    # a configuration: its file and its model operations
    cfg = json.loads((b / "configs" / "conformer_css16x256.json").read_text())
    (b / "configs" / "conformer_css4x256.json").write_text(json.dumps(cfg))
    shutil.copy(b / "costs" / "conformer_css16x256.py",
                b / "costs" / "conformer_css4x256.py")
    # a traffic mix: parameters read by an existing driver
    mix = json.loads((b / "traffic" / "sep_libricss10min.json").read_text())
    mix["session"]["seconds"] = 7
    (b / "traffic" / "sep_short7s.json").write_text(json.dumps(mix))
    # a per-layer metric: a reader of its own
    (b / "metrics" / "sessions_seen.sep.py").write_text(
        "def read(rec):\n    return rec.counts.get('sessions')\n")
    bench["configs"].append({"name": "conformer_css4x256",
                             "source": cfg["source"],
                             "file": "bench_gpu/configs/conformer_css4x256.json",
                             "reduced": cfg["reduced"], "why": "a test"})
    cell = "conformer_css4x256.sep_short7s"
    bench["workloads"].append({"name": cell, "config": "conformer_css4x256",
                               "traffic": "sep_short7s", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "sessions_seen.sep", "unit": "1",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "pipeline", "moves": "sep_rate",
                               "workloads": [cell]})
    sep = next(m for m in bench["end_to_end"] if m["name"] == "sep_rate")
    sep["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    over = TINY["separation"]
    over = {**over, "traffic": {**over["traffic"], "session": {}}}
    rc, line, err = run.run_cell(cell, 7, 1.0, True, device="cpu",
                                 overrides=over, root=root)
    assert rc == 0, err
    out = json.loads(line)
    assert out["correct"] is True
    assert out["metrics"]["sessions_seen.sep"]["value"] == out["attempted"]
    loaded = manifest.load_cell(cell, root=root)
    assert loaded.traffic["session"]["seconds"] == 7
    assert loaded.config_name == "conformer_css4x256"
