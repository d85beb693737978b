"""A cell, a configuration, a traffic mix, a per-layer metric, a driver, a
reference and a kernel's cost file are added by adding files and entries:
the harness finds each by its name, in the cell's own root, and no file
that was there is edited."""

import hashlib
import json
import shutil
import sys

import pytest

from bench_gpu import run
from bench_gpu.harness import manifest
from bench_gpu.harness.setup import Launches
from bench_gpu.tests.conftest import TINY

CELL = "conformer_css16x256.sep_libricss10min"


def _copy(root):
    """A checkout root holding a copy of the benchmark; the digest of
    each of its files."""
    shutil.copytree(manifest.BENCH_DIR, root / "bench_gpu",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return _digests(root / "bench_gpu")


def _digests(b):
    return {p.relative_to(b): hashlib.sha1(p.read_bytes()).hexdigest()
            for p in sorted(b.rglob("*")) if p.is_file()}


def _unedited(b, before):
    after = _digests(b)
    assert {k: after[k] for k in before} == before


def _loaded(path):
    return any(getattr(m, "__file__", None) == str(path.resolve())
               for m in list(sys.modules.values()))


def test_new_files_are_picked_up(tmp_path):
    root = tmp_path
    before = _copy(root)
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
    _unedited(b, before)


def test_a_driver_and_a_reference_added_as_files(tmp_path):
    """A driver kind of its own (here a copy of the separation driver with
    its own tiny sizes; a new kind of traffic would bring one), the
    reference its configuration names, a traffic file naming the driver
    and a cell: run from the cell's root."""
    root = tmp_path
    before = _copy(root)
    b = root / "bench_gpu"
    src = (b / "drivers" / "separation.py").read_text()
    tiny = '"traffic": {"session": {"seconds": 5}, "pool": 2,'
    assert tiny in src
    (b / "drivers" / "separation_copy.py").write_text(src.replace(
        tiny, '"traffic": {"session": {"seconds": 4}, "pool": 2,'))
    shutil.copy(b / "reference" / "conformer.py",
                b / "reference" / "conformer_copy.py")
    cfg = json.loads((b / "configs" / "conformer_css16x256.json")
                     .read_text())
    cfg["reference"] = "conformer_copy"
    (b / "configs" / "conformer_copy.json").write_text(json.dumps(cfg))
    shutil.copy(b / "costs" / "conformer_css16x256.py",
                b / "costs" / "conformer_copy.py")
    mix = json.loads((b / "traffic" / "sep_libricss10min.json").read_text())
    mix["driver"] = "separation_copy"
    (b / "traffic" / "sep_copy.json").write_text(json.dumps(mix))
    bench = manifest.load_benchmark()
    bench["configs"].append({"name": "conformer_copy",
                             "source": cfg["source"],
                             "file": "bench_gpu/configs/conformer_copy.json",
                             "reduced": cfg["reduced"], "why": "a test"})
    cell = "conformer_copy.sep_copy"
    bench["workloads"].append({"name": cell, "config": "conformer_copy",
                               "traffic": "sep_copy", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    drv = manifest.driver_module("separation_copy", root)
    assert drv.TINY["traffic"]["session"]["seconds"] == 4
    rc, line, err = run.run_cell(cell, 2 ** 31 + 77, 1.0, False,
                                 device="cpu", overrides=drv.TINY,
                                 root=root)
    assert rc == 0, err
    out = json.loads(line)
    assert out["correct"] is True, err
    assert list(out)[-1] == "checks" and out["checks"]["frame_p50"]
    assert set(out["metrics"]) == {"sep_rate", "setup_s"}
    # the new driver and reference ran, from the cell's root
    assert _loaded(b / "drivers" / "separation_copy.py")
    assert _loaded(b / "reference" / "conformer_copy.py")
    _unedited(b, before)


def test_an_array_cell_added_as_files(tmp_path):
    """A configuration whose pipeline reads an array: a traffic file with
    its microphones, a configuration naming a pipeline reference of its
    own and that reference; run through the separation driver as it is."""
    root = tmp_path
    before = _copy(root)
    b = root / "bench_gpu"
    (b / "reference" / "separation_ch0.py").write_text(
        "from bench_gpu.reference import separation\n\n"
        "SEEN = []\n\n\n"
        "def separate(wav, mask_fn, pipe, k):\n"
        "    SEEN.append(tuple(wav.shape))\n"
        "    return separation.separate(wav[0], mask_fn, pipe, k)\n")
    cfg = json.loads((b / "configs" / "conformer_css16x256.json")
                     .read_text())
    cfg["pipeline_reference"] = "separation_ch0"
    (b / "configs" / "conformer_array.json").write_text(json.dumps(cfg))
    shutil.copy(b / "costs" / "conformer_css16x256.py",
                b / "costs" / "conformer_array.py")
    mix = json.loads((b / "traffic" / "sep_libricss10min.json").read_text())
    mix["session"]["mics"] = [[0.0, 0.0], [0.0425, 0.0], [-0.0425, 0.0]]
    mix["session"]["azimuths"] = [30.0, 200.0]
    (b / "traffic" / "sep_array.json").write_text(json.dumps(mix))
    bench = manifest.load_benchmark()
    bench["configs"].append({"name": "conformer_array",
                             "source": cfg["source"],
                             "file": "bench_gpu/configs/conformer_array.json",
                             "reduced": cfg["reduced"], "why": "a test"})
    cell = "conformer_array.sep_array"
    bench["workloads"].append({"name": cell, "config": "conformer_array",
                               "traffic": "sep_array", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    rc, line, err = run.run_cell(cell, 2 ** 31 + 91, 1.0, True,
                                 device="cpu", overrides=TINY["separation"],
                                 root=root)
    assert rc == 0, err
    out = json.loads(line)
    assert out["correct"] is True, err
    ref = manifest.load("reference", "separation_ch0", root)
    n = 16000 * TINY["separation"]["traffic"]["session"]["seconds"]
    assert ref.SEEN and set(ref.SEEN) == {(3, n)}
    _unedited(b, before)


def test_a_new_kernel_gets_its_roofline_from_its_cost_file(tmp_path,
                                                           monkeypatch):
    """A kernel added to the program's separation path brings a cost file
    with ``PROGRAM`` and ``shape``: its launches are counted, shaped and
    held to its bound with no edit to the driver."""
    import types

    from bench_gpu.harness.trace import Tracer

    wrapper = types.SimpleNamespace(launches=0)
    fake = types.ModuleType("css_tpu_torch.ops.kz_fake")
    fake.kz = wrapper
    monkeypatch.setitem(sys.modules, "css_tpu_torch.ops.kz_fake", fake)
    root = tmp_path
    before = _copy(root)
    b = root / "bench_gpu"
    (b / "costs" / "kz.py").write_text(
        "NAME = 'kz_kernel'\nPROGRAM = ('kz_fake', 'kz')\n\n\n"
        "def shape(config, geo):\n"
        "    return {'rows': geo['batch'], 'n': geo['win']}\n\n\n"
        "def bound_seconds(rows, n):\n    return 1e-9 * rows * n\n")
    (b / "metrics" / "kz_roofline.sep.py").write_text(
        "from bench_gpu.harness.readers import kernel_roofline\n\n\n"
        "def read(rec):\n    return kernel_roofline(rec, 'kz')\n")
    bench = manifest.load_benchmark()
    bench["per_layer"].append({"name": "kz_roofline.sep", "unit": "%",
                               "better": "higher", "source": "device_trace",
                               "layer": "kernels", "moves": "sep_rate",
                               "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    shapes = []

    def launch_per_session(pipe):
        process, sep = pipe.process, pipe.separator

        def counted(wav):
            wrapper.launches += 1
            shapes.append((sep.batch_size, sep.win))
            return process(wav)
        pipe.process = counted

    kernel, window, at = Tracer.kernel, Tracer.window, []

    def opened(self):
        at.append(len(shapes))
        return window(self)

    def seen(self, symbol):  # a CPU run traces no device: 2 x the bound
        if symbol != "kz_kernel":
            return kernel(self, symbol)
        inside = shapes[at[-1]:]
        return sum(2e-9 * r * n for r, n in inside), len(inside)

    monkeypatch.setattr(Tracer, "kernel", seen)
    monkeypatch.setattr(Tracer, "window", opened)
    over = {**TINY["separation"], "hooks": {"pipeline": launch_per_session}}
    rc, line, err = run.run_cell(CELL, 2 ** 31 + 3, 1.0, True,
                                 device="cpu", overrides=over, root=root)
    assert rc == 0, err
    out = json.loads(line)
    assert out["correct"] is True, err
    assert out["metrics"]["kz_roofline.sep"]["value"] == pytest.approx(50.0)
    _unedited(b, before)


def test_a_reader_that_loads_jax_gives_no_line(tmp_path, monkeypatch):
    """A per-layer reader the cell brings imports ``jax`` (a stub here):
    the run exits 4 with no result line, since the check of the loaded
    modules comes after the readers."""
    stub = tmp_path / "stub"
    (stub / "jax").mkdir(parents=True)
    (stub / "jax" / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(stub))
    root = tmp_path / "root"
    root.mkdir()
    before = _copy(root)
    b = root / "bench_gpu"
    (b / "metrics" / "jax_probe.sep.py").write_text(
        "import jax  # noqa: F401\n\n\n"
        "def read(rec):\n    return 1.0\n")
    bench = manifest.load_benchmark()
    bench["per_layer"].append({"name": "jax_probe.sep", "unit": "1",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "pipeline", "moves": "sep_rate",
                               "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    try:
        assert "jax" not in sys.modules
        rc, line, err = run.run_cell(CELL, 2 ** 31 + 4, 1.0, True,
                                     device="cpu",
                                     overrides=TINY["separation"],
                                     root=root)
    finally:
        sys.modules.pop("jax", None)
    assert rc == 4 and line is None
    assert err == ["loaded after the window: jax"]
    _unedited(b, before)


@pytest.mark.parametrize("program", [("istft_cuda", "no_such_wrapper"),
                                     ("no_such_module", "kernel")])
def test_a_kernel_the_program_lacks_reads_none(tmp_path, program):
    """A cost file whose PROGRAM names a wrapper the checkout's program
    lacks (as on a parent without the kernel): no count, no error, and
    its roofline left out of the line with the reason on standard
    error."""
    root = tmp_path
    before = _copy(root)
    b = root / "bench_gpu"
    (b / "costs" / "kz.py").write_text(
        f"NAME = 'kz_kernel'\nPROGRAM = {program!r}\n\n\n"
        "def bound_seconds(**shape):\n    return 1e-6\n")
    (b / "metrics" / "kz_roofline.sep.py").write_text(
        "from bench_gpu.harness.readers import kernel_roofline\n\n\n"
        "def read(rec):\n    return kernel_roofline(rec, 'kz')\n")
    bench = manifest.load_benchmark()
    bench["per_layer"].append({"name": "kz_roofline.sep", "unit": "%",
                               "better": "higher", "source": "device_trace",
                               "layer": "kernels", "moves": "sep_rate",
                               "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    wrapper = ".".join(program)
    launches = Launches(root)
    assert launches.missing == {"kz": wrapper}
    assert launches.since()["kz"] == 0
    assert {"k1", "k2", "k3", "kc"} <= set(launches.since())
    rc, line, err = run.run_cell(CELL, 5, 1.0, True, device="cpu",
                                 overrides=TINY["separation"], root=root)
    assert rc == 0, err
    out = json.loads(line)
    assert out["correct"] is True, err
    assert "kz_roofline.sep" not in out["metrics"]
    assert f"not reported: kz: the program has no {wrapper}" in err
    _unedited(b, before)


def test_a_kernel_module_that_fails_to_import_raises(tmp_path, monkeypatch):
    """A wrapper's module that is there but fails on an import of its own
    is a fault, not a missing kernel."""
    import css_tpu_torch.ops as ops

    extra = tmp_path / "ops_extra"
    extra.mkdir()
    (extra / "kz_broken.py").write_text("import no_such_dependency_x\n")
    monkeypatch.setattr(ops, "__path__", [*ops.__path__, str(extra)])
    root = tmp_path / "root"
    root.mkdir()
    _copy(root)
    (root / "bench_gpu" / "costs" / "kz.py").write_text(
        "NAME = 'kz_kernel'\nPROGRAM = ('kz_broken', 'kz')\n")
    with pytest.raises(ModuleNotFoundError, match="no_such_dependency_x"):
        Launches(root)
