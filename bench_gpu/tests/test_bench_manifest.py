"""BENCHMARK.json as the contract has it: keys, names, units, files."""

import json
import re

import pytest

from bench_gpu.harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = manifest.load_benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
])
def test_entries(section, keys):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert set(e) == keys, e["name"]
        assert NAME.match(e["name"]), e["name"]
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    if section == "configs":
        for e in BENCH[section]:
            assert len(e["reduced"]) <= 16
            assert all(NAME.match(k) for k in e["reduced"])
            assert any(e["file"].startswith(p + "/") for p in BENCH["paths"])
            with open(manifest.ROOT / e["file"]) as fh:
                cfg = json.load(fh)
            assert cfg["source"] == e["source"]
            assert cfg["reduced"] == e["reduced"]
            assert not [k for k in e["reduced"]
                        if k.endswith(("_dim", "_rank", "_units", "heads"))]
    else:
        configs = {c["name"] for c in BENCH["configs"]}
        pairs = [(e["config"], e["traffic"]) for e in BENCH[section]]
        assert len(pairs) == len(set(pairs))
        for e in BENCH[section]:
            assert e["config"] in configs and e["chips"] in (1, 4)
            assert NAME.match(e["traffic"])
            assert e["name"] == f"{e['config']}.{e['traffic']}"
            assert (manifest.BENCH_DIR / "traffic"
                    / f"{e['traffic']}.json").is_file()
        used = {e["config"] for e in BENCH[section]}
        assert used == configs


def test_metrics():
    e2e, layer = BENCH["end_to_end"], BENCH["per_layer"]
    names = [m["name"] for m in e2e + layer]
    assert len(names) == len(set(names))
    assert "setup_s" in names
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in layer:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in {x["name"] for x in e2e}
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        assert (manifest.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in e2e + layer:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    # every cell reports setup_s, another end-to-end metric and a per-layer
    for cell in cells:
        c = manifest.load_cell(cell)
        assert "setup_s" in {m["name"] for m in c.end_to_end}
        assert len(c.end_to_end) >= 2 and c.per_layer
        for m in c.per_layer:  # the metric's end-to-end one is the cell's
            assert m["moves"] in {x["name"] for x in c.end_to_end}


def test_configs_have_costs_and_references():
    for c in BENCH["configs"]:
        cell = next(w for w in BENCH["workloads"] if w["config"] == c["name"])
        cfg = manifest.load_cell(cell["name"]).config
        assert (manifest.BENCH_DIR / "costs" / f"{c['name']}.py").is_file()
        assert (manifest.BENCH_DIR / "reference"
                / f"{cfg['reference']}.py").is_file()
        assert cfg["dtype"] in ("bfloat16", "float32")
        assert set(cfg["limits"]["controls"]) <= {"separation", "training"}
