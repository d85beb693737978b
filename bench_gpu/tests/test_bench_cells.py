"""Each cell of BENCHMARK.json end to end at a tiny size on the CPU (the
kernels' plain versions): the one result line, as the contract has it."""

import json

import pytest

from bench_gpu import run
from bench_gpu.harness import manifest
from bench_gpu.tests.conftest import TRAINING_CELLS, training_root

CELLS = [w["name"] for w in manifest.load_benchmark()["workloads"]]
SEED = 2 ** 31 + 12345  # more than 32 signed bits hold


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS + TRAINING_CELLS)
def test_cell_prints_its_line(workload, trace, tiny, tmp_path):
    root = (training_root(tmp_path) if workload in TRAINING_CELLS
            else manifest.ROOT)
    cell = manifest.load_cell(workload, root=root)
    rc, line, err = run.run_cell(workload, SEED, 1.0, bool(trace),
                                 device="cpu",
                                 overrides=tiny[cell.traffic["driver"]],
                                 root=root)
    assert rc == 0, err
    out = json.loads(line)
    assert list(out)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(out)
    assert out["correct"] is True, err
    assert out["attempted"] > 0 and out["failed"] == 0
    limits = cell.config["limits"][cell.traffic["driver"]]
    assert set(out["checks"]) == set(limits)
    for name, c in out["checks"].items():
        assert c["value"] <= c["limit"], name
    # the compared numbers close standard error
    assert err[-len(limits):] == [f"{k} {v['value']!r} limit {v['limit']!r}"
                                  for k, v in out["checks"].items()]
    names = {m["name"]: m["unit"] for m in
             (cell.per_layer if trace else cell.end_to_end)}
    assert set(out["metrics"]) <= set(names)
    for k, v in out["metrics"].items():
        assert v["unit"] == names[k] and v["value"] > 0
    if trace:
        # a CPU run has no device trace: no roofline, idle share or busy_s
        assert "busy_s" not in out["device"] and out["device"]["window_s"]
        assert not [k for k in out["metrics"] if "roofline" in k
                    or "idle" in k]
    else:
        assert set(out["metrics"]) == set(names)


def test_same_seed_same_inputs():
    """The sessions and the weights are functions of the seed."""
    import torch

    from bench_gpu.drivers.separation import make_pool
    from bench_gpu.harness.setup import weights_for

    cell = manifest.load_cell(CELLS[0])
    traffic = dict(cell.traffic, pool=1,
                   session=dict(cell.traffic["session"], seconds=3))
    dev = torch.device("cpu")
    a, b = make_pool(traffic, SEED, dev), make_pool(traffic, SEED, dev)
    c = make_pool(traffic, SEED + 1, dev)
    assert (a[0] == b[0]).all() and not (a[0] == c[0]).all()
    wa, wb = weights_for(cell.config, SEED, dev), weights_for(
        cell.config, SEED, dev)
    assert all(torch.equal(wa[k], wb[k]) for k in wa)


def test_no_card_exits_nonzero(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                     "1"]) == 2
    assert capsys.readouterr().out == ""
