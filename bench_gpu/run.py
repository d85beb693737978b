"""Run one cell of the port's benchmark once and print its result line.

    python3 bench_gpu/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout that holds the program (``css_tpu_torch``).
The cell's configuration, traffic mix and per-layer readers are found by
name through ``BENCHMARK.json`` (``harness/manifest.py``); the traffic
file names the driver (``drivers/``) that sets the program up from the
seed, runs the measured window and checks the window's outputs against
the plain reference (``reference/``). The last line on standard output is
the result: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared beside its limit, which also close standard error.

Exit codes: 0 a result was printed; 2 no card, or fewer than the cell
asks for; 3 the program is not in this checkout; 4 the JAX package or
JAX was loaded by the time the result was due (the window, the check
and the per-layer readers all run by then).
"""

import time

T0 = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache of the run stays in the checkout, at fixed
# paths: only a checkout's first run builds
CACHE = ROOT / ".bench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["USE_FLAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = (_merge(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: dict = None, root: Path = ROOT):
    """Run the cell of ``root``'s BENCHMARK.json; returns (exit code,
    result line or None, the lines for standard error). ``overrides``
    (tests): dicts merged into the cell's ``config`` and ``traffic``, and
    ``hooks`` handed to the driver."""
    import torch

    from bench_gpu.harness import manifest, result
    from bench_gpu.harness.trace import Tracer

    cell = manifest.load_cell(workload, root=root)
    if overrides:
        cell.config = _merge(cell.config, overrides.get("config", {}))
        cell.traffic = _merge(cell.traffic, overrides.get("traffic", {}))
    dev = torch.device(device)
    try:
        import css_tpu_torch  # noqa: F401
    except ImportError as exc:
        return 3, None, [f"the program is not in this checkout: {exc}"]
    tracer = Tracer(trace, dev)
    drv = manifest.driver(cell)
    out = drv.run(cell, seed=int(seed), seconds=float(seconds),
                  device=dev, tracer=tracer, t0=T0,
                  hooks=(overrides or {}).get("hooks", {}))
    units = {m["name"]: m["unit"] for m in
             cell.end_to_end + cell.per_layer}
    if trace:
        rec = out.record
        metrics = {}
        for m in cell.per_layer:
            value = manifest.reader(m["name"], root)(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        err = [f"not reported: {w}" for w in rec.why]
        breakdown = tracer.breakdown() if tracer.busy_s is not None else None
    else:
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in out.metrics.items()}
        err, breakdown = [], None
    # last, once the readers and the cost files they load have run too
    bad = result.forbidden_modules()
    if bad:
        return 4, None, [f"loaded after the window: {', '.join(bad)}"]
    line = result.line(out.correct, out.attempted, out.failed, metrics,
                       result.device_info(dev, cell.chips, out.memory_peak,
                                          tracer if trace else None),
                       out.checks, breakdown)
    err += out.notes
    err.append(f"correct: {out.correct}")
    err += result.checks_lines(out.checks)
    return 0, line, err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        from bench_gpu.harness import manifest
        cell = manifest.load_cell(args.workload)
    except (OSError, KeyError, ValueError) as exc:
        print(f"cannot read the cell {args.workload!r}: {exc}",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no card: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"the cell asks for {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    rc, line, err = run_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace))
    for e in err:
        print(e, file=sys.stderr, flush=True)
    if line is not None:
        print(line, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
