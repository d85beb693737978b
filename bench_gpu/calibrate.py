"""Readings that the output check's limits are set from.

    python3 bench_gpu/calibrate.py --workload <cell> --seeds 1 2 3 ...

For each seed: the program's numbers, as a run of the cell takes them
(separation: set-up from the seed, the warm calls, then every pooled
session through the timed path; training: the checked steps), judged
against the float32 reference; and the control's: the reference itself
in the precision below the configuration's (``control`` in the
configuration's limits: fp8 for a bf16 model, TF32 for a float32 one)
put in the program's place and judged the same way. Training cells also
read each fault of ``FAULTS`` planted in the program. One JSON line a
seed; the benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def separation_readings(cell, seed: int, device) -> dict:
    import torch

    from bench_gpu.drivers import separation as drv
    from bench_gpu.harness.setup import free, program_model, weights_for
    from css_tpu_torch.executor.pipeline import CssPipeline

    cfg, traffic = cell.config, cell.traffic
    pool = drv.make_pool(traffic, seed, device)
    model = program_model(cfg, seed, device)
    pipe = CssPipeline(model, cfg["pipeline"], device=device)
    for i in range(int(traffic["warm_sessions"])):
        pipe.process(pool[i % len(pool)])
    program = [(i, pipe.process(pool[i])) for i in range(len(pool))]
    del pipe, model
    free(device)
    out = {"program": drv.judge(cfg, traffic, seed, program, pool, device)}
    mode = cfg["limits"]["controls"]["separation"]
    p = weights_for(cfg, seed, device)
    control = [(i, tuple(s.cpu().numpy() for s in drv.reference_streams(
        cfg, p, pool[i], device, mode))) for i, _ in program]
    out["control"] = drv.judge(cfg, traffic, seed, control, pool, device)
    out["control_mode"] = mode
    del p
    free(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out


def _half_batch(trainer):
    """Fault: the loss over the first half of the batch's rows alone."""
    objective = trainer.objective

    def half(outputs, feats):
        b = feats["input"].shape[0] // 2
        return objective(tuple(o[:b] for o in outputs),
                         {k: v[:b] for k, v in feats.items()})
    trainer.objective = half


def _double_update(trainer):
    """Fault: every update applied twice over (the rate doubled)."""
    schedule = trainer.schedule
    trainer.schedule = lambda n: 2 * schedule(n)


# the faults a training cell can have that need a run; a state left
# unchanged reads 1 on change_gap by its definition
FAULTS = {"half_batch": _half_batch, "double_update": _double_update}


def training_readings(cell, seed: int, device, faults=tuple(FAULTS)
                      ) -> dict:
    from bench_gpu.drivers import training as drv
    from bench_gpu.harness.setup import free
    from bench_gpu.harness.trace import Tracer

    cfg, traffic = cell.config, cell.traffic
    off = Tracer(False, device)

    def program(fault=None):
        loader, trainer, _ = drv.build(cell, seed, device, off)
        if fault is not None:
            FAULTS[fault](trainer)
        r = drv.checked_steps(trainer, drv.Feed(loader, off),
                              int(traffic["checked_steps"]),
                              int(traffic["train"]["steps_per_dispatch"]))
        loader.close()
        del trainer
        free(device)
        return r

    prog = program()
    ref = drv.reference_run(cfg, traffic, seed, prog["batches"], device)
    out = {"program": drv.compare(prog, ref)}
    mode = cfg["limits"]["controls"]["training"]
    out["control"] = drv.compare(drv.reference_run(
        cfg, traffic, seed, prog["batches"], device, mode), ref)
    out["control_mode"] = mode
    for fault in faults:
        fr = program(fault)
        out[fault] = drv.compare(fr, drv.reference_run(
            cfg, traffic, seed, fr["batches"], device))
    free(device)
    return out


def readings(workload: str, seeds, device: str = "cuda",
             fault_seeds: int = None):
    import torch

    from bench_gpu.harness import manifest

    cell = manifest.load_cell(workload)
    dev = torch.device(device)
    kind = cell.traffic["driver"]
    fn = {"separation": separation_readings,
          "training": training_readings}[kind]
    for i, seed in enumerate(seeds):
        t = time.perf_counter()
        kw = ({} if kind != "training" or fault_seeds is None
              or i < fault_seeds else {"faults": ()})
        r = fn(cell, int(seed), dev, **kw)
        r.update(seed=int(seed), seconds=time.perf_counter() - t)
        yield r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fault-seeds", type=int, default=None,
                    help="read the planted faults on the first N seeds "
                         "only (default: all)")
    args = ap.parse_args(argv)
    for r in readings(args.workload, args.seeds, args.device,
                      fault_seeds=args.fault_seeds):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
