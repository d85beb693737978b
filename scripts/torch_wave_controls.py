"""The Conv-TasNet cell's check, read as its limit was set: the program
and the control against the float32 reference, and where the program's
boundary permutations differ from that reference's.

    python3 scripts/torch_wave_controls.py --seeds 1 2 3 [--device cuda]
        [--seconds S] [--float32]

For each seed: the cell's program and sessions from the seed (the
benchmark's harness, ``bench_gpu/``), the warm sessions and then each
pooled session through ``CssPipeline.process``, with the stitcher's
boundary permutations kept and its ``stitch_swaps`` counted. Then, the
program freed, the plain reference (``bench_gpu/reference/
conv_tasnet.py`` inside ``separation_wave.py``) separates each session
in float32, as the check runs it, and with the model's products rounded
to the configuration's control precision (fp8 for bf16, TF32 with
``--float32``). Each is judged by the check's own numbers
(``drivers/separation.py:errors``). ``--float32`` runs the program in
float32 in place of the configuration's bf16. One JSON line a seed: per
session the boundaries, each side's swaps, the boundaries where the
program or the control decides otherwise than the float32 reference, and
the numbers of the program and of the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CELL = "conv_tasnet_css512x24.sep_libricss10min_wave"


def readings(seed: int, device, seconds: float = None,
             float32: bool = False, tiny: bool = False):
    import torch

    from bench_gpu.drivers import separation_wave as drv
    from bench_gpu.harness import manifest
    from bench_gpu.harness.setup import (free, pipeline_reference,
                                         program_model, reference,
                                         weights_for)
    from bench_gpu.reference.precision import strict_float32
    from bench_gpu.run import _merge
    from css_tpu_torch.executor.pipeline import CssPipeline
    from css_tpu_torch.utils import trace

    cell = manifest.load_cell(CELL)
    cfg, traffic = cell.config, cell.traffic
    if tiny:
        cfg = _merge(cfg, drv.TINY["config"])
    if float32:
        cfg = _merge(cfg, {"dtype": "float32", "program_conf": {"bf16": False},
                           "limits": {"controls": {"separation": "tf32"}}})
    if seconds:
        traffic["session"]["seconds"] = seconds
    pool = drv.SEP.make_pool(traffic, seed, device)
    model = program_model(cfg, seed, device)
    pipe = CssPipeline(model, cfg["pipeline"], device=device)
    wave_perms, kept = pipe.stitcher.wave_perms, []

    def keeping(streams):
        perms = wave_perms(streams)
        kept.append(perms.clone())
        return perms
    pipe.stitcher.wave_perms = keeping
    for i in range(int(traffic["warm_sessions"])):
        pipe.process(pool[i % len(pool)])
    program = []
    for wav in pool:
        kept.clear()
        with trace.recording():
            outs = pipe.process(wav)
        swaps = trace.collect()["counters"].get("stitch_swaps")
        program.append((outs, kept[0], swaps))
    del pipe, model
    free(device)
    strict_float32()
    ref, rw = reference(cfg), pipeline_reference(cfg)
    p = weights_for(cfg, seed, device)
    widths, k = cfg["widths"], cfg["widths"]["num_spk"]
    g = rw.geometry(cfg["pipeline"])
    frame = int(cfg["pipeline"]["separation"]["frame_length"])
    mode = cfg["limits"]["controls"]["separation"]
    out = []
    for (outs, perms, swaps), wav in zip(program, pool):
        x = torch.as_tensor(wav, device=device)
        sides = {}
        for m in ("f32", mode):
            wins = rw.model_windows(
                x, lambda w, m=m: ref.streams(p, w, widths, mode=m), g)
            sides[m] = (rw.boundary_perms(wins, g["hop"], k),
                        rw.stitched(wins, x.shape[-1], g, k))
            del wins
        want = sides["f32"][0]
        ident = torch.arange(k, device=want.device)

        def swapped(q):
            return int((q != ident).any(-1).sum())
        refs = sides["f32"][1]
        out.append({
            "boundaries": int(want.shape[0]),
            "swaps": {"program": swapped(perms), "program_counter": swaps,
                      "f32": swapped(want), mode: swapped(sides[mode][0])},
            "differ": {"program": int((perms != want).any(-1).sum()),
                       mode: int((sides[mode][0] != want).any(-1).sum())},
            "errors": {
                "program": drv.SEP.errors(outs, refs, frame),
                mode: drv.SEP.errors(tuple(s.cpu().numpy()
                                           for s in sides[mode][1]),
                                     refs, frame)}})
    del p
    free(device)
    return out


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seconds", type=float, default=None,
                    help="session length (default the cell's; shorter "
                         "for a check on the CPU)")
    ap.add_argument("--float32", action="store_true",
                    help="the program in float32, the control TF32")
    ap.add_argument("--tiny", action="store_true",
                    help="the driver's CPU widths")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    for seed in args.seeds:
        t = time.perf_counter()
        sessions = readings(seed, dev, args.seconds, args.float32, args.tiny)
        print(json.dumps({"seed": seed, "float32": args.float32,
                          "sessions": sessions,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
