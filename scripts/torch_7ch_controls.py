"""The 7-channel cell's check, read as its limit was set: the program and
two controls against the float32 reference, and where the DOA merge
decides otherwise than that reference, window by window.

    python3 scripts/torch_7ch_controls.py --seeds 1 2 3 [--device cuda]
        [--seconds S]

For each seed: the cell's program and sessions from the seed (the
benchmark's harness, ``bench_gpu/``), the warm sessions and then each
pooled session through ``CssPipeline.process``, with the separator's
per-window kill decisions kept and its ``merge_kills`` count read after
the call. Then, the program freed, the plain reference
(``bench_gpu/reference/separation_7ch.py``) separates each session three
ways: as the check runs it (float32, the Souden stage in float64), with
the model's products rounded to the configuration's control precision
(TF32), and with the Souden stage in complex64 as a float32 program would
run it. Each is judged by the check's own numbers
(``drivers/separation.py:errors``). One JSON line a seed: per session
the windows, each side's killed windows, the windows where the program
or the TF32 control decides otherwise than the float32 reference, and
the numbers of the program and of both controls.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CELL = "conformer_css7ch.sep_libricss7ch10min"


def readings(seed: int, device, seconds: float = None):
    import torch

    from bench_gpu.drivers import separation as drv
    from bench_gpu.harness import manifest
    from bench_gpu.harness.setup import (free, pipeline_reference,
                                         program_model, reference,
                                         weights_for)
    from bench_gpu.reference.precision import strict_float32
    from css_tpu_torch.executor.pipeline import CssPipeline

    cell = manifest.load_cell(CELL)
    cfg, traffic = cell.config, cell.traffic
    if seconds:
        traffic["session"]["seconds"] = seconds
    pool = drv.make_pool(traffic, seed, device)
    model = program_model(cfg, seed, device)
    pipe = CssPipeline(model, cfg["pipeline"], device=device)
    forward, kept = pipe.separator.forward, []

    def keeping(batch):
        masks, mag, kill = forward(batch)
        kept.append(kill.clone())
        return masks, mag, kill
    pipe.separator.forward = keeping
    for i in range(int(traffic["warm_sessions"])):
        pipe.process(pool[i % len(pool)])
    program = []
    for wav in pool:
        kept.clear()
        outs = pipe.process(wav)
        program.append((outs, torch.cat(kept),
                        int(pipe.separator.merge_kills)))
    del pipe, model
    free(device)
    strict_float32()
    ref, r7 = reference(cfg), pipeline_reference(cfg)
    p = weights_for(cfg, seed, device)
    pipe_cfg, widths, k = cfg["pipeline"], cfg["widths"], cfg["widths"][
        "num_spk"]
    frame = int(pipe_cfg["separation"]["frame_length"])
    mode = cfg["limits"]["controls"]["separation"]

    def mask_fn(m):
        return lambda feats: ref.masks(p, feats, widths, mode=m)
    out = []
    for (outs, kills, counted), wav in zip(program, pool):
        x = torch.as_tensor(wav, device=device)
        want = r7.masks_of(x, mask_fn("f32"), pipe_cfg)[2]
        control = r7.masks_of(x, mask_fn(mode), pipe_cfg)[2]
        kills = kills[:want.shape[0]]
        refs = drv.reference_streams(cfg, p, wav, device)
        sides = {"program": outs,
                 mode: r7.separate(x, mask_fn(mode), pipe_cfg, k),
                 "souden_c64": r7.separate(x, mask_fn("f32"), pipe_cfg, k,
                                           souden=torch.complex64)}
        out.append({
            "windows": int(want.shape[0]),
            "killed": {"program": int(kills.any(-1).sum()),
                       "program_counter": counted,
                       "f32": int(want.any(-1).sum()),
                       mode: int(control.any(-1).sum())},
            "differ": {"program": int((kills != want).any(-1).sum()),
                       mode: int((control != want).any(-1).sum())},
            "errors": {name: drv.errors(tuple(
                s if isinstance(s, np.ndarray) else s.cpu().numpy()
                for s in streams), refs, frame)
                for name, streams in sides.items()}})
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
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    for seed in args.seeds:
        t = time.perf_counter()
        sessions = readings(seed, dev, args.seconds)
        print(json.dumps({"seed": seed, "sessions": sessions,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
