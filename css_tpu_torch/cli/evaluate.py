"""Separation-quality evaluation: SI-SNR and SI-SNRi over wav directories
(port of ``css_tpu/cli/evaluate.py``).

  --estimates DIR with {key}_0.wav .. {key}_{K-1}.wav (cli.separate output)
  --references DIR with {key}_src0.wav .. {key}_src{K-1}.wav
  --mixtures DIR with {key}.wav (for the SI-SNRi baseline)

K is found per key from the files present (or set with --num-spk). The
streams are matched to the references by the best permutation
(``utils/metrics.pit_si_snr_db``); one jsonl line per key, then a
summary line.

    python -m css_tpu_torch.cli.evaluate --estimates out/ \\
        --references refs/ [--mixtures mix/] --output results.jsonl
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from css_tpu_torch.data.wav_io import read_wav
from css_tpu_torch.utils.logging import get_logger
from css_tpu_torch.utils.metrics import pit_si_snr_db, si_snr_improvement_db

log = get_logger(__name__)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--estimates", required=True)
    parser.add_argument("--references", required=True)
    parser.add_argument("--mixtures", default=None)
    parser.add_argument("--num-spk", type=int, default=None,
                        help="stream count; default: discover per key from "
                             "the {key}_{i}.wav files present")
    parser.add_argument("--output", default=None, help="jsonl results path")
    args = parser.parse_args(argv)

    est_dir = Path(args.estimates)
    ref_dir = Path(args.references)
    keys = sorted({p.name[: -len("_0.wav")]
                   for p in est_dir.glob("*_0.wav")})
    if not keys:
        raise SystemExit(f"no {{key}}_0.wav estimates found in {est_dir}")
    results = []
    for key in keys:
        if args.num_spk:
            k = args.num_spk
        else:
            k = 0
            while (est_dir / f"{key}_{k}.wav").exists() and \
                    (ref_dir / f"{key}_src{k}.wav").exists():
                k += 1
            if k < 2:
                raise SystemExit(
                    f"found fewer than 2 estimate/reference pairs for {key}")
        ests = [read_wav(est_dir / f"{key}_{i}.wav")[0] for i in range(k)]
        refs = [read_wav(ref_dir / f"{key}_src{i}.wav")[0] for i in range(k)]
        rec = {"key": key, "num_spk": k, "si_snr_db": pit_si_snr_db(ests, refs)}
        if args.mixtures:
            mix = read_wav(Path(args.mixtures) / f"{key}.wav")[0]
            rec["si_snri_db"] = si_snr_improvement_db(ests, refs, mix)
        results.append(rec)
        log.info("%s", json.dumps(rec))
    summary = {"num_recordings": len(results),
               "mean_si_snr_db": float(np.mean([r["si_snr_db"]
                                                for r in results]))}
    if args.mixtures:
        summary["mean_si_snri_db"] = float(
            np.mean([r["si_snri_db"] for r in results]))
    log.info("summary: %s", json.dumps(summary))
    if args.output:
        with open(args.output, "w") as f:
            for r in results + [summary]:
                f.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
