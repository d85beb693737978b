"""WER through an external ASR hook (port of ``css_tpu/cli/wer.py``).

    python -m css_tpu_torch.cli.wer --estimates out/ \\
        --references refs.jsonl --asr-cmd 'my_asr --wav {wav}'

``--asr-cmd`` is a command template run once per separated stream wav
({wav} substituted); its stdout is the hypothesis. ``--references`` is
jsonl of {"key": ..., "text": ...} per recording, or {"key": ...,
"texts": [...]} per utterance (``cli.prepare libricss
--transcripts-output`` writes these).

Scoring is the optimistic multi-stream assignment of CSS evaluation:
each reference is scored against every output stream of its recording
and takes the least word errors. Reported: per-key WER and the corpus
WER = total errors / total reference words. ``python -m
css_tpu_torch.cli.toy_asr {wav}`` is a hook for the synthetic corpus.
"""

from __future__ import annotations

import argparse
import json
import shlex
import subprocess
from pathlib import Path

from css_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def edit_distance(ref, hyp) -> int:
    """Word-level Levenshtein distance."""
    n, m = len(ref), len(hyp)
    prev = list(range(m + 1))
    for i in range(1, n + 1):
        cur = [i] + [0] * m
        for j in range(1, m + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (ref[i - 1] != hyp[j - 1]))
        prev = cur
    return prev[m]


def normalize(text: str):
    return [w for w in text.upper().split() if w]


def run_asr(cmd_template: str, wav: Path) -> str:
    cmd = [a.replace("{wav}", str(wav)) for a in shlex.split(cmd_template)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=3600)
    if res.returncode != 0:
        raise RuntimeError(
            f"ASR command failed on {wav} (rc={res.returncode}): "
            f"{res.stderr[-500:]}")
    return res.stdout.strip()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--estimates", required=True,
                        help="dir of {key}_{i}.wav separated streams "
                             "(cli.separate output)")
    parser.add_argument("--references", required=True,
                        help="jsonl: {key, text} or {key, texts: [...]}")
    parser.add_argument("--asr-cmd", required=True,
                        help="shell template; {wav} is substituted per "
                             "stream wav; stdout = transcript")
    parser.add_argument("--output", default=None, help="jsonl results path")
    args = parser.parse_args(argv)

    refs = {}
    with open(args.references) as fh:
        for line in fh:
            rec = json.loads(line)
            texts = rec["texts"] if "texts" in rec else [rec["text"]]
            refs[rec["key"]] = [normalize(t) for t in texts]

    est_dir = Path(args.estimates)
    results = []
    total_err = total_words = 0
    for key, ref_texts in sorted(refs.items()):
        # explicit {key}_{i}.wav indices: a glob on {key}_* would also take
        # the streams of keys that have this key as a prefix
        stream_wavs = []
        while (est_dir / f"{key}_{len(stream_wavs)}.wav").exists():
            stream_wavs.append(est_dir / f"{key}_{len(stream_wavs)}.wav")
        if not stream_wavs:
            raise SystemExit(f"no separated streams for key {key!r} "
                             f"in {est_dir}")
        hyps = [normalize(run_asr(args.asr_cmd, w)) for w in stream_wavs]
        key_err = sum(min(edit_distance(ref, h) for h in hyps)
                      for ref in ref_texts)
        key_words = sum(len(ref) for ref in ref_texts)
        results.append({"key": key, "wer": round(key_err / max(key_words, 1),
                                                 4),
                        "errors": key_err, "ref_words": key_words,
                        "num_streams": len(hyps)})
        total_err += key_err
        total_words += key_words
        log.info("%s", json.dumps(results[-1]))
    summary = {"num_recordings": len(results),
               "wer": round(total_err / max(total_words, 1), 4),
               "errors": total_err, "ref_words": total_words}
    log.info("summary: %s", json.dumps(summary))
    if args.output:
        with open(args.output, "w") as f:
            for r in results + [summary]:
                f.write(json.dumps(r) + "\n")
    return summary


if __name__ == "__main__":
    main()
