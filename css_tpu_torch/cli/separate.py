"""Offline continuous separation CLI (1ch and 7ch).

Port of the offline path of ``css_tpu/cli/separate.py``: loads an npz
``.mdl`` checkpoint, builds the model from its conf, runs the separator ->
stitcher -> beamformer pipeline over each recording and writes
{key}_0.wav / {key}_1.wav. A multichannel wav is read as (C, T).
``--session`` keeps only recordings whose path (or manifest utt_id)
contains the substring. Streaming waits for ROADMAP.md Queue 1 item 9.

    python -m css_tpu_torch.cli.separate --config configs/infer_1ch.yaml \
        --checkpoint checkpoints/h2ft_masksnr_best.mdl \
        --corpus-dir recs/ --out-dir out/ [--device cuda]
    # 7 channels: IPD features, DOA merge, Souden MVDR
    python -m css_tpu_torch.cli.separate --config configs/infer_7ch.yaml \
        --checkpoint checkpoints/s7_mse_best.mdl \
        --corpus-dir recs7/ --out-dir out7/ [--device cuda]

``--model BLSTM`` takes a BLSTM checkpoint written by ``css_tpu`` (the npz
format); its conf's ``blstm_*`` and ``bf16`` keys build the model.
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path

import numpy as np

from css_tpu_torch.data.wav_io import read_wav
from css_tpu_torch.device import resolve_device
from css_tpu_torch.executor.pipeline import CssPipeline
from css_tpu_torch.models import (MODELS, build_model,
                                  state_dict_from_checkpoint)
from css_tpu_torch.trainer.checkpoint import load_checkpoint

log = logging.getLogger("css_tpu_torch.separate")


def iter_recordings(args):
    if args.corpus_dir:
        for wav_path in sorted(Path(args.corpus_dir).rglob("*.wav")):
            if args.session and args.session not in str(wav_path):
                continue
            yield wav_path.stem, wav_path
    elif args.manifest:
        with open(args.manifest) as fh:
            for line in fh:
                rec = json.loads(line)
                if args.session and args.session not in rec["utt_id"]:
                    continue
                yield rec["utt_id"], rec["path"]
    else:
        raise SystemExit("need --corpus-dir or --manifest")


def load_model(checkpoint: str, name: str = "Conformer"):
    """Checkpoint -> model with its weights (float32 parameters; the
    compute dtype follows the checkpoint's conf)."""
    ckpt = load_checkpoint(checkpoint)
    model = build_model(name, dict(ckpt.get("conf", {})))
    model.load_state_dict(state_dict_from_checkpoint(name, ckpt))
    return model


def main(argv=None):
    import yaml  # only here: the port's other modules run without PyYAML

    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True,
                        help="pipeline YAML (configs/infer_1ch.yaml or "
                             "configs/infer_7ch.yaml schema)")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--model", default="Conformer", choices=sorted(MODELS))
    parser.add_argument("--corpus-dir", default=None)
    parser.add_argument("--manifest", default=None)
    parser.add_argument("--out-dir", required=True)
    parser.add_argument("--session", default=None,
                        help="only process recordings matching this "
                             "substring (per-session sharding)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(format="%(asctime)s %(levelname)-8s %(message)s",
                        level=logging.INFO)

    device = resolve_device(args.device)
    with open(args.config) as fh:
        config = yaml.safe_load(fh)
    pipe = CssPipeline(load_model(args.checkpoint, args.model), config,
                       device=device)
    total_audio = 0.0
    t0 = time.perf_counter()
    for key, path in iter_recordings(args):
        wav, sr = read_wav(path)
        if sr != pipe.sr:
            raise ValueError(f"{path}: sample rate {sr} != {pipe.sr}")
        log.info("Separating %s (%.1fs)", key, np.shape(wav)[-1] / sr)
        pipe.process_recording(key, wav, args.out_dir)
        total_audio += np.shape(wav)[-1] / sr
    dt = time.perf_counter() - t0
    if total_audio:
        log.info("Processed %.1fs of audio in %.1fs (%.2fx realtime)",
                 total_audio, dt, total_audio / dt)


if __name__ == "__main__":
    main()
