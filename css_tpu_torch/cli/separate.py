"""Continuous separation CLI (1ch and 7ch), offline or streaming.

Port of ``css_tpu/cli/separate.py``: loads an npz ``.mdl`` checkpoint,
builds the model from its conf, runs the separator -> stitcher ->
beamformer pipeline over each recording and writes {key}_0.wav /
{key}_1.wav. A multichannel wav is read as (C, T). ``--session`` keeps
only recordings whose path (or manifest utt_id) contains the substring.
``--streaming`` feeds each recording in ``--push-sec`` pieces to the
window-granular ``StreamingCssPipeline`` (any model), or with
``--stream-mode hop`` to the frame-level ``HopStreamingPipeline`` (a
causal model, ``--stream-chunk-frames`` frames a step), and writes the
streams peak-normalised at the end.

    python -m css_tpu_torch.cli.separate --config configs/infer_1ch.yaml \
        --checkpoint checkpoints/h2ft_masksnr_best.mdl \
        --corpus-dir recs/ --out-dir out/ [--device cuda]
    # 7 channels: IPD features, DOA merge, Souden MVDR
    python -m css_tpu_torch.cli.separate --config configs/infer_7ch.yaml \
        --checkpoint checkpoints/s7_mse_best.mdl \
        --corpus-dir recs7/ --out-dir out7/ [--device cuda]
    # streaming, window-granular (~2.8 s of lag at 0.8 s pushes) or
    # frame-level with a causal checkpoint
    python -m css_tpu_torch.cli.separate --config configs/infer_1ch.yaml \
        --checkpoint checkpoints/h2ft_masksnr_best.mdl --corpus-dir recs/ \
        --out-dir out/ --streaming [--stream-mode hop] [--device cuda]

``--model BLSTM`` takes a BLSTM checkpoint written by ``css_tpu`` (the npz
format); its conf's ``blstm_*`` and ``bf16`` keys build the model. The
config is read by ``utils/config.py`` (no PyYAML). The last log line
gives the run's kernel launches and plain routes as JSON.
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
from css_tpu_torch.executor.hop_streaming import HopStreamingPipeline
from css_tpu_torch.executor.pipeline import CssPipeline, write_streams
from css_tpu_torch.executor.streaming import StreamingCssPipeline
from css_tpu_torch.models import (MODELS, build_model,
                                  state_dict_from_checkpoint)
from css_tpu_torch.ops import istft_cuda, lstm_cuda, stft_mag_cuda
from css_tpu_torch.trainer.checkpoint import load_checkpoint
from css_tpu_torch.utils.config import load_config

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
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True,
                        help="pipeline config (configs/infer_1ch.yaml or "
                             "configs/infer_7ch.yaml schema; read by "
                             "utils/config.py, no PyYAML)")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--model", default="Conformer", choices=sorted(MODELS))
    parser.add_argument("--corpus-dir", default=None)
    parser.add_argument("--manifest", default=None)
    parser.add_argument("--out-dir", required=True)
    parser.add_argument("--session", default=None,
                        help="only process recordings matching this "
                             "substring (per-session sharding)")
    parser.add_argument("--streaming", action="store_true",
                        help="use the incremental streaming executor "
                             "(bounded latency; the output matches the "
                             "offline one up to the global peak "
                             "normalisation, which a causal system cannot "
                             "do)")
    parser.add_argument("--stream-mode", choices=("window", "hop"),
                        default="window",
                        help="window: any model, the CSS algorithm's "
                             "latency (~2.8 s of lag at 0.8 s pushes); hop: "
                             "a causal model "
                             "(--blstm-causal or --conformer-causal "
                             "checkpoint), frame-level latency (~48 ms "
                             "plus the chunk), no stitcher")
    parser.add_argument("--push-sec", type=float, default=0.8,
                        help="streaming push granularity in seconds")
    parser.add_argument("--stream-chunk-frames", type=int, default=8,
                        help="hop mode: STFT frames advanced per step, the "
                             "latency/throughput knob (chunk chaining is "
                             "exact, so the output is the same at any "
                             "value; 8 = 128 ms added latency)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(format="%(asctime)s %(levelname)-8s %(message)s",
                        level=logging.INFO)

    device = resolve_device(args.device)
    config = load_config(args.config)
    model = load_model(args.checkpoint, args.model)
    pipe = CssPipeline(model, config, device=device)
    total_audio = 0.0
    t0 = time.perf_counter()
    for key, path in iter_recordings(args):
        wav, sr = read_wav(path)
        if sr != pipe.sr:
            raise ValueError(f"{path}: sample rate {sr} != {pipe.sr}")
        log.info("Separating %s (%.1fs)", key, np.shape(wav)[-1] / sr)
        if args.streaming:
            push = int(args.push_sec * pipe.sr)
            wav2 = np.atleast_2d(np.asarray(wav, np.float32))
            if args.stream_mode == "hop":
                stream = HopStreamingPipeline(
                    model, config, chunk_frames=args.stream_chunk_frames,
                    device=device)
                outs = [stream.push(wav2[0, i: i + push])
                        for i in range(0, wav2.shape[-1], push)]
            else:
                stream = StreamingCssPipeline(model, config, device=device)
                outs = [stream.push(wav2[:, i: i + push])
                        for i in range(0, wav2.shape[-1], push)]
            outs.append(stream.flush())
            write_streams(key, np.concatenate(outs, axis=-1), args.out_dir,
                          pipe.sr)
        else:
            pipe.process_recording(key, wav, args.out_dir)
        total_audio += np.shape(wav)[-1] / sr
    dt = time.perf_counter() - t0
    if total_audio:
        log.info("Processed %.1fs of audio in %.1fs (%.2fx realtime)",
                 total_audio, dt, total_audio / dt)
    kernels = (stft_mag_cuda.stft_mag, istft_cuda.istft, lstm_cuda.lstm_fused)
    log.info("kernel launches %s", json.dumps({
        "launches": {k.__name__: k.launches for k in kernels},
        "plain_routes": {k.__name__: k.plain_routes for k in kernels}}))


if __name__ == "__main__":
    main()
