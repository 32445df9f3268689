"""The command line: ``train`` and ``inference``, as the reference's run.py.

Usage:
  python -m multilingual_kws_tpu_torch.api.cli train --keyword mask \
      --samples-dir samples/ --embedding emb_ckpt/ --unknown-words unknown/ \
      --background-noise _background_noise_/ --output mask_model/
  python -m multilingual_kws_tpu_torch.api.cli inference --keywords mask \
      --modelpaths mask_model --wav radio.wav --write-detections out.json

Counterpart of the ``train`` and ``inference`` subcommands of
``multilingual_kws_tpu/api/cli.py`` (reference multilingual_kws/run.py:25-304),
with the same flags, defaults and artifacts: sample validation, the
``_background_noise_`` name check, the ``unknown_files.txt`` manifest,
transfer_learn's defaults (4 epochs x 1 batch x batch 64, LR 1e-3, unknown
50 %), the detections.json schema and the visualizer layout. Checkpoints are
this package's (``train/checkpoints.py``). ``--device`` (default ``cuda``)
picks the card or the CPU; float32 is the only compute dtype so far.
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os
import tempfile
from pathlib import Path
from typing import List, Optional

from .. import resolve_device


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"error: {msg}")


def _float32_only(args) -> None:
    _require(args.compute_dtype == "float32",
             f"--compute-dtype {args.compute_dtype} is not ported yet: this package computes in float32")


def cmd_train(args) -> None:
    from ..data.manifests import read_unknown_files
    from ..settings import standard_microspeech_model_settings
    from ..train import checkpoints as ckpt
    from ..train.finetune import transfer_learn
    from ..utils.wav import validate_sample_wav

    device = resolve_device(args.device)
    _float32_only(args)
    background_noise = Path(args.background_noise)
    _require(
        background_noise.name == "_background_noise_",
        f"only tested with GSC _background_noise_ directory, please provide a path {background_noise}",
    )
    for d in [args.samples_dir, args.embedding, args.unknown_words, args.background_noise]:
        _require(os.path.isdir(d), f"directory {d} not found")

    if os.path.exists(args.output):
        print(f"Warning: overwriting {args.output}")

    samples = glob.glob(os.path.join(args.samples_dir, "*.wav"))
    _require(len(samples) > 0, "no sample .wavs found")
    for s in samples:
        validate_sample_wav(s)
    print(f"{len(samples)} training samples found:\n" + "\n".join(samples))

    unknown_files = read_unknown_files(args.unknown_words)

    print("Training model")
    result = transfer_learn(
        target=args.keyword,
        train_files=samples,
        val_files=samples,
        unknown_files=unknown_files,
        num_epochs=args.num_epochs,
        num_batches=args.num_batches,
        batch_size=args.batch_size,
        primary_lr=args.primary_learning_rate,
        backprop_into_embedding=False,
        embedding_lr=0,
        model_settings=standard_microspeech_model_settings(3),
        base_model_path=args.embedding,
        unknown_percentage=args.unknown_percentage,
        bg_datadir=args.background_noise,
        device=device,
    )
    print(f"saving model to {args.output}")
    trunk = result.model.trunk
    ckpt.save_model(
        args.output,
        result.model,
        metadata={
            "kind": "transfer",
            "target": args.keyword,
            "details": result.details,
            "width_coefficient": trunk.width_coefficient,
            "depth_coefficient": trunk.depth_coefficient,
        },
    )


def cmd_inference(args) -> None:
    from ..stream.engine import StreamFlags, StreamTarget, eval_stream_test
    from ..stream.tprfpr import get_groundtruth
    from .visualizer import assemble_visualizer_data, install_site

    device = resolve_device(args.device)
    _float32_only(args)
    keywords = args.keywords
    modelpaths = args.modelpaths.split(",")
    _require(
        len(modelpaths) == len(set(keywords)),
        f"discrepancy: {len(modelpaths)} modelpaths provided for {len(set(keywords))} keywords",
    )
    for p in modelpaths:
        _require(os.path.exists(p), f"{p} inference model not found")
    _require(os.path.exists(args.wav), f"{args.wav} streaming audio wavfile not found")
    _require(Path(args.wav).suffix == ".wav", f"{args.wav} filetype not supported")
    _require(args.inference_chunk_len_seconds > 0, "--inference-chunk-len-seconds must be positive")

    groundtruth = args.groundtruth
    created_temp_gt = groundtruth is None
    if created_temp_gt:
        fd, groundtruth = tempfile.mkstemp(prefix="empty_", suffix=".txt")
        os.close(fd)
        print(f"created {groundtruth}")

    print(f"Target keywords: {keywords}")
    print(f"performing inference using detection threshold {args.detection_threshold}")

    unsorted_detections = []
    try:
        for keyword, modelpath in zip(keywords, modelpaths):
            flags = StreamFlags(
                wav=args.wav,
                ground_truth=groundtruth,
                target_keyword=keyword,
                detection_thresholds=[args.detection_threshold],
                average_window_duration_ms=100,
                suppression_ms=500,
                time_tolerance_ms=750,
                max_chunk_length_sec=args.inference_chunk_len_seconds,
            )
            st = StreamTarget(
                target_lang=args.language, target_word=keyword, model_path=modelpath, stream_flags=[flags]
            )
            results = eval_stream_test(st, device=device)
            unsorted_detections.extend(results[keyword][0][1][args.detection_threshold][1])
    finally:
        if created_temp_gt:
            os.remove(groundtruth)
            print(f"deleted {groundtruth}")

    detections_with_confidence = sorted(unsorted_detections, key=lambda d: d[1])
    for d in detections_with_confidence:
        print(d)

    if created_temp_gt:
        detections_with_confidence = [
            dict(keyword=d[0], time_ms=d[1], confidence=d[2], groundtruth="ng")
            for d in detections_with_confidence
        ]
    else:
        groundtruth_data = []
        with open(groundtruth) as fh:
            for row in csv.reader(fh):
                if len(row) >= 2:
                    groundtruth_data.append((row[0], float(row[1])))
        detections_with_confidence = get_groundtruth(detections_with_confidence, keywords, groundtruth_data)

    detections = dict(
        keywords=keywords,
        detections=detections_with_confidence,
        min_threshold=args.detection_threshold,
    )

    if args.write_detections:
        with open(args.write_detections, "w") as fh:
            json.dump(detections, fh)

    if not args.visualizer:
        return

    print("running visualizer")
    install_site(args.visualizer_dir)
    files = assemble_visualizer_data(
        Path(args.visualizer_dir) / "data", args.wav, detections,
        transcript=args.transcript, overwrite=args.overwrite,
    )
    print(f"visualizer data written: {[str(f) for f in files]}")
    serve_visualizer(args.visualizer_dir, args.serve_port)


def serve_visualizer(directory, port: int) -> None:
    """Static server for the visualizer site (replaces `npx serve`,
    reference run.py:197-209)."""
    import functools
    import http.server

    handler = functools.partial(http.server.SimpleHTTPRequestHandler, directory=str(directory))
    print(f"serving {directory} at http://localhost:{port} (Ctrl-C to stop)")
    try:
        with http.server.ThreadingHTTPServer(("", port), handler) as httpd:
            httpd.serve_forever()
    except KeyboardInterrupt:
        print("\nTerminating visualization server")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="multilingual_kws_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    t = sub.add_parser("train", help="few-shot fine-tune from an embedding model")
    t.add_argument("--keyword", required=True)
    t.add_argument("--samples-dir", required=True)
    t.add_argument("--embedding", required=True)
    t.add_argument("--unknown-words", required=True)
    t.add_argument("--background-noise", required=True)
    t.add_argument("--output", required=True)
    t.add_argument("--num-epochs", type=int, default=4)
    t.add_argument("--num-batches", type=int, default=1)
    t.add_argument("--primary-learning-rate", type=float, default=0.001)
    t.add_argument("--batch-size", type=int, default=64)
    t.add_argument("--unknown-percentage", type=float, default=50.0)
    t.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"],
                   help="trunk compute dtype; bfloat16 is not ported yet and exits with an error")
    t.add_argument("--device", default="cuda", help="torch device (cuda, or cpu)")
    t.set_defaults(fn=cmd_train)

    i = sub.add_parser("inference", help="streaming detection over a wav")
    i.add_argument("--keywords", nargs="+", required=True)
    i.add_argument("--modelpaths", required=True)
    i.add_argument("--wav", required=True)
    i.add_argument("--groundtruth", default=None)
    i.add_argument("--transcript", default=None)
    i.add_argument("--visualizer", action="store_true")
    i.add_argument("--visualizer-dir", default="visualizer")
    i.add_argument("--serve-port", type=int, default=8080)
    i.add_argument("--detection-threshold", type=float, default=0.9)
    i.add_argument("--inference-chunk-len-seconds", type=int, default=1200)
    i.add_argument("--language", default="unspecified_language")
    i.add_argument("--write-detections", default=None)
    i.add_argument("--overwrite", action="store_true")
    i.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"],
                   help="trunk compute dtype; bfloat16 is not ported yet and exits with an error")
    i.add_argument("--device", default="cuda", help="torch device (cuda, or cpu)")
    i.set_defaults(fn=cmd_inference)
    return p


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
