"""The command line: ``train`` and ``inference``, as the reference's run.py,
``pretrain``, as its embedding-training scripts, and ``import-tf`` /
``export-tf``, between the reference's Keras models and this package's
checkpoints.

Usage:
  python -m multilingual_kws_tpu_torch.api.cli train --keyword mask \
      --samples-dir samples/ --embedding emb_ckpt/ --unknown-words unknown/ \
      --background-noise _background_noise_/ --output mask_model/
  python -m multilingual_kws_tpu_torch.api.cli inference --keywords mask \
      --modelpaths mask_model --wav radio.wav --write-detections out.json
  python -m multilingual_kws_tpu_torch.api.cli pretrain --commands commands.txt \
      --train-files train_files.txt --val-files val_files.txt \
      --background-noise _background_noise_/ --output emb_ckpt/
  torchrun --nproc_per_node 4 -m multilingual_kws_tpu_torch.api.cli pretrain ...
  python -m multilingual_kws_tpu_torch.api.cli import-tf \
      multilingual_context_73_0.8011/ emb_ckpt/
  python -m multilingual_kws_tpu_torch.api.cli export-tf mask_model/ mask.keras

Counterpart of the subcommands of
``multilingual_kws_tpu/api/cli.py`` (reference multilingual_kws/run.py:25-304),
with the same flags, defaults and artifacts: sample validation, the
``_background_noise_`` name check, the ``unknown_files.txt`` manifest,
transfer_learn's defaults (4 epochs x 1 batch x batch 64, LR 1e-3, unknown
50 %), the detections.json schema, the visualizer layout, and pretraining's
manifests (commands.txt, train_files.txt, val_files.txt). Checkpoints are
this package's (``train/checkpoints.py``); an embedding checkpoint written by
``pretrain`` or ``import-tf`` is what ``train --embedding`` loads. ``--device`` (default
``cuda``) picks the card or the CPU; ``--compute-dtype bfloat16`` runs the
trunk in bf16 (parameters, embedding and heads stay float32), and float32
runs without TF32. ``pretrain`` under torchrun is data-parallel over the
processes (``parallel/mesh.py``; ``--batch-size`` is the global batch).
``import-tf`` and ``export-tf`` need TensorFlow and refuse to run without it.
On a card every subcommand builds and loads the port's compiled libraries in
the shared cache (``utils/compilation_cache.py``: ``$MKWS_COMPILATION_CACHE``
or ``~/.cache/multilingual_kws_tpu_torch/build``), as the JAX package's CLI
enables its compilation cache.
"""

from __future__ import annotations

import argparse
import csv
import glob
import importlib.util
import json
import os
import tempfile
from pathlib import Path
from typing import List, Optional

from .. import resolve_device
from ..utils.compilation_cache import enable_compilation_cache


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"error: {msg}")


def cmd_train(args) -> None:
    from ..data.manifests import read_unknown_files
    from ..settings import standard_microspeech_model_settings
    from ..train import checkpoints as ckpt
    from ..train.finetune import transfer_learn
    from ..utils.wav import validate_sample_wav

    device = resolve_device(args.device)
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
        compute_dtype=args.compute_dtype,
        device=device,
    )
    print(f"saving model to {args.output}")
    ckpt.save_model(
        args.output,
        result.model,
        metadata={
            "kind": "transfer",
            "target": args.keyword,
            "details": result.details,
            **ckpt.trunk_metadata(result.model.trunk),
        },
    )


def cmd_inference(args) -> None:
    from ..stream.engine import StreamFlags, StreamTarget, eval_stream_test
    from ..stream.tprfpr import get_groundtruth
    from .visualizer import assemble_visualizer_data, install_site

    device = resolve_device(args.device)
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
            results = eval_stream_test(st, compute_dtype=args.compute_dtype, device=device)
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


def cmd_pretrain(args) -> None:
    """Embedding pretraining from manifests (the reference's
    train_monolingual/multilingual_embedding.py scripts): reads the
    commands.txt / train_files.txt / val_files.txt contract
    (train_multilingual_embedding.py:27-32) and runs ``train/pretrain.py``
    with best-val checkpointing and CSV metrics; data-parallel when the
    environment describes a process group (torchrun)."""
    from ..data.manifests import read_commands, read_lines
    from ..models.efficientnet import EfficientNet
    from ..models.kws_model import KWSEmbeddingModel, lecun_init_
    from ..parallel.mesh import initialize_distributed
    from ..train.checkpoints import load_model, sized_trunk
    from ..train.pretrain import PretrainConfig, pretrain

    device = resolve_device(args.device)
    initialize_distributed("nccl" if device.type == "cuda" else "gloo")
    commands = read_commands(args.commands)
    train_files = read_lines(args.train_files)
    val_files = read_lines(args.val_files)
    unknown_files = read_lines(args.unknown_files) if args.unknown_files else []
    config = PretrainConfig(
        num_labels=len(commands) + 2,
        batch_size=args.batch_size,
        num_epochs=args.num_epochs,
        learning_rate=args.learning_rate,
        silence_percentage=args.silence_percentage,
        unknown_percentage=args.unknown_percentage,
        shuffle_seed=args.seed,
        csvlog_dest=args.csvlog,
        checkpoint_dir=args.output,
        history_dest=args.history,
        steps_per_epoch=args.steps_per_epoch,
        compute_dtype=args.compute_dtype,
        device=str(device),
    )
    # the trunk the flags describe, or, resuming, the one the checkpoint was trained with (prefix included)
    resume_params, trunk_meta = None, dict(width_coefficient=args.width_coefficient,
                                           depth_coefficient=args.depth_coefficient)
    if args.resume:
        resume_params, trunk_meta = load_model(args.resume, device)
        print(f"resuming from {args.resume} (epoch {trunk_meta.get('epoch')}, "
              f"val_accuracy {trunk_meta.get('val_accuracy')})")
    trunk = sized_trunk(trunk_meta, args.compute_dtype)
    coefficients = (args.width_coefficient, args.depth_coefficient)
    held = (trunk.width_coefficient, trunk.depth_coefficient) if isinstance(trunk, EfficientNet) else (1.0, 1.0)
    _require(held == coefficients,
             f"--resume {args.resume} holds a {type(trunk).__name__} trunk with width and depth coefficients {held}, "
             f"but --width-coefficient and --depth-coefficient say {coefficients}")
    has_silence = config.silence_percentage > 0
    has_unknown = bool(unknown_files) and config.unknown_percentage > 0
    model = lecun_init_(KWSEmbeddingModel(len(commands) + int(has_silence) + int(has_unknown), trunk), args.seed)
    _, history, _ = pretrain(
        train_files,
        val_files,
        commands=commands,
        background_data_dir=args.background_noise,
        unknown_files=unknown_files,
        config=config,
        model=model,
        resume_params=resume_params,
    )
    best = max(history["val_accuracy"]) if history["val_accuracy"] else float("nan")
    print(f"best val_accuracy {best:.4f}; checkpoints in {args.output}")


def _require_tensorflow(command: str) -> None:
    _require(importlib.util.find_spec("tensorflow") is not None,
             f"{command} needs the 'tensorflow' package, which is not installed")


def cmd_import_tf(args) -> None:
    """A reference Keras model (SavedModel directory, ``.keras`` or
    ``.h5``) -> a checkpoint of this package."""
    from ..models.import_tf import convert_and_save

    device = resolve_device(args.device)
    _require_tensorflow("import-tf")
    convert_and_save(args.tf_model, args.output, device)
    print(f"converted {args.tf_model} -> {args.output}")


def cmd_export_tf(args) -> None:
    """A checkpoint of this package -> a Keras artifact in the reference's
    layout (drop-in for transfer_learning.py's base_model_path truncation)."""
    from ..models.export_tf import convert_checkpoint_and_save

    device = resolve_device(args.device)
    _require_tensorflow("export-tf")
    convert_checkpoint_and_save(args.checkpoint, args.output, device)
    print(f"exported {args.checkpoint} -> {args.output}")


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
                   help="trunk conv/dense/BN compute dtype (params, embedding and softmax head stay float32)")
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
                   help="trunk compute dtype for streaming inference (softmax rows stay float32)")
    i.add_argument("--device", default="cuda", help="torch device (cuda, or cpu)")
    i.set_defaults(fn=cmd_inference)

    pt = sub.add_parser("pretrain", help="embedding-model pretraining from manifests")
    pt.add_argument("--commands", required=True, help="commands.txt")
    pt.add_argument("--train-files", required=True, help="train_files.txt")
    pt.add_argument("--val-files", required=True, help="val_files.txt")
    pt.add_argument("--unknown-files", default=None)
    pt.add_argument("--background-noise", required=True)
    pt.add_argument("--output", required=True, help="checkpoint directory")
    pt.add_argument("--num-epochs", type=int, default=40)
    pt.add_argument("--batch-size", type=int, default=64, help="the global batch (over all processes)")
    pt.add_argument("--learning-rate", type=float, default=1e-3)
    pt.add_argument("--silence-percentage", type=float, default=1.0)
    pt.add_argument("--unknown-percentage", type=float, default=0.0)
    pt.add_argument("--steps-per-epoch", type=int, default=None)
    pt.add_argument("--seed", type=int, default=0)
    pt.add_argument("--csvlog", default=None)
    pt.add_argument("--history", default=None)
    pt.add_argument("--resume", default=None,
                    help="checkpoint dir to resume from (load params + BN stats, keep training with a fresh "
                         "optimizer: the reference's load+recompile pattern)")
    pt.add_argument("--width-coefficient", type=float, default=1.0,
                    help="EfficientNet width scaling (1.0 = B0); with --resume, the checkpoint's")
    pt.add_argument("--depth-coefficient", type=float, default=1.0,
                    help="EfficientNet depth scaling (1.0 = B0); with --resume, the checkpoint's")
    pt.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"],
                    help="conv/dense/BN compute dtype (params, BN stats, embedding, logits and optimizer "
                         "stay float32)")
    pt.add_argument("--device", default="cuda", help="torch device (cuda, or cpu)")
    pt.set_defaults(fn=cmd_pretrain)

    it = sub.add_parser("import-tf", help="convert a reference Keras model to a checkpoint of this package")
    it.add_argument("tf_model")
    it.add_argument("output")
    it.add_argument("--device", default="cuda", help="torch device the model is built on (cuda, or cpu)")
    it.set_defaults(fn=cmd_import_tf)

    et = sub.add_parser("export-tf", help="convert a checkpoint of this package to a Keras artifact "
                        "(.keras/.h5 via model.save, else a SavedModel directory)")
    et.add_argument("checkpoint")
    et.add_argument("output")
    et.add_argument("--device", default="cuda", help="torch device the checkpoint is loaded on (cuda, or cpu)")
    et.set_defaults(fn=cmd_export_tf)
    return p


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    # after parsing: --help and bad flags pay nothing; on a card the kernels
    # and host libraries are built into (and loaded from) the shared cache
    enable_compilation_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
