"""End-to-end case study: radio-stream-style keyword spotting on the port.

The port's counterpart of ``examples/case_study.py``, after the
reference's Luganda case study (luganda/luganda_train.py, luganda_eval.py,
luganda_multitarget_data.py): transcript-driven data preparation, few-shot
fine-tunes over a sweep of shot counts, streaming evaluation on long-form
audio, and the TPR against false accepts per hour with a 50 FA/h
operating cutoff.

Synthetic mode (no data; tiny models, seconds on a CPU):

    python -m multilingual_kws_tpu_torch.examples.case_study --workdir W [--device cpu]

Real data (a transcribed corpus with forced alignments, the reference's
Makerere layout; see ``tools/transcripts.py``):

    python -m multilingual_kws_tpu_torch.examples.case_study --workdir W \\
        --transcripts-csv /data/uliza-clips/transcripts.csv --clips-root /data/uliza-clips \\
        --alignments /data/alignment/cs288/alignments --aligned-clips /data/alignment/cs288/cs288_clips \\
        --keyword akawuka --exclude-variants masiki masks mask \\
        --base-model /path/to/embedding_checkpoint --unknown-files /path/to/unknown_files.txt
"""

from __future__ import annotations

import argparse
import json
import pickle
from pathlib import Path

import numpy as np

from .. import resolve_device

THRESHOLDS = list(np.arange(0.3, 1.0, 0.05))


def make_synthetic_corpus(workdir: Path):
    """The synthetic keyword corpus, and a stream of 5 "alpha" among 5
    "charlie": (corpus, stream wav, labels file, target times, seconds)."""
    from ..tools.stream_synth import synthesize_stream, write_stream
    from .synth import keyword_clip, make_corpus

    corpus = make_corpus(workdir / "corpus", clips_per_word=12)
    spec = synthesize_stream(
        "alpha",
        [keyword_clip("alpha", seed=9000 + i) for i in range(5)],
        [keyword_clip("charlie", seed=9500 + i) for i in range(5)],
        num_targets=5, num_distractors=5, seed=21, noise_rms=0.003,
    )
    wav, labels = workdir / "stream.wav", workdir / "labels.txt"
    write_stream(spec, wav, labels)
    return corpus, str(wav), str(labels), [t for _, t in spec.labels], spec.waveform.shape[0] / spec.sample_rate


def prepare_real_data(args, workdir: Path):
    """Transcript-driven preparation (reference luganda_multitarget_data.py
    and luganda_nontarget.py): (shot files, stream wav, labels file, target
    times, seconds, ground truth)."""
    from ..tools import transcripts as tr
    from ..tools.word_extraction import extract_shot

    entries = tr.load_transcripts_csv(args.transcripts_csv, args.clips_root)
    _, non_targets = tr.split_by_keywords(entries, set(args.keyword), exclude=set(args.exclude_variants))
    targets = tr.timings_from_alignments(args.alignments, args.aligned_clips, set(args.keyword))
    print(f"targets with alignments: {len(targets)}, non-target clips: {len(non_targets)}")
    order = np.random.default_rng(0).permutation(len(targets))
    n_train = max(args.max_shots, len(targets) // 5)
    train_side = [targets[i] for i in order[:n_train]]
    eval_side = [targets[i] for i in order[n_train:]]

    shots_dir = workdir / "shots"
    shots_dir.mkdir(parents=True, exist_ok=True)
    shot_files = []
    for t in train_side:
        o = t.occurences_s[0]
        try:
            shot_files.append(str(extract_shot(t.wav, o["start_s"], o["end_s"], shots_dir, include_context=True)))
        except ValueError:
            continue

    eval_dir = workdir / "eval"
    gt = tr.assemble_multitarget_stream(eval_side, non_targets, eval_dir, seed=1)
    tr.assemble_nontarget_stream(non_targets, workdir / "nontarget_eval", num_wavs=min(len(non_targets) * 2, 160),
                                 seed=2)
    duration_s = sum(e["duration_s"] for e in gt["stream_data"])
    times = [g["time_ms"] for g in gt["groundtruth_target_times_ms"]]
    print(f"eval stream: {duration_s / 60:.1f} min, {len(times)} target occurrences; shots: {len(shot_files)}")
    (workdir / "groundtruth.json").write_text(json.dumps(gt))
    return shot_files, str(eval_dir / "stream.wav"), str(eval_dir / "groundtruth_labels.txt"), times, duration_s, gt


def _sweep(args, workdir: Path, keyword: str, lang: str, train_files, unknown, base, bg_dir, wav, labels, gt_times,
           duration_s, primary_lr, batch_size, model, dev):
    """Each shot count: ``run_job`` (fine-tune, save, stream), then the
    streaming ROC and its operating point. Returns [(shots, status, roc,
    results)]."""
    from ..analysis.batch_jobs import TLData, run_job
    from ..analysis.streaming_roc import operating_point, streaming_roc
    from ..stream.engine import StreamFlags, StreamTarget

    out = []
    for shots in args.shots:
        if shots >= len(train_files):
            raise SystemExit(f"--shots {shots}: only {len(train_files)} shots to train and validate on")
        dest_pkl = workdir / f"result_{shots}shot.pkl"
        st = StreamTarget(
            target_lang=lang, target_word=keyword, model_path=None,
            stream_flags=[StreamFlags(wav=wav, ground_truth=labels, target_keyword=keyword,
                                      detection_thresholds=THRESHOLDS)],
            destination_result_pkl=str(dest_pkl),
            destination_result_inferences=str(workdir / f"inferences_{shots}shot.npy"),
        )
        job = TLData(train_files=train_files[:shots], val_files=train_files[shots:], n_batches=1, n_epochs=4,
                     model_dest_dir=str(workdir / "models"), primary_lr=primary_lr, backprop_into_embedding=False,
                     embedding_lr=0, target=keyword, stream_targets=[st], batch_size=batch_size)
        status = run_job(job, unknown, base, bg_dir, model=model, device=dev)
        print(f"{shots}-shot job: {status}")
        with open(dest_pkl, "rb") as fh:
            results = pickle.load(fh)
        roc = streaming_roc(results, keyword, gt_times, duration_s)
        roc["keyword"] = f"{keyword} ({shots}-shot)"
        print(f"  operating point (<=50 FA/h): {operating_point(roc)}")
        out.append((shots, status, roc, results))
    return out


def _plot(rocs, workdir: Path) -> None:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("(no plot: matplotlib is not installed)")
        return
    from ..analysis.viz import plot_streaming_roc

    dest = workdir / "streaming_roc.png"
    plot_streaming_roc(rocs, dest=dest)
    print(f"wrote {dest}")


def _summary(sweep, **extra):
    from ..analysis.streaming_roc import operating_point

    return {**extra, "jobs": {shots: status for shots, status, _, _ in sweep},
            "operating_points": {shots: operating_point(roc) for shots, _, roc, _ in sweep},
            "rocs": [roc for _, _, roc, _ in sweep]}


def main(argv=None):
    """Runs the synthetic mode, or the real-data mode with
    ``--transcripts-csv``; returns a summary (each shot count's job status,
    ROC and operating point; in synthetic mode also the pretrained
    embedding's validation accuracy)."""
    ap = argparse.ArgumentParser(prog="python -m multilingual_kws_tpu_torch.examples.case_study")
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--shots", type=int, nargs="+", default=[3, 5])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--transcripts-csv", default=None)
    ap.add_argument("--clips-root", default=None)
    ap.add_argument("--alignments", default=None)
    ap.add_argument("--aligned-clips", default=None)
    ap.add_argument("--keyword", nargs="+", default=["akawuka"])
    ap.add_argument("--exclude-variants", nargs="*", default=[])
    ap.add_argument("--base-model", default=None, help="embedding checkpoint directory (real data)")
    ap.add_argument("--unknown-files", default=None, help="unknown_files.txt manifest (real data)")
    args = ap.parse_args(argv)
    args.max_shots = max(args.shots)
    if args.transcripts_csv and not (args.base_model and args.unknown_files):
        ap.error("real data needs --base-model (an embedding checkpoint) and --unknown-files")
    dev = resolve_device(args.device)
    workdir = Path(args.workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    if args.transcripts_csv:
        return main_real(args, workdir, dev)

    from ..train import checkpoints as ckpt
    from ..train.pretrain import PretrainConfig, pretrain
    from .synth import tiny_embedding_model, tiny_transfer_model

    print("== synthesizing corpus + stream ==")
    corpus, wav, labels, gt_times, duration_s = make_synthetic_corpus(workdir)
    print("== pretraining embedding (bravo/charlie) ==")
    words = ["bravo", "charlie"]
    model, hist, _ = pretrain(
        [f for w in words for f in corpus[w][:10]], [f for w in words for f in corpus[w][10:]],
        commands=words, background_data_dir=corpus["bg_dir"], unknown_files=corpus["unknown_files"],
        config=PretrainConfig(num_labels=4, batch_size=16, num_epochs=5, learning_rate=3e-3, silence_percentage=10,
                              unknown_percentage=15, shuffle_seed=0, steps_per_epoch=12, device=str(dev)),
        verbose=0, model=tiny_embedding_model(4, dev),
    )
    print(f"pretrain val accuracy: {hist['val_accuracy'][-1]:.2f}")
    base = workdir / "embedding"
    ckpt.save_model(base, model, {"kind": "embedding", **ckpt.trunk_metadata(model.trunk)})

    print("== sweep: shots -> train -> stream ==")
    sweep = _sweep(args, workdir, "alpha", "syn", corpus["alpha"], corpus["unknown_files"], base, corpus["bg_dir"],
                   wav, labels, gt_times, duration_s, 1e-2, 16, tiny_transfer_model(dev), dev)
    _plot([roc for _, _, roc, _ in sweep], workdir)
    return _summary(sweep, val_accuracy=float(hist["val_accuracy"][-1]))


def main_real(args, workdir: Path, dev):
    """Real data: transcript preparation, the few-shot sweep, the streaming
    ROC and the transcript of each detection at the operating point
    (reference luganda_train.py sweep_run, luganda_eval.py, luganda.py:761)."""
    from ..analysis.streaming_roc import operating_point
    from ..tools import transcripts as tr

    keyword = args.keyword[0]
    shot_files, wav, labels, gt_times, duration_s, gt = prepare_real_data(args, workdir)
    manifest = Path(args.unknown_files)
    unknown = [str(manifest.parent / line) for line in manifest.read_text().splitlines() if line.strip()]
    sweep = _sweep(args, workdir, keyword, "lu", shot_files, unknown, Path(args.base_model), None, wav, labels,
                   gt_times, duration_s, 1e-3, 64, None, dev)
    for shots, _, roc, results in sweep:
        op = operating_point(roc)
        if op is None:
            continue
        _, per_thresh = results[keyword][0]
        found = per_thresh[min(per_thresh, key=lambda t: abs(t - op["threshold"]))][0]
        print(f"  {shots}-shot: {len(found)} detections at threshold {op['threshold']:.2f}:")
        for _, t_ms in found[:10]:
            info = tr.transcript_by_offset(t_ms, gt)
            if info is None:
                continue
            flag = " [CERTAIN FP]" if info["certain_false_positive"] else ""
            print(f"    {t_ms:>9.0f} ms{flag}  {info['decorated'][:80]}")
    _plot([roc for _, _, roc, _ in sweep], workdir)
    return _summary(sweep)


if __name__ == "__main__":
    main()
