"""Benchmark of the port: clips/s through the exact micro frontend and the
full-width EfficientNetB0 761-way embedding model on one card.

    python -m multilingual_kws_tpu_torch.bench                 # one JSON line
    python -m multilingual_kws_tpu_torch.bench --extra --out F # the extra metrics

The counterpart of the root ``bench.py`` (the JAX package's benchmark).
``main`` first proves on the card that the kernels the headline runs are
right in this run (``preflight_bit_exact_on_chip``: the clip frontend, the
stream prefix and suffix ``==`` the port's copy of ``micro_exact``, the
augment kernel within one int16 step of its plain version), then times the
frontend and model at batch 2048 in float32 and in bf16 compute
(``measure_ours``) and prints ONE JSON line: ``bench.py``'s keys plus
``flops_per_clip``, ``mfu`` and ``device`` (the card's name, power limit and
count). If the preflight fails it prints the failure line (``value`` 0.0)
and exits 1. The TF-CPU reference baseline is read from
``benchmarks/ref_baseline.json`` and never re-measured (TensorFlow is not
on the card's host).

``--extra`` adds the frontend / model split with its MFU, the 5-shot
fine-tune wall, the streaming real-time factor, the realtime detector's
per-feed latency, the batch-512 pretraining step (a graphed epoch) and
end-to-end pretraining with its input pipeline. It prints them and writes
them to ``--out`` only.

Every size is a parameter with ``bench.py``'s default, so that the tests
can run each function on the CPU at a tiny size; ``main`` runs the
defaults. Entry points run on the card unless given ``device="cpu"``; a CPU
run reports no MFU (there is no device peak to hold it to).
"""

from __future__ import annotations

import argparse
import datetime
import json
import math
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import exact_float32, resolve_device

REPO = Path(__file__).resolve().parents[1]
BASELINE_CACHE = REPO / "benchmarks" / "ref_baseline.json"
BATCH = 2048
NUM_LABELS = 761
METRIC = "frontend+EfficientNetB0 embed throughput (bs 2048)"
# H100 SXM data-sheet peaks (dense, 700 W): bf16 on the tensor cores, and
# float32 outside them. The port computes float32 with TF32 off
# (``exact_float32``), so 67 TFLOP/s, not TF32's 495, is float32's peak.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TF32 = False
PREFLIGHT_SEED = 20260817
AUGMENT_SEED = 20260819
# the augment bound of bench.py's preflight: one int16 step, on fewer than
# this share of samples (the kernel and the plain version sum the RMS in
# other orders)
AUGMENT_MAX_SHARE = 1e-4


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def chained_time(step: Callable, x: torch.Tensor, target_s: float = 2.0) -> float:
    """Seconds per iteration of ``step(x, eps) -> eps``: each call's input
    depends on the previous output through a negligible device scalar, so
    no call can be skipped or merged with another and the wall is the
    device's work. One warm-up call, a 4-iteration estimate, then as many
    iterations as fill ``target_s`` (at least 12), ended by a synchronize.
    A program's eager call and its capture fall in the warm-up and the
    estimate, so the timed iterations are replays."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    step(x, zero)
    _sync(x.device)

    def run(iters: int) -> float:
        e = zero
        t0 = time.perf_counter()
        for _ in range(iters):
            e = step(x, e)
        _sync(x.device)
        return (time.perf_counter() - t0) / iters

    est = run(4)
    return run(max(12, int(target_s / max(est, 1e-5))))


def tone_clip(freq: float, seed: int, sr: int = 16000) -> np.ndarray:
    """``bench.py::_tone_clip``: a 1 s Gaussian-enveloped tone, pitch jitter
    and noise from ``seed``."""
    rng = np.random.default_rng(seed)
    t = np.arange(sr) / sr
    env = np.exp(-(((t - 0.5) / 0.18) ** 2))
    x = 0.4 * env * np.sin(2 * np.pi * freq * (1 + 0.01 * rng.normal()) * t)
    return np.clip(x + rng.normal(0, 0.01, sr), -1, 1).astype(np.float32)


def card_info(device) -> Dict:
    """The device a result was measured on: name, power limit (W) and
    count, from ``nvidia-smi`` on a card; ``cpu`` with no power limit and a
    count of 0 on the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit_w": None, "count": 0}
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    name, limit = (s.strip() for s in out[dev.index or 0].rsplit(",", 1))
    return {"name": name, "power_limit_w": float(limit.split()[0]), "count": torch.cuda.device_count()}


def flops_per_clip(model: torch.nn.Module) -> int:
    """Floating-point operations of one clip's forward through ``model``'s
    convolutions and dense layers: 2 x their multiply-adds, the same count
    whatever computes them. A convolution's come from its weight and output
    shapes (one forward of one zero clip); every dense layer acts once a
    clip, on the pooled features, so its are its weight's size."""
    dev = next(model.parameters()).device
    total = 0

    def conv(mod, _, out):
        nonlocal total
        total += 2 * out[0].numel() * mod.weight[0].numel()

    hooks = [m.register_forward_hook(conv) for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    try:
        with torch.inference_mode():
            model(torch.zeros((1, 49, 40, 1), device=dev))
    finally:
        for h in hooks:
            h.remove()
    return total + sum(2 * m.weight.numel() for m in model.modules() if isinstance(m, torch.nn.Linear))


def embedding_model(compute_dtype: str, device, num_labels: int = NUM_LABELS, **trunk_kw):
    """The benchmark's model: the EfficientNetB0 embedding classifier in
    eval mode, Flax's default initialization from seed 0 (built on the CPU,
    so the weights are the same on every device)."""
    from .models.kws_model import lecun_init_, make_embedding_model

    model = make_embedding_model(num_labels, device="cpu", compute_dtype=compute_dtype, **trunk_kw)
    return lecun_init_(model, seed=0).to(resolve_device(device)).eval()


def _float_clips(rng, n: int) -> np.ndarray:
    return rng.normal(0, 0.1, (n, 16000)).astype(np.float32).clip(-1, 1)


def _mixed_clips(n: int):
    """``bench.py``'s preflight audio: seeded noise, an 800 Hz tone on every
    fourth clip, a x8 burst on every seventh, clipped to [-1, 1]; and the
    generator, for the draws that follow."""
    rng = np.random.default_rng(PREFLIGHT_SEED)
    audio = rng.normal(0, 0.1, (n, 16000)).astype(np.float32)
    t = np.arange(16000) / 16000.0
    audio[::4] += 0.6 * np.sin(2 * np.pi * 800 * t).astype(np.float32)
    audio[1::7] *= 8.0
    return audio.clip(-1, 1), rng


def preflight_bit_exact_on_chip(n: int = 256, device="cuda") -> bool:
    """Whether the kernels behind the headline are right in this run, on
    ``bench.py``'s inputs:

    - ``n`` one-second clips of mixed content through
      ``MicroFrontendTorch.features`` (the clip frontend, B1) ``==`` the
      port's copy of ``micro_exact.to_micro_spectrogram_exact``;
    - four 2.5 s clips through the stream prefix (B2) and suffix (B3)
      ``==`` the same;
    - the augment kernel (B4) on 64 clips, three background sizes and
      silence on every ninth clip, against ``augment_quantize_plain`` on
      the same draws (``draw_augment_params``, a generator seeded
      AUGMENT_SEED: torch cannot reproduce ``jax.random``): samples of
      unmixed rows ``==``, of mixed rows at most one int16 step apart on
      fewer than AUGMENT_MAX_SHARE of them.

    Each failure is named on stderr."""
    from .ops.augment import AugmentParams, pad_background_bank
    from .ops.cuda_augment import augment_quantize, augment_quantize_plain, draw_augment_params
    from .ops.cuda_frontend import scale_features
    from .ops.micro_exact import to_micro_spectrogram_exact
    from .ops.micro_torch import MicroFrontendTorch

    dev = resolve_device(device)
    fe = MicroFrontendTorch(device=dev)
    audio, rng = _mixed_clips(n)
    failures = []
    got = fe.features(torch.from_numpy(audio).to(dev)).cpu().numpy()
    want = np.stack([to_micro_spectrogram_exact(a) for a in audio])
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = int((got != want).sum()) if got.shape == want.shape else -1
        failures.append(f"clip features: {bad} of {want.size} cells differ")

    long = audio[:4, :8000].repeat(5, axis=1)  # 2.5 s, mixed content
    i16 = np.clip(np.trunc(long * 32768.0), -32768, 32767).astype(np.int16)
    raw = fe.nr_pcan_log_int(fe.base_frames(torch.from_numpy(i16).to(dev)))
    got_l = scale_features(raw, True).cpu().numpy()
    want_l = np.stack([to_micro_spectrogram_exact(a) for a in long])
    if got_l.shape != want_l.shape or not np.array_equal(got_l, want_l):
        bad = int((got_l != want_l).sum()) if got_l.shape == want_l.shape else -1
        failures.append(f"stream prefix + suffix: {bad} of {want_l.size} cells differ")

    b = 64
    fg16 = ((rng.normal(0, 0.15, (b, 16000)) * 32768).clip(-32768, 32767)).astype(np.int16)
    is_sil = np.zeros(b, bool)
    is_sil[::9] = True
    fg16[is_sil] = 0
    sizes = np.array([61234, 17000, 16001], np.int32)
    bank = np.zeros((3, int(sizes.max())), np.float32)
    for i, sz in enumerate(sizes):
        bank[i, :sz] = rng.normal(0, 0.1, sz).astype(np.float32)
    bank = pad_background_bank(bank, 16000)
    fg, sil = torch.from_numpy(fg16).to(dev), torch.from_numpy(is_sil).to(dev)
    rows = torch.arange(b, dtype=torch.int32, device=dev)
    bg, bg_sizes = torch.from_numpy(bank).to(dev), torch.from_numpy(sizes).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(AUGMENT_SEED)
    draws = draw_augment_params(gen, b, 16000, bg_sizes, AugmentParams())
    got_a = augment_quantize(fg, rows, sil, bg, draws).to(torch.int32)
    want_a = augment_quantize_plain(fg, rows, sil, bg, draws).to(torch.int32)
    diff = (got_a - want_a).abs()
    unmixed = sil | (draws.volume == 0)
    share = float((diff > 0).to(torch.float64).mean())
    if not (torch.equal(got_a[unmixed], want_a[unmixed]) and int(diff.max()) <= 1 and share < AUGMENT_MAX_SHARE):
        failures.append(f"augment: max |kernel - plain| {int(diff.max())} on a share {share} of samples")
    for f in failures:
        print(f"# PREFLIGHT FAILED on {dev}: {f}", file=sys.stderr)
    return not failures


def headline_step(fe, model) -> Callable:
    """The headline's step ``(audio, eps) -> eps``: the exact frontend (B1)
    and the model on ``audio + eps``, one program (``train/graphs.ProgramGraphs``:
    on a card a CUDA graph, as the JAX package jits its step)."""
    from .train.graphs import ProgramGraphs

    def step(a, eps):
        with torch.inference_mode(), exact_float32():
            out = model(fe.features(a + eps)[..., None])
            return torch.tanh(out.float().mean()) * 1e-30

    return ProgramGraphs(step, [model])


def measure_ours(batch: int = BATCH, num_labels: int = NUM_LABELS, target_s: float = 2.0, device="cuda"):
    """Clips/s of the exact frontend plus the embedding model (logits,
    eval mode) on ``batch`` seeded clips, chained timing of the headline
    step, in float32 and in bf16 compute. Returns (the faster rate, its
    dtype, {dtype: rate})."""
    from .ops.micro_torch import MicroFrontendTorch

    dev = resolve_device(device)
    fe = MicroFrontendTorch(device=dev)
    audio = torch.from_numpy(_float_clips(np.random.default_rng(0), batch)).to(dev)
    detail = {}
    for dtype in ("float32", "bfloat16"):
        model = embedding_model(dtype, dev, num_labels)
        detail[dtype] = batch / chained_time(headline_step(fe, model), audio, target_s)
        del model
    best = max(detail, key=detail.get)
    return detail[best], best, detail


def get_baseline() -> Dict:
    """The TF-CPU reference baseline (per-clip microfrontend op and Keras
    EfficientNetB0 predict) from ``benchmarks/ref_baseline.json``, with its
    age and provenance. It is never re-measured here and nothing is
    written."""
    if not BASELINE_CACHE.exists():
        return {"clips_per_sec": float("nan"), "age_days": None, "provenance": "unavailable"}
    cached = json.loads(BASELINE_CACHE.read_text())
    age_s = time.time() - BASELINE_CACHE.stat().st_mtime
    return {
        "clips_per_sec": float(cached["clips_per_sec"]),
        "age_days": round(age_s / 86400, 2),
        "provenance": f"cache ({cached.get('config', 'TF-CPU')}, measured by bench.py; "
                      "not re-measured: no TensorFlow on the card's host)",
    }


def _mfu(rate: float, flops: int, dtype: str, device: torch.device) -> Optional[float]:
    return rate * flops / PEAK_FLOPS[dtype] if device.type == "cuda" else None


def main(argv=None, device="cuda", batch: int = BATCH, target_s: float = 2.0, preflight_clips: int = 256) -> int:
    """Prints the benchmark's JSON line (or, with ``--extra``, the extra
    metrics); returns the exit code: 1 when the preflight fails."""
    ap = argparse.ArgumentParser(prog="python -m multilingual_kws_tpu_torch.bench")
    ap.add_argument("--extra", action="store_true", help="the extra metrics instead of the headline")
    ap.add_argument("--out", default=None, help="with --extra: write the metrics here as JSON")
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    if args.extra:
        run_extra(args.out, device=dev)
        return 0
    info = card_info(dev)
    if not preflight_bit_exact_on_chip(preflight_clips, dev):
        print(json.dumps({
            "metric": METRIC, "value": 0.0, "unit": "clips/sec", "vs_baseline": 0.0,
            "bit_exact_on_chip": False, "device": info,
            "error": "the port's frontend or augment kernel disagrees with ops/micro_exact on the device",
        }))
        return 1
    ours, dtype, detail = measure_ours(batch, target_s=target_s, device=dev)
    flops = flops_per_clip(embedding_model("float32", dev))
    base = get_baseline()
    bval = base["clips_per_sec"]
    vs = ours / bval if bval == bval else None
    mfu = _mfu(ours, flops, dtype, dev)
    print(json.dumps({
        "metric": METRIC,
        "value": round(ours, 1),
        "unit": "clips/sec",
        "vs_baseline": round(vs, 2) if vs is not None else None,
        "bit_exact_on_chip": True,
        "model_compute_dtype": dtype,
        "f32_clips_per_sec": round(detail["float32"], 1),
        "bf16_clips_per_sec": round(detail["bfloat16"], 1),
        "baseline_clips_per_sec": round(bval, 2) if bval == bval else None,
        "baseline_age_days": base["age_days"],
        "baseline_provenance": base["provenance"],
        "flops_per_clip": flops,
        "mfu": mfu,
        "mfu_peak_flops": PEAK_FLOPS[dtype] if mfu is not None else None,
        "tf32": TF32,
        "device": info,
    }))
    return 0


# -- the extra metrics ----------------------------------------------------------


def measure_decomposition(batch: int = BATCH, num_labels: int = NUM_LABELS, target_s: float = 2.0,
                          device="cuda") -> List[Dict]:
    """The headline split: the frontend alone on ``batch`` clips, and the
    model alone on ``batch`` seeded feature windows in float32 and bf16,
    each with its MFU against the card's peak for its dtype; each step one
    program, as the headline's."""
    from .ops.micro_torch import MicroFrontendTorch
    from .train.graphs import ProgramGraphs

    dev = resolve_device(device)
    fe = MicroFrontendTorch(device=dev)
    rng = np.random.default_rng(0)
    audio = torch.from_numpy(_float_clips(rng, batch)).to(dev)
    specs = torch.from_numpy(rng.normal(0, 2.0, (batch, 49, 40, 1)).astype(np.float32)).to(dev)

    def fe_step(a, eps):
        return torch.tanh(fe.features(a + eps).mean()) * 1e-30

    fe_clips = batch / chained_time(ProgramGraphs(fe_step), audio, target_s)
    rates = {}
    flops = 0
    for dtype in ("float32", "bfloat16"):
        model = embedding_model(dtype, dev, num_labels)

        def m_step(s, eps, model=model):
            with torch.inference_mode(), exact_float32():
                return torch.tanh(model(s + eps).float().mean()) * 1e-30

        rates[dtype] = batch / chained_time(ProgramGraphs(m_step, [model]), specs, target_s)
        flops = flops or flops_per_clip(model)
        del model
    out = [{"metric": f"frontend only (bit-exact, clip_features kernel), chained bs {batch}",
            "value": round(fe_clips, 0), "unit": "clips/sec"}]
    for dtype, short in (("float32", "f32"), ("bfloat16", "bf16")):
        out.append({"metric": f"EfficientNetB0 {num_labels}-way forward only, {short}, chained bs {batch}",
                    "value": round(rates[dtype], 0), "unit": "clips/sec",
                    "flops_per_clip": flops, f"mfu_vs_{short}_peak": _mfu(rates[dtype], flops, dtype, dev)})
    return out


def _write_tone_corpus(root: Path, words: Dict[str, float], clips: int) -> Dict[str, List[str]]:
    """root/<word>/<i>.wav of ``tone_clip``s, the seed of each from
    zlib.crc32 of "<word>/<i>" (the same in every process)."""
    from .utils.wav import write_wav

    paths = {}
    for w, freq in words.items():
        paths[w] = []
        for i in range(clips):
            p = root / w / f"{i}.wav"
            p.parent.mkdir(parents=True, exist_ok=True)
            write_wav(p, tone_clip(freq, seed=zlib.crc32(f"{w}/{i}".encode())))
            paths[w].append(str(p))
    return paths


def _write_background(root: Path, seed: int) -> str:
    from .utils.wav import write_wav

    bg_dir = root / "_background_noise_"
    bg_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(2):
        write_wav(bg_dir / f"noise_{i}.wav", np.clip(rng.normal(0, 0.05, 3 * 16000), -1, 1).astype(np.float32))
    return str(bg_dir)


def measure_fewshot_wallclock(tmp, device="cuda", model_factory: Optional[Callable] = None) -> Dict:
    """BASELINE config 1: a 5-shot ``transfer_learn`` at the reference's
    defaults (4 epochs x 1 batch of 64, LR 1e-3, unknown 50 %) and
    ``evaluate_files_single_target`` on the held-out clips, cold (the first
    in this process) and warm. ``model_factory()``: the transfer model to
    train (default: transfer_learn's full-width B0)."""
    from .train.evaluate import evaluate_files_single_target
    from .train.finetune import transfer_learn

    dev = resolve_device(device)
    tmp = Path(tmp)
    paths = _write_tone_corpus(tmp, {"target": 440.0, "other": 1200.0}, 12)
    bg_dir = _write_background(tmp, 0)

    def run(seed):
        _sync(dev)
        t0 = time.perf_counter()
        res = transfer_learn(target="target", train_files=paths["target"][:5], val_files=paths["target"][5:],
                             unknown_files=paths["other"], num_epochs=4, num_batches=1, batch_size=64,
                             primary_lr=1e-3, bg_datadir=bg_dir, seed=seed, verbose=0,
                             model=model_factory() if model_factory else None, device=dev)
        evaluate_files_single_target(paths["target"][5:], 2, res.predict_fn(), device=dev)
        _sync(dev)
        return time.perf_counter() - t0

    cold, warm = run(0), run(1)
    return {"metric": "5-shot fine-tune + eval wall-clock (config 1; 4x1x64, LR 1e-3)",
            "cold_s": round(cold, 3), "warm_s": round(warm, 3), "unit": "seconds"}


def _transfer_model(device, **trunk_kw):
    from .models.kws_model import lecun_init_, make_transfer_model

    return lecun_init_(make_transfer_model(3, device="cpu", **trunk_kw), seed=0).to(resolve_device(device)).eval()


def measure_realtime_latency(device="cuda", chunks_ms=(20, 100, 500), **trunk_kw) -> Dict:
    """Online serving: the wall of one ``RealtimeDetector.feed`` (ring
    buffer, featurize, transfer-model softmax, detector) at several chunk
    sizes, median and p90 over max(10, 2000 / chunk) feeds after a 1 s
    fill and two warm feeds (the predict program's eager call and its
    capture at the feed's batch)."""
    from .stream.realtime import RealtimeDetector

    dev = resolve_device(device)
    model = _transfer_model(dev, **trunk_kw)
    rng = np.random.default_rng(0)
    out = {"metric": "online RealtimeDetector feed() latency (featurize + transfer model + detector)",
           "unit": "ms per feed (median / p90)"}
    for chunk_ms in chunks_ms:
        det = RealtimeDetector("kw", model, device=dev)
        chunk = rng.normal(0, 0.1, 16 * chunk_ms).astype(np.float32)
        det.feed(rng.normal(0, 0.1, 16000).astype(np.float32))
        det.feed(chunk)
        det.feed(chunk)
        times = []
        for _ in range(max(10, 2000 // chunk_ms)):
            t0 = time.perf_counter()
            det.feed(chunk)
            times.append((time.perf_counter() - t0) * 1e3)
        times = np.sort(np.asarray(times))
        med = float(np.median(times))
        out[f"chunk_{chunk_ms}ms"] = [round(med, 3), round(float(times[int(0.9 * (len(times) - 1))]), 3),
                                      f"{chunk_ms / med:.1f}x real-time"]
    return out


def measure_streaming_rtf(tmp, device="cuda", num_targets: int = 120, num_distractors: int = 280,
                          **trunk_kw) -> Dict:
    """BASELINE config 5: streaming detection over the synthesized stream
    (``num_targets`` tone targets among ``num_distractors`` distractors,
    ~10 min at the defaults) with a 19-threshold sweep; the real-time
    factor from the median of 3 passes on freshly dithered copies, after
    one warm pass."""
    from .stream.engine import StreamFlags, calculate_streaming_accuracy
    from .tools.stream_synth import synthesize_stream, write_stream
    from .utils.wav import write_wav

    dev = resolve_device(device)
    tmp = Path(tmp)
    targets = [tone_clip(440.0, seed=s) for s in range(6)]
    distractors = [tone_clip(900.0 + 80 * s, seed=100 + s) for s in range(8)]
    spec = synthesize_stream("target", targets, distractors, num_targets=num_targets,
                             num_distractors=num_distractors, gap_ms_range=(200, 900), noise_rms=0.003, seed=7)
    wav, labels = tmp / "stream.wav", tmp / "labels.txt"
    write_stream(spec, wav, labels)
    audio_s = spec.waveform.shape[0] / spec.sample_rate
    model = _transfer_model(dev, **trunk_kw)
    thresholds = [round(0.05 * i, 2) for i in range(1, 20)]

    def flags(path):
        return StreamFlags(wav=str(path), ground_truth=str(labels), target_keyword="target",
                           detection_thresholds=thresholds)

    calculate_streaming_accuracy(model, [flags(wav)], verbose=False, device=dev)
    rng = np.random.default_rng(11)
    walls = []
    for rep in range(3):
        dithered = np.clip(spec.waveform + rng.uniform(-2e-5, 2e-5, spec.waveform.shape).astype(np.float32), -1, 1)
        path = tmp / f"stream_timed_{rep}.wav"
        write_wav(path, dithered)
        _sync(dev)
        t0 = time.perf_counter()
        calculate_streaming_accuracy(model, [flags(path)], verbose=False, device=dev)
        _sync(dev)
        walls.append(time.perf_counter() - t0)
    dt = float(np.median(walls))
    return {"metric": "streaming KWS over long-form audio, 19-threshold sweep (config 5)",
            "audio_seconds": round(audio_s, 1), "wall_seconds": round(dt, 4),
            "wall_seconds_reps": [round(w, 4) for w in walls], "real_time_factor": round(audio_s / dt, 1),
            "unit": "x real-time"}


def spec_pretrain_epoch(model, specs: torch.Tensor, seed: int = 1):
    """The pretraining step on fixed feature windows (no input pipeline)
    as a resident epoch: ``(epoch, body)``, where ``epoch(idx_all, lbl_all,
    sil_all)`` is a ``train/graphs.EpochGraph`` of ``body`` (a CUDA graph on
    the card) and ``body(rows, labels, is_silence) -> (loss, accuracy)``
    is one ``make_pretrain_step`` update of ``model`` (flat Adam 1e-3,
    drop-connect from a generator seeded ``seed``) on ``specs`` with
    ``labels``; rows and silence flags are not read."""
    from .train.graphs import EpochGraph
    from .train.steps import flat_adam, make_pretrain_step

    dev = specs.device
    opt = flat_adam(model.parameters(), 1e-3)
    drop = torch.Generator(device=dev)
    drop.manual_seed(seed)
    step = make_pretrain_step(model, opt, None)[0].fn  # eager: the epoch's graph holds it

    def body(rows, labels, is_silence):
        m = step(specs, labels, drop)
        return m["loss"], m["accuracy"]

    return EpochGraph(body, dev, generators=[drop], optimizer=opt), body


def spec_epoch_inputs(labels: torch.Tensor, steps: int):
    """(steps, B) inputs of ``spec_pretrain_epoch``'s epoch: rows and
    silence flags unread, the same labels every step."""
    b = labels.shape[0]
    dev = labels.device
    return (torch.zeros((steps, b), dtype=torch.int32, device=dev), labels.expand(steps, b).contiguous(),
            torch.zeros((steps, b), dtype=torch.bool, device=dev))


def measure_pretrain_step(batch: int = 512, steps: int = 96, reps: int = 3, num_labels: int = NUM_LABELS,
                          device="cuda", **trunk_kw) -> Dict:
    """The train step alone: forward, backward, Adam and train-mode BN of
    the embedding model at ``batch`` on seeded feature windows, timed as a
    graphed epoch of ``steps`` steps (the counterpart of the JAX package's
    scan) after one warm epoch of the same length; the median of ``reps``,
    in float32 and bf16 compute."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    specs = torch.from_numpy(rng.normal(0, 2, (batch, 49, 40, 1)).astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, num_labels, (batch,))).to(dev)
    inputs = spec_epoch_inputs(labels, steps)
    out = {"metric": f"{num_labels}-way EfficientNetB0 pretrain step (bs {batch}, fwd+bwd+adam+BN, "
                     f"graphed epochs of {steps} steps)", "unit": "ms/step"}
    for dtype, short in (("float32", "f32"), ("bfloat16", "bf16")):
        epoch, _ = spec_pretrain_epoch(embedding_model(dtype, dev, num_labels, **trunk_kw), specs)
        losses, _ = epoch(*inputs)
        if not bool(torch.isfinite(losses).all()):
            raise RuntimeError(f"pretrain step at {dtype}: a non-finite loss")
        times = []
        for _ in range(reps):
            _sync(dev)
            t0 = time.perf_counter()
            epoch(*inputs)
            _sync(dev)
            times.append((time.perf_counter() - t0) / steps)
        sec = float(np.median(times))
        out[f"{short}_ms_per_step"] = round(sec * 1e3, 4)
        out[f"{short}_ms_per_step_reps"] = [round(t * 1e3, 4) for t in times]
        out[f"{short}_clips_per_sec"] = round(batch / sec, 1)
    return out


def pretrain_e2e_corpus(tmp, words: int = 16, clips: int = 32, device="cuda"):
    """The end-to-end pretraining corpus under ``tmp``: ``words`` tone words
    of ``clips`` one-second clips each and a background. Returns (dataset
    (seed 0, 1 % silence), files, labels)."""
    from .data.dataset import AudioDataset
    from .settings import standard_microspeech_model_settings
    from .utils.wav import write_wav

    tmp = Path(tmp)
    names = [f"w{i:02d}" for i in range(words)]
    files, labels = [], []
    for wi, w in enumerate(names):
        for i in range(clips):
            p = tmp / "clips" / w / f"{i}.wav"
            p.parent.mkdir(parents=True, exist_ok=True)
            write_wav(p, tone_clip(300.0 + 45 * wi, seed=wi * 100 + i))
            files.append(str(p))
            labels.append(w)
    dataset = AudioDataset(standard_microspeech_model_settings(words + 1), names, _write_background(tmp, 1), [],
                           silence_percentage=1.0, seed=0, device=resolve_device(device))
    return dataset, files, labels


def stream_rate(model, dataset, files, labels, batch: int, steps: int, prefetch: int) -> float:
    """Clips/s of ``steps`` streaming-pipeline pretraining steps of
    ``model`` (a fresh flat Adam, drop-connect seeded 1) on
    ``dataset.train_batches`` at ``batch``, ``prefetch`` batches ahead,
    after 3 warm steps: the transform and the step programs (CUDA graphs
    from their second calls; under ``train/graphs.disable_graphs``,
    eager)."""
    from .train.steps import flat_adam, make_pretrain_step

    dev = dataset.device
    drop = torch.Generator(device=dev)
    drop.manual_seed(1)
    step, _ = make_pretrain_step(model, flat_adam(model.parameters(), 1e-3), None)

    def run(n):
        for specs, lbl in dataset.train_batches(files, batch, n, labels=labels, single_target=False,
                                                prefetch=prefetch):
            step(specs, lbl, drop)
        _sync(dev)

    run(3)
    t0 = time.perf_counter()
    run(steps)
    return batch * steps / (time.perf_counter() - t0)


def measure_pretrain_e2e(tmp, compute_bound: Optional[float] = None, words: int = 16, clips: int = 32,
                         batch: int = 512, steps: int = 12, resident_steps: int = 48, reps: int = 3,
                         num_labels: int = NUM_LABELS, device="cuda", **trunk_kw) -> Dict:
    """End-to-end pretraining throughput at ``batch`` with the input
    pipeline (wav reads, batch assembly, augment and frontend kernels):
    ``train_batches`` synchronous and with ``data/pipeline.prefetch`` (2
    ahead), ``steps`` steps each after 3 warm ones (``stream_rate``: the
    transform and the step programs), and synchronous once more under
    ``train/graphs.disable_graphs`` (eager); and the resident bank with
    each epoch a CUDA graph (``build_fused_resident_epoch``), epochs of
    ``resident_steps`` after one warm epoch, the median of ``reps``.
    ``compute_bound``: the float32 step's clips/s, for the resident
    share."""
    from .train.graphs import disable_graphs
    from .train.pretrain import build_fused_resident_epoch
    from .train.steps import flat_adam

    dev = resolve_device(device)
    dataset, files, labels = pretrain_e2e_corpus(tmp, words, clips, dev)
    bank = dataset.build_resident_bank(files)

    def streamed(prefetch: int) -> float:
        model = embedding_model("float32", dev, num_labels, **trunk_kw)
        return stream_rate(model, dataset, files, labels, batch, steps, prefetch)

    def resident() -> float:
        model = embedding_model("float32", dev, num_labels, **trunk_kw)
        drop = torch.Generator(device=dev)
        drop.manual_seed(1)
        epoch = build_fused_resident_epoch(model, flat_adam(model.parameters(), 1e-3), None, dataset, bank["bank"],
                                           drop, device=dev)

        def draws():
            d = list(dataset.host_train_indices(files, batch, resident_steps, bank, labels=labels,
                                                single_target=False))
            return dataset._put_batch(tuple(np.stack(a) for a in zip(*d)))

        epoch(*draws())
        _sync(dev)
        t0 = time.perf_counter()
        epoch(*draws())
        _sync(dev)
        return batch * resident_steps / (time.perf_counter() - t0)

    sync_rate, prefetch_rate = streamed(0), streamed(2)
    with disable_graphs():
        eager_rate = streamed(0)
    res = [resident() for _ in range(reps)]
    med = float(np.median(res))
    return {
        "metric": f"{num_labels}-way pretrain END-TO-END incl. input pipeline (bs {batch})",
        "stream_sync_clips_per_sec": round(sync_rate, 1),
        "stream_prefetch2_clips_per_sec": round(prefetch_rate, 1),
        "stream_sync_eager_clips_per_sec": round(eager_rate, 1),
        "resident_graphed_clips_per_sec": round(med, 1),
        "resident_reps_clips_per_sec": [round(r, 1) for r in res],
        "steps_timed": {"stream_sync": steps, "stream_prefetch2": steps, "stream_sync_eager": steps,
                        "resident_graphed": resident_steps},
        "unit": "clips/sec",
        "pct_of_train_step_bound": round(100 * med / compute_bound, 1) if compute_bound else None,
    }


def run_extra(out=None, device="cuda") -> Dict:
    """The extra metrics at ``bench.py``'s sizes: printed as JSON and, when
    ``out`` is given, written there (never under ``benchmarks/``)."""
    dev = resolve_device(device)
    info = card_info(dev)
    print("# extra: preflight...", file=sys.stderr, flush=True)
    if not preflight_bit_exact_on_chip(device=dev):
        raise SystemExit("the port's frontend or augment kernel disagrees with ops/micro_exact on the device")
    print("# extra: headline...", file=sys.stderr, flush=True)
    ours, dtype, detail = measure_ours(device=dev)
    base = get_baseline()
    metrics = [{"metric": f"{METRIC}, chained", "value": round(ours, 1), "unit": "clips/sec",
                "model_compute_dtype": dtype, "f32_clips_per_sec": round(detail["float32"], 1),
                "bf16_clips_per_sec": round(detail["bfloat16"], 1),
                "vs_tf_cpu_baseline": round(ours / base["clips_per_sec"], 1)
                if not math.isnan(base["clips_per_sec"]) else None,
                "bit_exact_on_chip": True, "baseline_provenance": base["provenance"]}]
    print("# extra: decomposition...", file=sys.stderr, flush=True)
    metrics += measure_decomposition(device=dev)
    with tempfile.TemporaryDirectory(prefix="bench_extra_") as tmp:
        print("# extra: 5-shot wall-clock...", file=sys.stderr, flush=True)
        metrics.append(measure_fewshot_wallclock(Path(tmp) / "fewshot", device=dev))
        print("# extra: streaming RTF...", file=sys.stderr, flush=True)
        metrics.append(measure_streaming_rtf(tmp, device=dev))
    print("# extra: realtime feed latency...", file=sys.stderr, flush=True)
    metrics.append(measure_realtime_latency(device=dev))
    print("# extra: pretrain step...", file=sys.stderr, flush=True)
    step_metric = measure_pretrain_step(device=dev)
    metrics.append(step_metric)
    with tempfile.TemporaryDirectory(prefix="bench_pretrain_") as tmp:
        print("# extra: pretrain e2e...", file=sys.stderr, flush=True)
        metrics.append(measure_pretrain_e2e(tmp, compute_bound=step_metric["f32_clips_per_sec"], device=dev))
    result = {"measured": f"{datetime.date.today()}, {info['name']}", "device": info, "metrics": metrics,
              "baseline": "TF-CPU reference pipeline (per-clip microfrontend op + Keras EfficientNetB0 predict): "
                          f"{base['clips_per_sec']} clips/sec ({base['provenance']})"}
    print(json.dumps(result, indent=1))
    if out:
        Path(out).write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    sys.exit(main())
