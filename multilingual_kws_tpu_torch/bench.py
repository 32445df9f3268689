"""Benchmark of the port: clips/s through the exact micro frontend and the
full-width EfficientNetB0 761-way embedding model on one card.

    python -m multilingual_kws_tpu_torch.bench                 # one JSON line

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

The port's speed on its users' traffic (the scan, the fine-tune,
pretraining) is measured by ``kwsbench``'s cells, with their correctness
checks; this line measures the batch-2048 embedding traffic, which no cell
runs yet.

Every size is a parameter with ``bench.py``'s default, so that the tests
can run each function on the CPU at a tiny size; ``main`` runs the
defaults. Entry points run on the card unless given ``device="cpu"``; a CPU
run reports no MFU (there is no device peak to hold it to).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, Optional

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
    shapes (one forward of one zero clip, on the module path, where every
    convolution module is called: an input that autograd records keeps the
    trunk off its inference path, whose MBConv kernel calls no depthwise or
    SE module); every dense layer acts once a clip, on the pooled features,
    so its are its weight's size."""
    dev = next(model.parameters()).device
    total = 0

    def conv(mod, _, out):
        nonlocal total
        total += 2 * out[0].numel() * mod.weight[0].numel()

    hooks = [m.register_forward_hook(conv) for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    try:
        with torch.enable_grad():
            model(torch.zeros((1, 49, 40, 1), device=dev, requires_grad=True))
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
    """Prints the benchmark's JSON line; returns the exit code: 1 when the
    preflight fails. The command line takes no arguments."""
    argparse.ArgumentParser(prog="python -m multilingual_kws_tpu_torch.bench").parse_args(argv)
    dev = resolve_device(device)
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


if __name__ == "__main__":
    sys.exit(main())
