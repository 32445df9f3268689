#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py              # what a check of the port runs
    python3 chip_smoke.py --profile    # also: where the main path's time goes

Builds the port's CUDA kernels from ``multilingual_kws_tpu_torch/csrc`` with
nvcc, then:

  (a) holds each kernel against its plain PyTorch version on the card (==),
      on a seeded 60 s stream and on edge cases;
  (b) checks the port's features on the card against the golden features of
      the real TFLite op (tests/golden/microfrontend_golden.npz), ==;
  (c) drives the main path once: ``calculate_streaming_accuracy`` over a
      synthesized 10-minute 16 kHz stream with the full-width EfficientNetB0
      transfer model (seeded random weights, eval mode, batch 2048), counts
      each kernel's launches in that run, and checks the softmax rows
      (shape, finite, normalized; a prefix of windows against the CPU path;
      detections found). The target logit's bias is raised first, so that
      the random model's target softmax passes 0.5 on about half of the
      windows and the detector runs on non-empty input;
  (d) holds each kernel against its plain version at the main path's
      shapes (==, and the max |kernel - plain| measured there), times both,
      and prints one JSON line ``{"kernels": [...]}``.

float32 throughout, with TF32 off for cuDNN and matmuls (the precision the
port's CPU tests hold the model to). Every check that fails raises; the
last line of a run that passes is ``{"ok": true, "device": {...}}``. Without
a CUDA device, or without the package beside this script, it exits 2 and
prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PKG = "multilingual_kws_tpu_torch"
SR = 16000
STREAM_SECONDS = 600
BATCH = 2048
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, and for the
# kernels' scalar integer ops the INT32 rate: half the float32 non-tensor
# 67 T/s, as an SM has 64 INT32 lanes beside its 128 FP32 lanes (CUDA C++
# programming guide, arithmetic throughput of compute capability 9.0).
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 33.5e12
# integer operations per unit of work, counted from the algorithm
# (csrc/frontend.cu): per 20 ms frame of the prefix (window 960, max|x|
# 960, shift 480, four radix-4 stages 17920, real post-stage 5120,
# filterbank 2 * 40 * 28, Sqrt64 and >>shift 520) and per output element
# of the suffix (noise estimate 11, PCAN gain 15, shrink 5, log 19, scale 2)
PREFIX_OPS_PER_FRAME = 960 + 960 + 480 + 17920 + 5120 + 2 * 40 * 28 + 520
SUFFIX_OPS_PER_ELEMENT = 52


def fail(msg: str):
    raise RuntimeError(msg)


def check(cond, msg: str):
    if not cond:
        fail(msg)


def cuda_ms(torch, fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of fn() over iters calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def synth_stream(seconds: int, seed: int):
    """Seeded stream: noise floor, tone-sequence 'keywords' at known times,
    other tone sequences as distractors, loud and quiet stretches.
    Returns (float32 waveform, [(label, ms)])."""
    rng = np.random.default_rng(seed)
    n = seconds * SR
    x = rng.normal(0, 0.004, n) * np.repeat(rng.uniform(0.3, 3.0, seconds), SR)
    labels = []
    t = 1.0
    while t < seconds - 2.0:
        kind = "alpha" if rng.random() < 0.5 else "other"
        freqs = (350, 700, 450) if kind == "alpha" else tuple(rng.uniform(900, 3300, 3))
        pos = int(t * SR)
        for f in freqs:
            m = int(rng.uniform(0.12, 0.22) * SR)
            tt = np.arange(m) / SR
            env = np.sqrt(np.clip(np.sin(np.pi * tt / tt[-1]), 0, 1))
            x[pos : pos + m] += rng.uniform(0.2, 0.5) * env * np.sin(2 * np.pi * f * tt)
            pos += m
        if kind == "alpha":
            labels.append(("alpha", int(t * 1000)))
        t += rng.uniform(1.5, 3.5)
    return np.clip(x, -1, 1).astype(np.float32), labels


def edge_cases(rng):
    full = np.where(np.arange(20000) % 2, 32767, -32768)
    imp = np.zeros(24000)
    imp[::1231] = 32767
    imp[500::977] = -32768
    cases = {
        "zeros": np.zeros(20000),
        "full_scale_pos": np.full(20000, 32767),
        "full_scale_neg": np.full(20000, -32768),
        "full_scale_alt": full,
        "impulses": imp,
        "shorter_than_a_clip": rng.normal(0, 3000, 12000),
        "one_frame": rng.normal(0, 3000, 480),
    }
    return {k: np.clip(np.round(v), -32768, 32767).astype(np.int16) for k, v in cases.items()}


def profile_main_path(torch, run, out_dir: Path):
    """Where the main path's time goes: three timed runs (the spread), then
    one run under torch.profiler: device busy time (the union of device
    activity), its split by kernel, and the idle share of the wall time.
    Writes the chrome trace to out_dir."""
    from torch.profiler import ProfilerActivity, profile

    walls = []
    for _ in range(3):
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    busy, end = 0.0, float("-inf")
    for a, b, _ in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    kinds = {}
    for a, b, name in spans:
        low = name.lower()
        kind = next(
            (k for k in ("stream_prefix", "stream_suffix", "memcpy", "memset") if k in low),
            "model_and_other",
        )
        kinds[kind] = kinds.get(kind, 0.0) + (b - a) / 1e3
    out_dir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out_dir / "main_path_trace.json"))
    top = sorted(
        ((e.self_device_time_total / 1e3, e.key) for e in prof.key_averages()), reverse=True
    )[:8]
    print(
        f"profile: wall of 3 runs {walls} s; profiled run {wall} s, device busy "
        f"{busy / 1e3} ms ({len(spans)} device events), idle share {1 - busy / 1e6 / wall}; "
        f"device ms by kind {kinds}; top ops by device ms {top}"
    )


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if not (ROOT / PKG / "csrc").is_dir():
        print(f"chip_smoke: {PKG}/ is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from multilingual_kws_tpu_torch.models.kws_model import make_transfer_model, seeded_init_
    from multilingual_kws_tpu_torch.ops import _build, cuda_fft, cuda_frontend
    from multilingual_kws_tpu_torch.ops.micro_torch import MicroFrontendTorch
    from multilingual_kws_tpu_torch.stream.engine import StreamFlags, calculate_streaming_accuracy
    from multilingual_kws_tpu_torch.utils.wav import write_wav

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.time()
    logs = _build.build()
    for name, log in logs.items():
        usage = [ln.strip() for ln in log.splitlines() if "registers" in ln or "smem" in ln]
        print(f"build {name}: {time.time() - t0:.1f} s; " + " | ".join(usage))
    fe = MicroFrontendTorch(device="cuda")
    rng = np.random.default_rng(0)

    # (a) kernels against their plain versions, on the card, ==
    stream60, _ = synth_stream(60, seed=1)
    cases = {"stream_60s": np.clip(np.trunc(stream60 * 32768.0), -32768, 32767).astype(np.int16)}
    cases.update(edge_cases(rng))
    n_cmp = 0
    for name, a in cases.items():
        audio = torch.from_numpy(a).to(dev)[None]
        base = cuda_fft.stream_prefix(audio, fe)
        torch.cuda.synchronize()
        check(torch.equal(base, cuda_fft.stream_prefix_plain(audio, fe)), f"prefix != plain on {name}")
        base = base[0]
        n_w = max(0, -(-(a.shape[0] - SR) // 320))
        for scaled in (True, False):
            got = cuda_frontend.stream_suffix(base, n_w, 1, 49, fe, scaled=scaled)
            torch.cuda.synchronize()
            want = cuda_frontend.stream_suffix_plain(base, n_w, 1, 49, fe, scaled=scaled)
            check(torch.equal(got, want), f"suffix != plain on {name} (scaled={scaled})")
        n_cmp += 3
    clips = torch.from_numpy(cases["stream_60s"][: 8 * SR].reshape(8, SR)).to(dev)
    base = cuda_fft.stream_prefix(clips, fe)  # (8, 49, 40): clip batches, suffix stride 49
    got = cuda_frontend.stream_suffix(base.reshape(-1, 40), 8, 49, 49, fe)
    want = cuda_frontend.stream_suffix_plain(base.reshape(-1, 40), 8, 49, 49, fe)
    check(torch.equal(got, want), "suffix != plain on clip batches")
    print(f"phase a: kernels == plain versions on the card in {n_cmp + 1} comparisons "
          f"({len(cases)} inputs and clip batches)")

    # (b) golden features of the real TFLite op
    golden = np.load(ROOT / "tests" / "golden" / "microfrontend_golden.npz")
    names = sorted(k[len("floataudio_"):] for k in golden.files if k.startswith("floataudio_"))
    for wname in names:
        got = fe.features(torch.from_numpy(golden[f"floataudio_{wname}"]).to(dev)).cpu().numpy()
        check(np.array_equal(got, golden[f"spec_{wname}"]), f"golden features differ on {wname}")
    print(f"phase b: features == golden TFLite features on {len(names)} waveforms")

    # (c) the main path: 10-minute stream, full-width EfficientNetB0, batch 2048
    model = seeded_init_(make_transfer_model(device="cuda"), seed=0)
    cpu_model = seeded_init_(make_transfer_model(device="cpu"), seed=0)
    wave, labels = synth_stream(STREAM_SECONDS, seed=2)
    i16 = np.clip(np.trunc(wave * 32768.0), -32768, 32767).astype(np.int16)
    n_w = -(-(STREAM_SECONDS * SR - SR) // 320)
    windows = fe.stream_features(torch.from_numpy(i16).to(dev), n_w)
    feats_gpu = windows[:256].clone()  # the stream's first 256 windows
    with torch.inference_mode():
        p = model(windows[:: n_w // BATCH + 1, ..., None]).cpu().numpy()
    del windows
    # random weights never score the target top: raise its logit's bias by
    # the median of log((p0 + p1) / p2) over windows spread across the
    # stream, so that its softmax passes 0.5 on about half of them
    lift = float(np.median(np.log(p[:, :2].sum(1) / p[:, 2])))
    with torch.no_grad():
        for m in (model, cpu_model):
            m.transfer_head.out.bias[2] += lift
    with tempfile.TemporaryDirectory() as tmp:
        wav, gt = Path(tmp) / "stream.wav", Path(tmp) / "labels.txt"
        write_wav(wav, wave, SR)
        gt.write_text("".join(f"{lab}, {ms}\n" for lab, ms in labels))
        flags = StreamFlags(
            wav=str(wav), ground_truth=str(gt), target_keyword="alpha",
            detection_thresholds=[0.5, 0.7, 0.9],
        )
        short = dataclasses.replace(flags, max_chunk_length_sec=30)
        # warm-up on the same stream in 30 s chunks (cuDNN set-up, allocator)
        calculate_streaming_accuracy(model, [short], batch_size=BATCH, verbose=False)
        torch.cuda.synchronize()

        cuda_fft.stream_prefix.launches = 0
        cuda_frontend.stream_suffix.launches = 0
        t1 = time.perf_counter()
        results, inferences = calculate_streaming_accuracy(
            model, [flags], batch_size=BATCH, verbose=False
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = {
            "stream_prefix": cuda_fft.stream_prefix.launches,
            "stream_suffix": cuda_frontend.stream_suffix.launches,
        }
    check(inferences.shape == (n_w, 3), f"inferences {inferences.shape}, expected {(n_w, 3)}")
    check(np.isfinite(inferences).all(), "non-finite softmax rows")
    check(np.abs(inferences.sum(1) - 1).max() < 1e-4, "softmax rows do not sum to 1")
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched on the main path")
    # reference on a small input: the first windows through the CPU path
    feats_cpu = MicroFrontendTorch(device="cpu").stream_features(i16[: SR + 255 * 320], 256)
    check(torch.equal(feats_gpu.cpu(), feats_cpu), "stream features differ from the CPU path")
    with torch.inference_mode():
        ref = cpu_model(feats_cpu[..., None]).numpy()
    model_err = float(np.abs(inferences[:256] - ref).max())
    check(model_err < 1e-4, f"softmax differs from the CPU model by {model_err}")
    found = {th: len(r[0]) for th, r in results[0][1].items()}
    check(any(found.values()), f"no detections at any threshold: {found}")
    print(
        f"phase c: {n_w} windows of a {STREAM_SECONDS} s stream in {wall:.3f} s: "
        f"{n_w / wall:.1f} windows/s, real-time factor {STREAM_SECONDS / wall:.1f}; "
        f"launches {launches}; max |softmax - CPU| {model_err:.2e} on 256 windows; "
        f"target bias raised by {lift:.4f}, target > 0.5 on "
        f"{float((inferences[:, 2] > 0.5).mean()):.3f} of windows; detections per threshold {found}"
    )

    # (d) kernels against their plain versions, and times, at the main path's shapes
    audio = torch.from_numpy(i16).to(dev)[None]
    base = cuda_fft.stream_prefix(audio, fe)
    plain = cuda_fft.stream_prefix_plain(audio, fe)
    err_prefix = float((base.to(torch.int64) - plain.to(torch.int64)).abs().max())
    check(torch.equal(base, plain), f"prefix != plain at the main path's shape: {err_prefix}")
    base = base[0]
    frames, c = base.shape
    feats = cuda_frontend.stream_suffix(base, n_w, 1, 49, fe)
    plain = cuda_frontend.stream_suffix_plain(base, n_w, 1, 49, fe)
    err_suffix = float((feats - plain).abs().max())
    check(torch.equal(feats, plain), f"suffix != plain at the main path's shape: {err_suffix}")
    batch = feats[:BATCH, ..., None].contiguous()
    del feats, plain
    k_prefix = cuda_ms(torch, lambda: cuda_fft.stream_prefix(audio, fe), 20)
    p_prefix = cuda_ms(torch, lambda: cuda_fft.stream_prefix_plain(audio, fe), 3)
    k_suffix = cuda_ms(torch, lambda: cuda_frontend.stream_suffix(base, n_w, 1, 49, fe), 20)
    p_suffix = cuda_ms(torch, lambda: cuda_frontend.stream_suffix_plain(base, n_w, 1, 49, fe), 3)
    with torch.inference_mode():
        model_ms = cuda_ms(torch, lambda: model(batch), 5)

    def bound(nbytes, ops):
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_INT32_OPS_PER_S * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

    b_prefix = bound(audio.numel() * 2 + frames * c * 4, frames * PREFIX_OPS_PER_FRAME)
    out_elems = n_w * 49 * c
    b_suffix = bound(frames * c * 4 + out_elems * 4, out_elems * SUFFIX_OPS_PER_ELEMENT)
    kernels = [
        {
            "name": "stream_prefix", "route": "cuda",
            "source": f"{PKG}/csrc/frontend.cu",
            "replaces": "multilingual_kws_tpu/ops/pallas_fft.py:439",
            "launches": launches["stream_prefix"], "max_abs_err": err_prefix,
            "ms": k_prefix, "plain_ms": p_prefix,
            "bound_ms": b_prefix[0], "bound_by": b_prefix[1], "library_ms": None,
        },
        {
            "name": "stream_suffix", "route": "cuda",
            "source": f"{PKG}/csrc/frontend.cu",
            "replaces": "multilingual_kws_tpu/ops/pallas_frontend.py:88",
            "launches": launches["stream_suffix"], "max_abs_err": err_suffix,
            "ms": k_suffix, "plain_ms": p_suffix,
            "bound_ms": b_suffix[0], "bound_by": b_suffix[1], "library_ms": None,
        },
    ]
    if "--profile" in sys.argv[1:]:
        with tempfile.TemporaryDirectory() as tmp:
            wav, gt = Path(tmp) / "stream.wav", Path(tmp) / "labels.txt"
            write_wav(wav, wave, SR)
            gt.write_text("".join(f"{lab}, {ms}\n" for lab, ms in labels))
            flags = dataclasses.replace(flags, wav=str(wav), ground_truth=str(gt))
            profile_main_path(
                torch,
                lambda: calculate_streaming_accuracy(model, [flags], batch_size=BATCH, verbose=False),
                ROOT / "chiprun_out",
            )
    n_batches = -(-n_w // BATCH)
    print(
        f"phase d: kernels == plain versions at the main path's shapes ({frames} frames, "
        f"{n_w} windows); model forward "
        f"{model_ms:.3f} ms per batch of {BATCH} ({n_batches} batches: "
        f"{n_batches * model_ms:.1f} ms); kernels {k_prefix + k_suffix:.3f} ms"
    )
    print(json.dumps({"kernels": kernels}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
