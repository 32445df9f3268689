#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py              # what a check of the port runs
    python3 chip_smoke.py --profile    # also: where the stream's, a fine-tune
                                       # epoch's and a pretraining epoch's time goes

Builds the port's CUDA kernels from ``multilingual_kws_tpu_torch/csrc`` with
nvcc into a build cache of its own (``utils/compilation_cache.py``, through
``$MKWS_COMPILATION_CACHE``, which its fresh processes inherit), then:

  (a) holds each kernel against its plain PyTorch version on the card (==),
      on a seeded 60 s stream and on edge cases, and ``stream_suffix`` over
      every caller's shape (1, 63 and 65 windows at strides 1, 7 and 49, one
      window of 5999 frames; default, no-PCAN and no-log frontends; scaled
      and raw) at each of its layouts (1 and 4 channels a thread);
  (b) checks the port's features on the card against the golden features of
      the real TFLite op (tests/golden/microfrontend_golden.npz), ==;
  (c) drives the main path: ``calculate_streaming_accuracy`` over a
      synthesized 10-minute 16 kHz stream with the full-width EfficientNetB0
      transfer model (seeded random weights, eval mode, batch 2048), counts
      each kernel's launches in the first run (a predict batch launches the
      inference epilogue 18 times and the MBConv middle 16), times five runs
      (median and
      best), and checks the softmax rows
      (shape, finite, normalized; a prefix of windows against the CPU path;
      detections found). The target logit's bias is raised first, so that
      the random model's target softmax passes 0.5 on about half of the
      windows and the detector runs on non-empty input;
  (d) holds each kernel against its plain version at the main path's
      shapes (==, and the max |kernel - plain| measured there; the suffix
      for each frontend variant, output and layout) and times both; times
      the suffix's two layouts at the stream's first 4,096 to 27,000
      windows and all 29,950, at 64 and 2048 clips and on one long window
      (where they cross sets the launch plan's switch point), and prints
      each layout's SASS census (``probes/sass.py``);
  (e) the few-shot fine-tune slice: holds the clip-frontend and augment
      kernels against their plain versions (clip_features == plain and ==
      prefix + suffix, also with the cost probe's PCAN-off and log-off
      frontends; augment_quantize == plain on rows that are not mixed,
      within one int16 step on fewer than 1e-4 of the mixed rows' samples,
      with and without shift, and == itself on a second run), runs
      ``features_from_int16`` on 64 10 s clips (the prefix on a clip batch,
      B6, and the suffix at stride F; launches counted, the features and
      each kernel == plain on that batch, the prefix timed there), then drives
      ``transfer_learn`` on a synthesized corpus at
      the JAX defaults (full-width EfficientNetB0, batch 64, 4 epochs x 64
      steps, 5 shots, no base weights: BN calibration on the card), and one
      more call with one epoch of phase 2 (``backprop_into_embedding``).
      It counts both kernels' launches over the two calls and checks: every
      loss finite and the last epoch's below the first; phase 1 changed the
      head and no trunk or embedding-head parameter; phase 2 changed the
      trunk's top conv and no BN tensor; one step on the card against the
      same step on the CPU (loss rtol 1e-5; gradients rtol 1e-4, atol 1e-4
      of each tensor's largest, the CPU tests' tolerance); the batch-eval
      helpers and the streaming engine on the fine-tuned ``predict_fn``;
      the streaming and resident input pipelines give equal specs. Each
      resident epoch is a CUDA graph (``make_finetune_epoch_scan``): it
      checks the replays, holds both calls ``==`` the same calls on the
      streaming pipeline, which runs a step at a time (every step's loss and
      accuracy, the model, the optimizers' state, the generators), then
      runs the graphed epoch beside the eager step loop in turns (five
      timed epochs after a warm one, on the same draws) and holds them
      ``==`` too, with the last replayed step's augment and frontend outputs
      ``==`` the eager wrappers'; one profiled graphed epoch must show one
      cudaGraphLaunch a step and every augment and frontend kernel launched
      by one. It times both loops' step (median and best of five epochs),
      the capture, the step's parts, the transform's device time, one
      profiled epoch of each (device busy time and idle share), and the two
      kernels at batches of 64 and 2048 clips;
  (f) the fast frontend mode (``MicroFrontendTorch(mode="fast")``): holds
      ``noise_scan_f32`` against its plain version (==) at the stream's
      shape, at 64 and 2048 clips and on the edge cases, drives the
      10-minute stream of (c) through the fast frontend and the same model
      (launches, softmax rows, windows/s and detections beside exact
      mode's), reports the fast-vs-exact feature gap, runs the batch-eval
      helpers on (e)'s fine-tuned model and one training batch of each input
      pipeline with a fast frontend (equal specs, and the same augmented
      int16 as exact mode), and times the fast prefix and the kernel;
  (g) the probes: holds ``fft_energy`` against its plain version (==, at
      100,352 rows with extreme rows) and against the energies of the kiss
      FFT on the stream's own frames, runs the frontend cost decomposition
      (``probes/fft_cost.py``), holds ``rate_chain`` (each operation class)
      and ``dot_chain`` (rows 64, 128, 192 and 25,088, k 0, 1, 5 and 64)
      against their plain versions (==), and measures the card's rates
      (``probes/rates.py``), each beside the data-sheet peak it tests; a
      rate above its peak, or a chain that does not grow linearly with its
      depth, fails the run. It prices every
      bound again at the measured rates, and ``stream_suffix``'s census at
      the measured integer instruction rate;
  (h) the user's workflow through the CLI (``api/cli.py``): saves (e)'s
      fine-tuned model as an embedding checkpoint (every tensor loaded back
      ==, and a transfer model rebuilt from it gives softmax rows == the
      model's on the stream's first 2048 windows), lays (e)'s corpus out as
      the CLI expects it, runs ``train`` at the JAX defaults from the
      checkpoint (trunk and embedding head == the checkpoint's, the head
      changed, every epoch's loss finite) and ``inference`` on (c)'s stream
      with its ground truth, at the highest threshold from 0.9 down to 0.4
      where the saved model, loaded and run in memory through
      ``calculate_streaming_accuracy``, detects (detections.json in the JAX
      schema, its detections == the in-memory run's, three calls alike), writes the
      visualizer's files, counts the four kernels' launches over the two
      calls, and times ``train``, ``inference`` (median of 3) and its model
      load, the checkpoint's save and load and its size; then each
      subcommand once in a fresh interpreter (``-X importtime``): its wall
      and when, from where and for how long it imports ``torch._dynamo``;
      the fresh ``inference``'s detections must equal this process's, with
      confidences within FRESH_CONF_TOL (the port pins float32 itself);
  (i) embedding pretraining and bf16: builds a seeded 761-label corpus (760
      tone-sequence words of PT_CLIPS clips, and _silence_), joins an NCCL
      process group of one rank (``parallel/mesh.py``: the step runs under
      its gradient all-reduce), and runs ``pretrain()`` with the full-width
      B0, 761 outputs, batch 64, PT_EPOCHS epochs of PT_STEPS steps, BN
      calibration and best-val checkpoints, at float32 and at bfloat16. It
      checks: losses finite and falling, every parameter and BN statistic
      float32, every BN statistic changed, both kernels' launches (one
      augment and one clip frontend a train and calibration batch, one clip
      frontend a validation batch); one card step == the same step on the
      CPU (same global batch and drop-connect masks; loss rtol 1e-5,
      gradients rtol 1e-4, atol 1e-4 of each tensor's largest) from a state
      that is the same in every run (``pretrain_gate``: the seeded init, BN
      calibrated on the CPU; each tensor's error is printed) on a batch that
      is too (``gate_batch``: the first of a dataset of its own); both kernels
      == plain at the pretraining batch. Each resident epoch is a CUDA
      graph (``build_fused_resident_epoch``, NCCL's collectives inside): it
      holds ``pretrain()`` ``==`` ``pretrain(scan_epoch=False)`` (history,
      model, generator, launches), and the graphed epoch ``==`` the eager
      step loop over two epochs (every step's metrics, the model, Adam's
      state, both generators), both under deterministic cuDNN (at float32
      its default weight-gradient algorithms make two eager runs differ);
      it times both loops' step in turns (median and best of five epochs)
      and the capture, and profiles one epoch of each (device busy time,
      idle share; one cudaGraphLaunch a step). Then the CLI: ``pretrain`` (one short epoch), ``train
      --embedding`` from its checkpoint and ``inference`` at ``--compute-dtype
      bfloat16``; the bf16 gate: ``bf16_gate_model`` (a full-width B0 with
      BN calibrated to its data) at bfloat16 beside float32, its softmax
      rows within BF16_SOFTMAX_TOL and its rows and embedding moved as far
      as the JAX package's bf16 moves them (BF16_GATE_JAX within
      BF16_GATE_RATIO); (c)'s stream at bfloat16 beside float32 (runs in
      turns: windows/s; for (c)'s model the softmax rows' max |delta| <=
      BF16_SOFTMAX_TOL, and for it and (e)'s fine-tuned model the deltas,
      the target probability's delta percentiles and the detections); and
      a bf16 ``transfer_learn`` at the JAX defaults with its step beside
      (e)'s.
  (j) the realtime detector, the TF-free weight mapping and the analysis
      modules, on phase e's fine-tuned model and corpus, phase h's embedding
      checkpoint and the first J_SECONDS of (c)'s stream: ``RealtimeDetector``
      (default frontend: the port's on the card) fed in 100 ms, then 1 s
      chunks, its detections equal across the two and equal to the offline
      engine's (``featurize_stream``, the same predict,
      ``detect_all_thresholds``), its softmax rows within J_CONF_TOL of the
      offline rows; it prints the per-feed wall (p50, p99), the real-time
      factor, the B1 launches (one a feed that completes windows), B1's
      device time at a feed's batch of 5 and a feed's device busy time. The
      model through the Keras weight map (``models/export_tf.keras_weight_map``,
      ``models/import_tf.import_weight_map``) into a new model: every tensor
      and the softmax rows on 256 windows ==. Then ``cluster_and_sort`` (the
      card's k-means within J_KMEANS_TOL of the CPU's from the same seeded
      centers), ``run_sweep_point`` (1 epoch x 8 steps; resumes),
      ``run_job`` (its pickled detections == a direct ``eval_stream_test``
      of its saved model; a second call skips), ``streaming_roc`` on that
      pickle and ``analyze_model``, each with its wall and launches.
  (k) the DS-CNN, the native host path, profiling and the build cache, on
      phase e's corpus and the first K_SECONDS of (c)'s stream: the DS-CNN
      at the reference's width (64 filters, 4 blocks, 3 labels) trained
      K_EPOCHS x K_STEPS steps at batch 64 from ``AudioDataset.train_batches``
      (B4 then B1 a step, launches counted) with ``dscnn_optimizer``
      (learning rate checked at steps 0, 12, 24 and 36 epochs in), epoch
      losses finite and falling, one card step against the CPU's from the
      seeded init (same batch, same dropout masks; the bounds above), the
      step time and the batch-eval accuracy; the native host frontend and
      wav loader ``==`` the card (``featurize_files`` native against device,
      ``stream_features``, ``load_batch`` against ``read_wav_int16``) with
      their walls and host threads; a fresh process in another checkout of
      the package that loads every library from the shared build cache and
      compiles nothing, then runs ``utils/profiling.trace`` around one
      ``calculate_streaming_accuracy`` inside a ``PhaseTimer`` phase, its
      Chrome trace holding both stream kernels and the phase's span; and the
      wav2vec2 embedder, which needs ``transformers``: a tiny random model
      (no hub weights) on the card against the CPU, within 1e-4; without the
      package the script says so and checks that the error names it.
  (l) the port's benchmark program and graft entry points: ``bench.main``
      (its preflight: clip_features on 256 clips, stream_prefix and
      stream_suffix on four 2.5 s clips, == the port's copy of micro_exact,
      augment_quantize against its plain version; then the headline at full
      width and batch 2048, float32 and bf16, chained L_TARGET_S a dtype),
      its JSON line printed on a line of its own, B1-B4 launched on its
      path; the pretraining step at batch 512 on fixed feature windows as
      an epoch graph (``train/graphs.EpochGraph``) == the eager steps on
      its first two steps; ``graft_entry.entry()`` on the card against the
      CPU (logits within L_MODEL_TOL); ``graft_entry.dryrun_multichip(1,
      full_size=True)`` over NCCL (its four lines); and
      ``examples/tutorial.run_tutorial`` at full width. Each path's launches
      by kernel go into the kernels line (``phase_l_launches``).
  (m) the inference programs as CUDA graphs (``train/graphs.ProgramGraphs``,
      one graph per input shape after one eager call): the stream's
      batch-2048 predict at float32 and bf16, realtime predicts of 1, 5 and
      25 windows, ``FinetuneResult.predict_fn`` and ``make_embedding_fn`` on
      (e)'s model with host arrays, and the bench's headline step (B1 and
      the B0 in one graph) at float32 and bf16. For each: graphed == eager,
      bitwise, on the key's eager call, its capture and a replay; the first
      replay's output unchanged after a second replay on other inputs; an
      in-place change of the stem's weight moves the output with no
      capture, a swap of its storage recaptures; captures, replays and the
      memory pools printed. Realtime detections through the graphed predict
      == the eager predict's at 20, 100 and 500 ms feeds, the stream's rows
      == at both dtypes. Then graphed against eager in turns (M_TURNS
      each): the headline's clips/s, realtime feed p50 / p99, the stream's
      windows/s. Each graphed path's launches by kernel go into the kernels
      line (``phase_m_launches``: graph replays count).
  (n) the per-step programs as CUDA graphs (``train/graphs.ProgramGraphs``
      with an optimizer and generators), under phase i's NCCL group and
      deterministic cuDNN, each graphed against a twin run eagerly under
      ``graphs.disable_graphs`` (the same calls, seeds and draws), bitwise:
      N_STEPS streaming-pipeline pretraining steps at full width and batch
      64, f32 and bf16 (the transform and step programs; every step's
      metrics, the model, Adam's state, both generators), the
      ``scan_epoch=False`` fused resident step, ``pretrain(resident_data=
      False)`` (history, model, generator), ``transfer_learn(resident=
      False)`` from a fresh B0 (history, model, Adam's state, generator),
      three validation passes, ``kmeans_fit`` and ``cluster_and_sort``;
      each program's eager calls, captures and replays checked, and B4 and
      B1 launched once a step. One profiled pair of graphed streaming steps
      shows both kernels launched by cudaGraphLaunch. Then graphed against
      eager in turns (N_TURNS each): the step at batch 64 (f32, bf16),
      one validation pass, ``cluster_and_sort``; captures and pool sizes
      printed, each graphed path's launches into the kernels line
      (``phase_n_launches``).
  (o) the frontend's entry points and the resident train transform as CUDA
      graphs (``MicroFrontendTorch.features``, ``features_from_int16``,
      ``stream_features``; ``AudioDataset.resident_specs``), each graphed
      against a twin run eagerly under ``graphs.disable_graphs``, bitwise:
      exact ``features`` on O_CLIPS one-second clips (B1), exact
      ``features_from_int16`` on O_LONG_CLIPS 10 s clips (B6 + B3), fast
      ``features`` on O_CLIPS clips (B5, cuFFT; graphed with TF32 allowed,
      which its GEMM must not use), ``stream_features`` on phase c's stream
      in O_CHUNK_S s chunks (B2 + B3; the last chunk's window count its own
      program), realtime detections at 20, 100 and 500 ms feeds,
      ``featurize_files`` and ``file2spec`` on phase e's corpus, O_RESIDENT
      ``train_batches_resident`` batches and the generator's state after
      them, and ``pretrain(resident_data=True)``'s BN calibration (under
      phase i's NCCL group and deterministic cuDNN); each program's eager
      calls, captures and replays checked; in a fresh process (FRESH_O),
      profiled replays of each program at phase o's shapes show B1-B6
      launched by cudaGraphLaunch and no wrapper called. Then graphed
      against eager in turns
      (O_TURNS each): realtime feed p50 / p99 (the predict graphed on both
      sides), the ``featurize_files`` wall, fast ``features`` at O_CLIPS
      clips, one resident batch; pool sizes printed, each graphed path's
      launches into the kernels line (``phase_o_launches``).
  (p) (run right after d) the B0 trunk's inference epilogue
      (``ops/cuda_epilogue.bn_act``) at the scan's batch of 8192 windows of
      phase c's stream: the kernel against its module-path twin at the 18
      BatchNorm sites a float32 inference forward calls (the stem, the 16
      project BatchNorms, the top; float32 within EPILOGUE_F32_RTOL of each
      site's largest value) and at all 49 in bfloat16 (==), the softmax
      against the module path (within EPILOGUE_SOFTMAX_GAP, phase c's
      card-vs-CPU tolerance), one traced eager forward and one traced replay
      of the predict program with no cuDNN BatchNorm or layout-transpose
      kernel, 18 launches a forward and 18 captured, the replay == the eager
      call; the kernel's device time over the 18 sites beside its bytes
      bound. Phase c's timed scan launches it 18 times a predict batch.
  (q) (run right after p) the middle of each MBConv block
      (``ops/cuda_mbconv.mbconv_middle``) at the live feed's batch of 5, the
      fine-tune's 64 and the scan's 8192 windows of phase c's stream, each
      in the form the launch rule takes there: the kernel against its twin
      at the 16 blocks (within MBCONV_RTOL of each block's largest value),
      the per-sample and split forms == each other, the form each batch
      took (its launch counters), 16 captured launches in a predict graph;
      its device time over the 16 blocks beside its bytes bound, the twin's
      time and today's ops before it (bn_act, the pad, cuDNN's depthwise
      convolution, bn_act, the SE mean, the row products, silu, sigmoid,
      the multiply) as the library yardstick. Phase c's timed scan launches
      it 16 times a predict batch.
      Last, one JSON line ``{"kernels": [...]}`` lists all eleven kernels
      (``stream_prefix`` twice: on the stream, B2, and on a clip batch,
      B6).

Kernel times are device times: the mean duration of the kernel's own
events in a ``torch.profiler`` trace of 20 calls (``kernel_ms``), which
also gives the launch's grid; a run whose five traces in a row each hold
fewer than half of those events fails. The wrapper loop's time per call (CUDA events
around 20 calls, ``cuda_ms``) is printed beside it as host µs per call: at
small shapes it measures the Python wrapper's dispatch, not the kernel.
Plain versions are timed by CUDA events.

float32, with TF32 off for cuDNN and matmuls (the precision the port's CPU
tests hold the model to), except where phase i runs bfloat16. Every check that fails raises; the
last line of a run that passes is ``{"ok": true, "device": {...}}``. Without
a CUDA device, or without the package beside this script, it exits 2 and
prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pickle
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
PEAK_FP32_OPS_PER_S = 67e12
# integer operations per unit of work, counted from the algorithm
# (csrc/frontend.cu): per 20 ms frame of the prefix (window 960, max|x|
# 960, shift 480, four radix-4 stages 17920, real post-stage 5120,
# filterbank 2 * 40 * 28, Sqrt64 and >>shift 520) and per output element
# of the suffix (noise estimate 11, PCAN gain 15, shrink 5, log 19, scale 2)
PREFIX_OPS_PER_FRAME = 960 + 960 + 480 + 17920 + 5120 + 2 * 40 * 28 + 520
SUFFIX_OPS_PER_ELEMENT = 52
# float operations per sample of augment_quantize (csrc/augment.cu): pass 1
# converts, scales and squares the foreground and squares the background,
# with two sums (6); pass 2 converts and scales the foreground, multiplies
# and adds the background, clamps, scales, truncates and clamps (11)
AUGMENT_OPS_PER_SAMPLE = 6 + 11
# float operations per (window, frame, channel) of noise_scan_f32
# (csrc/fast.cu): two products, the fused multiply-add (2), the division
# and the floor
NOISE_SCAN_OPS_PER_ELEMENT = 6
# integer operations per row of fft_energy: the four radix-4 stages and the
# real post-stage with the energies, as counted for the prefix above
FFT_OPS_PER_ROW = 17920 + 5120
PEAK_BF16_FLOPS = 989e12  # tensor cores, dense (NVIDIA data sheet)
GRID_STEP = 10.0 / 256.0  # one step of the features' uint16 grid
FT_BATCH = 64  # the fine-tune's batch (the JAX package's default)
GRAPH_EPOCHS = 5  # phases e, i: timed epochs of the graphed and the eager loop, in turns, after one warm epoch
FT_SHOTS = 5
LONG_CLIPS = 64  # 10 s clips through features_from_int16: the prefix on a clip batch (B6)
THRESHOLDS_H = [0.9, 0.8, 0.7, 0.6, 0.5, 0.4]  # phase h: the CLI's default first
# phase h: a fresh CLI process's confidences against this process's. Both
# compute in float32 with TF32 off; a fresh process may only pick other
# cuDNN algorithms, whose float32 sums round in another order (~1e-6 of a
# softmax score); 1e-5 is the CPU tests' softmax tolerance
# (tests/test_torch_stream.py), and a confidence is a mean of such scores
FRESH_CONF_TOL = 1e-5
# phase i: a synthesized 761-label corpus (760 words and _silence_ at the
# JAX defaults' silence percentage 1): PT_CLIPS one-second clips a word, the
# last to validate; two epochs of PT_STEPS steps at batch 64
PT_WORDS = 760
PT_CLIPS = 3
PT_STEPS = 20
PT_EPOCHS = 2
PT_BATCH = 64
# phase i: the bf16 stream's softmax rows against the float32 ones (the JAX
# package's contract test's bound, tests/test_models_extra.py)
BF16_SOFTMAX_TOL = 0.05
# phase i: the bf16 gate on a model where bf16 moves the rows
# (``bf16_gate_model``): the JAX package's bf16 moves it by these
# (``bf16_gate_stats``) on the CPU; the port's bf16 on the card must move it
# by BF16_GATE_RATIO of that. tests/test_torch_bf16.py measures the JAX
# package on the same model and holds these numbers, and the port's bf16 on
# the CPU, to it
BF16_GATE_JAX = {"softmax mean": 3.502e-3, "embedding mean": 4.585e-3, "embedding p99": 2.550e-2}
BF16_GATE_RATIO = (0.9, 1.1)
# each Conv and BN at bf16: its error over one rounding of its float32
# result (``bf16_op_rounding``), 1 up to the float32 sums' order
BF16_OP_ROUNDING = 1.01


# the work behind each kernel's reported bound: name -> (bytes, operations,
# the peak their operations are priced at); phase g prices it again at the
# rates the card measured
WORK = {}
# stream_suffix's instruction census by layout (channels a thread), from
# phase d; phase g prices it at the measured integer instruction rate
CENSUS = {}


def bound(nbytes, ops, ops_per_s=PEAK_INT32_OPS_PER_S, name=None, bytes_per_s=PEAK_BYTES_PER_S):
    """(least ms for the work, "bytes" or "operations"): the larger of the
    bytes over the memory rate and the operations over their peak rate.
    ``name`` records the work as the one of that kernel's reported bound."""
    if name:
        WORK[name] = (nbytes, ops, ops_per_s)
    t_bytes, t_ops = nbytes / bytes_per_s * 1e3, ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


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


def device_trace(torch, fn, iters: int = 1, warmup: int = 1, expect=None):
    """The device's activity over ``iters`` calls of fn (after ``warmup``
    calls), by torch.profiler's CUDA activity: the trace's device events
    (kernels, copies and sets, each with its name, start and duration in µs
    and, for a kernel, its grid and block) and the wall seconds of the
    profiled calls, which end in a synchronize. A trace may miss an event
    at its start, and now and then comes back with few or none: the calls
    start 20 ms into the trace, and with ``expect`` = (name, n) it is taken
    again, up to five times, until it holds at least n kernels of that name
    (each retry is printed); if none does, it fails."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(5):
        if attempt:
            print(f"device_trace: {got} {expect[0]} events of {expect[1]} wanted; trace {attempt + 1}")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)
            t = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text())["traceEvents"]
        kinds = ("kernel", "gpu_memcpy", "gpu_memset")
        events = [e for e in events if e.get("ph") == "X" and e.get("cat") in kinds]
        if expect is None:
            break
        got = sum(e["cat"] == "kernel" and expect[0] in e["name"] for e in events)
        if got >= expect[1]:
            break
    else:
        fail(f"{expect[0]}: {got} device events in the trace, expected at least {expect[1]}")
    return events, wall


def busy_us(spans) -> float:
    """Device busy time: the length of the union of (start, end) spans."""
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy


def kernel_ms(torch, fn, kernel: str, iters: int = 20):
    """A kernel's own device time: the mean duration (ms) of the device
    events whose name holds ``kernel`` over ``iters`` calls of fn, each of
    which launches it once (the mean is over the events the trace holds,
    at least half of them, or the run fails); and that launch's grid and
    block."""
    events, _ = device_trace(torch, fn, iters, expect=(kernel, iters // 2))
    hits = [e for e in events if e["cat"] == "kernel" and kernel in e["name"]]
    args = hits[0].get("args", {})
    return sum(e["dur"] for e in hits) / len(hits) / 1e3, args.get("grid"), args.get("block")


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


def tone_clip(rng, freqs):
    """A 1 s clip: a noise floor and a tone sequence (sqrt-sine envelopes, as
    in synth_stream) at a random onset, as float32."""
    x = rng.normal(0, 0.004, SR) * rng.uniform(0.3, 3.0)
    segs = []
    for f in freqs:
        tt = np.arange(int(rng.uniform(0.12, 0.22) * SR)) / SR
        env = np.sqrt(np.clip(np.sin(np.pi * tt / tt[-1]), 0, 1))
        segs.append(rng.uniform(0.2, 0.5) * env * np.sin(2 * np.pi * f * rng.uniform(0.96, 1.04) * tt))
    sig = np.concatenate(segs)[:SR]
    onset = int(rng.integers(0, SR - sig.shape[0] + 1))
    x[onset : onset + sig.shape[0]] += sig
    return np.clip(x, -1, 1).astype(np.float32)


def synth_corpus(root: Path, seed: int, write_wav):
    """Seeded few-shot corpus: 'alpha' keyword clips (the stream's tone
    sequence; FT_SHOTS to train on, 20 to validate), 40 unknown clips (other
    tone sequences and chirps) and three 8 s background noise wavs."""
    rng = np.random.default_rng(seed)
    out = {"train": [], "val": [], "unknown": []}
    for i in range(FT_SHOTS + 20):
        path = root / "alpha" / f"alpha_{i}.wav"
        write_wav(path, tone_clip(rng, (350, 700, 450)), SR)
        out["train" if i < FT_SHOTS else "val"].append(str(path))
    t = np.arange(SR) / SR
    for i in range(40):
        path = root / "unknown" / f"unknown_{i}.wav"
        if i % 4:
            wave = tone_clip(rng, tuple(rng.uniform(900, 3300, 3)))
        else:
            wave = 0.3 * np.sin(2 * np.pi * (rng.uniform(400, 1500) + 1500 * t) * t)
        write_wav(path, np.clip(wave + rng.normal(0, 0.01, SR), -1, 1), SR)
        out["unknown"].append(str(path))
    for i in range(3):
        noise = rng.normal(0, 0.05, 8 * SR) * np.repeat(rng.uniform(0.3, 2.0, 8), SR)
        write_wav(root / "_background_noise_" / f"noise_{i}.wav", np.clip(noise, -1, 1), SR)
    out["bg_dir"] = str(root / "_background_noise_")
    return out


def profile_run(torch, runs, out_dir: Path):
    """Where each run's time goes. ``runs``: (name, run, kernel-name
    substrings to group device time by). For each: three timed runs (the
    spread), then one run under torch.profiler: device busy time (the union
    of device activity), its split by kind, and the idle share of the wall
    time. Device activity is the trace's kernels, copies and sets (not the
    annotations of CPU ranges that the optimizer places on the
    device's timeline). Writes each chrome trace to out_dir."""
    from torch.profiler import ProfilerActivity, profile

    for name, run, kinds in runs:
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
        out_dir.mkdir(parents=True, exist_ok=True)
        trace = out_dir / f"{name}_trace.json"
        prof.export_chrome_trace(str(trace))
        spans = sorted(
            (e["ts"], e["ts"] + e["dur"], e["name"])
            for e in json.loads(trace.read_text())["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
        )
        busy = busy_us((lo, hi) for lo, hi, _ in spans)
        by_kind = {}
        for lo, hi, event in spans:
            kind = next((k for k in kinds if k in event.lower()), "model_and_other")
            by_kind[kind] = by_kind.get(kind, 0.0) + (hi - lo) / 1e3
        top = sorted(
            ((e.self_device_time_total / 1e3, e.key) for e in prof.key_averages()), reverse=True
        )[:8]
        print(
            f"profile {name}: wall of 3 runs {walls} s; profiled run {wall} s, device busy "
            f"{busy / 1e3} ms ({len(spans)} device events), idle share {1 - busy / 1e6 / wall}; "
            f"device ms by kind {by_kind}; top ops by device ms {top}"
        )

SUFFIX_WINDOWS = (1, 63, 65)
SUFFIX_STRIDES = (1, 7, 49)
SUFFIX_LAYOUTS = (1, 4)  # channels a thread
SUFFIX_SWEEP = (4096, 8192, 12288, 16384, 20480, 24576, 27000)  # stream windows, both layouts timed


def frontend_variants(fe):
    """The default frontend and the cost probe's diagnostic ones (PCAN off,
    log off)."""
    from multilingual_kws_tpu_torch.ops.micro_exact import FrontendConfig
    from multilingual_kws_tpu_torch.ops.micro_torch import MicroFrontendTorch

    return {"default": fe,
            "no_pcan": MicroFrontendTorch(FrontendConfig(enable_pcan=False), device="cuda"),
            "no_log": MicroFrontendTorch(FrontendConfig(enable_log=False), device="cuda")}


def suffix_grid(torch, fe, dev) -> int:
    """stream_suffix == plain over every caller's shape: 1, 63 and 65
    windows of 49 frames at strides 1, 7 and 49, and one window of 5999
    frames (a 2-minute clip at stride F); each frontend variant, scaled and
    raw, each layout. Returns the number of comparisons."""
    from multilingual_kws_tpu_torch.ops import cuda_fft, cuda_frontend

    wave, _ = synth_stream(120, seed=7)
    audio = torch.from_numpy(np.clip(np.trunc(wave * 32768.0), -32768, 32767).astype(np.int16)).to(dev)
    base = cuda_fft.stream_prefix(audio[None], fe)[0]
    shapes = [(n, st, 49) for n in SUFFIX_WINDOWS for st in SUFFIX_STRIDES] + [(1, base.shape[0], base.shape[0])]
    n_cmp = 0
    for name, f in frontend_variants(fe).items():
        for n, stride, frames in shapes:
            for scaled in (True, False):
                want = cuda_frontend.stream_suffix_plain(base, n, stride, frames, f, scaled=scaled)
                for cpt in SUFFIX_LAYOUTS:
                    got = cuda_frontend.launch_suffix(base, n, stride, frames, f, scaled, cpt)
                    torch.cuda.synchronize()
                    check(torch.equal(got, want),
                          f"suffix != plain: {name}, {n} windows, stride {stride}, {frames} frames, "
                          f"scaled={scaled}, {cpt} channels a thread")
                    n_cmp += 1
    return n_cmp


class _LastBatch:
    """A frontend that keeps a copy of the int16 batch it featurizes (the
    augment kernel's output) and of its features (the frontend kernel's)
    from its last call. In a CUDA graph the copies are nodes of the graph,
    so after a replay they hold that replay's batch."""

    def __init__(self, fe):
        self.fe, self.last = fe, None

    def features_from_int16(self, audio):
        feats = self.fe.features_from_int16(audio)
        self.last = (audio.clone(), feats.clone())
        return feats


def tensor_diffs(torch, a, b, prefix=""):
    """{name: max |a - b|} over the tensors of two nested dicts or lists
    (state dicts, optimizer states) where they are not ==; a tensor missing
    on one side, or of another shape, counts as a difference."""
    out = {}
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)) or a.shape != b.shape:
            return {prefix: "missing or another shape"}
        if not torch.equal(a.cpu(), b.cpu()):
            out[prefix] = float((a.cpu().double() - b.cpu().double()).abs().max())
        return out
    if isinstance(a, dict):
        for k in set(a) | set(b):
            out.update(tensor_diffs(torch, a.get(k), b.get(k), f"{prefix}.{k}"))
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            out.update(tensor_diffs(torch, x, y, f"{prefix}.{i}"))
    elif a != b:
        out[prefix] = f"{a} != {b}"
    return out


def epochs_in_turns(torch, sides, inputs, before_last=None):
    """Run each side's epoch (name -> epoch(idx, lbl, sil) -> (losses, accs))
    on the same inputs, in turns, one epoch of each per entry of ``inputs``;
    ``before_last()`` runs before the last turn. Returns per side the ms a
    step of each epoch (wall to a synchronize) and every epoch's losses and
    accuracies on the host."""
    out = {name: {"ms": [], "metrics": []} for name in sides}
    for k, batch in enumerate(inputs):
        if k == len(inputs) - 1 and before_last:
            before_last()
        for name, run in sides.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses, accs = run(*batch)
            torch.cuda.synchronize()
            out[name]["ms"].append((time.perf_counter() - t0) / batch[0].shape[0] * 1e3)
            out[name]["metrics"].append((losses.cpu(), accs.cpu()))
    return out


def graph_trace(torch, run, steps: int):
    """One graphed epoch (``run()``, all its steps replays) under
    torch.profiler, host and device: its wall, the device's busy time (ms)
    and idle share, the host's cudaGraphLaunch calls, and for the augment and
    frontend kernels of the epoch the host call that launched each (by
    correlation id). A trace that holds fewer than steps - 2 frontend
    kernels is taken again, up to five times."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    for attempt in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text())["traceEvents"]
        device = [e for e in events if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
        if sum("clip_features_kernel" in e["name"] for e in device) >= steps - 2:
            break
        print(f"graph_trace: too few frontend kernel events; trace {attempt + 2}")
    else:
        fail("graph_trace: five traces in a row hold too few of the epoch's kernels")
    host = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    by_correlation = {e.get("args", {}).get("correlation"): e["name"] for e in host}
    launched_by = {}
    for kernel in ("augment_quantize_kernel", "clip_features_kernel"):
        names = [by_correlation.get(e["args"].get("correlation"), "unknown")
                 for e in device if e["cat"] == "kernel" and kernel in e["name"]]
        launched_by[kernel] = {n: names.count(n) for n in sorted(set(names))}
    busy = busy_us((e["ts"], e["ts"] + e["dur"]) for e in device) / 1e3
    return {"wall_s": wall, "busy_ms": busy, "idle": 1 - busy / 1e3 / wall,
            "graph_launches": sum("GraphLaunch" in e["name"] for e in host),
            "host_kernel_launches": sum("LaunchKernel" in e["name"] for e in host), "launched_by": launched_by}


def check_graph_trace(tr, steps: int, what: str):
    """A replayed epoch: one cudaGraphLaunch a step, and every augment and
    frontend kernel launched by one of them (none by the host)."""
    check(tr["graph_launches"] == steps, f"{what}: {tr['graph_launches']} cudaGraphLaunch calls for {steps} steps")
    for kernel, by in tr["launched_by"].items():
        check(by and all("GraphLaunch" in n for n in by), f"{what}: {kernel} launched by {by}")


def pair_diffs(torch, turns, graphed, eager):
    """Where a graphed and an eager side of ``epochs_in_turns`` differ:
    each epoch's losses and accuracies, then each side's (model, optimizer,
    generators) after the run. Empty when they hold the same bits."""
    out = {}
    for k, ((lg, ag), (le, ae)) in enumerate(zip(turns["graphed"]["metrics"], turns["eager"]["metrics"])):
        if not (torch.equal(lg, le) and torch.equal(ag, ae)):
            out[f"epoch {k} metrics"] = float(torch.maximum((lg - le).abs().max(), (ag - ae).abs().max()))
    out.update(state_diffs(torch, graphed, eager))
    return out


def state_diffs(torch, graphed, eager):
    """Where two (model, optimizer, generators) triples differ: every tensor
    of the models and of the optimizers' state, the generators' states.
    Empty when they hold the same bits."""
    out = {}
    (mg, og, gg), (me, oe, ge) = graphed, eager
    out.update({f"model{k}": v for k, v in tensor_diffs(torch, mg.state_dict(), me.state_dict()).items()})
    out.update({f"optimizer{k}": v for k, v in tensor_diffs(
        torch, og.state_dict()["state"], oe.state_dict()["state"]).items()})
    out.update({f"generator {i}": "differs" for i, (x, y) in enumerate(zip(gg, ge))
                if not torch.equal(x.get_state(), y.get_state())})
    return out


@contextlib.contextmanager
def deterministic_cudnn(torch):
    """cuDNN restricted to deterministic algorithms inside the block."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def finetune_phase(torch, fe, cases, rng, work: Path, then=None):
    """Phase e: the fine-tune slice on the card (see the module docstring).
    Returns one resident fine-tune epoch as a function (for ``--profile``),
    what ``then(predict, corpus)`` returns (it runs on the fine-tuned
    ``predict_fn``), the fine-tuned model, the synthesized corpus (under
    ``work``) and the ``kernels`` entries of clip_features and
    augment_quantize."""
    import copy

    from multilingual_kws_tpu_torch.data.dataset import AudioDataset
    from multilingual_kws_tpu_torch.models.kws_model import lecun_init_, make_transfer_model
    from multilingual_kws_tpu_torch.ops import cuda_augment, cuda_clip, cuda_fft, cuda_frontend
    from multilingual_kws_tpu_torch.ops.augment import AugmentParams, pad_background_bank
    from multilingual_kws_tpu_torch.ops.micro_exact import FrontendConfig
    from multilingual_kws_tpu_torch.ops.micro_torch import MicroFrontendTorch
    from multilingual_kws_tpu_torch.settings import standard_microspeech_model_settings
    from multilingual_kws_tpu_torch.stream.engine import StreamFlags, calculate_streaming_accuracy
    from multilingual_kws_tpu_torch.train.evaluate import (
        evaluate_files_multiclass,
        evaluate_files_single_target,
    )
    from multilingual_kws_tpu_torch.ops.augment import SpecAugParams
    from multilingual_kws_tpu_torch.train.finetune import _head_and_top, _head_only, transfer_learn
    from multilingual_kws_tpu_torch.train.graphs import WARMUP_STEPS
    from multilingual_kws_tpu_torch.train.steps import make_finetune_epoch_scan, make_finetune_step
    from multilingual_kws_tpu_torch.utils.wav import write_wav

    dev = torch.device("cuda")
    c = fe.num_channels

    # 1. the two kernels against their plain versions
    def clip_check(a_np, what, fe=fe):
        a = torch.from_numpy(np.ascontiguousarray(a_np)).to(dev)
        got = cuda_clip.clip_features(a, fe)
        raw = cuda_clip.clip_features(a, fe, scaled=False)
        torch.cuda.synchronize()
        plain = cuda_clip.clip_features_plain(a, fe)
        check(torch.equal(got, plain), f"clip_features != plain on {what}")
        check(torch.equal(raw, cuda_clip.clip_features_plain(a, fe, scaled=False)),
              f"clip_features (raw) != plain on {what}")
        b, nf = a.shape[0], fe.num_frames(a.shape[1])
        base = cuda_fft.stream_prefix(a, fe).reshape(b * nf, c)
        split = cuda_frontend.stream_suffix(base, b, nf, nf, fe).reshape(got.shape)
        check(torch.equal(got, split), f"clip_features != prefix + suffix on {what}")
        return float((got - plain).abs().max()) if got.numel() else 0.0

    n_clip = 0
    for name, a in cases.items():
        clips = a[: a.shape[0] // SR * SR].reshape(-1, SR) if a.shape[0] >= SR else a[None]
        clip_check(clips, name)
        n_clip += 1
    # 9000 samples; and longer clips, up to the longest that take the kernel
    # (204 frames), whose rows need more than 48 KB of shared memory
    for samples in (9000, 24000, 64160):
        clip_check(np.clip(rng.normal(0, 6000, (3, samples)), -32768, 32767).astype(np.int16),
                   f"{samples} samples")
    loud = rng.uniform(30, 12000, (2048, 1))  # quiet to near full scale, per clip
    clips = np.clip(np.round(rng.normal(0, 1, (2048, SR)) * loud), -32768, 32767).astype(np.int16)
    err_clip = {nb: clip_check(clips[:nb], f"{nb} clips") for nb in (64, 2048)}
    # the cost probe's diagnostic frontends (probes/fft_cost.py): PCAN and
    # log off, log off
    for cfg in (FrontendConfig(enable_pcan=False, enable_log=False), FrontendConfig(enable_log=False)):
        other = MicroFrontendTorch(cfg, device="cuda")
        for nb in (64, 2048):
            clip_check(clips[:nb], f"{nb} clips, {cfg}", fe=other)
    clips_dev = torch.from_numpy(clips).to(dev)
    # audio longer than the fused kernel takes (10 s clips, 499 frames):
    # features_from_int16 runs the prefix on the clip batch (B6) and the
    # suffix at stride F; each is held == plain on that batch, and B6's
    # kernels entry is timed and bounded there
    loud = rng.uniform(30, 12000, (LONG_CLIPS, 1))
    long_audio = torch.from_numpy(np.clip(np.round(rng.normal(0, 1, (LONG_CLIPS, 10 * SR)) * loud),
                                          -32768, 32767).astype(np.int16)).to(dev)
    cuda_fft.stream_prefix.launches = cuda_frontend.stream_suffix.launches = 0
    long_feats = fe.features_from_int16(long_audio)
    launches_long = {"stream_prefix": cuda_fft.stream_prefix.launches,
                     "stream_suffix": cuda_frontend.stream_suffix.launches}
    torch.cuda.synchronize()
    check(launches_long == {"stream_prefix": 1, "stream_suffix": 1}, f"10 s clips: launches {launches_long}")
    check(torch.equal(long_feats, cuda_clip.clip_features_plain(long_audio, fe)), "features of 10 s clips != plain")
    long_base = cuda_fft.stream_prefix(long_audio, fe)
    torch.cuda.synchronize()
    long_plain = cuda_fft.stream_prefix_plain(long_audio, fe)
    err_prefix_long = float((long_base.to(torch.int64) - long_plain.to(torch.int64)).abs().max())
    check(torch.equal(long_base, long_plain), f"stream_prefix != plain on 10 s clips: {err_prefix_long}")
    nf_long = long_base.shape[1]
    long_base = long_base.reshape(-1, c)
    check(torch.equal(cuda_frontend.stream_suffix(long_base, LONG_CLIPS, nf_long, nf_long, fe),
                      cuda_frontend.stream_suffix_plain(long_base, LONG_CLIPS, nf_long, nf_long, fe)),
          "stream_suffix != plain on 10 s clips")
    del long_feats, long_plain, long_base
    a32 = clips_dev[:64].to(torch.int32)
    check(torch.equal(fe.features_from_int16(a32), fe.features_from_int16(clips_dev[:64])),
          "int32 audio features differ from int16 audio features on the card")
    a32[0, 0] = 40000
    try:
        fe.features_from_int16(a32)
        fail("int32 audio outside the int16 range was taken")
    except ValueError:
        pass

    sizes = np.array([61234, 17000, 16001], np.int32)
    bank = np.zeros((3, int(sizes.max())), np.float32)
    for i, n in enumerate(sizes):
        bank[i, :n] = rng.normal(0, 0.1, n)
    bg = torch.from_numpy(pad_background_bank(bank, SR)).to(dev)
    bg_sizes = torch.from_numpy(sizes).to(dev)

    def aug_inputs(b, max_shift, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        d = cuda_augment.draw_augment_params(gen, b, SR, bg_sizes, AugmentParams(time_shift_samples=max_shift))
        sil = torch.rand((b,), generator=gen, device=dev) < 0.1
        sil[0] = True
        rows = torch.randint(0, 2048, (b,), generator=gen, device=dev, dtype=torch.int32)
        return rows, sil, d

    def aug_check(b, max_shift, seed):
        rows, sil, d = aug_inputs(b, max_shift, seed)
        got = cuda_augment.augment_quantize(clips_dev, rows, sil, bg, d)
        again = cuda_augment.augment_quantize(clips_dev, rows, sil, bg, d)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"augment_quantize differs between two runs ({b}, {max_shift})")
        want = cuda_augment.augment_quantize_plain(clips_dev, rows, sil, bg, d)
        diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
        unmixed = sil | (d.volume == 0)
        check(torch.equal(got[unmixed], want[unmixed]), f"augment_quantize != plain on unmixed rows ({b}, {max_shift})")
        share = float((diff > 0).to(torch.float64).mean())
        check(int(diff.max()) <= 1 and share < 1e-4,
              f"augment_quantize differs from plain by {int(diff.max())} on a share {share} ({b}, {max_shift})")
        return int(diff.max()), share

    keys = ((11, 1600), (11, 0), (64, 1600), (64, 0), (2048, 1600), (2048, 0))
    err_aug = {key: aug_check(*key, seed=i) for i, key in enumerate(keys)}
    print(f"phase e: clip_features == plain and == prefix + suffix on {n_clip} edge cases cut into clips, "
          f"clips of 9000, 24000 and 64160 samples, 64 and 2048 clips (max |kernel - plain| "
          f"{err_clip}), and at 64 and 2048 clips with PCAN and log off and with log off; int32 audio == "
          f"int16 audio; augment_quantize == itself on a second run, and (rows, max_shift): (max "
          f"|kernel - plain| in int16 steps, share of samples that differ) {err_aug}; features_from_int16 on "
          f"{LONG_CLIPS} 10 s clips == plain, stream_prefix and stream_suffix == plain on them, "
          f"launches {launches_long}")

    # 2. the slice: transfer_learn at the JAX defaults, then one epoch of phase 2
    corpus = synth_corpus(work / "corpus", 5, write_wav)
    common = dict(
        target="alpha", train_files=corpus["train"], val_files=corpus["val"],
        unknown_files=corpus["unknown"], bg_datadir=corpus["bg_dir"], batch_size=FT_BATCH,
        device="cuda", verbose=1,
    )
    model = lecun_init_(make_transfer_model(device="cpu"), seed=0).to(dev)
    init = {k: t.detach().clone() for k, t in model.named_parameters()}
    cuda_clip.clip_features.launches = 0
    cuda_augment.augment_quantize.launches = 0
    t0 = time.perf_counter()
    r1 = transfer_learn(**common, seed=0, model=model)
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t0
    after1 = {k: t.clone() for k, t in model.state_dict().items()}
    t0 = time.perf_counter()
    r2 = transfer_learn(
        **common, num_epochs=1, seed=1, model=model, base_params=after1,
        backprop_into_embedding=True, embedding_lr=1e-4,
    )
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    launches = {
        "clip_features": cuda_clip.clip_features.launches,
        "augment_quantize": cuda_augment.augment_quantize.launches,
    }

    # 3. checks
    steps1 = [l for ep in r1.history[0]["step_loss"] for l in ep]
    steps2 = [l for h in r2.history for ep in h["step_loss"] for l in ep]
    check(len(steps1) == 4 * FT_BATCH and len(steps2) == 2 * FT_BATCH, "wrong number of steps")
    check(np.isfinite(steps1 + steps2).all(), "a non-finite loss")
    ep_loss = r1.history[0]["loss"]
    check(ep_loss[-1] < ep_loss[0], f"epoch losses did not fall: {ep_loss}")
    for k, t in init.items():
        if not k.startswith("transfer_head."):
            check(torch.equal(after1[k], t), f"phase 1 changed {k}")
    check(any(not torch.equal(after1[k], init[k]) for k in init if k.startswith("transfer_head.")),
          "phase 1 left the head unchanged")
    after2 = model.state_dict()
    for k, t in after2.items():
        frozen = "bn." in k or (k.startswith("trunk.") and not k.startswith("trunk.top.conv."))
        if frozen:
            check(torch.equal(t, after1[k]), f"phase 2 changed {k}")
    check(not torch.equal(after2["trunk.top.conv.weight"], after1["trunk.top.conv.weight"]),
          "phase 2 left trunk.top.conv unchanged")
    n_train = 2 + len(steps1) + len(steps2)  # 2 calibration batches
    check(launches["augment_quantize"] == n_train,
          f"augment_quantize launched {launches['augment_quantize']} times for {n_train} train batches")
    check(launches["clip_features"] >= n_train, f"clip_features launched {launches['clip_features']} times")
    # every resident epoch ran as a CUDA graph: WARMUP_STEPS eager steps in
    # each phase's first epoch, then replays
    graphs_used = [h["graph"] for h in r1.history + r2.history]
    replays = [g["replays"] for g in graphs_used]
    check(replays == [4 * FT_BATCH - WARMUP_STEPS, FT_BATCH - WARMUP_STEPS, FT_BATCH - WARMUP_STEPS],
          f"graph replays {replays}")

    # graphed == eager, bitwise: the same two calls on the streaming
    # pipeline, which runs a step at a time, from the same start and seeds:
    # every step's loss and accuracy, the model after each call, each
    # call's last optimizer state and its dataset's generator
    model_e = lecun_init_(make_transfer_model(device="cpu"), seed=0).to(dev)
    eager = dict(common, verbose=0, resident=False)
    e1 = transfer_learn(**eager, seed=0, model=model_e)
    after1_e = {k: t.clone() for k, t in model_e.state_dict().items()}
    e2 = transfer_learn(**eager, num_epochs=1, seed=1, model=model_e, base_params=after1_e,
                        backprop_into_embedding=True, embedding_lr=1e-4)
    twin = {}
    for name, g, e in (("call 1", r1, e1), ("call 2", r2, e2)):
        for i, (hg, he) in enumerate(zip(g.history, e.history)):
            for k in ("step_loss", "step_accuracy"):
                if hg[k] != he[k]:
                    twin[f"{name} phase {i + 1} {k}"] = float(np.abs(np.subtract(hg[k], he[k])).max())
        twin.update({f"{name} optimizer{k}": v for k, v in tensor_diffs(
            torch, g.optimizer.state_dict()["state"], e.optimizer.state_dict()["state"]).items()})
        if not torch.equal(g.dataset.gen.get_state(), e.dataset.gen.get_state()):
            twin[f"{name} generator"] = "differs"
    twin.update({f"model after call 1{k}": v for k, v in tensor_diffs(torch, after1, after1_e).items()})
    twin.update({f"model{k}": v for k, v in tensor_diffs(torch, model.state_dict(), model_e.state_dict()).items()})
    check(not twin, f"graphed transfer_learn != eager: {twin}")
    del model_e, e1, e2

    # one step on the card against the same step on the CPU
    specs, labels = next(r2.dataset.train_batches(corpus["train"], FT_BATCH, 1))
    got = {}
    for where, m, x, y in (
        ("cuda", copy.deepcopy(model), specs, labels),
        ("cpu", copy.deepcopy(model).cpu(), specs.cpu(), labels.cpu()),
    ):
        step, _, _ = make_finetune_step(m, 1e-3, _head_and_top)
        loss = float(step(x, y)["loss"])
        got[where] = loss, {n: p.grad.cpu() for n, p in m.named_parameters() if p.requires_grad}
    (lg, gg), (lc, gc) = got["cuda"], got["cpu"]
    check(abs(lg - lc) <= 1e-5 * abs(lc), f"step loss {lg} on the card, {lc} on the CPU")
    step_err = 0.0
    for n, w in gc.items():
        scale = float(w.abs().max())
        err = float((gg[n] - w).abs().max())
        check(torch.allclose(gg[n], w, rtol=1e-4, atol=1e-4 * scale), f"gradient of {n}: {err} (max {scale})")
        step_err = max(step_err, err / max(scale, 1e-30))

    predict = r2.predict_fn()
    files = corpus["val"] + corpus["unknown"][:20]
    conf, preds = evaluate_files_single_target(files, 2, predict)
    check(preds.shape == (len(files), 3) and np.isfinite(preds).all(), "batch eval rows")
    check(np.abs(preds.sum(1) - 1).max() < 1e-4, "batch eval rows do not sum to 1")
    multi = evaluate_files_multiclass(corpus["val"], 2, predict)
    check(len(multi["correct"]) + len(multi["incorrect"]) == len(corpus["val"]), "multiclass eval")
    wave, labels30 = synth_stream(30, seed=3)
    wav, gt = work / "stream30.wav", work / "labels30.txt"
    write_wav(wav, wave, SR)
    gt.write_text("".join(f"{lab}, {ms}\n" for lab, ms in labels30))
    flags = StreamFlags(wav=str(wav), ground_truth=str(gt), target_keyword="alpha",
                        detection_thresholds=[0.5, 0.9])
    _, inferences = calculate_streaming_accuracy(predict, [flags], batch_size=BATCH, verbose=False)
    n_w30 = -(-(30 * SR - SR) // 320)
    check(inferences.shape == (n_w30, 3) and np.isfinite(inferences).all(), "stream inferences")

    # the streaming pipeline (host batches uploaded by the prefetch
    # thread) and the resident one give the same specs for one seed
    pipes = []
    for resident in (False, True):
        ds = AudioDataset(standard_microspeech_model_settings(3), ["alpha"], corpus["bg_dir"],
                          corpus["unknown"], unknown_percentage=50.0, seed=7, device="cuda")
        it = (ds.train_batches_resident(corpus["train"], FT_BATCH, 3) if resident
              else ds.train_batches(corpus["train"], FT_BATCH, 3, prefetch=2))
        pipes.append(list(it))
    check(all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) for a, b in zip(*pipes)),
          "the streaming and resident pipelines differ on the card")
    after = then(predict, corpus) if then else None

    # 4. times: the step and its parts, then the kernels
    ds = r2.dataset
    bank_d = ds.build_resident_bank(corpus["train"])
    draws = list(ds.host_train_indices(corpus["train"], FT_BATCH, FT_BATCH, bank_d))
    idx, lbl, sil = ds._put_batch(tuple(np.stack(a) for a in zip(*draws)))
    step, _, _ = make_finetune_step(model, 1e-3, _head_only)

    def transform(i):
        return ds._train_device(bank_d["bank"], idx[i], sil[i])

    x0 = transform(0)
    t_transform = cuda_ms(torch, lambda: transform(0), 20)
    # the transform's device time per batch (the union of its device
    # events), and its two kernels' part of it
    ev, _ = device_trace(torch, lambda: transform(0), 20, expect=("clip_features_kernel", 18))
    n_traced = sum("clip_features_kernel" in e["name"] for e in ev)  # one per batch
    dev_transform = busy_us((e["ts"], e["ts"] + e["dur"]) for e in ev) / n_traced / 1e3
    dev_in_transform = {
        k: sum(e["dur"] for e in ev if k in e["name"]) / n_traced / 1e3
        for k in ("clip_features_kernel", "augment_quantize_kernel")
    }
    with torch.no_grad():
        t_forward = cuda_ms(torch, lambda: model(x0), 20)
    t_step = cuda_ms(torch, lambda: step.fn(x0, lbl[0]), 20)  # the eager step
    # the step time: the graphed epoch (make_finetune_epoch_scan, as
    # transfer_learn runs it; the fine-tuned model) beside the eager step
    # loop (a copy of it), in turns, each side with its own dataset of one
    # seed, on the same bank rows: the same steps on the same draws. Then
    # the two are held ==: every step's loss and accuracy, the model, Adam's
    # state, the generator, and the last step's augment and frontend outputs
    # (copied inside the graph; from the eager wrappers' launches)
    def ft_side():
        d = AudioDataset(standard_microspeech_model_settings(3), ["alpha"], corpus["bg_dir"], corpus["unknown"],
                         unknown_percentage=50.0, spec_aug_params=SpecAugParams(percentage=80), seed=7, device="cuda")
        return d, d.build_resident_bank(corpus["train"])

    (ds_g, bank_g), (ds_e, bank_e) = ft_side(), ft_side()
    model_eager = copy.deepcopy(model)
    rec_g, rec_e = _LastBatch(ds_g.frontend), _LastBatch(ds_e.frontend)
    ds_g.frontend = rec_g
    graphed = make_finetune_epoch_scan(model, 1e-3, _head_only, ds_g, bank_g["bank"])
    step_e, _, _ = make_finetune_step(model_eager, 1e-3, _head_only)

    def eager_epoch(idx, lbl, sil):
        ms = [step_e.fn(ds_e._train_device(bank_e["bank"], idx[i], sil[i]), lbl[i]) for i in range(idx.shape[0])]
        return torch.stack([m["loss"] for m in ms]), torch.stack([m["accuracy"] for m in ms])

    inputs = [ds_g._put_batch(tuple(np.stack(a) for a in zip(*ds_g.host_train_indices(
        corpus["train"], FT_BATCH, FT_BATCH, bank_g)))) for _ in range(GRAPH_EPOCHS + 1)]
    turns = epochs_in_turns(torch, {"graphed": graphed, "eager": eager_epoch}, inputs,
                            before_last=lambda: setattr(ds_e, "frontend", rec_e))
    pair = pair_diffs(torch, turns, (model, graphed.optimizer, [ds_g.gen]),
                      (model_eager, step_e.optimizer, [ds_e.gen]))
    check(not pair, f"graphed fine-tune epochs != eager: {pair}")
    (quant_g, feats_g), (quant_e, feats_e) = rec_g.last, rec_e.last
    check(torch.equal(quant_g, quant_e) and torch.equal(feats_g, feats_e),
          "the augment and frontend outputs of a replayed step != the eager wrappers' on the same draws")
    check(graphed.replays == (GRAPH_EPOCHS + 1) * FT_BATCH - WARMUP_STEPS, f"{graphed.replays} replays")
    ms_graph, ms_steps = turns["graphed"]["ms"][1:], turns["eager"]["ms"][1:]
    ms_step = float(np.median(ms_steps))
    # one more epoch of each under the profiler: the device busy time and
    # the idle share of the wall; the graphed one launches its steps as
    # graphs
    tr_ft = graph_trace(torch, lambda: graphed(*inputs[-1]), FT_BATCH)
    check_graph_trace(tr_ft, FT_BATCH, "fine-tune")
    ev, wall_epoch = device_trace(torch, lambda: eager_epoch(*inputs[-1]), 1, warmup=0,
                                  expect=("clip_features_kernel", FT_BATCH - 2))
    busy_epoch = busy_us((e["ts"], e["ts"] + e["dur"]) for e in ev) / 1e3
    idle_epoch = 1 - busy_epoch / 1e3 / wall_epoch

    # each kernel's device time (profiler), the wrapper loop's time per call
    # (CUDA events around 20 calls: host dispatch where that is longer than
    # the kernel), the plain version's, the bound and the launch's grid
    times, host, plain, bounds, grids = {}, {}, {}, {}, {}
    nf = fe.num_frames(SR)
    for nb in (64, 2048):
        a = clips_dev[:nb]
        rows, sil_t, d = aug_inputs(nb, 1600, seed=nb)
        runs = {
            "clip": ("clip_features_kernel", lambda: cuda_clip.clip_features(a, fe),
                     lambda: cuda_clip.clip_features_plain(a, fe)),
            "aug": ("augment_quantize_kernel",
                    lambda: cuda_augment.augment_quantize(clips_dev, rows, sil_t, bg, d),
                    lambda: cuda_augment.augment_quantize_plain(clips_dev, rows, sil_t, bg, d)),
        }
        for k, (kernel, run, run_plain) in runs.items():
            times[k, nb], grids[k, nb], _ = kernel_ms(torch, run, kernel)
            host[k, nb] = cuda_ms(torch, run, 20) * 1e3
            plain[k, nb] = cuda_ms(torch, run_plain, 3)
        bounds["clip", nb] = bound(nb * SR * 2 + nb * nf * c * 4,
                                   nb * nf * (PREFIX_OPS_PER_FRAME + c * SUFFIX_OPS_PER_ELEMENT),
                                   name="clip_features" if nb == 64 else f"clip_features@{nb}")
        # int16 row in, float32 crop in, int16 out; per clip 21 bytes of draws
        bounds["aug", nb] = bound(nb * (SR * (2 + 4 + 2) + 21), nb * SR * AUGMENT_OPS_PER_SAMPLE,
                                  PEAK_FP32_OPS_PER_S,
                                  name="augment_quantize" if nb == 64 else f"augment_quantize@{nb}")
    print(
        f"phase e: transfer_learn {wall1:.2f} s (calibration, {len(steps1)} steps, 4 evals), "
        f"then {wall2:.2f} s ({len(steps2)} steps over phases 1 and 2, 2 evals); val accuracy "
        f"{r1.details['val_accuracy']:.4f} after phase 1, {r2.details['val_accuracy']:.4f} after phase 2; "
        f"epoch losses {ep_loss}; launches {launches}; card vs CPU step: loss {lg:.7f} / {lc:.7f}, "
        f"max gradient error {step_err:.2e} of each tensor's largest"
    )
    ms_g = float(np.median(ms_graph))
    print(
        f"phase e: fine-tune step at batch {FT_BATCH}, epochs in turns (median of {GRAPH_EPOCHS}, best, all): "
        f"graphed {ms_g:.3f} ms (best {min(ms_graph):.3f}: {[round(m, 3) for m in ms_graph]}; "
        f"{FT_BATCH * 1e3 / ms_g:.0f} clips/s), eager {ms_step:.3f} ms (best {min(ms_steps):.3f}: "
        f"{[round(m, 3) for m in ms_steps]}; {FT_BATCH * 1e3 / ms_step:.0f} clips/s), eager / graphed "
        f"{ms_step / ms_g:.2f}; the first graphed epoch {turns['graphed']['ms'][0]:.3f} ms a step "
        f"({WARMUP_STEPS} eager step, then the capture, {graphed.capture_s:.4f} s); by CUDA events: transform "
        f"(augment, frontend, SpecAugment) {t_transform:.3f} ms, model forward {t_forward:.3f} ms, step (forward, "
        f"head backward, Adam) {t_step:.3f} ms; transform device time {dev_transform:.4f} ms per batch (device ms "
        f"of its kernels {dev_in_transform}); one profiled graphed epoch of {FT_BATCH} steps: wall "
        f"{tr_ft['wall_s']:.4f} s, device busy {tr_ft['busy_ms']:.3f} ms, idle share {tr_ft['idle']:.4f}, "
        f"cudaGraphLaunch {tr_ft['graph_launches']}, host kernel launches {tr_ft['host_kernel_launches']}, the "
        f"kernels launched by {json.dumps(tr_ft['launched_by'])}; one profiled eager epoch: wall {wall_epoch:.4f} s, "
        f"device busy {busy_epoch:.3f} ms, idle share {idle_epoch:.4f}"
    )
    print(
        f"phase e: graphed == eager, bitwise: transfer_learn's two calls (phases 1 and 2; replays {replays}, "
        f"captures {[round(g['capture_s'], 4) for g in graphs_used]} s) against the same calls on the streaming "
        f"pipeline, a step at a time (every step's loss and accuracy, the model after each call, the optimizers' "
        f"state, the generators); {GRAPH_EPOCHS + 1} epochs in turns ({graphed.replays} replays); the last "
        f"replayed step's augment_quantize and clip_features outputs == the eager wrappers' on the same draws"
    )
    # B6 on the 10 s clips whose launches were counted above
    k_long, grid_long, _ = kernel_ms(torch, lambda: cuda_fft.stream_prefix(long_audio, fe), "stream_prefix_kernel")
    p_long = cuda_ms(torch, lambda: cuda_fft.stream_prefix_plain(long_audio, fe), 3)
    b_long = bound(long_audio.numel() * 2 + LONG_CLIPS * nf_long * c * 4, LONG_CLIPS * nf_long * PREFIX_OPS_PER_FRAME,
                   name="stream_prefix_clips")
    print("phase e: kernel device ms (profiler) at 64 / 2048 clips [wrapper loop, host us per call; "
          "plain ms; bound ms (by); grid]: " + "; ".join(
              f"{k} " + " / ".join(
                  f"{times[k, nb]:.5f} [{host[k, nb]:.1f} us; plain {plain[k, nb]:.3f}; bound "
                  f"{bounds[k, nb][0]:.5f} ({bounds[k, nb][1]}); grid {grids[k, nb]}]" for nb in (64, 2048))
              for k in ("clip", "aug"))
          + f"; stream_prefix on {LONG_CLIPS} 10 s clips ({nf_long} frames each) {k_long:.5f} [plain {p_long:.3f}; "
          f"bound {b_long[0]:.5f} ({b_long[1]}); grid {grid_long}]")
    return lambda: graphed(*inputs[-1]), after, model, corpus, [
        {
            "name": "clip_features", "route": "cuda",
            "source": f"{PKG}/csrc/frontend.cu",
            "replaces": "multilingual_kws_tpu/ops/pallas_fft.py:723",
            "launches": launches["clip_features"], "max_abs_err": err_clip[64],
            "ms": times["clip", 64], "plain_ms": plain["clip", 64],
            "bound_ms": bounds["clip", 64][0], "bound_by": bounds["clip", 64][1], "library_ms": None,
        },
        {
            "name": "stream_prefix_clips", "route": "cuda",
            "source": f"{PKG}/csrc/frontend.cu",
            "replaces": "multilingual_kws_tpu/ops/pallas_fft.py:456",
            "launches": launches_long["stream_prefix"], "max_abs_err": err_prefix_long,
            "ms": k_long, "plain_ms": p_long,
            "bound_ms": b_long[0], "bound_by": b_long[1], "library_ms": None,
        },
        {
            "name": "augment_quantize", "route": "cuda",
            "source": f"{PKG}/csrc/augment.cu",
            "replaces": "multilingual_kws_tpu/ops/pallas_augment.py:72",
            "launches": launches["augment_quantize"], "max_abs_err": float(err_aug[64, 1600][0]),
            "ms": times["aug", 64], "plain_ms": plain["aug", 64],
            "bound_ms": bounds["aug", 64][0], "bound_by": bounds["aug", 64][1], "library_ms": None,
        },
    ]


class _Recorder:
    """A frontend that keeps each int16 batch it featurizes (to compare two
    frontends' inputs)."""

    def __init__(self, fe):
        self.fe, self.seen = fe, []

    def features_from_int16(self, audio):
        self.seen.append(audio.clone())
        return self.fe.features_from_int16(audio)


def fast_eval(torch, fe, ff, predict, corpus):
    """Phase f, on phase e's fine-tuned model and corpus: the batch-eval
    helpers with the fast frontend ``ff`` against the exact ``fe``, and one
    training batch of each input pipeline with a fast frontend."""
    from multilingual_kws_tpu_torch.data.dataset import AudioDataset
    from multilingual_kws_tpu_torch.settings import standard_microspeech_model_settings
    from multilingual_kws_tpu_torch.train.evaluate import evaluate_files_single_target, featurize_files

    files = corpus["val"] + corpus["unknown"][:20]
    feats = featurize_files(files, frontend=ff)
    check(feats.shape == (len(files), 49, 40) and np.isfinite(feats).all(), "fast featurize_files")
    conf_f, preds_f = evaluate_files_single_target(files, 2, predict, frontend=ff)
    conf_e, preds_e = evaluate_files_single_target(files, 2, predict, frontend=fe)
    check(np.isfinite(preds_f).all() and np.abs(preds_f.sum(1) - 1).max() < 1e-4, "fast batch-eval rows")
    res = {
        "eval_argmax_agree": float((preds_f.argmax(1) == preds_e.argmax(1)).mean()),
        "eval_max_conf_gap": float(np.abs(conf_f - conf_e).max()),
    }
    recs = {}
    for name, frontend, resident in (("fast", ff, False), ("fast", ff, True), ("exact", fe, False)):
        rec = _Recorder(frontend)
        ds = AudioDataset(standard_microspeech_model_settings(3), ["alpha"], corpus["bg_dir"],
                          corpus["unknown"], unknown_percentage=50.0, seed=7, frontend=rec, device="cuda")
        it = (ds.train_batches_resident(corpus["train"], FT_BATCH, 1) if resident
              else ds.train_batches(corpus["train"], FT_BATCH, 1, prefetch=2))
        recs[name, resident] = rec, list(it)
    (rs, bs), (rr, br) = recs["fast", False], recs["fast", True]
    check(all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) for a, b in zip(bs, br)),
          "the fast frontend's streaming and resident pipelines differ")
    check(bs[0][0].shape == (FT_BATCH, 49, 40, 1) and torch.isfinite(bs[0][0]).all(), "fast training batch")
    re_, be = recs["exact", False]
    check(len(rs.seen) == len(re_.seen) == 1 and torch.equal(rs.seen[0], re_.seen[0]),
          "the fast and exact datasets augmented different int16 batches")
    check(torch.equal(rs.seen[0], rr.seen[0]), "the two pipelines augmented different int16 batches")
    res["train_batch_spec_gap_steps"] = float((bs[0][0] - be[0][0]).abs().max() / GRID_STEP)
    return res


def fast_phase(torch, fe, ff, model, wave, labels, i16, n_w, cases, eval_res, exact):
    """Phase f: the fast frontend mode on the card (see the module
    docstring). Returns the ``kernels`` entry of noise_scan_f32."""
    from multilingual_kws_tpu_torch.ops import cuda_fast, micro_fast
    from multilingual_kws_tpu_torch.ops.micro_torch import MicroFrontendTorch
    from multilingual_kws_tpu_torch.stream.engine import StreamFlags, calculate_streaming_accuracy
    from multilingual_kws_tpu_torch.utils.wav import write_wav

    dev = torch.device("cuda")
    c = ff.num_channels

    # 1. the kernel against its plain version
    def scan_check(base, n, stride, what):
        got = cuda_fast.noise_scan_f32(base, n, stride, 49, ff)
        torch.cuda.synchronize()
        want = cuda_fast.noise_scan_f32_plain(base, n, stride, 49, ff)
        err = float((got - want).abs().max()) if got.numel() else 0.0
        check(torch.equal(got, want), f"noise_scan_f32 != plain on {what}: max {err}")
        return err

    audio = torch.from_numpy(i16).to(dev)
    base_stream = ff.base_frames(audio)  # (T, C) float32
    check(base_stream.dtype == torch.float32 and base_stream.shape == (fe.num_frames(i16.shape[0]), c),
          "fast prefix shape")
    err_scan = scan_check(base_stream, n_w, 1, "the stream")
    rng = np.random.default_rng(6)
    loud = rng.uniform(30, 12000, (2048, 1))
    clips = torch.from_numpy(
        np.clip(np.round(rng.normal(0, 1, (2048, SR)) * loud), -32768, 32767).astype(np.int16)
    ).to(dev)
    for nb in (64, 2048):
        scan_check(ff.base_frames(clips[:nb]).reshape(-1, c), nb, 49, f"{nb} clips")
    n_cmp = 3
    for name, a in cases.items():
        base = ff.base_frames(torch.from_numpy(a).to(dev))
        nw = max(0, -(-(a.shape[0] - SR) // 320))
        if nw:
            scan_check(base, nw, 1, f"{name} (windows)")
            n_cmp += 1
        if a.shape[0] >= SR:
            cb = ff.base_frames(torch.from_numpy(a[: a.shape[0] // SR * SR].reshape(-1, SR)).to(dev))
            scan_check(cb.reshape(-1, c), cb.shape[0], 49, f"{name} (clips)")
            n_cmp += 1

    # 2. the main path: the 10-minute stream through the fast frontend
    with tempfile.TemporaryDirectory() as tmp:
        wav, gt = Path(tmp) / "stream.wav", Path(tmp) / "labels.txt"
        write_wav(wav, wave, SR)
        gt.write_text("".join(f"{lab}, {ms}\n" for lab, ms in labels))
        flags = StreamFlags(wav=str(wav), ground_truth=str(gt), target_keyword="alpha",
                            detection_thresholds=[0.5, 0.7, 0.9])
        calculate_streaming_accuracy(model, [dataclasses.replace(flags, max_chunk_length_sec=30)],
                                     frontend=ff, batch_size=BATCH, verbose=False)  # warm-up
        torch.cuda.synchronize()
        cuda_fast.noise_scan_f32.launches = 0
        t1 = time.perf_counter()
        results, inferences = calculate_streaming_accuracy(model, [flags], frontend=ff, batch_size=BATCH,
                                                           verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = cuda_fast.noise_scan_f32.launches
    check(launches > 0, "noise_scan_f32 was not launched on the fast stream")
    check(inferences.shape == (n_w, 3) and np.isfinite(inferences).all(), "fast stream softmax rows")
    check(np.abs(inferences.sum(1) - 1).max() < 1e-4, "fast stream softmax rows do not sum to 1")
    found = {th: len(r[0]) for th, r in results[0][1].items()}

    # 3. the fast-vs-exact feature gap on the stream, and the card against
    #    the CPU on its first windows (cuFFT against the CPU's FFT)
    fast_w = ff.stream_features(audio, n_w)
    steps = (fast_w - fe.stream_features(audio, n_w)).abs() / GRID_STEP
    gap = {
        "share_differ": float((steps > 0).double().mean()),
        "share_over_2_steps": float((steps > 2).double().mean()),
        "max_steps": float(steps.max()),
    }
    del steps
    cpu_w = MicroFrontendTorch(device="cpu", mode="fast").stream_features(i16[: SR + 255 * 320], 256)
    card_cpu = float((fast_w[:256].cpu() != cpu_w).double().mean())
    del fast_w

    # 4. times
    est = cuda_fast.noise_scan_f32(base_stream, n_w, 1, 49, ff)
    view = micro_fast.windows_view(base_stream, n_w, 1, 49)
    k_scan = kernel_ms(torch, lambda: cuda_fast.noise_scan_f32(base_stream, n_w, 1, 49, ff),
                       "noise_scan_f32_kernel")[0]
    h_scan = cuda_ms(torch, lambda: cuda_fast.noise_scan_f32(base_stream, n_w, 1, 49, ff), 20) * 1e3
    p_scan = cuda_ms(torch, lambda: cuda_fast.noise_scan_f32_plain(base_stream, n_w, 1, 49, ff), 3)
    t_pointwise = cuda_ms(torch, lambda: micro_fast.nr_pcan_log_fast(view, est, ff), 3)
    t_prefix = cuda_ms(torch, lambda: ff.base_frames(audio), 20)
    t_fast_2048 = cuda_ms(torch, lambda: ff.features_from_int16(clips), 10)
    t_exact_2048 = cuda_ms(torch, lambda: fe.features_from_int16(clips), 10)
    out_elems = n_w * 49 * c
    b_scan = bound(base_stream.numel() * 4 + out_elems * 4, out_elems * NOISE_SCAN_OPS_PER_ELEMENT,
                   PEAK_FP32_OPS_PER_S, name="noise_scan_f32")
    print(f"phase f: noise_scan_f32 == plain in {n_cmp} comparisons (the stream's {n_w} windows at "
          f"stride 1, 64 and 2048 clips at stride 49, edge cases); fast stream: {n_w} windows in "
          f"{wall:.3f} s, {n_w / wall:.1f} windows/s (exact {n_w / exact['wall']:.1f}); launches "
          f"{{'noise_scan_f32': {launches}}}; detections per threshold {found} (exact {exact['found']})")
    print(f"phase f: fast vs exact features on the stream: {gap}; fast features on the card vs the CPU "
          f"on 256 windows: share that differ {card_cpu}; batch eval and training batches: {eval_res}")
    print(f"phase f: ms on the stream: fast prefix {t_prefix:.4f}, noise_scan_f32 {k_scan:.5f} by the "
          f"profiler ({h_scan:.1f} us per wrapper call; plain "
          f"{p_scan:.3f}; bound {b_scan[0]:.5f} by {b_scan[1]}), pointwise stages {t_pointwise:.3f}; "
          f"features_from_int16 on 2048 clips: fast {t_fast_2048:.3f}, exact {t_exact_2048:.3f}")
    return [{
        "name": "noise_scan_f32", "route": "cuda",
        "source": f"{PKG}/csrc/fast.cu",
        "replaces": "multilingual_kws_tpu/ops/pallas_frontend.py:33",
        "launches": launches, "max_abs_err": err_scan,
        "ms": k_scan, "plain_ms": p_scan,
        "bound_ms": b_scan[0], "bound_by": b_scan[1], "library_ms": None,
    }]


DOT_ROWS = (64, 128, 192, 25088)
DOT_KS = (0, 1, 5, 64)


def probe_phase(torch, fe, cases):
    """Phase g: fft_energy and the rate probes (see the module docstring).
    Returns the ``kernels`` entries of fft_energy, rate_chain and dot_chain."""
    from multilingual_kws_tpu_torch.ops import cuda_fft
    from multilingual_kws_tpu_torch.probes import fft_cost, rates, sass

    dev = torch.device("cuda")
    rows = BATCH * 49
    rng = np.random.default_rng(4)
    xr, xi = (torch.from_numpy(rng.integers(-32768, 32769, (rows, 256)).astype(np.int32)).to(dev)
              for _ in range(2))
    alt = torch.where(torch.arange(256, device=dev) % 2 == 0, 32768, -32768).to(torch.int32)
    for i, (r, m) in enumerate(((32767, 32767), (-32768, -32768), (32768, -32768), (0, 0))):
        xr[i], xi[i] = r, m
    xr[4], xi[4] = alt, -alt

    def wrapped(e):
        return e.to(torch.int64) & 0xFFFFFFFF

    got = cuda_fft.fft_energy(xr, xi, fe)
    torch.cuda.synchronize()
    want = cuda_fft.fft_energy_plain(xr, xi, fe)
    err_fft = float((wrapped(got) - wrapped(want)).abs().max())
    check(torch.equal(got, want), f"fft_energy != plain at {rows} rows: max {err_fft}")
    del want
    # against the kiss FFT's energies on the stream's own frames
    fft_in, _ = cuda_fft.fft_input(torch.from_numpy(cases["stream_60s"]).to(dev)[None], fe)
    fft_in = fft_in[0]
    fr, fi = fe.kiss(fft_in)
    perm = torch.from_numpy(fe.kiss.perm).to(dev)
    got = cuda_fft.fft_energy(fft_in[:, 0::2][:, perm].to(torch.int32).contiguous(),
                              fft_in[:, 1::2][:, perm].to(torch.int32).contiguous(), fe)
    check(torch.equal(wrapped(got), (fr * fr + fi * fi) & 0xFFFFFFFF),
          "fft_energy != the kiss FFT's energies on the stream's frames")
    n_frames = fft_in.shape[0]
    del fft_in, fr, fi

    cuda_fft.fft_energy.launches = 0
    cost = fft_cost.fft_cost(batch=BATCH, device="cuda")
    launches_fft = cuda_fft.fft_energy.launches
    check(launches_fft > 0, "fft_energy was not launched by the cost probe")
    k_fft = kernel_ms(torch, lambda: cuda_fft.fft_energy(xr, xi, fe), "fft_energy_kernel")[0]
    h_fft = cuda_ms(torch, lambda: cuda_fft.fft_energy(xr, xi, fe), 20) * 1e3
    p_fft = cuda_ms(torch, lambda: cuda_fft.fft_energy_plain(xr, xi, fe), 2)
    b_fft = bound(rows * 256 * 4 * 2 + rows * 257 * 4, rows * FFT_OPS_PER_ROW, name="fft_energy")
    del xr, xi

    # the rate kernels against their plain versions, then the rates
    x, y, xd, w = rates.probe_inputs(dev)
    err_rate = 0.0
    for op in rates.OPS:
        got = rates.rate_chain(x, y, op, 7)
        torch.cuda.synchronize()
        want = rates.rate_chain_plain(x, y, op, 7)
        err_rate = max(err_rate, float((got.to(torch.int64) - want.to(torch.int64)).abs().max()))
        check(torch.equal(got, want), f"rate_chain != plain for {op}")
    err_dot = 0.0
    w_img = rates.swizzled_w(w)
    for rows_d in DOT_ROWS:
        for k in DOT_KS:
            want = rates.dot_chain_plain(xd[:rows_d], w, k)
            got = rates.dot_chain(xd[:rows_d], w, k)
            torch.cuda.synchronize()
            err_dot = max(err_dot, float((got - want).abs().max()))
            check(torch.equal(got, want), f"dot_chain != plain at {rows_d} rows, k={k}")
    del got, want
    rates.rate_chain.launches = rates.dot_chain.launches = 0
    r = rates.measure_rates("cuda")
    launches_rate, launches_dot = rates.rate_chain.launches, rates.dot_chain.launches
    check(launches_rate > 0 and launches_dot > 0, "the rate kernels were not launched by the probe")
    for op in rates.OPS_PER_PASS:
        check(0.8 <= r[op]["linearity"] <= 1.25, f"the {op} chain does not scale with its depth: {r[op]}")
        check(r[op]["ops_per_s"] <= PEAK_INT32_OPS_PER_S, f"{op} above the INT32 peak: a failed probe {r[op]}")
    check(r["copy"]["bytes_per_s"] <= PEAK_BYTES_PER_S, f"copy above the memory peak: {r['copy']}")
    dot = r["dot_bf16"]
    check(0.8 <= dot["linearity"] <= 1.25 and dot["flop_per_s"] <= PEAK_BF16_FLOPS, f"dot chain: {dot}")
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, check=True).stdout.split("\n")[0]
    sm_mhz, max_mhz = (float(v) for v in clock.split(","))

    k1, d2 = rates.DEPTHS[0], rates.DOT_DEPTHS[1]
    n = x.numel()
    k_rate = kernel_ms(torch, lambda: rates.rate_chain(x, y, "alu", k1), "rate_chain_kernel")[0]
    k_dot, grid_dot, _ = kernel_ms(torch, lambda: rates.launch_dot_chain(xd, w_img, d2), "dot_chain_kernel")
    p_rate = cuda_ms(torch, lambda: rates.rate_chain_plain(x, y, "alu", k1), 1, warmup=0)
    b_rate = bound(3 * n * 4, n * k1 * rates.OPS_PER_PASS["alu"], name="rate_chain")
    p_dot = cuda_ms(torch, lambda: rates.dot_chain_plain(xd, w, d2), 2)
    flop = 2 * xd.shape[0] * 256 * 256 * d2
    b_dot = bound(xd.numel() * 4 * 2 + 256 * 256 * 2, flop, PEAK_BF16_FLOPS, name="dot_chain")
    # every kernel's bound again, at the rates this card measured: integer
    # operations at the alu chain's rate, bf16 at the dot chain's, bytes at
    # the copy's (float32 stays at the data sheet: no probe measures it)
    measured = {PEAK_INT32_OPS_PER_S: r["alu"]["ops_per_s"], PEAK_BF16_FLOPS: dot["flop_per_s"],
                PEAK_FP32_OPS_PER_S: PEAK_FP32_OPS_PER_S}
    repriced = {
        k: bound(nb, ops, measured[peak], bytes_per_s=r["copy"]["bytes_per_s"]) for k, (nb, ops, peak) in WORK.items()
    }
    print(f"phase g: fft_energy == plain at {rows} rows (extreme rows included) and == the kiss FFT's "
          f"energies on {n_frames} stream frames; decomposition, us per clip at {BATCH} clips: {cost}")
    print(f"phase g: rate_chain == plain for {list(rates.OPS)}, dot_chain == plain at rows {DOT_ROWS} x k "
          f"{DOT_KS}; rates at depths "
          f"{rates.DEPTHS} (dot {rates.DOT_DEPTHS}): " + "; ".join(
              f"{op} {r[op]['ops_per_s'] / 1e12:.3f} T ops/s (linearity {r[op]['linearity']:.3f})"
              for op in rates.OPS_PER_PASS)
          + f" -- data sheet INT32 {PEAK_INT32_OPS_PER_S / 1e12:.1f} T/s; copy "
          f"{r['copy']['bytes_per_s'] / 1e9:.1f} GB/s -- data sheet {PEAK_BYTES_PER_S / 1e9:.0f} GB/s; bf16 "
          f"dot chain (wgmma) {dot['flop_per_s'] / 1e12:.1f} TFLOP/s (linearity {dot['linearity']:.3f}), "
          f"one bf16 torch.matmul pass {dot['matmul_pass_ms']:.4f} ms "
          f"({flop / d2 / dot['matmul_pass_ms'] / 1e9:.1f} TFLOP/s) -- data sheet {PEAK_BF16_FLOPS / 1e12:.0f} "
          f"TFLOP/s; chain ms {[(op, r[op]['ms']) for op in rates.OPS_PER_PASS]}, dot ms {dot['ms']}")
    print(f"phase g: each kernel's bound (ms, by) at the rates this card measured: {repriced}")
    # stream_suffix's instruction-level bound: its census (phase d) at the
    # alu chain's instruction rate (two instructions a pass)
    alu_instr = r["alu"]["ops_per_s"] / rates.OPS_PER_PASS["alu"]
    elems = WORK["stream_suffix"][1] / SUFFIX_OPS_PER_ELEMENT
    print("phase g: stream_suffix's instruction bound (ms) at the stream's shape, census at "
          f"{alu_instr / 1e12:.3f} T integer instructions/s: " + "; ".join(
              f"{cpt} channels a thread {sass.issue_bound_ms(loops[0], elems, alu_instr)}"
              for cpt, loops in CENSUS.items()))
    print(f"phase g: SM clock {sm_mhz:.0f} MHz (maximum {max_mhz:.0f}); the bf16 dot chain's "
          f"{dot['flop_per_s'] / 1e12:.1f} TFLOP/s is {dot['flop_per_s'] / PEAK_BF16_FLOPS:.3f} of the data "
          f"sheet's {PEAK_BF16_FLOPS / 1e12:.0f}; dot_chain grid {grid_dot}")
    print(f"phase g: kernel device ms (profiler): fft_energy {k_fft:.5f} ({h_fft:.1f} us per wrapper call), "
          f"rate_chain alu k={k1} {k_rate:.5f}, dot_chain k={d2} {k_dot:.5f}")
    return [
        {
            "name": "fft_energy", "route": "cuda",
            "source": f"{PKG}/csrc/frontend.cu",
            "replaces": "multilingual_kws_tpu/ops/pallas_fft.py:400",
            "launches": launches_fft, "max_abs_err": err_fft,
            "ms": k_fft, "plain_ms": p_fft,
            "bound_ms": b_fft[0], "bound_by": b_fft[1], "library_ms": None,
        },
        {
            "name": "rate_chain", "route": "cuda",
            "source": f"{PKG}/csrc/probes.cu",
            "replaces": "tools_dev/vpu_roofline.py:60",
            "launches": launches_rate, "max_abs_err": err_rate,
            "ms": k_rate, "plain_ms": p_rate,
            "bound_ms": b_rate[0], "bound_by": b_rate[1], "library_ms": None,
        },
        {
            "name": "dot_chain", "route": "cuda",
            "source": f"{PKG}/csrc/probes.cu",
            "replaces": "tools_dev/vpu_roofline.py:91",
            "launches": launches_dot, "max_abs_err": err_dot,
            "ms": k_dot, "plain_ms": p_dot,
            "bound_ms": b_dot[0], "bound_by": b_dot[1], "library_ms": d2 * dot["matmul_pass_ms"],
        },
    ]


# one CLI call in a fresh interpreter (``-X importtime``): its wall, and the
# first import of torch._dynamo (when and from where); argv[1] is the repo
FRESH_CLI = r"""
import json, sys, time, traceback
t0 = time.perf_counter()
seen = {}


class Spy:
    def find_spec(self, name, path=None, target=None):
        if name == "torch._dynamo" and not seen:
            seen["dynamo_at_s"] = time.perf_counter() - t0
            seen["dynamo_from"] = [
                f"{f.filename.rsplit('site-packages/', 1)[-1]}:{f.lineno} {f.name}"
                for f in traceback.extract_stack()[:-1] if "importlib" not in f.filename
            ][-6:]
        return None


sys.meta_path.insert(0, Spy())
sys.path.insert(0, sys.argv[1])
from multilingual_kws_tpu_torch.api import cli

seen["main_at_s"] = time.perf_counter() - t0
cli.main(sys.argv[2:])
import torch

torch.cuda.synchronize()
print("FRESH " + json.dumps({"wall_s": time.perf_counter() - t0, **seen}))
"""


class _Tee:
    """stdout that is also kept (to read what the CLI printed)."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, s):
        self.parts.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def fresh_cli(argv):
    """``cli.main(argv)`` in a fresh interpreter: its wall in s, when
    ``cli.main`` began, the cumulative s of the imports of torch and
    torch._dynamo by ``-X importtime`` (None where not imported), and when
    and from which frames torch._dynamo was imported."""
    out = subprocess.run([sys.executable, "-X", "importtime", "-c", FRESH_CLI, str(ROOT), *argv],
                         capture_output=True, text=True, timeout=600)
    check(out.returncode == 0, f"fresh CLI call {argv[0]} failed: {out.stderr[-3000:]}")
    res = json.loads([ln for ln in out.stdout.splitlines() if ln.startswith("FRESH ")][-1][6:])
    for name in ("torch", "torch._dynamo"):
        hit = [ln for ln in out.stderr.splitlines() if ln.startswith("import time:") and ln.split("|")[-1].strip() == name]
        res[f"{name}_import_s"] = int(hit[0].split("|")[1]) / 1e6 if hit else None
    return res


def cli_phase(torch, fe, model, corpus, wave, labels, work: Path):
    """Phase h: the user's workflow through the CLI on the card. Phase e's
    fine-tuned model saved as an embedding checkpoint; ``train`` from it at
    the JAX defaults on phase e's corpus; ``inference`` from the result on
    phase c's 10-minute stream; the checkpoints' round trips."""
    import contextlib
    import shutil

    from multilingual_kws_tpu_torch.api import cli
    from multilingual_kws_tpu_torch.api.visualizer import assemble_visualizer_data, install_site
    from multilingual_kws_tpu_torch.ops import cuda_augment, cuda_clip, cuda_fft, cuda_frontend
    from multilingual_kws_tpu_torch.stream.engine import StreamFlags, calculate_streaming_accuracy
    from multilingual_kws_tpu_torch.train import checkpoints as ckpt
    from multilingual_kws_tpu_torch.utils.wav import write_wav

    dev = torch.device("cuda")
    model.eval()
    counters = {"clip_features": cuda_clip.clip_features, "augment_quantize": cuda_augment.augment_quantize,
                "stream_prefix": cuda_fft.stream_prefix, "stream_suffix": cuda_frontend.stream_suffix}

    def reset():
        for fn in counters.values():
            fn.launches = 0

    # 1. phase e's model as an embedding checkpoint (its trunk's BN
    # statistics were calibrated on the card in phase e)
    emb = work / "embedding"
    saves, loads = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save_model(emb, model, {"kind": "embedding", "width_coefficient": 1.0, "depth_coefficient": 1.0})
        saves.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        state, meta = ckpt.load_model(emb, "cuda")
        torch.cuda.synchronize()
        loads.append(time.perf_counter() - t0)
    size = (emb / ckpt.STATE_FILE).stat().st_size
    own = model.state_dict()
    check(list(state) == list(own), "the embedding checkpoint's keys differ from the model's")
    check(all(t.is_cuda and torch.equal(t, own[k]) for k, t in state.items()),
          "a tensor of the embedding checkpoint != phase e's model's")
    check(meta["has_batch_stats"] and meta["format"] == ckpt.FORMAT, f"embedding metadata {meta}")
    # a transfer model rebuilt from the save: softmax rows == the in-memory model's
    n_cmp = 2048
    i16 = np.clip(np.trunc(wave * 32768.0), -32768, 32767).astype(np.int16)
    windows = fe.stream_features(torch.from_numpy(i16[: SR + (n_cmp - 1) * 320]).to(dev), n_cmp)[..., None]
    rebuilt, _ = ckpt.load_transfer_model(emb, "cuda")
    with torch.inference_mode():
        rows_mem, rows_ckpt = model(windows), rebuilt(windows)
    check(torch.equal(rows_mem, rows_ckpt), "softmax rows of the model rebuilt from its checkpoint != the model's: "
          f"{float((rows_mem - rows_ckpt).abs().max())}")
    del rebuilt, windows

    # 2. phase e's corpus as the CLI expects it
    samples = work / "samples"
    samples.mkdir()
    for f in corpus["train"]:
        shutil.copy2(f, samples)
    unknown = Path(corpus["unknown"][0]).parent
    (unknown / "unknown_files.txt").write_text("".join(Path(f).name + "\n" for f in corpus["unknown"]))
    check(Path(corpus["bg_dir"]).name == "_background_noise_", "background directory name")

    # 3. train at the JAX defaults (4 epochs x 1 batch, batch 64: 256 steps)
    xfer = work / "alpha_model"
    reset()
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        cli.main(["train", "--keyword", "alpha", "--samples-dir", str(samples), "--embedding", str(emb),
                  "--unknown-words", str(unknown), "--background-noise", corpus["bg_dir"], "--output", str(xfer),
                  "--device", "cuda"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches_train = {k: counters[k].launches for k in ("clip_features", "augment_quantize")}

    # 4. frozen tensors ==, the head changed, every epoch's loss finite
    trained, tmeta = ckpt.load_model(xfer, "cuda")
    frozen = [k for k in trained if k.split(".")[0] in ("trunk", "embedding_head")]
    check(frozen and all(torch.equal(trained[k], state[k]) for k in frozen),
          "train changed a trunk or embedding-head tensor")
    check(any(not torch.equal(trained[k], state[k]) for k in trained if k.startswith("transfer_head.")),
          "train left the head unchanged")
    losses = [float(w.split("=")[1]) for ln in "".join(tee.parts).splitlines() if ln.startswith("epoch ")
              for w in ln.split() if w.startswith("loss=")]
    check(len(losses) == 4 and np.isfinite(losses).all(), f"epoch losses {losses}")
    check(tmeta["kind"] == "transfer" and tmeta["width_coefficient"] == 1.0, f"transfer metadata {tmeta}")

    # 5. inference on the 10-minute stream with its ground truth, at the
    # highest threshold of THRESHOLDS_H where the saved model, loaded and
    # run in memory, detects (random trunks rarely pass the CLI's 0.9)
    wav, gt = work / "stream600.wav", work / "labels600.txt"
    write_wav(wav, wave, SR)
    gt.write_text("".join(f"{lab}, {ms}\n" for lab, ms in labels))
    loads_xfer = []
    for _ in range(3):
        t0 = time.perf_counter()
        loaded, _ = ckpt.load_transfer_model(xfer, "cuda")
        torch.cuda.synchronize()
        loads_xfer.append(time.perf_counter() - t0)
    flags = StreamFlags(wav=str(wav), ground_truth=str(gt), target_keyword="alpha",
                        detection_thresholds=THRESHOLDS_H)
    res, _ = calculate_streaming_accuracy(loaded, [flags], batch_size=8192, verbose=False)
    found_at = {th: len(res[0][1][th][1]) for th in THRESHOLDS_H}
    thr = next((th for th in THRESHOLDS_H if found_at[th]), None)
    check(thr is not None, f"the trained model detects nothing at {THRESHOLDS_H}")
    mem = sorted(res[0][1][thr][1], key=lambda d: d[1])
    argv = ["inference", "--keywords", "alpha", "--modelpaths", str(xfer), "--wav", str(wav),
            "--groundtruth", str(gt), "--detection-threshold", str(thr), "--device", "cuda"]
    walls, launches_inf = [], None
    for i in range(3):
        reset()
        t0 = time.perf_counter()
        cli.main(argv + ["--write-detections", str(work / f"detections{i}.json")])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if launches_inf is None:
            launches_inf = {k: counters[k].launches for k in ("stream_prefix", "stream_suffix")}

    # 6. detections.json: the JAX schema, and the detections of the saved
    # model in memory
    det = json.loads((work / "detections0.json").read_text())
    check(set(det) == {"keywords", "detections", "min_threshold"} and det["keywords"] == ["alpha"]
          and det["min_threshold"] == thr, f"detections.json keys {sorted(det)}")
    tags = [d["groundtruth"] for d in det["detections"]]
    check(set(tags) <= {"tp", "fp", "fn", "ng"}, f"groundtruth tags {set(tags)}")
    for d in det["detections"]:
        want = {"keyword", "time_ms", "groundtruth"} | ({"confidence"} if d["groundtruth"] != "fn" else set())
        check(set(d) == want, f"detection keys {sorted(d)}")
    for i in (1, 2):
        check(json.loads((work / f"detections{i}.json").read_text()) == det, f"inference call {i} differs")
    found = [d for d in det["detections"] if d["groundtruth"] in ("tp", "fp")]
    check([(d["keyword"], d["time_ms"], d["confidence"]) for d in found] == [tuple(d) for d in mem],
          f"CLI detections ({len(found)}) != the in-memory model's ({len(mem)})")
    site = install_site(work / "visualizer")
    files = assemble_visualizer_data(work / "visualizer" / "data", str(wav), det)
    check(site.exists() and all(Path(f).stat().st_size > 0 for f in files), "visualizer files")

    # 7. the kernels through the CLI: train featurizes and augments on the
    # card; inference runs the stream's prefix and suffix once a chunk
    check(all(n > 0 for n in launches_train.values()), f"train launches {launches_train}")
    check(launches_inf == {"stream_prefix": 1, "stream_suffix": 1}, f"inference launches {launches_inf}")

    # 8. the first call of a fresh process, as a user runs it: with torch's
    # defaults (TF32 allowed for cuDNN), which the port's entry points pin to
    # float32 themselves (exact_float32), so it detects what this process
    # detects: the same detections, tags and times, and confidences within
    # FRESH_CONF_TOL
    fresh_inf = fresh_cli(argv + ["--write-detections", str(work / "detections_fresh.json")])
    fresh_det = json.loads((work / "detections_fresh.json").read_text())

    def tags_of(dets):
        return [(d["keyword"], d["time_ms"], d["groundtruth"]) for d in dets]

    check(tags_of(fresh_det["detections"]) == tags_of(det["detections"]),
          f"a fresh process's detections ({len(fresh_det['detections'])}) != this process's "
          f"({len(det['detections'])})")
    conf_err = max((abs(a["confidence"] - b["confidence"]) for a, b in zip(fresh_det["detections"], det["detections"])
                    if "confidence" in a), default=0.0)
    check(conf_err <= FRESH_CONF_TOL, f"a fresh process's confidences differ by {conf_err}")
    fresh_inf["same_detections"] = fresh_det == det
    fresh_inf["max_confidence_diff"] = conf_err
    fresh_inf["tp_fp"] = sum(d["groundtruth"] in ("tp", "fp") for d in fresh_det["detections"])
    shutil.rmtree(work / "alpha_model_fresh", ignore_errors=True)
    fresh_train = fresh_cli(["train", "--keyword", "alpha", "--samples-dir", str(samples), "--embedding", str(emb),
                             "--unknown-words", str(unknown), "--background-noise", corpus["bg_dir"],
                             "--output", str(work / "alpha_model_fresh"), "--device", "cuda"])

    wall = float(np.median(walls))
    load = float(np.median(loads_xfer))
    tp, fp, fn = (tags.count(t) for t in ("tp", "fp", "fn"))
    print(f"phase h: embedding checkpoint of phase e's model: {size} bytes, save {float(np.median(saves)):.4f} s, "
          f"load {float(np.median(loads)):.4f} s (medians of 3: {[round(s, 4) for s in saves]}, "
          f"{[round(s, 4) for s in loads]}); every tensor == the model's; softmax rows of the model rebuilt "
          f"from it == the model's on the stream's first {n_cmp} windows")
    print(f"phase h: train (4 epochs x 64 steps at batch 64, from the embedding checkpoint, no calibration) "
          f"{train_s:.3f} s; epoch losses {losses}; val accuracy {tmeta['details']['val_accuracy']:.4f}; "
          f"trunk and embedding head == the embedding's; launches {launches_train}")
    print(f"phase h: inference on the {STREAM_SECONDS} s stream {wall:.3f} s (median of 3: "
          f"{[round(w, 4) for w in walls]}); transfer model load {load:.4f} s (median of 3, "
          f"{load / wall:.3f} of the wall); launches {launches_inf}; the saved model in memory detects "
          f"{found_at} (threshold: detections); the CLI at {thr}: {tp} tp, {fp} fp, {fn} fn, == the in-memory "
          f"model's; visualizer files {[Path(f).name for f in files]}")
    print(f"phase h: fresh process (python -X importtime): inference {json.dumps(fresh_inf)} (detections == this "
          f"process's, confidences within {FRESH_CONF_TOL}); train {json.dumps(fresh_train)}")
    return {"samples": samples, "unknown": unknown, "wav": wav, "gt": gt, "threshold": thr}


def pretrain_corpus(root: Path, seed: int, write_wav):
    """Seeded 760-word corpus: each word a tone sequence of three
    frequencies of its own, PT_CLIPS clips of it (tone_clip: onset, pitch and
    loudness vary), the last of each to validate; three 8 s background noise
    wavs."""
    rng = np.random.default_rng(seed)
    out = {"words": [], "train": [], "val": []}
    for w in range(PT_WORDS):
        word = f"w{w:03d}"
        freqs = tuple(rng.uniform(300, 3500, 3))
        out["words"].append(word)
        for i in range(PT_CLIPS):
            path = root / word / f"{word}_{i}.wav"
            write_wav(path, tone_clip(rng, freqs), SR)
            out["val" if i == PT_CLIPS - 1 else "train"].append(str(path))
    for i in range(3):
        noise = rng.normal(0, 0.05, 8 * SR) * np.repeat(rng.uniform(0.3, 2.0, 8), SR)
        write_wav(root / "_background_noise_" / f"noise_{i}.wav", np.clip(noise, -1, 1), SR)
    out["bg_dir"] = str(root / "_background_noise_")
    return out


def bf16_gate_model(torch):
    """A full-width EfficientNetB0 transfer model whose rows bf16 moves:
    LeCun-normal kernels truncated at two standard deviations (Flax's
    default) drawn with numpy from seed 1, zero biases, and BN calibrated
    on 128 of 256 windows of features uniform in [0, 26), so that BN keeps
    every layer at unit scale and rounding grows with depth (a model with
    init statistics, such as phase c's, scores every window near one value
    whatever its trunk computes). numpy draws the same weights under every
    torch version (how far bf16 moves the rows depends on the draw), so the
    model is the one tests/test_torch_bf16.py runs through the JAX package. Built on the CPU: (model, the 256 windows as a
    float32 numpy array)."""
    from multilingual_kws_tpu_torch.models.kws_model import make_transfer_model
    from multilingual_kws_tpu_torch.train.steps import calibrate_batch_stats

    rng = np.random.default_rng(1)
    model = make_transfer_model(device="cpu", drop_connect_rate=0.0)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear)):
                z = rng.standard_normal(mod.weight.numel())
                while (out := np.abs(z) > 2).any():
                    z[out] = rng.standard_normal(int(out.sum()))
                std = (1.0 / mod.weight[0].numel()) ** 0.5 / 0.87962566103423978
                mod.weight.copy_(torch.from_numpy((z * std).astype(np.float32)).reshape(mod.weight.shape))
                if mod.bias is not None:
                    mod.bias.zero_()
    x = np.random.default_rng(0).uniform(0, 26, (256, 49, 40, 1)).astype(np.float32)
    calibrate_batch_stats(model, [torch.from_numpy(x[:64]), torch.from_numpy(x[64:128])])
    return model, x


def bf16_gate_stats(rows16, rows32, emb16, emb32):
    """How far bf16 moves the gate model: the mean |bf16 - f32| of the
    softmax rows, and the mean and 99th percentile of the embedding's over
    the float32 embedding's largest |value|. These three move by < 2 % when
    the model's BN statistics move by 1e-6 (the softmax rows' 99th
    percentile and maximum, a few of 768 values, by up to 12 %)."""
    d = np.abs(emb16 - emb32) / np.abs(emb32).max()
    return {"softmax mean": float(np.abs(rows16 - rows32).mean()), "embedding mean": float(d.mean()),
            "embedding p99": float(np.percentile(d, 99))}


def bf16_op_rounding(torch, model, x):
    """Each Conv and BatchNorm of ``model`` at bf16 on ``x``: its error
    against float32 arithmetic on the same bf16 operands, over the error of
    rounding that float32 result to bf16 once (Flax computes BN in float32
    and rounds once; a convolution accumulates in float32). A BatchNorm
    that applies the swish or the residual add after it is called again
    without them (on the path it took), so that its own rounding is
    measured. Returns the largest such ratio by kind: 1 up to the float32
    sums' order, more where an op rounds inside its arithmetic."""
    from multilingual_kws_tpu_torch.models.efficientnet import BatchNorm, Conv

    model.trunk.compute_dtype = torch.bfloat16
    worst, busy = {"Conv": 0.0, "BatchNorm": 0.0}, []

    def hook(mod, inputs, kwargs, out):
        if busy:
            return
        busy.append(mod)
        if isinstance(mod, BatchNorm):
            out = mod(inputs[0], fused=kwargs.get("fused", False))
        params = {n: p.data for n, p in mod.named_parameters()}
        if isinstance(mod, Conv):  # the bf16 operands, in float32
            for n, p in mod.named_parameters():
                p.data = p.data.to(out.dtype).float()
        ref = mod(inputs[0].float())
        for n, p in mod.named_parameters():
            p.data = params[n]
        busy.clear()
        once = (ref.to(out.dtype).float() - ref).abs().mean()
        kind = type(mod).__name__
        worst[kind] = max(worst[kind], float((out.float() - ref).abs().mean() / once))

    hooks = [m.register_forward_hook(hook, with_kwargs=True) for m in model.modules()
             if isinstance(m, (Conv, BatchNorm))]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return worst


def pretrain_gate(torch, specs, labels, group):
    """Phase i's card-vs-CPU gate: one pretraining step on the card (under
    ``group``) and the same step on the CPU, with the same global batch and
    the same drop-connect masks (one CPU generator's draws), from a state
    that is the same in every run: the float32 embedding model as
    ``pretrain()`` initialises it (``lecun_init_``, seed 0), its BN
    statistics calibrated on the CPU on this batch. (The state card
    training leaves is not bitwise repeatable from run to run.) Loss rtol
    1e-5; gradients rtol 1e-4 with atol 1e-4 of each tensor's largest. A
    non-residual block's last BN bias has an exact gradient of zero (its
    shift reaches the loss only through train-mode BNs): both sides hold
    rounding there, held to 1e-5 of the model's largest gradient. Returns
    each tensor's max |card - CPU| over its largest |CPU| value, and hashes
    of the state and the batch (equal in every run)."""
    import copy
    import hashlib

    from multilingual_kws_tpu_torch.models.kws_model import lecun_init_, make_embedding_model
    from multilingual_kws_tpu_torch.train.steps import calibrate_batch_stats, flat_adam, make_pretrain_step

    model = lecun_init_(make_embedding_model(PT_WORDS + 1, device="cpu"), seed=0)
    calibrate_batch_stats(model, [specs.cpu()], drop_generator=torch.Generator().manual_seed(4))

    def digest(tensors):
        h = hashlib.sha1()
        for t in tensors:
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
        return h.hexdigest()[:16]

    state_hash, batch_hash = digest(model.state_dict().values()), digest([specs, labels])
    got = {}
    for where, m, x, y, grp in (("cuda", copy.deepcopy(model).cuda(), specs, labels, group),
                                ("cpu", copy.deepcopy(model), specs.cpu(), labels.cpu(), None)):
        step, _ = make_pretrain_step(m, flat_adam(m.parameters(), 1e-3), grp)
        loss = float(step(x, y, torch.Generator().manual_seed(5))["loss"])
        got[where] = loss, {n: p.grad.cpu() for n, p in m.named_parameters()}
    (lg, gg), (lc, gc) = got["cuda"], got["cpu"]
    check(abs(lg - lc) <= 1e-5 * abs(lc), f"pretrain step loss {lg} on the card, {lc} on the CPU")
    trunk = model.trunk
    zero = {f"trunk.{b}.project_bn.bias" for b in trunk.block_names if not getattr(trunk, b).residual}
    largest = max(float(w.abs().max()) for w in gc.values())
    errors = {}
    for n, w in gc.items():
        if n in zero:
            check(max(float(w.abs().max()), float(gg[n].abs().max())) < 1e-5 * largest, f"gradient of {n}")
            continue
        scale = float(w.abs().max())
        err = float((gg[n] - w).abs().max())
        check(torch.allclose(gg[n], w, rtol=1e-4, atol=1e-4 * scale), f"pretrain gradient of {n}: {err} (max {scale})")
        errors[n] = err / max(scale, 1e-30)
    return {"errors": errors, "loss": (lg, lc), "state": state_hash, "batch": batch_hash}


def gate_batch(torch, corpus, train_labels):
    """Phase i's gate batch: the first training batch of a dataset of its
    own, built as pretrain() builds its dataset (seed 0), on the card. It
    depends on the corpus alone, not on how many epochs any earlier loop
    drew from a dataset (drawn from pretrain()'s dataset after the phase's
    other loops, the batch, and with it the gate's errors, moved whenever
    they changed)."""
    from multilingual_kws_tpu_torch.data.dataset import AudioDataset
    from multilingual_kws_tpu_torch.ops.augment import SpecAugParams
    from multilingual_kws_tpu_torch.settings import standard_microspeech_model_settings

    ds = AudioDataset(standard_microspeech_model_settings(PT_WORDS + 1), corpus["words"], corpus["bg_dir"], [],
                      silence_percentage=1.0, unknown_percentage=0.0, spec_aug_params=SpecAugParams(percentage=80),
                      seed=0, device="cuda")
    return next(ds.train_batches_resident(corpus["train"], PT_BATCH, 1, labels=train_labels, single_target=False,
                                          bank=ds.build_resident_bank(corpus["train"])))


def pretrain_sides(torch, model, corpus, group):
    """Phase i's graphed and eager pretraining loops on copies of ``model``:
    each with its own dataset (pretrain()'s, seed 5), resident bank, Adam
    and drop-connect generator (seed 1), so that the two take the same steps
    on the same draws. The graphed side is ``build_fused_resident_epoch``
    as pretrain() runs it; the eager side is the per-step loop of
    ``scan_epoch=False``. Returns {side: (epoch, (model, optimizer,
    generators))} and the graphed side's dataset and bank."""
    import copy

    from multilingual_kws_tpu_torch.data.dataset import AudioDataset
    from multilingual_kws_tpu_torch.ops.augment import SpecAugParams
    from multilingual_kws_tpu_torch.settings import standard_microspeech_model_settings
    from multilingual_kws_tpu_torch.train.pretrain import build_fused_resident_epoch
    from multilingual_kws_tpu_torch.train.steps import flat_adam, make_pretrain_step

    sides = {}
    for name in ("graphed", "eager"):
        ds = AudioDataset(standard_microspeech_model_settings(PT_WORDS + 1), corpus["words"], corpus["bg_dir"], [],
                          silence_percentage=1.0, unknown_percentage=0.0, spec_aug_params=SpecAugParams(percentage=80),
                          seed=5, device="cuda")
        bank = ds.build_resident_bank(corpus["train"])
        m = copy.deepcopy(model)
        opt = flat_adam(m.parameters(), 1e-3)
        drop = torch.Generator(device="cuda")
        drop.manual_seed(1)
        if name == "graphed":
            run = build_fused_resident_epoch(m, opt, group, ds, bank["bank"], drop)
            out = (ds, bank)
        else:
            step = make_pretrain_step(m, opt, group)[0].fn  # the eager step

            def run(idx, lbl, sil, step=step, ds=ds, bank=bank, drop=drop):
                ms = [step(ds._train_device(bank["bank"], idx[i], sil[i]), lbl[i], drop) for i in range(idx.shape[0])]
                return torch.stack([x["loss"] for x in ms]), torch.stack([x["accuracy"] for x in ms])

        sides[name] = (run, (m, opt, [ds.gen, drop]))
    return sides, out


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def bf16_copy(torch, model):
    """A copy of a port model whose trunk computes in bfloat16 (its tensors
    stay float32)."""
    import copy

    m16 = copy.deepcopy(model)
    m16.trunk.compute_dtype = torch.bfloat16
    return m16


def pretrain_phase(torch, stream_model, ft_model, ft_corpus, finetune_epoch, cli_paths, work: Path):
    """Phase i: embedding pretraining on the card under an NCCL process
    group of one rank (the data-parallel path: the gradient all-reduce,
    parallel/mesh.py), at float32 and bfloat16; the CLI's pretrain -> train
    -> inference at bfloat16; the bf16 stream beside the float32 one; a
    bf16 fine-tune beside phase e's. Returns the float32 pretraining epoch
    (for ``--profile``), which runs in the process group: the caller leaves
    the group after it; and the phase's corpus (phase n trains on it)."""
    import torch.distributed as dist

    from multilingual_kws_tpu_torch.api import cli
    from multilingual_kws_tpu_torch.data.manifests import label_from_parent_dir, write_lines
    from multilingual_kws_tpu_torch.models.kws_model import lecun_init_, make_embedding_model
    from multilingual_kws_tpu_torch.ops import cuda_augment, cuda_clip, cuda_fft, cuda_frontend
    from multilingual_kws_tpu_torch.parallel import mesh
    from multilingual_kws_tpu_torch.stream.engine import StreamFlags, calculate_streaming_accuracy
    from multilingual_kws_tpu_torch.stream.tprfpr import get_groundtruth
    from multilingual_kws_tpu_torch.train import checkpoints as ckpt
    from multilingual_kws_tpu_torch.train.finetune import transfer_learn
    from multilingual_kws_tpu_torch.train.graphs import WARMUP_STEPS
    from multilingual_kws_tpu_torch.train.pretrain import PretrainConfig, pretrain
    from multilingual_kws_tpu_torch.utils.wav import write_wav

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    counters = {"clip_features": cuda_clip.clip_features, "augment_quantize": cuda_augment.augment_quantize,
                "stream_prefix": cuda_fft.stream_prefix, "stream_suffix": cuda_frontend.stream_suffix}

    def reset():
        for fn in counters.values():
            fn.launches = 0

    t0 = time.perf_counter()
    corpus = pretrain_corpus(work / "pretrain_corpus", 11, write_wav)
    t_corpus = time.perf_counter() - t0
    n_clips = len(corpus["train"]) + len(corpus["val"])
    corpus_bytes = sum(Path(f).stat().st_size for f in corpus["train"] + corpus["val"])
    train_labels = [label_from_parent_dir(f) for f in corpus["train"]]
    check(mesh.initialize_distributed("nccl", init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0),
          "no process group")
    check(dist.get_backend() == "nccl" and mesh.world_size() == 1, "the process group is not NCCL of one rank")
    group = mesh.default_group()

    # 1. pretrain() at float32, then bfloat16
    runs = {}
    for dtype in ("float32", "bfloat16"):
        model0 = lecun_init_(make_embedding_model(PT_WORDS + 1, device="cpu", compute_dtype=dtype), seed=0)
        init = {k: t.clone() for k, t in model0.state_dict().items()}
        config = PretrainConfig(num_labels=PT_WORDS + 1, batch_size=PT_BATCH, num_epochs=PT_EPOCHS,
                                steps_per_epoch=PT_STEPS, bn_calibration_batches=2,
                                checkpoint_dir=str(work / f"emb_{dtype}"), compute_dtype=dtype, device=str(dev))
        reset()
        sync()
        t0 = time.perf_counter()
        model, hist, ds = pretrain(corpus["train"], corpus["val"], corpus["words"], corpus["bg_dir"],
                                   config=config, model=model0)
        sync()
        wall = time.perf_counter() - t0
        launches = {k: counters[k].launches for k in ("augment_quantize", "clip_features")}
        check(len(ds.commands) == PT_WORDS + 1 and model.classifier.out_features == PT_WORDS + 1,
              f"{len(ds.commands)} labels")
        check(np.isfinite(hist["loss"]).all() and np.isfinite(hist["val_loss"]).all(), f"a non-finite loss {hist}")
        check(hist["loss"][-1] < hist["loss"][0], f"{dtype}: epoch losses did not fall: {hist['loss']}")
        state = model.state_dict()
        check(all(t.dtype == init[k].dtype and t.dtype in (torch.float32, torch.int64) for k, t in state.items()),
              f"{dtype}: a tensor left float32")
        stats = [k for k in state if k.endswith(("running_mean", "running_var"))]
        check(all(not torch.equal(state[k].cpu(), init[k]) for k in stats), f"{dtype}: a BN statistic did not change")
        n_train = PT_EPOCHS * (PT_STEPS + config.bn_calibration_batches)
        n_val = PT_EPOCHS * -(-len(corpus["val"]) // PT_BATCH)
        check(launches == {"augment_quantize": n_train, "clip_features": n_train + n_val},
              f"{dtype}: launches {launches}, expected {n_train} and {n_train + n_val}")
        meta = ckpt.load_metadata(work / f"emb_{dtype}")
        check(meta["kind"] == "embedding" and meta["num_labels"] == PT_WORDS + 1, f"checkpoint metadata {meta}")
        size = (work / f"emb_{dtype}" / ckpt.STATE_FILE).stat().st_size

        # graphed == eager, bitwise, for the user's call: pretrain() with
        # scan_epoch True and False from the same init and seeds (the
        # history, every tensor of the model, the dataset's generator, the
        # launches), with cuDNN restricted to deterministic algorithms: at
        # float32 its default weight-gradient algorithms sum in an order
        # that changes from run to run, so two eager runs differ too
        twin_runs = {}
        with deterministic_cudnn(torch):
            for scan in (True, False):
                reset()
                m0 = lecun_init_(make_embedding_model(PT_WORDS + 1, device="cpu", compute_dtype=dtype), seed=0)
                m, h, d = pretrain(corpus["train"], corpus["val"], corpus["words"], corpus["bg_dir"], model=m0,
                                   config=dataclasses.replace(config, checkpoint_dir=None, scan_epoch=scan), verbose=0)
                twin_runs[scan] = (m.state_dict(), h, d.gen.get_state(),
                                   {k: counters[k].launches for k in ("augment_quantize", "clip_features")})
        (sg, hg, gg, lg), (se, he, ge, le) = twin_runs[True], twin_runs[False]
        twin = {f"model{k}": v for k, v in tensor_diffs(torch, sg, se).items()}
        if hg != he:
            twin["history"] = f"{hg} != {he}"
        if not torch.equal(gg, ge):
            twin["generator"] = "differs"
        check(not twin and lg == le == launches, f"{dtype}: pretrain(scan_epoch=True) != False: {twin}, launches {lg} {le}")

        # the step time: the graphed epoch beside the eager step loop, in
        # turns, on copies of the pretrained model (pretrain_sides), then one
        # profiled epoch of each; and the same two held == over two epochs
        # (every step's loss and accuracy, the model, Adam's state, the
        # dataset's and drop-connect's generators) under deterministic cuDNN
        sides, (ds_g, bank_g) = pretrain_sides(torch, model, corpus, group)
        inputs = [ds_g._put_batch(tuple(np.stack(a) for a in zip(*ds_g.host_train_indices(
            corpus["train"], PT_BATCH, PT_STEPS, bank_g, labels=train_labels, single_target=False))))
            for _ in range(GRAPH_EPOCHS + 1)]
        graphed = sides["graphed"][0]
        turns = epochs_in_turns(torch, {name: run for name, (run, _) in sides.items()}, inputs)
        check(graphed.replays == (GRAPH_EPOCHS + 1) * PT_STEPS - WARMUP_STEPS, f"{dtype}: {graphed.replays} replays")
        tr = graph_trace(torch, lambda graphed=graphed, b=inputs[-1]: graphed(*b), PT_STEPS)
        check_graph_trace(tr, PT_STEPS, f"pretraining at {dtype}")
        eager_run = sides["eager"][0]
        ev, wall_epoch = device_trace(torch, lambda: eager_run(*inputs[-1]), 1, warmup=0,
                                      expect=("clip_features_kernel", PT_STEPS - 2))
        busy = busy_us((e["ts"], e["ts"] + e["dur"]) for e in ev) / 1e3
        with deterministic_cudnn(torch):
            det_sides, _ = pretrain_sides(torch, model, corpus, group)
            det_turns = epochs_in_turns(torch, {name: run for name, (run, _) in det_sides.items()}, inputs[:2])
            pair = pair_diffs(torch, det_turns, det_sides["graphed"][1], det_sides["eager"][1])
        check(not pair, f"{dtype}: graphed pretraining epochs != eager: {pair}")
        del det_sides, twin_runs
        runs[dtype] = {"model": model, "ds": ds, "epoch": lambda graphed=graphed, b=inputs[-1]: graphed(*b),
                       "bank": ds.build_resident_bank(corpus["train"]), "hist": hist, "wall": wall,
                       "launches": launches, "size": size, "ms": turns["eager"]["ms"][1:],
                       "ms_graph": turns["graphed"]["ms"][1:], "first_graph": turns["graphed"]["ms"][0],
                       "capture_s": graphed.capture_s, "replays": graphed.replays, "trace": tr, "busy": busy,
                       "idle": 1 - busy / 1e3 / wall_epoch, "wall_epoch": wall_epoch}

    # 2. one step on the card against the same step on the CPU: the same
    # global batch, the same drop-connect masks (one CPU generator's draws),
    # from a state that is the same in every run (pretrain_gate), on a batch
    # that is too (gate_batch)
    ds, bank = runs["float32"]["ds"], runs["float32"]["bank"]
    specs, labels = gate_batch(torch, corpus, train_labels)
    step_gate = pretrain_gate(torch, specs, labels, group)
    step_err = max(step_gate["errors"].values())

    # 3. the two kernels == plain at the pretraining batch (64 clips of the
    # corpus' bank, its augmentation parameters)
    idx, _, sil = ds._put_batch(next(ds.host_train_indices(corpus["train"], PT_BATCH, 1, bank, labels=train_labels,
                                                           single_target=False)))
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    d = cuda_augment.draw_augment_params(gen, PT_BATCH, SR, ds.bg_sizes, ds.aug_params)
    quant = cuda_augment.augment_quantize(bank["bank"], idx, sil, ds.bg_data, d)
    feats = cuda_clip.clip_features(quant, ds.frontend)
    sync()
    want = cuda_augment.augment_quantize_plain(bank["bank"], idx, sil, ds.bg_data, d)
    diff = (quant.to(torch.int32) - want.to(torch.int32)).abs()
    unmixed = sil | (d.volume == 0)
    share = float((diff > 0).to(torch.float64).mean())
    check(torch.equal(quant[unmixed], want[unmixed]) and int(diff.max()) <= 1 and share < 1e-4,
          f"augment_quantize != plain at the pretraining batch: {int(diff.max())} on a share {share}")
    err_feats = float((feats - cuda_clip.clip_features_plain(quant, ds.frontend)).abs().max())
    check(err_feats == 0.0, f"clip_features != plain at the pretraining batch: {err_feats}")

    # 4. the user's loop through the CLI: pretrain (one short epoch), train
    # from its checkpoint and inference, both at bfloat16
    mdir = work / "manifests"
    write_lines(mdir / "commands.txt", corpus["words"])
    write_lines(mdir / "train_files.txt", corpus["train"])
    write_lines(mdir / "val_files.txt", corpus["val"])
    emb = work / "emb_cli"
    reset()
    t0 = time.perf_counter()
    cli.main(["pretrain", "--commands", str(mdir / "commands.txt"), "--train-files", str(mdir / "train_files.txt"),
              "--val-files", str(mdir / "val_files.txt"), "--background-noise", corpus["bg_dir"],
              "--output", str(emb), "--num-epochs", "1", "--steps-per-epoch", "5", "--batch-size", str(PT_BATCH),
              "--device", str(dev)])
    sync()
    cli_pretrain_s = time.perf_counter() - t0
    launches_cli = {"pretrain": {k: counters[k].launches for k in ("augment_quantize", "clip_features")}}
    emb_meta = ckpt.load_metadata(emb)
    check(emb_meta["kind"] == "embedding" and emb_meta["num_labels"] == PT_WORDS + 1, f"CLI checkpoint {emb_meta}")
    xfer = work / "alpha_bf16"
    reset()
    t0 = time.perf_counter()
    cli.main(["train", "--keyword", "alpha", "--samples-dir", str(cli_paths["samples"]), "--embedding", str(emb),
              "--unknown-words", str(cli_paths["unknown"]), "--background-noise", ft_corpus["bg_dir"],
              "--output", str(xfer), "--batch-size", str(FT_BATCH), "--compute-dtype", "bfloat16",
              "--device", str(dev)])
    sync()
    cli_train_s = time.perf_counter() - t0
    launches_cli["train"] = {k: counters[k].launches for k in ("augment_quantize", "clip_features")}
    trained, _ = ckpt.load_model(xfer, dev)
    emb_state, _ = ckpt.load_model(emb, dev)
    frozen = [k for k in trained if k.split(".")[0] in ("trunk", "embedding_head")]
    check(frozen and all(torch.equal(trained[k], emb_state[k]) for k in frozen),
          "train --compute-dtype bfloat16 changed a tensor of the pretrained embedding")
    check(all(t.dtype in (torch.float32, torch.int64) for t in trained.values()), "a bf16 tensor in a checkpoint")
    reset()
    t0 = time.perf_counter()
    cli.main(["inference", "--keywords", "alpha", "--modelpaths", str(xfer), "--wav", str(cli_paths["wav"]),
              "--groundtruth", str(cli_paths["gt"]), "--detection-threshold", str(cli_paths["threshold"]),
              "--write-detections", str(work / "detections_bf16.json"), "--compute-dtype", "bfloat16",
              "--device", str(dev)])
    sync()
    cli_inference_s = time.perf_counter() - t0
    launches_cli["inference"] = {k: counters[k].launches for k in ("stream_prefix", "stream_suffix")}
    det = json.loads((work / "detections_bf16.json").read_text())
    check(set(det) == {"keywords", "detections", "min_threshold"}, f"detections.json keys {sorted(det)}")
    check(launches_cli["inference"] == {"stream_prefix": 1, "stream_suffix": 1}
          and all(n > 0 for n in launches_cli["train"].values()), f"CLI launches {launches_cli}")
    cli_tags = {t: sum(x["groundtruth"] == t for x in det["detections"]) for t in ("tp", "fp", "fn")}

    # 5. bf16 beside float32. The gate: bf16_gate_model, a full-width B0
    # with BN calibrated to its data, on which bf16 moves the rows: every
    # row within BF16_SOFTMAX_TOL and normalized, and its softmax rows and
    # embedding moved as far as the JAX package's bf16 moves them
    # (BF16_GATE_JAX, BF16_GATE_RATIO). Phase c's stream, runs in turns
    # (walls), its rows held to BF16_SOFTMAX_TOL; that bound cannot catch a
    # broken trunk there (its random model scores every window near its
    # lifted 0.5), so the gate model carries it. Phase e's fine-tuned model,
    # reported: its scores spread, so its detections say more, but its
    # trunk is random with calibrated BN, as the gate model's, under a
    # trained head that spreads the moved rows further; the JAX package has
    # not been run on that model, and its record of 0.021 is for a trained
    # checkpoint
    gate_model, gate_x = bf16_gate_model(torch)
    gate_model = gate_model.to(dev)
    gate = {}
    for dtype in (torch.float32, torch.bfloat16):
        gate_model.trunk.compute_dtype = dtype
        with torch.no_grad():
            xs = torch.from_numpy(gate_x).to(dev)
            gate[dtype] = gate_model(xs).cpu().numpy(), gate_model.embed(xs).cpu().numpy()
    (g32, ge32), (g16, ge16) = gate[torch.float32], gate[torch.bfloat16]
    check(g16.dtype == ge16.dtype == np.float32 and np.isfinite(g16).all() and np.isfinite(ge16).all(),
          "bf16 gate model: rows not finite float32")
    check(np.abs(g16.sum(1) - 1).max() < 1e-3, "bf16 gate model: softmax rows do not sum to 1")
    gate_max = float(np.abs(g16 - g32).max())
    check(gate_max <= BF16_SOFTMAX_TOL, f"bf16 gate model: softmax rows differ from float32 by {gate_max}")
    gate_deltas = bf16_gate_stats(g16, g32, ge16, ge32)
    gate_ratios = {k: v / BF16_GATE_JAX[k] for k, v in gate_deltas.items()}
    lo, hi = BF16_GATE_RATIO
    check(all(lo <= r <= hi for r in gate_ratios.values()),
          f"bf16 gate model: the port's bf16 moves the rows by {gate_ratios} of the JAX package's")
    rounding = bf16_op_rounding(torch, gate_model, xs[:64])
    check(all(r <= BF16_OP_ROUNDING for r in rounding.values()),
          f"bf16 gate model: an op rounds more than once: {rounding}")
    flags = StreamFlags(wav=str(cli_paths["wav"]), ground_truth=str(cli_paths["gt"]), target_keyword="alpha",
                        detection_thresholds=THRESHOLDS_H)
    gt_rows = [(lab, float(ms)) for lab, ms in (ln.split(", ") for ln in Path(cli_paths["gt"]).read_text().splitlines())]

    def bf16_of(m):
        return bf16_copy(torch, m)

    def stream(m):
        sync()
        t0 = time.perf_counter()
        res, inf = calculate_streaming_accuracy(m, [flags], batch_size=BATCH, verbose=False, device=str(dev))
        sync()
        detector = {}
        for th, (_, with_conf) in res[0][1].items():
            tags = [x["groundtruth"] for x in get_groundtruth(sorted(with_conf, key=lambda x: x[1]), ["alpha"], gt_rows)]
            detector[th] = {t: tags.count(t) for t in ("tp", "fp", "fn")}
        return time.perf_counter() - t0, inf, detector

    models = {"phase c": {"float32": stream_model, "bfloat16": bf16_of(stream_model)},
              "phase e": {"float32": ft_model, "bfloat16": bf16_of(ft_model)}}
    calculate_streaming_accuracy(models["phase c"]["bfloat16"], [dataclasses.replace(flags, max_chunk_length_sec=30)],
                                 batch_size=BATCH, verbose=False, device=str(dev))
    walls = {"float32": [], "bfloat16": []}
    bf16_rows = {}
    for name, pair in models.items():
        got = {}
        for _ in range(5 if name == "phase c" else 1):
            for dtype, m in pair.items():
                wall, inf, detector = stream(m)
                got[dtype] = inf, detector
                if name == "phase c":
                    walls[dtype].append(wall)
        (r32, det32), (r16, det16) = got["float32"], got["bfloat16"]
        check(r16.dtype == np.float32 and r16.shape == r32.shape and np.isfinite(r16).all(), f"{name}: bf16 rows")
        check(np.abs(r16.sum(1) - 1).max() < 1e-4, f"{name}: bf16 softmax rows do not sum to 1")
        max_delta = float(np.abs(r16 - r32).max())
        check(name != "phase c" or max_delta <= BF16_SOFTMAX_TOL,
              f"{name}: bf16 softmax rows differ from float32 by {max_delta}")
        bf16_rows[name] = {
            "max_abs_softmax_delta": max_delta,
            "target_prob_delta_percentiles": {
                f"p{q}": float(np.percentile(np.abs(r16[:, 2] - r32[:, 2]), q)) for q in (50, 90, 99, 99.9)},
            "f32_target_prob_percentiles": {f"p{q}": float(np.percentile(r32[:, 2], q)) for q in (1, 50, 99)},
            "detector": {"float32": det32, "bfloat16": det16},
        }
    n_w = r32.shape[0]

    # 6. a bf16 fine-tune at the JAX defaults (fresh B0, BN calibration),
    # its steps beside phase e's float32 ones, in turns
    common = dict(target="alpha", train_files=ft_corpus["train"], val_files=ft_corpus["val"],
                  unknown_files=ft_corpus["unknown"], bg_datadir=ft_corpus["bg_dir"], batch_size=FT_BATCH,
                  device=str(dev), verbose=0)
    t0 = time.perf_counter()
    ft16 = transfer_learn(**common, seed=0, compute_dtype="bfloat16")
    sync()
    ft_wall = time.perf_counter() - t0
    check(ft16.model.trunk.compute_dtype == torch.bfloat16, "transfer_learn did not build a bf16 trunk")
    ft_steps = [x for ep in ft16.history[0]["step_loss"] for x in ep]
    check(len(ft_steps) == 4 * FT_BATCH and np.isfinite(ft_steps).all(), "bf16 fine-tune losses")
    ft_loss = ft16.history[0]["loss"]
    check(ft_loss[-1] < ft_loss[0], f"bf16 fine-tune epoch losses did not fall: {ft_loss}")
    from multilingual_kws_tpu_torch.train.finetune import _head_only
    from multilingual_kws_tpu_torch.train.steps import make_finetune_epoch_scan

    fds = ft16.dataset
    fbank = fds.build_resident_bank(ft_corpus["train"])
    fdraws = list(fds.host_train_indices(ft_corpus["train"], FT_BATCH, FT_BATCH, fbank))
    fidx, flbl, fsil = fds._put_batch(tuple(np.stack(a) for a in zip(*fdraws)))
    fgraph = make_finetune_epoch_scan(ft16.model, 1e-3, _head_only, fds, fbank["bank"])

    def ft16_epoch():
        fgraph(fidx, flbl, fsil)

    ft16_epoch()
    ft_ms = {"float32": [], "bfloat16": []}
    for _ in range(5):
        for dtype, run in (("float32", finetune_epoch), ("bfloat16", ft16_epoch)):
            sync()
            t0 = time.perf_counter()
            run()
            sync()
            ft_ms[dtype].append((time.perf_counter() - t0) / FT_BATCH * 1e3)

    for dtype, r in runs.items():
        tr = r["trace"]
        print(f"phase i: pretrain() at {dtype}: full-width B0, {PT_WORDS + 1} outputs, batch {PT_BATCH}, {PT_EPOCHS} epochs x "
              f"{PT_STEPS} steps, BN calibration 2 batches, under nccl (world size 1), each epoch a CUDA graph: "
              f"{r['wall']:.2f} s; epoch losses {r['hist']['loss']}, val accuracy {r['hist']['val_accuracy']}; "
              f"launches {r['launches']}; checkpoint {r['size']} bytes; == pretrain(scan_epoch=False), bitwise, "
              f"under deterministic cuDNN")
        print(f"phase i: pretraining step at {dtype}, batch {PT_BATCH}, epochs of {PT_STEPS} in turns (median of "
              f"{GRAPH_EPOCHS}, best, all): graphed {float(np.median(r['ms_graph'])):.3f} ms (best "
              f"{min(r['ms_graph']):.3f}: {[round(m, 3) for m in r['ms_graph']]}), eager {float(np.median(r['ms'])):.3f} "
              f"ms (best {min(r['ms']):.3f}: {[round(m, 3) for m in r['ms']]}), eager / graphed "
              f"{float(np.median(r['ms'])) / float(np.median(r['ms_graph'])):.2f}; the first graphed epoch "
              f"{r['first_graph']:.3f} ms a step (capture {r['capture_s']:.4f} s; {r['replays']} replays in all); "
              f"one profiled graphed epoch: wall {tr['wall_s']:.4f} s, device busy {tr['busy_ms']:.3f} ms, idle share "
              f"{tr['idle']:.4f}, cudaGraphLaunch {tr['graph_launches']}, host kernel launches "
              f"{tr['host_kernel_launches']}, the kernels launched by {json.dumps(tr['launched_by'])}; one profiled "
              f"eager epoch: wall {r['wall_epoch']:.4f} s, device busy {r['busy']:.3f} ms, idle share {r['idle']:.4f}; "
              f"graphed == eager over 2 epochs, bitwise, under deterministic cuDNN")
    print(f"phase i: corpus of {n_clips} clips ({len(corpus['train'])} to train, {len(corpus['val'])} to validate; "
          f"{corpus_bytes} bytes) written in {t_corpus:.2f} s; card vs CPU step (the seeded init, BN calibrated on "
          f"the CPU; state {step_gate['state']}, batch {step_gate['batch']}): loss {step_gate['loss'][0]:.7f} / "
          f"{step_gate['loss'][1]:.7f}, max gradient error {step_err:.2e} of each tensor's largest, the five largest "
          f"{json.dumps(dict(sorted(step_gate['errors'].items(), key=lambda kv: -kv[1])[:5]))}, trunk.stem.conv.weight "
          f"{step_gate['errors']['trunk.stem.conv.weight']:.2e}; augment_quantize at the pretraining batch: max "
          f"|kernel - plain| {int(diff.max())} on a share {share}; clip_features == plain")
    print(f"phase i: card vs CPU step, each tensor's max |card - CPU| / max |CPU|: {json.dumps(step_gate['errors'])}")
    print(f"phase i: CLI pretrain (1 epoch x 5 steps) {cli_pretrain_s:.2f} s, train --compute-dtype bfloat16 from "
          f"its checkpoint {cli_train_s:.2f} s, inference --compute-dtype bfloat16 {cli_inference_s:.3f} s at "
          f"{cli_paths['threshold']}: {cli_tags}; launches {launches_cli}")
    print(f"phase i: stream at bf16 beside float32 ({n_w} windows, phase c's model, runs in turns): " + "; ".join(
        f"{dtype} {float(np.median(w)):.4f} s median, {n_w / float(np.median(w)):.1f} windows/s (best "
        f"{n_w / min(w):.1f}): {[round(x, 4) for x in w]}" for dtype, w in walls.items()))
    print(f"phase i: bf16 gate model (full-width B0, BN calibrated, 256 windows): max softmax |bf16 - f32| "
          f"{gate_max} (bound {BF16_SOFTMAX_TOL}); |bf16 - f32| {json.dumps(gate_deltas)}, over the JAX "
          f"package's {json.dumps(gate_ratios)} (bounds {BF16_GATE_RATIO}); each op's error over one rounding, "
          f"largest by kind: {json.dumps(rounding)} (bound {BF16_OP_ROUNDING})")
    for name, r in bf16_rows.items():
        bound = f"bound {BF16_SOFTMAX_TOL}" if name == "phase c" else "reported"
        print(f"phase i: bf16 vs float32 on the stream, {name}'s model ({bound}; detections tp/fp/fn by "
              f"threshold): {json.dumps(r)}")
    print(f"phase i: transfer_learn at bfloat16 (JAX defaults, fresh B0): {ft_wall:.2f} s, epoch losses {ft_loss}; "
          f"graphed fine-tune step ms, in turns: " + "; ".join(
              f"{dtype} {float(np.median(v)):.3f} (best {min(v):.3f}: {[round(x, 3) for x in v]})"
              for dtype, v in ft_ms.items()))
    return runs["float32"]["epoch"], corpus


J_SECONDS = 60  # phase j: the realtime and analysis paths run on the first 60 s of phase c's stream
J_CHUNKS_MS = (100, 1000)  # realtime feeds
J_THRESHOLD = 0.6  # phase e's model scores 0.17-0.77 (PERF.md PR 7)
J_CONF_TOL = 1e-4  # realtime rows come from other batch sizes (cuDNN algorithms) than the offline engine's
J_KMEANS_TOL = 1e-4  # of the largest center value: card against CPU Lloyd updates


def analysis_phase(torch, fe, ft_model, corpus, wave, labels, work: Path):
    """Phase j: the realtime detector, the TF-free weight mapping and the
    analysis modules on the card, with phase e's fine-tuned model and corpus,
    phase h's embedding checkpoint and the first J_SECONDS of phase c's
    stream (see the module docstring)."""
    from multilingual_kws_tpu_torch.analysis import batch_jobs, distance_filtering, model_analysis, sweeps
    from multilingual_kws_tpu_torch.analysis.streaming_roc import operating_point, streaming_roc
    from multilingual_kws_tpu_torch.models.export_tf import keras_weight_map
    from multilingual_kws_tpu_torch.models.import_tf import import_weight_map, model_from_import
    from multilingual_kws_tpu_torch.ops import cuda_augment, cuda_clip, cuda_fft, cuda_frontend
    from multilingual_kws_tpu_torch.stream.detector import DetectorParams, detect_all_thresholds
    from multilingual_kws_tpu_torch.stream.engine import (
        StreamFlags,
        StreamTarget,
        eval_stream_test,
        featurize_stream,
        model_predict_fn,
    )
    from multilingual_kws_tpu_torch.stream.realtime import RealtimeDetector
    from multilingual_kws_tpu_torch.train.evaluate import featurize_files
    from multilingual_kws_tpu_torch.utils.wav import write_wav

    dev = fe.device
    sync = torch.cuda.synchronize
    ft_model.eval()
    counters = {"clip_features": cuda_clip.clip_features, "augment_quantize": cuda_augment.augment_quantize,
                "stream_prefix": cuda_fft.stream_prefix, "stream_suffix": cuda_frontend.stream_suffix}

    def reset():
        for fn in counters.values():
            fn.launches = 0

    def launches():
        return {k: fn.launches for k, fn in counters.items() if fn.launches}

    audio = wave[: J_SECONDS * SR]
    gt = [(lab, ms) for lab, ms in labels if ms < J_SECONDS * 1000]
    check(gt, f"no keyword in the stream's first {J_SECONDS} s")

    # 1. realtime: the audio fed in 100 ms, then 1 s chunks, after one
    # untimed pass (cuDNN set-up for each batch size)
    predict = model_predict_fn(ft_model)
    rows = []

    def recording(specs):
        out = predict(specs)
        rows.append(out.float().cpu().numpy())
        return out

    def run(chunk_ms, predict_fn, walls=None):
        det = RealtimeDetector("alpha", predict_fn, detection_threshold=J_THRESHOLD, device=dev)
        step = chunk_ms * SR // 1000
        out = []
        for i in range(0, len(audio), step):
            before = det._next_window_start
            t0 = time.perf_counter()
            got = det.feed(audio[i : i + step])
            sync()
            if walls is not None and det._next_window_start > before:  # a feed that completed windows
                walls.append(time.perf_counter() - t0)
            out.extend((d.time_ms, d.confidence) for d in got)
        return out, det

    run(J_CHUNKS_MS[0], predict)
    walls = []
    reset()
    t0 = time.perf_counter()
    dets = {J_CHUNKS_MS[0]: run(J_CHUNKS_MS[0], predict, walls)[0]}
    rt_wall = time.perf_counter() - t0
    rt_launches = launches()
    dets[J_CHUNKS_MS[1]], det = run(J_CHUNKS_MS[1], recording)
    a, b = dets[J_CHUNKS_MS[0]], dets[J_CHUNKS_MS[1]]
    check([t for t, _ in a] == [t for t, _ in b], f"realtime detections differ by chunk size: {a} != {b}")
    conf_chunks = max((abs(x[1] - y[1]) for x, y in zip(a, b)), default=0.0)
    check(conf_chunks <= J_CONF_TOL, f"realtime confidences differ by chunk size by {conf_chunks}")
    check(a, f"no realtime detection at {J_THRESHOLD} in {J_SECONDS} s")
    n_rt = det._next_window_start // det.stride_samples
    check(rt_launches == {"clip_features": len(walls)},
          f"realtime launches {rt_launches}, expected one clip_features a feed that completes windows ({len(walls)})")
    # the offline engine: featurize_stream, the same predict, detect_all_thresholds
    flags = StreamFlags(wav="", ground_truth="", target_keyword="alpha", detection_thresholds=[J_THRESHOLD])
    windows = torch.from_numpy(featurize_stream(audio, SR, flags, device=dev)).to(dev)
    offline_rows = torch.cat([predict(windows[i : i + BATCH, ..., None]) for i in range(0, len(windows), BATCH)])
    offline_rows = offline_rows.float().cpu().numpy()
    times = np.arange(len(windows)) * 20
    offline, _ = detect_all_thresholds(offline_rows, times, [J_THRESHOLD], DetectorParams(),
                                       target_name="alpha")[J_THRESHOLD]
    online = [(t, c) for t, c in a if t <= times[-1]]  # the realtime detector also scores the stream's last window
    check([t for t, _ in online] == [t for _, t in offline],
          f"realtime detections != the offline engine's: {online} against {offline}")
    rt_rows = np.concatenate(rows)
    check(rt_rows.shape[0] == n_rt and n_rt >= len(windows), f"realtime scored {rt_rows.shape[0]} windows")
    row_err = float(np.abs(rt_rows[: len(windows)] - offline_rows).max())
    check(row_err <= J_CONF_TOL, f"realtime softmax rows differ from the offline engine's by {row_err}")
    feeds = np.array(walls)
    n_feeds = -(-len(audio) // (J_CHUNKS_MS[0] * SR // 1000))
    x5 = torch.from_numpy(np.clip(np.trunc(audio[: SR + 4 * 320] * 32768.0), -32768, 32767).astype(np.int16)).to(dev)
    x5 = x5.unfold(0, SR, 320).contiguous()  # the five windows a 100 ms feed completes
    k_b1, grid_b1, _ = kernel_ms(torch, lambda: cuda_clip.clip_features(x5, fe), "clip_features_kernel")
    spec5 = cuda_clip.clip_features(x5, fe)[..., None]
    model5 = cuda_ms(torch, lambda: predict(spec5), 20)
    # one 100 ms feed's device busy time, over 20 feeds of a session that has its first second
    det = RealtimeDetector("alpha", predict, detection_threshold=J_THRESHOLD, device=dev)
    det.feed(audio[:SR])
    chunks = iter(range(SR, len(audio), 1600))
    events, traced = device_trace(torch, lambda: det.feed(audio[next(chunks):][:1600]), iters=20,
                                  expect=("clip_features_kernel", 10))
    feed_busy_ms = busy_us((e["ts"], e["ts"] + e["dur"]) for e in events) / 1e3 / 20
    print(f"phase j: realtime on {J_SECONDS} s of phase c's stream with phase e's model at {J_THRESHOLD}: "
          f"{n_feeds} feeds of {J_CHUNKS_MS[0]} ms in {rt_wall:.4f} s, real-time factor (wall / audio) "
          f"{rt_wall / J_SECONDS:.5f}; per-feed wall (host clock to a synchronize) of the {len(feeds)} feeds that "
          f"complete windows p50 {np.percentile(feeds, 50) * 1e3:.3f} ms, p99 {np.percentile(feeds, 99) * 1e3:.3f} "
          f"ms, max {feeds.max() * 1e3:.3f} ms; {n_rt} windows; launches {rt_launches}; a 100 ms feed's device "
          f"busy {feed_busy_ms:.4f} ms (profiler, mean of 20; {traced / 20 * 1e3:.3f} ms wall each under the "
          f"profiler); clip_features at the feed's batch of 5: {k_b1:.5f} ms (profiler, grid {grid_b1}); "
          f"predict at batch 5: {model5:.3f} ms (CUDA events); detections {len(a)} == at {J_CHUNKS_MS[1]} ms "
          f"chunks (max |conf delta| {conf_chunks:.2e}) == the offline engine's ({len(offline)}); max |softmax "
          f"row - offline| {row_err:.2e} over {len(windows)} windows")

    # 2. the TF-free weight mapping: model -> Keras layer map -> a fresh port model
    t0 = time.perf_counter()
    sd = ft_model.state_dict()
    m = keras_weight_map(sd)
    rebuilt = model_from_import(import_weight_map(m["by_name"], m["dense_order"]), dev)
    sync()
    t_map = time.perf_counter() - t0
    got = rebuilt.state_dict()
    check(set(got) == set(sd) and all(torch.equal(got[k], sd[k]) for k in sd),
          "a tensor differs after the Keras weight mapping's round trip")
    with torch.inference_mode():
        w256 = windows[:256, ..., None]
        check(torch.equal(predict(w256), model_predict_fn(rebuilt)(w256)),
              "softmax rows of the model rebuilt from the Keras weight map != the model's")
    print(f"phase j: TF-free weight mapping ({m['kind']}, {len(m['by_name'])} Keras layers): model -> Keras map -> "
          f"a new model on the card in {t_map:.3f} s; all {len(sd)} tensors ==, softmax rows on 256 windows ==")
    del rebuilt

    # 3. analysis: cluster_and_sort, a sweep point, a batch job, streaming ROC, analyze_model
    root = Path(corpus["bg_dir"]).parent
    alpha = corpus["train"] + corpus["val"]
    emb_fn = distance_filtering.make_embedding_fn(ft_model)
    reset()
    t0 = time.perf_counter()
    res = distance_filtering.cluster_and_sort(alpha, emb_fn, seed=3, n_train=15, n_clusters=3, device=dev)
    t_cluster = time.perf_counter() - t0
    l_cluster = launches()
    check(l_cluster.get("clip_features", 0) > 0, f"cluster_and_sort launched {l_cluster}")
    points = torch.from_numpy(emb_fn(featurize_files(list(res["train_clips"]), device=dev)[..., None])).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    seeded = distance_filtering.kmeans_seed(points, 3, gen)
    card = distance_filtering.kmeans_lloyd(points, seeded)
    cpu = distance_filtering.kmeans_lloyd(points.cpu(), seeded.cpu())
    km_err = float((card.cpu() - cpu).abs().max())
    km_scale = float(cpu.abs().max())
    check(km_err <= J_KMEANS_TOL * km_scale, f"card k-means != CPU k-means: {km_err} of {km_scale}")
    check(len(res["sorted_clips"]) == len(alpha) - 15 and np.all(np.diff(res["distances"]) >= 0),
          "cluster_and_sort's order")
    print(f"phase j: cluster_and_sort on {len(alpha)} 'alpha' clips (15 to train, 3 clusters) {t_cluster:.3f} s, "
          f"launches {l_cluster}; card k-means from the seeded centers vs CPU: max |delta| {km_err:.2e} of "
          f"{km_scale:.3f}; vs cluster_and_sort's centers {float(np.abs(card.cpu().numpy() - res['cluster_centers']).max()):.2e}")

    emb_ckpt = work / "embedding"
    sp = sweeps.SweepPoint(ix=0, trial=0, target="alpha", train_files=corpus["train"], val_files=corpus["val"],
                           unknown_files=corpus["unknown"], unknown_sample=["unknown"], num_epochs=1,
                           num_batches=1, batch_size=8)
    reset()
    t0 = time.perf_counter()
    out = sweeps.run_sweep_point(sp, work / "sweep", root, base_model_path=emb_ckpt, bg_datadir=corpus["bg_dir"],
                                 n_target_eval=25, n_unknown_eval=40, device=dev)
    t_sweep = time.perf_counter() - t0
    l_sweep = launches()
    check(all(l_sweep.get(k, 0) > 0 for k in ("clip_features", "augment_quantize")),
          f"run_sweep_point launched {l_sweep}")
    check(out is not None and sweeps.run_sweep_point(sp, work / "sweep", root, device=dev) is None,
          "sweep point resume")
    loaded = sweeps.load_sweep_results(work / "sweep")
    check(len(loaded) == 1 and len(loaded[0]["tprs"]) == 101, "load_sweep_results")
    n_eval = len(out["target_results"]["correct"]) + len(out["target_results"]["incorrect"])
    print(f"phase j: run_sweep_point (1 epoch x 8 steps at batch 8, from phase h's embedding, 25 target and 40 "
          f"unknown clips evaluated) {t_sweep:.3f} s, launches {l_sweep}; val accuracy "
          f"{out['details']['val_accuracy']:.3f}; {n_eval} target clips scored; a second call resumes (None)")

    wav, gt_file = work / "stream60.wav", work / "labels60.txt"
    write_wav(wav, audio, SR)
    gt_file.write_text("".join(f"{lab}, {ms}\n" for lab, ms in gt))
    jflags = StreamFlags(wav=str(wav), ground_truth=str(gt_file), target_keyword="alpha",
                         detection_thresholds=[0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9])
    st = StreamTarget("x", "alpha", None, [jflags], destination_result_pkl=str(work / "job/result.pkl"),
                      destination_result_inferences=str(work / "job/inferences.npy"))
    job = batch_jobs.TLData(train_files=corpus["train"], val_files=corpus["val"], n_batches=1, n_epochs=1,
                            model_dest_dir=str(work / "job_models"), primary_lr=1e-3, backprop_into_embedding=False,
                            embedding_lr=0.0, target="alpha", stream_targets=[st], batch_size=8)
    reset()
    t0 = time.perf_counter()
    name = batch_jobs.run_job(job, corpus["unknown"], emb_ckpt, corpus["bg_dir"], device=dev)
    t_job = time.perf_counter() - t0
    l_job = launches()
    check(all(l_job.get(k, 0) > 0 for k in counters), f"run_job launched {l_job}")
    with open(st.destination_result_pkl, "rb") as fh:
        job_results = pickle.load(fh)
    direct_inf = work / "job/direct_inferences.npy"
    direct = eval_stream_test(StreamTarget("x", "alpha", str(work / "job_models" / name), [jflags],
                                           destination_result_inferences=str(direct_inf)), verbose=False,
                              device=dev)
    check(job_results["alpha"][0][1] == direct["alpha"][0][1],
          "the batch job's pickled detections != a direct eval_stream_test of its saved model")
    inf_err = float(np.abs(np.load(st.destination_result_inferences) - np.load(direct_inf)).max())
    check(batch_jobs.run_job(job, corpus["unknown"], emb_ckpt, corpus["bg_dir"], device=dev) == "skipped",
          "run_job resume")
    found = {th: len(r[0]) for th, r in job_results["alpha"][0][1].items()}
    t0 = time.perf_counter()
    roc = streaming_roc(job_results, "alpha", [ms for _, ms in gt], float(J_SECONDS), min_threshold=0.0)
    t_roc = time.perf_counter() - t0
    print(f"phase j: run_job (1 epoch x 8 steps at batch 8 from phase h's embedding, then eval_stream_test on "
          f"{J_SECONDS} s) {t_job:.3f} s, launches {l_job}; detections per threshold {found} == a direct "
          f"eval_stream_test of the saved model (max |softmax delta| {inf_err:.2e}); a second call skips; "
          f"streaming_roc {t_roc * 1e3:.2f} ms: tprs {[round(t, 3) for t in roc['tprs']]}, FA/h "
          f"{[round(f, 1) for f in roc['fa_per_hour']]}, operating point {operating_point(roc)}")

    reset()
    t0 = time.perf_counter()
    analysis = model_analysis.analyze_model(predict, ["alpha"], 0.0, str(root), ["unknown"], ["unknown"], ["unknown"],
                                            num_samples_command=25, n_examples_oov_unknown=40, seed=0, device=dev)
    t_analysis = time.perf_counter() - t0
    l_analysis = launches()
    check(l_analysis.get("clip_features", 0) > 0, f"analyze_model launched {l_analysis}")
    sizes = {k: len(analysis[k]["correct"]) + len(analysis[k]["incorrect"])
             for k in ("target_keywords", "oov", "unknown_training", "original_embedding")}
    check(sizes == {"target_keywords": 25, "oov": 40, "unknown_training": 40, "original_embedding": 40},
          f"analyze_model's clip counts {sizes}")
    tprs, fprs = model_analysis.calc_roc(analysis)
    print(f"phase j: analyze_model on phase e's clips {t_analysis:.3f} s, launches {l_analysis}; clips {sizes}; "
          f"AUC {model_analysis.auc(tprs, fprs):.4f}")
    return {"realtime": rt_launches, "cluster_and_sort": l_cluster, "sweep_point": l_sweep, "run_job": l_job,
            "analyze_model": l_analysis}


K_BATCH = 64  # phase k: the DS-CNN's batch
K_STEPS = 16  # steps an epoch: dscnn_optimizer(steps_per_epoch=K_STEPS)
K_EPOCHS = 5  # 80 steps: the learning rate stays 5e-4 (its first switch is at epoch 12)
K_SECONDS = 60  # the stream's seconds that the native frontend and the profiled stream run on
# phase k: a float32 DS-CNN gradient's distance from the float64 one, of each
# tensor's largest (``dscnn_gate``; tests/test_torch_dscnn.py measures the
# CPU's on a training batch of phase e's corpus and holds it under half of this)
K_F32_GRAD_TOL = 2e-2

# phase k: a fresh process in another checkout of the package, with the
# shared build cache on: what it finds built and what it compiles; then a
# calculate_streaming_accuracy under utils/profiling.trace, inside a
# PhaseTimer phase (argv: the checkout, the stream's wav and labels, the
# trace directory)
FRESH_K = r"""
import json, sys, time
t0 = time.perf_counter()
sys.path.insert(0, sys.argv[1])
from multilingual_kws_tpu_torch import native
from multilingual_kws_tpu_torch.ops import _build
from multilingual_kws_tpu_torch.utils.compilation_cache import enable_compilation_cache

enabled = enable_compilation_cache()
found = {n: _build._target(n).exists() for n in _build.SIGNATURES}
found.update({n: native.target(n).exists() for n in ("microfrontend", "wavloader")})
t1 = time.perf_counter()
compiled = sorted(_build.build())
libs = [_build.load(n) for n in _build.SIGNATURES] + [native.load(n, {}) for n in ("microfrontend", "wavloader")]
cache = {"enabled": enabled, "build_dir": str(_build.BUILD_DIR), "found": found, "compiled": compiled,
         "loaded": len(libs), "load_s": time.perf_counter() - t1, "wall_s": time.perf_counter() - t0}

import torch
from multilingual_kws_tpu_torch.models.kws_model import make_transfer_model, seeded_init_
from multilingual_kws_tpu_torch.ops import cuda_fft, cuda_frontend
from multilingual_kws_tpu_torch.stream.engine import StreamFlags, calculate_streaming_accuracy
from multilingual_kws_tpu_torch.utils import profiling

flags = StreamFlags(wav=sys.argv[2], ground_truth=sys.argv[3], target_keyword="alpha", detection_thresholds=[0.5])
model = seeded_init_(make_transfer_model(device="cuda"), seed=0)
calculate_streaming_accuracy(model, [flags], batch_size=2048, verbose=False)  # cuDNN set-up
timer = profiling.PhaseTimer()
cuda_fft.stream_prefix.launches = cuda_frontend.stream_suffix.launches = 0
with profiling.trace(sys.argv[4]) as path:
    with timer.phase("stream_60s"):
        calculate_streaming_accuracy(model, [flags], batch_size=2048, verbose=False)
events = json.loads(path.read_text())["traceEvents"]
kernels = [e for e in events if e.get("cat") == "kernel"]
trace = {"bytes": path.stat().st_size, "events": len(events), "kernel_events": len(kernels),
         "ours": {k: sum(f"{k}_kernel" in e["name"] for e in kernels) for k in ("stream_prefix", "stream_suffix")},
         "spans": sorted(e.get("cat") for e in events if e.get("name") == "stream_60s"),
         "launches": {"stream_prefix": cuda_fft.stream_prefix.launches, "stream_suffix": cuda_frontend.stream_suffix.launches},
         "report": timer.report()}
print("FRESH_K " + json.dumps({"cache": cache, "trace": trace}))
"""


def dscnn_gate(torch, state, specs, y, loss_of):
    """Phase k's card-vs-CPU DS-CNN step: one train-mode step from ``state``
    on the card and on the CPU, each in float64 and in float32 (BN keeps
    float64 input in float64), with the same batch and the same dropout
    masks (one CPU generator's draws).

    Bounds. Losses rtol 1e-5, card against CPU, in both precisions. In
    float64 the card's gradients match the CPU's within rtol 1e-4 and atol
    1e-4 of each tensor's largest: the same function. In float32, each
    side's gradients lie within K_F32_GRAD_TOL of each tensor's largest of
    the float64 CPU gradient. Error model: below the global pooling every
    gradient comes out of train-mode BNs' backward, which subtracts the
    batch mean of a gradient that is nearly the same at every position (the
    pooling spreads one value over the map), and a conv's weight gradient
    then sums, over the batch's 32,000 positions, products whose exact sum
    has that mean's share removed; float32 keeps few digits of either
    difference, and in another order on each side (torch's CPU sums
    pairwise, cuDNN by its own tiling), so card and CPU float32 disagree by
    ~1e-4 of a tensor's largest (NVIDIA H100 80GB HBM3, 700 W) and float32
    sits up to ~3e-3 from the float64 gradient on some of phase e's batches
    (tests/test_torch_dscnn.py measures it on the CPU). Gradients that
    vanish: a conv bias feeds a train-mode BN, which removes any shift, so
    its gradient is exactly zero (held to 1e-9 of the model's largest in
    float64); and at the seeded init, whose BN biases are 0, the stem's and
    blocks 1-3's last BN scale reach the loss through relu (positively
    homogeneous), a depthwise conv and a train-mode BN, which removes any
    per-channel scale but for its eps: their float64 gradients are ~3e-7 of
    the model's largest. Where the float64 gradient is below 1e-4 of the
    model's largest, float32 holds rounding, held to 1e-4 of the model's
    largest on both sides."""
    from multilingual_kws_tpu_torch.models.dscnn import DSCNN

    got = {}
    for where in ("cuda", "cpu"):
        for dtype in (torch.float64, torch.float32):
            m = DSCNN(3, device=where)
            m.load_state_dict(state)
            m.to(dtype).train()
            loss = loss_of(m, specs.to(where, dtype), y.to(where), torch.Generator().manual_seed(5))
            loss.backward()
            got[where, dtype] = float(loss.detach()), {n: p.grad.double().cpu() for n, p in m.named_parameters()}
    for dtype in (torch.float64, torch.float32):
        lg, lc = got["cuda", dtype][0], got["cpu", dtype][0]
        check(abs(lg - lc) <= 1e-5 * abs(lc), f"DS-CNN step loss at {dtype}: {lg} on the card, {lc} on the CPU")
    g64, c64 = got["cuda", torch.float64][1], got["cpu", torch.float64][1]
    g32, c32 = got["cuda", torch.float32][1], got["cpu", torch.float32][1]
    blocks = [n.split(".")[0] for n in state if n.endswith(".dw.weight")]
    zero = {"stem.bias"} | {f"{b}.{c}.bias" for b in blocks for c in ("dw", "pw")}
    largest = max(float(w.abs().max()) for w in c64.values())
    vanish = {n for n, w in c64.items() if float(w.abs().max()) < 1e-4 * largest}
    err = {"f64 card-cpu": 0.0, "f32 card-cpu": 0.0, "f32 card-f64": 0.0, "f32 cpu-f64": 0.0,
           "zero f64": 0.0, "vanishing f32": 0.0}
    for n, w in c64.items():
        if n in zero:
            z64 = max(float(g64[n].abs().max()), float(w.abs().max())) / largest
            check(z64 < 1e-9, f"DS-CNN float64 gradient of {n}, exactly zero: {z64:.2e} of the largest")
            err["zero f64"] = max(err["zero f64"], z64)
        else:
            scale = float(w.abs().max())
            check(torch.allclose(g64[n], w, rtol=1e-4, atol=1e-4 * scale),
                  f"DS-CNN float64 gradient of {n}: {float((g64[n] - w).abs().max()) / scale:.2e} of its largest")
            err["f64 card-cpu"] = max(err["f64 card-cpu"], float((g64[n] - w).abs().max()) / scale)
        if n in vanish:
            z32 = max(float(g32[n].abs().max()), float(c32[n].abs().max())) / largest
            check(z32 < 1e-4, f"DS-CNN float32 gradient of {n}, vanishing: {z32:.2e} of the model's largest")
            err["vanishing f32"] = max(err["vanishing f32"], z32)
            continue
        scale = float(w.abs().max())
        for key, a, b in (("f32 card-cpu", g32[n], c32[n]), ("f32 card-f64", g32[n], w), ("f32 cpu-f64", c32[n], w)):
            err[key] = max(err[key], float((a - b).abs().max()) / scale)
        check(err["f32 card-f64"] <= K_F32_GRAD_TOL and err["f32 cpu-f64"] <= K_F32_GRAD_TOL,
              f"DS-CNN float32 gradient of {n} off the float64 one: {err}")
    return {"loss": (got["cuda", torch.float32][0], got["cpu", torch.float32][0]), "err": err,
            "zero": sorted(zero), "vanishing": sorted(vanish)}


def dscnn_phase(torch, fe, corpus, wave, labels, work: Path, smi: str):
    """Phase k: the DS-CNN at the reference's width on phase e's corpus, the
    native host frontend and wav loader against the card, the profiling
    hooks around a stream, the shared build cache from another checkout, and
    the wav2vec2 embedder (see the module docstring)."""
    import copy
    import importlib.util
    import shutil

    import torch.nn.functional as F

    from multilingual_kws_tpu_torch.data.dataset import AudioDataset
    from multilingual_kws_tpu_torch.models.dscnn import DSCNN, dscnn_optimizer
    from multilingual_kws_tpu_torch.models.kws_model import lecun_init_
    from multilingual_kws_tpu_torch.models.wav2vec2_embed import Wav2Vec2Embedder
    from multilingual_kws_tpu_torch.native import host_frontend, wavloader
    from multilingual_kws_tpu_torch.ops import cuda_augment, cuda_clip
    from multilingual_kws_tpu_torch.settings import standard_microspeech_model_settings
    from multilingual_kws_tpu_torch.train.evaluate import featurize_files
    from multilingual_kws_tpu_torch.utils.wav import read_wav_int16, write_wav

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    counters = {"augment_quantize": cuda_augment.augment_quantize, "clip_features": cuda_clip.clip_features}

    # 1. the DS-CNN (filters 64, 4 blocks, 3 labels) trained on batches of
    # AudioDataset.train_batches (augment_quantize, then clip_features)
    ds = AudioDataset(standard_microspeech_model_settings(3), ["alpha"], corpus["bg_dir"], corpus["unknown"],
                      seed=7, device="cuda")
    check(ds.commands == ["_silence_", "_unknown_", "alpha"], f"labels {ds.commands}")
    model = lecun_init_(DSCNN(3, device="cpu"), seed=0).to(dev)
    init = copy.deepcopy(model.state_dict())
    n_params = sum(p.numel() for p in model.parameters())
    opt = dscnn_optimizer(steps_per_epoch=K_STEPS)(model.parameters())
    drop = torch.Generator(device=dev).manual_seed(2)

    def loss_of(m, specs, y, gen):
        # categorical cross-entropy on the softmax, clipped as Keras does
        p = m(specs, dropout_generator=gen)
        return F.nll_loss(torch.log(p.clamp(1e-7, 1 - 1e-7)), y)

    batches = ds.train_batches(corpus["train"], K_BATCH, K_EPOCHS * K_STEPS + 1)
    epoch_loss, epoch_ms = [], []
    for fn in counters.values():
        fn.launches = 0
    for _ in range(K_EPOCHS):
        sync()
        t0 = time.perf_counter()
        losses = []
        for _ in range(K_STEPS):
            specs, y = next(batches)
            model.train()
            opt.zero_grad(set_to_none=True)
            loss = loss_of(model, specs, y, drop)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        epoch_loss.append(float(torch.stack(losses).mean()))
        sync()
        epoch_ms.append((time.perf_counter() - t0) / K_STEPS * 1e3)
    dscnn_launches = {k: fn.launches for k, fn in counters.items()}
    n_steps = K_EPOCHS * K_STEPS
    check(dscnn_launches == {"augment_quantize": n_steps, "clip_features": n_steps},
          f"DS-CNN training launches {dscnn_launches}, expected {n_steps} of each")
    check(np.isfinite(epoch_loss).all(), f"a non-finite DS-CNN loss {epoch_loss}")
    check(epoch_loss[-1] < epoch_loss[0], f"DS-CNN epoch losses did not fall: {epoch_loss}")
    check(opt.count == n_steps and opt.lr() == 5e-4, f"optimizer at count {opt.count}, lr {opt.lr()}")
    probe = dscnn_optimizer(steps_per_epoch=K_STEPS)([torch.nn.Parameter(torch.zeros(1, device=dev))])
    schedule = {}
    for step, lr in ((0, 5e-4), (12 * K_STEPS, 1e-4), (24 * K_STEPS, 2e-5), (36 * K_STEPS, 1e-5)):
        probe.count = step
        schedule[step] = probe.lr()
        check(schedule[step] == lr, f"learning rate {schedule[step]} at step {step}, expected {lr}")

    # one step on the card against the same step on the CPU: the same batch,
    # the same dropout masks (one CPU generator's draws), from the seeded
    # init (a state that is the same in every run), in float64 and float32
    # (dscnn_gate)
    specs, y = next(batches)
    gate = dscnn_gate(torch, init, specs, y, loss_of)
    # batch eval after training: the 20 validation clips and the 40 unknowns
    model.eval()
    files = corpus["val"] + corpus["unknown"]
    want = ["alpha"] * len(corpus["val"]) + ["_unknown_"] * len(corpus["unknown"])
    correct, predicted = 0, np.zeros(3, np.int64)
    with torch.no_grad():
        for x, t in ds.eval_batches(files, K_BATCH, labels=want, single_target=False):
            top = model(x).argmax(-1)
            correct += int((top == t).sum())
            predicted += np.bincount(top.cpu().numpy(), minlength=3)
    accuracy = correct / len(files)

    # 2. the native host frontend and wav loader against the card, ==
    threads = host_frontend.default_threads()
    clips = corpus["train"] + corpus["val"] + corpus["unknown"]
    native_fe = host_frontend.NativeMicroFrontend()  # builds the library (g++) at first use
    walls = {}
    for backend in ("device", "native", "device", "native"):
        sync()
        t0 = time.perf_counter()
        feats = featurize_files(clips, backend=backend, device="cuda")
        walls.setdefault(backend, []).append(time.perf_counter() - t0)
        if backend == "device":
            dev_feats = feats
        else:
            check(np.array_equal(feats, dev_feats), "featurize_files: native != device")
    i16 = np.clip(np.trunc(wave[: K_SECONDS * SR] * 32768.0), -32768, 32767).astype(np.int16)
    n_w = -(-(K_SECONDS * SR - SR) // 320)
    audio = torch.from_numpy(i16).to(dev)
    card = fe.stream_features(audio, n_w)
    sync()
    t0 = time.perf_counter()
    card = fe.stream_features(audio, n_w).cpu().numpy()
    wall_card_stream = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = native_fe.stream_features(i16, n_w)
    wall_native_stream = time.perf_counter() - t0
    check(np.array_equal(host, card), f"native stream features != the card's on {n_w} windows")
    t0 = time.perf_counter()
    batch = wavloader.load_batch(clips, SR)
    wall_loader = time.perf_counter() - t0
    t0 = time.perf_counter()
    reader = np.stack([read_wav_int16(f, desired_samples=SR)[0] for f in clips])
    wall_reader = time.perf_counter() - t0
    check(np.array_equal(batch, reader), "load_batch != read_wav_int16 on the corpus")

    # 3. in a fresh process of another checkout of the package: the shared
    # build cache (nothing compiled), then profiling: one
    # calculate_streaming_accuracy on K_SECONDS of the stream inside a
    # PhaseTimer phase, under utils/profiling.trace. (In this long process
    # such a trace held none of the stream kernels' events in five tries,
    # though a CUDA-only trace here and the same trace in a fresh process
    # hold them: PERF.md §7.)
    wav, gt = work / "stream_k.wav", work / "labels_k.txt"
    write_wav(wav, wave[: K_SECONDS * SR], SR)
    gt.write_text("".join(f"{lab}, {ms}\n" for lab, ms in labels if ms < K_SECONDS * 1000))
    other = work / "other_checkout"
    shutil.copytree(ROOT / PKG, other / PKG, ignore=shutil.ignore_patterns("_build", "__pycache__"))
    out = subprocess.run([sys.executable, "-c", FRESH_K, str(other), str(wav), str(gt), str(work / "trace_k")],
                         capture_output=True, text=True, timeout=600)
    check(out.returncode == 0, f"the fresh process of phase k failed: {out.stderr[-3000:]}")
    fresh = json.loads([ln for ln in out.stdout.splitlines() if ln.startswith("FRESH_K ")][-1][8:])
    cache, trace = fresh["cache"], fresh["trace"]
    check(cache["enabled"] and all(cache["found"].values()) and cache["compiled"] == [],
          f"another checkout did not load the cached libraries: {cache}")
    check(not (other / PKG / "_build").exists(), "another checkout built into its own _build")
    check(trace["launches"] == {"stream_prefix": 1, "stream_suffix": 1}, f"profiled stream launches {trace['launches']}")
    check(all(trace["ours"].values()) and trace["spans"],
          f"the trace holds kernel events {trace['ours']} and phase spans {trace['spans']}")

    # 5. the wav2vec2 embedder needs the transformers package
    if importlib.util.find_spec("transformers") is None:
        try:
            Wav2Vec2Embedder(device="cuda", model=object(), extractor=object())
            fail("Wav2Vec2Embedder ran without the transformers package")
        except ImportError as e:
            check("'transformers'" in str(e), f"the embedder's error does not name the package: {e}")
            w2v = f"not run on this machine: it has no 'transformers' package (the embedder raises: {e}); " \
                  "tests/test_torch_wav2vec2.py holds it against the JAX package's on the CPU"
    else:
        from transformers import Wav2Vec2Config, Wav2Vec2FeatureExtractor, Wav2Vec2Model

        torch.manual_seed(0)
        tiny = Wav2Vec2Model(Wav2Vec2Config(hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                                            intermediate_size=64, conv_dim=(16,) * 7, num_feat_extract_layers=7))
        waves = [wave[i * SR : (i + 1) * SR] for i in range(4)]
        ref = Wav2Vec2Embedder(device="cpu", model=copy.deepcopy(tiny), extractor=Wav2Vec2FeatureExtractor())
        got_emb = Wav2Vec2Embedder(device="cuda", model=tiny, extractor=Wav2Vec2FeatureExtractor()).embed(waves)
        err = float(np.abs(got_emb - ref.embed(waves)).max())
        check(err < 1e-4, f"wav2vec2 embeddings on the card differ from the CPU's by {err}")
        w2v = f"a tiny random model on the card against the CPU: max |delta| {err:.2e}"

    print(f"phase k [{smi}]: DS-CNN (filters 64, 4 blocks, 3 labels, {n_params} parameters) at batch {K_BATCH}, "
          f"{K_EPOCHS} epochs x {K_STEPS} steps from AudioDataset.train_batches: epoch losses "
          f"{[round(v, 4) for v in epoch_loss]}; step {float(np.median(epoch_ms)):.3f} ms (median of {K_EPOCHS} "
          f"epochs, best {min(epoch_ms):.3f}: {[round(v, 3) for v in epoch_ms]}); launches {dscnn_launches}; "
          f"learning rate by step {schedule}; card vs CPU step from the seeded init: float32 loss "
          f"{gate['loss'][0]:.7f} / {gate['loss'][1]:.7f}; max gradient errors, of each tensor's largest (of the "
          f"model's for the {len(gate['zero'])} exact zeros and the {len(gate['vanishing'])} vanishing "
          f"{gate['vanishing']}) {json.dumps({k: float(f'{v:.3g}') for k, v in gate['err'].items()})}; "
          f"batch-eval accuracy {accuracy:.4f} (predicted {dict(zip(ds.commands, predicted.tolist()))}) on "
          f"{len(files)} clips")
    print(f"phase k [{smi}]: native == card: featurize_files on {len(clips)} clips (walls s, two runs each: device "
          f"{[round(v, 4) for v in walls['device']]}, native {[round(v, 4) for v in walls['native']]} on {threads} host "
          f"threads); stream features of {n_w} windows ({K_SECONDS} s): card {wall_card_stream:.4f} s (with the copy "
          f"to the host), native {wall_native_stream:.4f} s on {threads} threads; load_batch == read_wav_int16 on "
          f"{len(clips)} clips: {wall_loader:.4f} s on {wavloader.default_threads()} threads, reader {wall_reader:.4f} s")
    report = trace.pop("report")
    print(f"phase k [{smi}]: a fresh process of another checkout with the shared build cache: {json.dumps(cache)}; "
          f"there profiling.trace around calculate_streaming_accuracy on {K_SECONDS} s (phase c's model width, seeded "
          f"weights): {json.dumps(trace)}; PhaseTimer report:\n{report}")
    print(f"phase k [{smi}]: wav2vec2 embedder: {w2v}")


L_TARGET_S = 0.5  # phase l: the headline's chained timing, each dtype (the bench's default is 2 s)
L_PT_BATCH = 512  # phase l: the pretraining step held graphed == eager
L_MODEL_TOL = 1e-5  # entry() card against CPU: tests/test_torch_model.py's rtol and atol on logits


def phase_launches(torch, run):
    """(run's result, {wrapper name: launches during run}), the counters
    set to 0 just before it."""
    from multilingual_kws_tpu_torch.ops import _build

    for w in _build.WRAPPERS:
        w.launches = 0
    out = run()
    torch.cuda.synchronize()
    return out, {w.__name__: w.launches for w in _build.WRAPPERS if w.launches}


def bench_phase(torch, work: Path):
    """Phase l: the port's benchmark program and graft entry points on the
    card (see the module docstring). Returns each path's launches by
    kernel wrapper."""
    import contextlib
    import io

    from multilingual_kws_tpu_torch import bench, graft_entry
    from multilingual_kws_tpu_torch.examples import tutorial
    from multilingual_kws_tpu_torch.train.graphs import EpochGraph
    from multilingual_kws_tpu_torch.train.steps import flat_adam, make_pretrain_step

    t_phase = time.perf_counter()
    launches = {}

    # 1. the bench's line: its preflight (B1 on 256 clips, B2 and B3 on four
    # 2.5 s clips, B4 on 64 against the plain version), then the headline
    # at full width and batch 2048, float32 and bf16, a shorter timing
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc, launches["bench"] = phase_launches(torch, lambda: bench.main([], target_s=L_TARGET_S))
    bench_s = time.perf_counter() - t0
    out = buf.getvalue().strip().splitlines()
    check(rc == 0 and len(out) == 1, f"bench: exit {rc}, output {out}")
    line = json.loads(out[0])
    check(line["bit_exact_on_chip"] is True and line["value"] > 0 and line["device"]["count"] >= 1
          and line["mfu"] is not None and line["flops_per_clip"] > 0, f"bench line {line}")
    need = ("clip_features", "stream_prefix", "stream_suffix", "augment_quantize")
    check(all(launches["bench"].get(k, 0) > 0 for k in need), f"bench launches {launches['bench']}: not all of {need}")

    # 2. the pretraining step at batch 512 on fixed feature windows: an
    # epoch graph of it (train/graphs.EpochGraph) == the eager steps on an
    # epoch's first two steps (the eager warm-up step and the first replay),
    # under deterministic cuDNN, from one init
    rng = np.random.default_rng(0)
    specs = torch.from_numpy(rng.normal(0, 2, (L_PT_BATCH, 49, 40, 1)).astype(np.float32)).cuda()
    labels = torch.from_numpy(rng.integers(0, 761, (L_PT_BATCH,))).cuda()
    inputs = (torch.zeros((2, L_PT_BATCH), dtype=torch.int32, device="cuda"), labels.expand(2, L_PT_BATCH).contiguous(),
              torch.zeros((2, L_PT_BATCH), dtype=torch.bool, device="cuda"))

    def fixed_specs_epoch(model):
        """(an EpochGraph of the step, the step): one make_pretrain_step
        update of ``model`` (flat Adam 1e-3, drop-connect seeded 1) on
        ``specs`` with a step's labels; its rows and silence flags unread."""
        opt = flat_adam(model.parameters(), 1e-3)
        drop = torch.Generator(device="cuda")
        drop.manual_seed(1)
        step = make_pretrain_step(model, opt, None)[0].fn  # eager: the epoch's graph holds it

        def body(rows, labels, is_silence):
            m = step(specs, labels, drop)
            return m["loss"], m["accuracy"]

        return EpochGraph(body, specs.device, generators=[drop], optimizer=opt), body

    with deterministic_cudnn(torch):
        mg, me = bench.embedding_model("float32", "cuda"), bench.embedding_model("float32", "cuda")
        epoch, _ = fixed_specs_epoch(mg)
        lg, _ = epoch(*inputs)
        _, body = fixed_specs_epoch(me)
        le = torch.stack([body(*(t[i] for t in inputs))[0] for i in range(2)])
        torch.cuda.synchronize()
    diffs = tensor_diffs(torch, mg.state_dict(), me.state_dict())
    check(epoch.replays == 1 and torch.equal(lg, le) and not diffs,
          f"graphed pretraining step != eager: replays {epoch.replays}, losses {lg.tolist()} {le.tolist()}, {diffs}")
    del mg, me, epoch, body

    # 3. entry() on the card against the CPU on seeded audio, both with the
    # weights tests/test_torch_graft_entry.py gives the JAX entry's, so that
    # the rows differ: BN statistics and parameters moved off their init,
    # the stem's kernel scaled by 255 (undoing the 1/255 input scale)
    (fwd_gpu, (example,)), (fwd_cpu, _) = graft_entry.entry(), graft_entry.entry(device="cpu")
    moved, rng = {}, np.random.default_rng(1)
    for k, t in fwd_cpu.model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            t = t + torch.from_numpy(rng.uniform(0.05, 0.5, tuple(t.shape)).astype(np.float32))
        elif t.is_floating_point():
            t = t * torch.from_numpy(rng.uniform(0.8, 1.5, tuple(t.shape)).astype(np.float32))
        moved[k] = t * 255.0 if k == "trunk.stem.conv.weight" else t
    for f in (fwd_gpu, fwd_cpu):
        f.model.load_state_dict(moved)
    audio = np.random.default_rng(2).normal(0, 0.2, (8, 16000)).astype(np.float32).clip(-1, 1)
    with torch.inference_mode():
        got, launches["entry"] = phase_launches(torch, lambda: fwd_gpu(torch.from_numpy(audio).cuda()).cpu())
        want = fwd_cpu(torch.from_numpy(audio))
        shape = tuple(fwd_gpu(example).shape)
    entry_err = float((got - want).abs().max())
    spread = float(want.max(0).values.sub(want.min(0).values).max())  # across the clips: ten tolerances or more
    check(shape == (8, 761) and spread > 10 * L_MODEL_TOL
          and torch.allclose(got, want, rtol=L_MODEL_TOL, atol=L_MODEL_TOL),
          f"entry(): card against CPU {entry_err} (shape {shape}, spread across clips {spread})")
    del fwd_gpu, fwd_cpu

    # 4. the multi-card dry run on one rank over NCCL at full width (a
    # spawned process: its launches are its own)
    t0 = time.perf_counter()
    dry = graft_entry.dryrun_multichip(1, full_size=True)
    dry_s = time.perf_counter() - t0
    check(len(dry["lines"]) == 4 and np.isfinite([dry["step_loss"], dry["fused_loss"], *dry["epoch_losses"]]).all()
          and dry["windows"] == 100, f"dryrun_multichip(1): {dry}")

    # 5. the tutorial at full width (the notebook's fine-tune: 4 x 64 steps
    # at batch 64)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        summary, launches["tutorial"] = phase_launches(torch, lambda: tutorial.run_tutorial(work / "tutorial"))
    tut_s = time.perf_counter() - t0
    check(summary["embedding_dim"] == 192 and all(0.0 <= summary[k] <= 1.0 for k in
                                                   ("val_accuracy", "test_accuracy", "nontarget_accuracy"))
          and all(launches["tutorial"].get(k, 0) > 0 for k in ("clip_features", "augment_quantize")),
          f"tutorial: {summary}, launches {launches['tutorial']}")

    print(out[0])
    print(f"phase l: bench (preflight, then the headline at batch {bench.BATCH}, chained {L_TARGET_S} s a dtype) "
          f"{bench_s:.2f} s: {line['value']} clips/s at {line['model_compute_dtype']} (f32 {line['f32_clips_per_sec']}, "
          f"bf16 {line['bf16_clips_per_sec']}), {line['flops_per_clip']} FLOP a clip, MFU {line['mfu']:.4f}; "
          f"launches {launches['bench']}")
    print(f"phase l: pretraining step at batch {L_PT_BATCH}: graphed == eager on an epoch's first two steps, "
          "bitwise, under deterministic cuDNN")
    print(f"phase l: entry() card vs CPU on 8 clips: max |logit delta| {entry_err:.2e} (rtol, atol {L_MODEL_TOL}; "
          f"logits spread {spread:.2e} across the clips); "
          f"launches {launches['entry']}")
    print(f"phase l: dryrun_multichip(1, full_size=True) over nccl {dry_s:.2f} s: " + " | ".join(dry["lines"]))
    print(f"phase l: run_tutorial at full width {tut_s:.2f} s: {json.dumps(summary)}; launches {launches['tutorial']}")
    print(f"phase l: {time.perf_counter() - t_phase:.1f} s")
    return launches


M_TURNS = 5  # phase m: graphed and eager timings, in turns, each side this many times
M_CHUNKS_MS = (20, 100, 500)  # phase m: realtime feeds of 1, 5 and 25 windows
M_FEEDS = 50  # phase m: timed realtime feeds a turn and chunk size
M_HEADLINE_ITERS = 12  # phase m: chained headline calls a turn (the bench's least)
M_SECONDS = 10  # phase m: realtime detections graphed against eager on the stream's first seconds
M_STEM = "trunk.stem.conv.weight"  # phase m: the weight moved in place and swapped


def graph_phase(torch, fe, stream_model, ft_model, wave, work: Path):
    """Phase m: the inference programs as CUDA graphs (``train/graphs.ProgramGraphs``)
    on the card. For each program of the list below: graphed == eager
    (bitwise) on the key's eager call, its capture and a replay; two
    replays on different inputs leave the first output unchanged; an
    in-place change of the stem's weight moves the output (same key, no
    capture) and a swap of its storage recaptures; the captures, replays
    and the program's memory pool are printed. Then graphed against eager
    in turns: the bench's headline (clips/s, f32 and bf16), realtime feeds
    of 20, 100 and 500 ms (p50 / p99 of the feeds' walls) and the stream
    (windows/s, f32 and bf16). Returns each graphed path's launches by
    kernel wrapper, the counts set to 0 just before it."""
    from multilingual_kws_tpu_torch import bench
    from multilingual_kws_tpu_torch.analysis.distance_filtering import make_embedding_fn
    from multilingual_kws_tpu_torch.stream.engine import StreamFlags, calculate_streaming_accuracy, model_predict_fn
    from multilingual_kws_tpu_torch.stream.realtime import RealtimeDetector
    from multilingual_kws_tpu_torch.train import graphs
    from multilingual_kws_tpu_torch.train.finetune import FinetuneResult
    from multilingual_kws_tpu_torch.utils.wav import write_wav

    t_phase = time.perf_counter()
    dev = fe.device
    sync = torch.cuda.synchronize
    rng = np.random.default_rng(12)
    i16 = np.clip(np.trunc(wave * 32768.0), -32768, 32767).astype(np.int16)
    windows = fe.stream_features(torch.from_numpy(i16[: SR + (2 * BATCH - 1) * 320]).to(dev), 2 * BATCH)[..., None]

    stream16 = bf16_copy(torch, stream_model)
    head = {dtype: bench.embedding_model(dtype, dev) for dtype in ("float32", "bfloat16")}
    audio = torch.from_numpy(rng.normal(0, 0.1, (BATCH, SR)).astype(np.float32).clip(-1, 1)).to(dev)
    zero = torch.zeros((), device=dev)
    step = {dtype: bench.headline_step(fe, m) for dtype, m in head.items()}
    predict_ft = FinetuneResult("m", ft_model, {}, None).predict_fn()
    embed_ft = make_embedding_fn(ft_model)

    def prog(m, method=graphs.eval_forward):
        return graphs.module_program(m, method)

    def to_tensor(x):
        return torch.as_tensor(x, device=dev)

    # name: (graphed call, the eager body on the same arguments, its program,
    # the model whose stem moves, two argument tuples)
    cases = {
        f"stream f32, batch {BATCH}": (model_predict_fn(stream_model), lambda x: graphs.eval_forward(stream_model, x),
                                   prog(stream_model), stream_model, (windows[:BATCH],), (windows[BATCH:],)),
        f"stream bf16, batch {BATCH}": (model_predict_fn(stream16), lambda x: graphs.eval_forward(stream16, x),
                                    prog(stream16), stream16, (windows[:BATCH],), (windows[BATCH:],)),
        "FinetuneResult.predict_fn, 64 host arrays": (
            predict_ft, lambda x: graphs.eval_forward(ft_model, to_tensor(x)), prog(ft_model), ft_model,
            (windows[:64].cpu().numpy(),), (windows[64:128].cpu().numpy(),)),
        "make_embedding_fn, 64 host arrays": (
            embed_ft, lambda x: graphs.eval_embed(ft_model, to_tensor(x)).float().cpu().numpy(),
            prog(ft_model, graphs.eval_embed), ft_model,
            (windows[:64].cpu().numpy(),), (windows[64:128].cpu().numpy(),)),
    }
    for n in (1, 5, 25):
        cases[f"realtime predict, {n} windows"] = (
            model_predict_fn(ft_model), lambda x: graphs.eval_forward(ft_model, x), prog(ft_model), ft_model,
            (windows[:n],), (windows[n : 2 * n],))
    for dtype, m in head.items():
        cases[f"bench headline {dtype}, batch {BATCH}"] = (step[dtype], step[dtype].fn, step[dtype], m,
                                                        (audio, zero), (audio * 0.5, zero + 1e-3))

    def same(a, b):
        if isinstance(a, np.ndarray):
            return np.array_equal(a, b)
        return a.shape == b.shape and torch.equal(a, b)

    def err(a, b):
        return float(np.abs(np.asarray(a) - np.asarray(b)).max()) if isinstance(a, np.ndarray) else \
            float((a.float() - b.float()).abs().max())

    lines = []
    for name, (call, eager, program, model, xa, xb) in cases.items():
        stem = model.get_parameter(M_STEM)
        stem.data = stem.data.clone()  # new storage: a key of this case's own, whatever ran before
        captures0, eager0 = program.captures, program.eager_calls
        want_a = eager(*xa)
        outs = [call(*xa) for _ in range(3)]  # the key's eager call, its capture, a replay
        sync()
        errs = [err(o, want_a) for o in outs]
        check(all(same(o, want_a) for o in outs), f"phase m: {name}: graphed != eager: max |delta| {errs}")
        check(program.captures == captures0 + 1 and program.eager_calls == eager0 + 1,
              f"phase m: {name}: {program.eager_calls - eager0} eager calls and {program.captures - captures0} "
              "captures in a new key's first three calls")
        kept = outs[-1].copy() if isinstance(outs[-1], np.ndarray) else outs[-1].clone()
        first, second = call(*xa), call(*xb)
        sync()
        check(same(first, kept) and same(second, eager(*xb)) and not same(second, first),
              f"phase m: {name}: a second replay on other inputs changed the first output or is wrong")
        captured = program.captures
        with torch.no_grad():
            saved = stem.detach().clone()
            stem.mul_(1.25)
            moved = call(*xa)
            moved_ok = same(moved, eager(*xa)) and not same(moved, first)
            stem.copy_(saved)
        sync()
        check(moved_ok and program.captures == captured,
              f"phase m: {name}: an in-place weight change did not move the output ({moved_ok}), or recaptured "
              f"({program.captures - captured} captures)")
        stem.data = stem.data.clone()  # new storage: a new key, its eager call, then a capture
        swapped = [call(*xa) for _ in range(2)]
        sync()
        check(all(same(o, want_a) for o in swapped) and program.captures == captured + 1,
              f"phase m: {name}: after a storage swap {program.captures - captured} captures, outputs "
              f"{[err(o, want_a) for o in swapped]}")
        lines.append(f"{name}: graphed == eager (eager call, capture, replay); the first replay's output kept "
                     f"through a second on other inputs; stem x1.25 in place moved it with no capture; a storage "
                     f"swap recaptured; program captures {program.captures}, replays {program.replays}, eager "
                     f"calls {program.eager_calls}, capture {program.capture_s:.3f} s in all")
    pools = {name: program.pool_bytes() for name, program in (
        ("stream f32", prog(stream_model)), ("stream bf16", prog(stream16)), ("phase e's predict", prog(ft_model)),
        ("phase e's embedding", prog(ft_model, graphs.eval_embed)), ("headline f32", step["float32"]),
        ("headline bf16", step["bfloat16"]))}
    for line in lines:
        print(f"phase m: {line}")
    print("phase m: memory pools (MiB, allocator snapshot): " + ", ".join(
        f"{k} {v / 2**20:.1f}" if v is not None else f"{k} not measured" for k, v in pools.items()))
    del windows, cases

    launches = {}

    # the bench's headline, graphed against eager in turns
    def chained(fn, iters=M_HEADLINE_ITERS):
        e = zero
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            e = fn(audio, e)
        sync()
        return BATCH * iters / (time.perf_counter() - t0)

    rates = {}
    for dtype, graphed in step.items():
        for fn in (graphed, graphed.fn):
            chained(fn, 3)
        _, launches[f"headline_{dtype}"] = phase_launches(torch, lambda: chained(graphed))
        rates[dtype] = {"graphed": [], "eager": []}
        for turn in range(M_TURNS):
            for side in (("graphed", "eager") if turn % 2 == 0 else ("eager", "graphed")):
                rates[dtype][side].append(chained(graphed if side == "graphed" else graphed.fn))
    del step, head

    # realtime feeds, graphed against eager in turns, on phase e's model
    feed_ms = {}
    eager_ft = lambda x: graphs.eval_forward(ft_model, x)  # noqa: E731

    def feeds(chunk_ms, predict, walls):
        det = RealtimeDetector("alpha", predict, detection_threshold=J_THRESHOLD, device=dev)
        det.feed(wave[:SR])
        chunk = chunk_ms * SR // 1000
        out = []
        for i in range(M_FEEDS + 2):
            sync()
            t0 = time.perf_counter()
            got = det.feed(wave[SR + i * chunk : SR + (i + 1) * chunk])
            sync()
            if i >= 2:  # two warm feeds: the program's eager call and its capture at the feed's batch
                walls.append((time.perf_counter() - t0) * 1e3)
            out.extend((d.time_ms, d.confidence) for d in got)
        return out

    def detect(chunk_ms, predict):
        det = RealtimeDetector("alpha", predict, detection_threshold=J_THRESHOLD, device=dev)
        step_n = chunk_ms * SR // 1000
        gate = wave[: M_SECONDS * SR]
        return [(d.time_ms, d.confidence) for i in range(0, len(gate), step_n) for d in det.feed(gate[i : i + step_n])]

    for chunk_ms in M_CHUNKS_MS:
        runs = {"eager": detect(chunk_ms, eager_ft)}
        runs["graphed"], launches[f"realtime_{chunk_ms}ms"] = phase_launches(torch, lambda: detect(chunk_ms, ft_model))
        check(runs["graphed"] == runs["eager"],
              f"phase m: realtime at {chunk_ms} ms: graphed detections {runs['graphed']} != eager {runs['eager']}")
        feed_ms[chunk_ms] = {"graphed": [], "eager": [], "detections": len(runs["graphed"])}
        for turn in range(M_TURNS):
            for side in (("graphed", "eager") if turn % 2 == 0 else ("eager", "graphed")):
                feeds(chunk_ms, ft_model if side == "graphed" else eager_ft, feed_ms[chunk_ms][side])

    # the stream, graphed against eager in turns, f32 and bf16
    wav, gt = work / "m_stream.wav", work / "m_labels.txt"
    write_wav(wav, wave, SR)
    gt.write_text("")
    flags = [StreamFlags(wav=str(wav), ground_truth=str(gt), target_keyword="alpha", detection_thresholds=[0.5])]
    n_w = -(-(len(wave) - SR) // 320)
    wps = {}
    for dtype, m in (("float32", stream_model), ("bfloat16", stream16)):
        sides = {"graphed": model_predict_fn(m), "eager": lambda x, m=m: graphs.eval_forward(m, x)}
        rows = {}
        for side, predict in sides.items():
            if side == "graphed":
                _, launches[f"stream_{dtype}"] = phase_launches(torch, lambda: calculate_streaming_accuracy(
                    predict, flags, batch_size=BATCH, verbose=False, device=dev))
            rows[side] = calculate_streaming_accuracy(predict, flags, batch_size=BATCH, verbose=False, device=dev)[1]
        check(np.array_equal(rows["graphed"], rows["eager"]),
              f"phase m: stream {dtype}: graphed rows != eager: {float(np.abs(rows['graphed'] - rows['eager']).max())}")
        wps[dtype] = {"graphed": [], "eager": []}
        for turn in range(M_TURNS):
            for side in (("graphed", "eager") if turn % 2 == 0 else ("eager", "graphed")):
                sync()
                t0 = time.perf_counter()
                calculate_streaming_accuracy(sides[side], flags, batch_size=BATCH, verbose=False, device=dev)
                sync()
                wps[dtype][side].append(n_w / (time.perf_counter() - t0))
    del stream16

    def spread(v):
        v = np.asarray(v)
        return f"median {np.median(v):.1f} ({v.min():.1f}-{v.max():.1f})"

    for dtype, r in rates.items():
        print(f"phase m: headline {dtype} clips/s over {M_TURNS} turns of {M_HEADLINE_ITERS} chained calls at batch "
              f"{BATCH}: graphed {spread(r['graphed'])}, eager {spread(r['eager'])}; graphed {r['graphed']}, "
              f"eager {r['eager']}")
    for chunk_ms, f in feed_ms.items():
        desc = "; ".join(f"{side} p50 {np.percentile(f[side], 50):.3f} p99 {np.percentile(f[side], 99):.3f}"
                         for side in ("graphed", "eager"))
        print(f"phase m: realtime {chunk_ms} ms feeds ({chunk_ms // 20} windows), ms a feed over {M_TURNS} x {M_FEEDS} "
              f"feeds: {desc}; graphed detections == eager ({f['detections']} in {M_SECONDS} s)")
    for dtype, w in wps.items():
        print(f"phase m: stream {dtype} windows/s ({n_w} windows, batch {BATCH}) over {M_TURNS} turns: graphed "
              f"{spread(w['graphed'])}, eager {spread(w['eager'])}; graphed rows == eager")
    print(f"phase m: launches by path {launches}")
    print(f"phase m: {time.perf_counter() - t_phase:.1f} s")
    return launches


N_STEPS = 6  # phase n: steps held graphed == eager (the key's eager call, its capture, then replays)
N_FT_EPOCHS = 2  # phase n: transfer_learn(resident=False) epochs held graphed == eager (64 steps each)
N_TURNS = 5  # phase n: graphed and eager timings, in turns, each side this many times
N_TIMED_STEPS = 8  # phase n: steps a turn of the step's timing at batch 64


def step_program_phase(torch, pt_corpus, ft_corpus, ft_model):
    """Phase n: the per-step programs as CUDA graphs on the card (see the
    module docstring). Returns each graphed path's launches by kernel
    wrapper, the counts set to 0 just before it."""
    import copy

    from multilingual_kws_tpu_torch.analysis import distance_filtering
    from multilingual_kws_tpu_torch.data.dataset import AudioDataset
    from multilingual_kws_tpu_torch.data.manifests import label_from_parent_dir
    from multilingual_kws_tpu_torch.models.kws_model import lecun_init_, make_embedding_model
    from multilingual_kws_tpu_torch.ops.augment import SpecAugParams
    from multilingual_kws_tpu_torch.parallel import mesh
    from multilingual_kws_tpu_torch.settings import standard_microspeech_model_settings
    from multilingual_kws_tpu_torch.train import graphs
    from multilingual_kws_tpu_torch.train import pretrain as pretrain_mod
    from multilingual_kws_tpu_torch.train.finetune import transfer_learn
    from multilingual_kws_tpu_torch.train.steps import flat_adam, make_pretrain_step

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    group = mesh.default_group()  # phase i's NCCL group of one rank: the collectives sit in the step's graph
    train, val = pt_corpus["train"], pt_corpus["val"]
    train_labels = [label_from_parent_dir(f) for f in train]
    val_labels = [label_from_parent_dir(f) for f in val]
    launches, programs, lines = {}, {}, []
    transform_replays = {}  # path -> {wrapper: its launches by a transform program's replay}

    def replayed(ds):
        """B4's and B1's launches by replays of ``ds``'s train and eval
        transform programs (B4 and B1 in the first's graph, B1 in the
        second's)."""
        train_r, eval_r = (ds._train_program.replays, ds._eval_program.replays) if ds else (0, 0)
        return {"augment_quantize": train_r, "clip_features": train_r + eval_r}

    def dataset():
        return AudioDataset(standard_microspeech_model_settings(PT_WORDS + 1), pt_corpus["words"], pt_corpus["bg_dir"],
                            [], silence_percentage=1.0, unknown_percentage=0.0,
                            spec_aug_params=SpecAugParams(percentage=80), seed=5, device=dev)

    def drop_generator():
        drop = torch.Generator(device=dev)
        drop.manual_seed(1)
        return drop

    def on_side(graphed, run):
        """run() through the programs, or eagerly under disable_graphs."""
        with contextlib.nullcontext() if graphed else graphs.disable_graphs():
            return run()

    def metrics(ms):
        return torch.stack([torch.stack([m["loss"], m["accuracy"]]) if isinstance(m, dict) else torch.stack(m)
                            for m in ms])

    def twin_check(what, twins):
        """twins: {graphed: (metrics, (model, optimizer, generators))}: the
        same bits, the last step's gradients (``.grad`` after a replay)
        included."""
        (mg, sg), (me, se) = twins[True], twins[False]
        diff = state_diffs(torch, sg, se)
        diff.update({f"grad.{k}": v for k, v in tensor_diffs(torch, *(
            {n: p.grad for n, p in side[0].named_parameters() if p.grad is not None} for side in (sg, se))).items()})
        if not torch.equal(mg, me):
            diff["metrics"] = float((mg - me).abs().max())
        check(not diff, f"phase n: {what}: graphed != eager: {diff}")

    def runs_of(program):
        return program.eager_calls, program.captures, program.replays

    base = {dtype: lecun_init_(make_embedding_model(PT_WORDS + 1, device="cpu", compute_dtype=dtype), seed=0)
            for dtype in ("float32", "bfloat16")}
    kept = {}
    with deterministic_cudnn(torch):  # float32 weight gradients are not repeatable under the default algorithms
        # 1. the streaming pipeline's steps at batch 64: the transform and
        # step programs beside the eager twin, f32 and bf16
        for dtype, short in (("float32", "f32"), ("bfloat16", "bf16")):
            twins = {}
            for graphed in (True, False):
                ds, model, drop = dataset(), copy.deepcopy(base[dtype]).to(dev), drop_generator()
                opt = flat_adam(model.parameters(), 1e-3)
                step, _ = make_pretrain_step(model, opt, group)

                def run(step=step, ds=ds, drop=drop):
                    return metrics([step(specs, lbl, drop) for specs, lbl in ds.train_batches(
                        train, PT_BATCH, N_STEPS, labels=train_labels, single_target=False, prefetch=2)])

                if graphed:
                    got, launches[f"stream_step_{short}"] = phase_launches(torch, run)
                    transform_replays[f"stream_step_{short}"] = replayed(ds)
                    kept[dtype] = (model, ds, step, drop)
                else:
                    got = on_side(False, run)
                twins[graphed] = (got, (model, opt, [ds.gen, drop]))
            twin_check(f"streaming pretraining steps {dtype}", twins)
            model, ds, step, drop = kept[dtype]
            check(runs_of(step) == runs_of(ds._train_program) == (1, 1, N_STEPS - 1),
                  f"phase n: {dtype}: step program runs {runs_of(step)}, transform {runs_of(ds._train_program)}")
            check(launches[f"stream_step_{short}"] == {"augment_quantize": N_STEPS, "clip_features": N_STEPS},
                  f"phase n: {dtype}: streaming steps launched {launches[f'stream_step_{short}']}")
            programs[f"pretraining step {dtype}"] = step
        programs["train transform"] = kept["float32"][1]._train_program
        lines.append(f"streaming pretraining steps at batch {PT_BATCH} (transform and step programs, prefetch 2, "
                     f"NCCL all-reduce in the graph), f32 and bf16: graphed == eager over {N_STEPS} steps (every "
                     "step's loss and accuracy, the model, Adam's state, both generators)")

        # 2. the scan_epoch=False resident step (build_fused_resident_step)
        twins = {}
        for graphed in (True, False):
            ds, model, drop = dataset(), copy.deepcopy(base["float32"]).to(dev), drop_generator()
            opt = flat_adam(model.parameters(), 1e-3)
            bank = ds.build_resident_bank(train)
            fused = pretrain_mod.build_fused_resident_step(model, opt, group, ds, bank["bank"], drop)
            idx, lbl, sil = ds._put_batch(tuple(np.stack(a) for a in zip(*ds.host_train_indices(
                train, PT_BATCH, N_STEPS, bank, labels=train_labels, single_target=False))))
            got = on_side(graphed, lambda: metrics([fused(idx[i], lbl[i], sil[i]) for i in range(N_STEPS)]))
            twins[graphed] = (got, (model, opt, [ds.gen, drop]))
            if graphed:
                programs["fused resident step f32"] = fused
        twin_check("the fused resident step", twins)
        check(runs_of(programs["fused resident step f32"]) == (1, 1, N_STEPS - 1),
              f"phase n: fused resident step runs {runs_of(programs['fused resident step f32'])}")
        lines.append(f"scan_epoch=False's fused resident step: graphed == eager over {N_STEPS} steps")

        # 3. pretrain(resident_data=False), the user's call, one epoch
        config = pretrain_mod.PretrainConfig(num_labels=PT_WORDS + 1, batch_size=PT_BATCH, num_epochs=1,
                                             steps_per_epoch=N_STEPS, bn_calibration_batches=1, resident_data=False,
                                             device=str(dev))
        twins = {}
        for graphed in (True, False):
            def run(model=copy.deepcopy(base["float32"])):
                return pretrain_mod.pretrain(train, val, pt_corpus["words"], pt_corpus["bg_dir"], config=config,
                                             model=model, verbose=0)

            if graphed:
                (model, hist, ds), launches["pretrain_stream"] = phase_launches(torch, run)
                transform_replays["pretrain_stream"] = replayed(ds)
            else:
                model, hist, ds = on_side(False, run)
            twins[graphed] = (model.state_dict(), hist, ds.gen.get_state())
        (sg, hg, gg), (se, he, ge) = twins[True], twins[False]
        diff = {f"model{k}": v for k, v in tensor_diffs(torch, sg, se).items()}
        check(not diff and hg == he and torch.equal(gg, ge),
              f"phase n: pretrain(resident_data=False): graphed != eager: {diff}, {hg} {he}")
        n_val = -(-len(val) // PT_BATCH)
        check(launches["pretrain_stream"] == {"augment_quantize": N_STEPS + 1, "clip_features": N_STEPS + 1 + n_val,
                                              "bn_act": B0_F32_SITES * n_val, "mbconv_middle": B0_BLOCKS * n_val,
                                              "mbconv_middle_split": B0_BLOCKS * n_val},
              f"phase n: pretrain(resident_data=False) launched {launches['pretrain_stream']}")
        lines.append(f"pretrain(resident_data=False), 1 epoch of {N_STEPS} steps, 1 calibration batch, {len(val)} "
                     f"validation clips: graphed == eager (history {hg}, model, the dataset's generator)")

        # 4. transfer_learn(resident=False) at the JAX defaults, fewer epochs
        twins, hists = {}, {}
        for graphed in (True, False):
            def run():
                return transfer_learn("alpha", ft_corpus["train"], ft_corpus["val"], ft_corpus["unknown"],
                                      num_epochs=N_FT_EPOCHS, bg_datadir=ft_corpus["bg_dir"], seed=7, verbose=0,
                                      resident=False, device=dev)

            if graphed:
                res, launches["transfer_learn_stream"] = phase_launches(torch, run)
                transform_replays["transfer_learn_stream"] = replayed(res.dataset)
            else:
                res = on_side(False, run)
            hists[graphed] = res.history
            twins[graphed] = (torch.tensor(res.history[0]["step_loss"] + res.history[0]["step_accuracy"]),
                              (res.model, res.optimizer, [res.dataset.gen]))
        twin_check("transfer_learn(resident=False)", twins)
        check(hists[True] == hists[False], "phase n: transfer_learn(resident=False): graphed history != eager")
        lines.append(f"transfer_learn(resident=False), {N_FT_EPOCHS} epochs of {FT_BATCH} steps from a fresh B0 "
                     "(calibration, steps, evaluate_dataset through programs): graphed == eager (history, model, "
                     "Adam's state, the generator)")

    # 5. validation: three passes (each batch shape's eager call, capture,
    # replays) against an eager pass, on the graphed f32 twin
    model, ds, _, _ = kept["float32"]
    passes = [pretrain_mod._validate(model, ds, val, val_labels, PT_BATCH, group) for _ in range(3)]
    want = on_side(False, lambda: pretrain_mod._validate(model, ds, val, val_labels, PT_BATCH, group))
    check(all(p == want for p in passes), f"phase n: validation sums graphed {passes} != eager {want}")
    programs["validation f32"] = graphs.module_program(model, pretrain_mod._validation_sums)
    programs["eval transform"] = ds._eval_program
    check(runs_of(programs["validation f32"])[1] == 2, f"phase n: validation runs {runs_of(programs['validation f32'])}")
    lines.append(f"validation sums over {len(val)} clips (batches of {PT_BATCH} and the last of "
                 f"{len(val) - (n_val - 1) * PT_BATCH}): three graphed passes == eager, {want[:2]}")

    # 6. k-means: the program (kmeans++ seeding and 50 Lloyd updates) on a
    # generator seeded anew each call, against an eager call
    pts = torch.from_numpy(np.random.default_rng(13).normal(0, 1, (50, 192)).astype(np.float32)).to(dev)
    gen = torch.Generator(device=dev)

    def fit():
        gen.manual_seed(3)
        return distance_filtering.kmeans_fit(pts, 5, gen)

    fits = [fit() for _ in range(3)]
    want = on_side(False, fit)
    programs["k-means"] = distance_filtering._fit_program(5, 50)
    check(all(torch.equal(f, want) for f in fits) and runs_of(programs["k-means"])[1] >= 1,
          f"phase n: k-means graphed != eager, or not captured: {runs_of(programs['k-means'])}")
    lines.append("kmeans_fit (50 x 192 points, 5 clusters, 50 updates): eager call, capture, replay == eager")

    # 7. one profiled graphed streaming step: B4 and B1 launched by cudaGraphLaunch
    model, ds, step, drop = kept["float32"]
    tr = graph_trace(torch, lambda: [step(specs, lbl, drop) for specs, lbl in ds.train_batches(
        train, PT_BATCH, 3, labels=train_labels, single_target=False)], 3)
    check(tr["graph_launches"] == 2 * 3, f"phase n: {tr['graph_launches']} cudaGraphLaunch calls for 3 steps")
    for kernel, by in tr["launched_by"].items():
        check(by and all("GraphLaunch" in n for n in by), f"phase n: {kernel} launched by {by}")
    lines.append(f"profiled graphed streaming steps: {tr['graph_launches']} cudaGraphLaunch for 3 steps; launched "
                 f"by {tr['launched_by']}; device busy {tr['busy_ms']:.2f} ms of {tr['wall_s'] * 1e3:.2f} ms, idle "
                 f"{tr['idle']:.3f}")

    # 8. timings, graphed against eager in turns
    def turns(sides, timed):
        out = {name: [] for name in sides}
        for turn in range(N_TURNS):
            for name in (list(sides) if turn % 2 == 0 else list(sides)[::-1]):
                sync()
                t0 = time.perf_counter()
                timed(sides[name])
                sync()
                out[name].append(time.perf_counter() - t0)
        return out

    step_ms = {}
    for dtype in ("float32", "bfloat16"):
        # a step program of its own, captured under cuDNN's default algorithms
        model, ds, _, drop = kept[dtype]
        step, _ = make_pretrain_step(model, flat_adam(model.parameters(), 1e-3), group)
        specs, lbl = next(ds.train_batches(train, PT_BATCH, 1, labels=train_labels, single_target=False))
        for fn in (step, step, step.fn):  # the key's eager call, its capture; the eager step's warm-up
            fn(specs, lbl, drop)
        walls = turns({"graphed": step, "eager": step.fn},
                      lambda fn: [fn(specs, lbl, drop) for _ in range(N_TIMED_STEPS)])
        step_ms[dtype] = {k: [w / N_TIMED_STEPS * 1e3 for w in v] for k, v in walls.items()}
    model, ds, _, _ = kept["float32"]
    val_s = turns({"graphed": True, "eager": False}, lambda graphed: on_side(
        graphed, lambda: pretrain_mod._validate(model, ds, val, val_labels, PT_BATCH, group)))
    alpha = ft_corpus["train"] + ft_corpus["val"]
    emb_fn = distance_filtering.make_embedding_fn(ft_model)

    def cluster():
        return distance_filtering.cluster_and_sort(alpha, emb_fn, seed=3, n_train=15, n_clusters=3, device=dev)

    got, launches["cluster_and_sort"] = phase_launches(torch, cluster)
    transform_replays["cluster_and_sort"] = replayed(None)  # no dataset transform: featurize_files's frontend
    want = on_side(False, cluster)
    check(all(np.array_equal(got[k], want[k]) for k in want), "phase n: cluster_and_sort graphed != eager")
    cluster_s = turns({"graphed": True, "eager": False}, lambda graphed: on_side(graphed, cluster))

    def spread(v, fmt="{:.3f}"):
        v = np.asarray(v)
        return f"median {fmt.format(np.median(v))} ({fmt.format(v.min())}-{fmt.format(v.max())})"

    for line in lines:
        print(f"phase n: {line}")
    for name, program in programs.items():
        pool = program.pool_bytes()
        print(f"phase n: program {name}: eager calls {program.eager_calls}, captures {program.captures}, replays "
              f"{program.replays}, capture {program.capture_s:.3f} s, pool "
              + (f"{pool / 2**20:.1f} MiB" if pool is not None else "not measured"))
    for dtype, ms in step_ms.items():
        print(f"phase n: pretraining step {dtype} at batch {PT_BATCH} (fixed specs), ms a step over {N_TURNS} turns "
              f"of {N_TIMED_STEPS}: graphed {spread(ms['graphed'])}, eager {spread(ms['eager'])}; graphed "
              f"{[round(x, 3) for x in ms['graphed']]}, eager {[round(x, 3) for x in ms['eager']]}")
    print(f"phase n: one validation pass ({len(val)} clips), s over {N_TURNS} turns: graphed "
          f"{spread(val_s['graphed'], '{:.4f}')}, eager {spread(val_s['eager'], '{:.4f}')}")
    print(f"phase n: cluster_and_sort ({len(alpha)} clips, 15 to train, 3 clusters), s over {N_TURNS} turns: graphed "
          f"{spread(cluster_s['graphed'], '{:.4f}')}, eager {spread(cluster_s['eager'], '{:.4f}')}; graphed == eager")
    print(f"phase n: launches by path {launches}; of them replays {transform_replays}")
    print(f"phase n: {time.perf_counter() - t_phase:.1f} s")
    return launches


O_CLIPS = 2048  # phase o: one-second clips through features, exact and fast
O_LONG_CLIPS = LONG_CLIPS  # phase o: 10 s clips through features_from_int16 (B6 + B3)
O_CHUNK_S = 30  # phase o: phase c's warm-up chunks (19 of 1500 windows, the last of 1450)
O_FEAT_BATCH = 16  # phase o: featurize_files' batch on phase e's 65 clips (four full batches and one of 1)
O_RESIDENT = 6  # phase o: resident batches held graphed == eager
O_TURNS = 5  # phase o: graphed and eager timings, in turns, each side this many times
O_RESIDENT_ITERS = 8  # phase o: resident batches a timed turn
O_TRACE_REPS = 3  # phase o: replays of a program in one profiler trace


class _EagerFeatures:
    """A frontend whose ``features`` is the eager twin (the realtime
    detector's frontend before its program), for timing beside the
    program."""

    def __init__(self, fe):
        self.fe, self.device = fe, fe.device

    def features(self, windows):
        return self.fe.features_eager(windows)


def graph_launchers(torch, run, kernels, reps: int = 3, tries: int = 8):
    """{kernel: {host call that launched it: count}} for each named kernel
    in a CUDA profiler trace of ``reps`` calls of ``run()`` (its runtime
    events carry the launches' correlation ids). A trace now and then
    misses a kernel's events (PERF.md §7), so one that misses a named
    kernel is taken again, up to ``tries`` times, each miss printed with
    what the trace held. Late in this script's long process, traces of
    the stream kernels' graph replays missed them five times in a row (CPU
    + CUDA in phase k, CUDA only in phase o), so phase o calls this in a
    fresh process (FRESH_O)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)
            for _ in range(reps):
                run()
            torch.cuda.synchronize()
            time.sleep(0.02)
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text())["traceEvents"]
        device = [e for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"]
        missing = [k for k in kernels if not any(k in e["name"] for e in device)]
        if not missing:
            break
        held = sorted({e["name"].split("(")[0].split("<")[0] for e in device})
        print(f"graph_launchers: trace {attempt + 1} of {reps} x {kernels} misses {missing}; it holds "
              f"{len(device)} kernel events of {held[:6]}")
    else:
        fail(f"graph_launchers: {tries} traces in a row miss a kernel of {kernels}")
    host = {e.get("args", {}).get("correlation"): e["name"] for e in events
            if e.get("cat") in ("cuda_runtime", "cuda_driver")}
    out = {}
    for kernel in kernels:
        names = [host.get(e["args"].get("correlation"), "unknown") for e in device if kernel in e["name"]]
        out[kernel] = {n: names.count(n) for n in sorted(set(names))}
    return out


# Phase o's profiled replays, in a fresh process of this checkout: argv[1]
# is the repo, argv[2] a JSON object of the shapes and phase e's corpus.
# The kernels load from the run's build cache ($MKWS_COMPILATION_CACHE).
# Each program at phase o's shapes takes its eager call and its capture,
# then graph_launchers traces its replays, the wrappers' counts set to 0
# just before: a replay launches through cudaGraphLaunch, and adds its
# captured launches to the wrappers' counts (graphs.count_replays).
FRESH_O = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
from multilingual_kws_tpu_torch.data.dataset import AudioDataset
from multilingual_kws_tpu_torch.ops import _build
from multilingual_kws_tpu_torch.ops.micro_torch import MicroFrontendTorch
from multilingual_kws_tpu_torch.settings import standard_microspeech_model_settings
from multilingual_kws_tpu_torch.utils.compilation_cache import enable_compilation_cache

args = json.loads(sys.argv[2])
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
enabled = enable_compilation_cache()
compiled = sorted(_build.build())
dev = torch.device("cuda")
rng = np.random.default_rng(args["seed"])
fe, ff = MicroFrontendTorch(device=dev), MicroFrontendTorch(device=dev, mode="fast")
audio = torch.from_numpy(rng.normal(0, 0.3, (args["clips"], cs.SR)).clip(-1, 1).astype(np.float32)).to(dev)
int16 = lambda shape: np.clip(np.round(rng.normal(0, 3000, shape)), -32768, 32767).astype(np.int16)
long16 = torch.from_numpy(int16((args["long_clips"], 10 * cs.SR))).to(dev)
chunk = int16((args["windows"] - 1) * 320 + cs.SR)
ds = AudioDataset(standard_microspeech_model_settings(3), ["alpha"], args["bg_dir"], args["unknown"],
                  unknown_percentage=50.0, seed=7, device=dev)
made = ds.build_resident_bank(args["train"])
idx, _, sil = ds._put_batch(next(ds.host_train_indices(args["train"], args["batch"], 1, made)))
runs = {
    "exact features": (lambda: fe.features(audio), ["clip_features_kernel"]),
    "exact features_from_int16, long clips": (lambda: fe.features_from_int16(long16),
                                              ["stream_prefix_kernel", "stream_suffix_kernel"]),
    "fast features": (lambda: ff.features(audio), ["noise_scan_f32_kernel"]),
    "stream_features": (lambda: fe.stream_features(chunk, args["windows"]),
                        ["stream_prefix_kernel", "stream_suffix_kernel"]),
    "resident transform": (lambda: ds.resident_specs(made["bank"], idx, sil),
                           ["augment_quantize_kernel", "clip_features_kernel"]),
}
with profile(activities=[ProfilerActivity.CUDA]):  # the profiler's own set-up, outside the traces read
    torch.ones(1, device=dev).add_(1)
    torch.cuda.synchronize()
out = {}
for name, (run, kernels) in runs.items():
    run()
    run()
    calls = []
    traced = lambda: calls.append(run())
    by, wrapped = cs.phase_launches(torch, lambda: cs.graph_launchers(torch, traced, kernels, reps=args["reps"]))
    out[name] = {"by": by, "wrapper_launches": wrapped, "calls": len(calls)}
print("FRESH_O " + json.dumps({"enabled": enabled, "compiled": compiled, "programs": out}))
"""


def fresh_graph_launchers(ft_corpus, windows: int):
    """FRESH_O in a fresh process: {program: {"by": {kernel: {host call:
    count}}, "wrapper_launches": {...}, "calls": replays}} of its profiled
    replays; its retries printed."""
    args = {"seed": 14, "clips": O_CLIPS, "long_clips": O_LONG_CLIPS, "windows": windows, "batch": FT_BATCH,
            "reps": O_TRACE_REPS, "train": ft_corpus["train"], "unknown": ft_corpus["unknown"],
            "bg_dir": ft_corpus["bg_dir"]}
    out = subprocess.run([sys.executable, "-c", FRESH_O, str(ROOT), json.dumps(args)],
                         capture_output=True, text=True, timeout=600)
    for line in out.stdout.splitlines():
        if line.startswith("graph_launchers:"):
            print(f"phase o (fresh process): {line}")
    check(out.returncode == 0, f"phase o: the fresh process failed: {out.stderr[-3000:]}")
    fresh = json.loads([ln for ln in out.stdout.splitlines() if ln.startswith("FRESH_O ")][-1][8:])
    check(fresh["enabled"] and fresh["compiled"] == [], f"phase o: the fresh process built kernels: {fresh}")
    return fresh["programs"]


def frontend_program_phase(torch, ft_model, wave, ft_corpus, pt_corpus):
    """Phase o: the frontend's entry points and the resident train
    transform as CUDA graphs on the card (see the module docstring).
    Returns each graphed path's launches by kernel wrapper, the counts set
    to 0 just before it."""
    import copy

    from multilingual_kws_tpu_torch.data.dataset import AudioDataset, file2spec
    from multilingual_kws_tpu_torch.models.kws_model import lecun_init_, make_embedding_model
    from multilingual_kws_tpu_torch.ops.micro_torch import MicroFrontendTorch
    from multilingual_kws_tpu_torch.settings import standard_microspeech_model_settings
    from multilingual_kws_tpu_torch.stream.engine import StreamFlags, stream_feature_chunks
    from multilingual_kws_tpu_torch.stream.realtime import RealtimeDetector
    from multilingual_kws_tpu_torch.train import graphs
    from multilingual_kws_tpu_torch.train import pretrain as pretrain_mod
    from multilingual_kws_tpu_torch.train.evaluate import featurize_files

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    eager = graphs.disable_graphs
    rng = np.random.default_rng(14)
    fe, ff = MicroFrontendTorch(device=dev), MicroFrontendTorch(device=dev, mode="fast")
    launches, lines, programs = {}, [], {}

    def runs_of(program):
        return program.eager_calls, program.captures, program.replays

    def same(got, want):
        return all(g.shape == w.shape and torch.equal(g, w) for g, w in zip(got, want)) and len(got) == len(want)

    loud = rng.uniform(0.001, 0.9, (O_CLIPS, 1))
    audio = torch.from_numpy((rng.normal(0, 0.3, (O_CLIPS, SR)) * loud).clip(-1, 1).astype(np.float32)).to(dev)
    long16 = torch.from_numpy(np.clip(np.round(rng.normal(0, 3000, (O_LONG_CLIPS, 10 * SR))),
                                      -32768, 32767).astype(np.int16)).to(dev)

    # 1. the three entry points, graphed (eager call, capture, replay) == the eager twin
    def thrice(name, call, program, wrappers):
        with eager():
            want = call()
        got, launches[name] = phase_launches(torch, lambda: [call() for _ in range(3)])
        sync()
        check(all(torch.equal(g, want) for g in got), f"phase o: {name}: graphed != eager: max |delta| "
              f"{[float((g - want).abs().max()) for g in got]}")
        check(runs_of(program) == (1, 1, 2), f"phase o: {name}: runs {runs_of(program)}")
        check(launches[name] == {w: 3 for w in wrappers}, f"phase o: {name}: launched {launches[name]}")
        programs[name] = program

    thrice(f"exact features, {O_CLIPS} clips", lambda: fe.features(audio), fe.program("features"),
           ["clip_features"])
    thrice(f"exact features_from_int16, {O_LONG_CLIPS} 10 s clips", lambda: fe.features_from_int16(long16),
           fe.program("features_from_int16"), ["stream_prefix", "stream_suffix"])
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True  # the program must keep fast mode's GEMM in float32 anyway
    try:
        fast_got, launches["fast features"] = phase_launches(torch, lambda: [ff.features(audio) for _ in range(3)])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    with eager():
        fast_want = ff.features(audio)
    check(all(torch.equal(g, fast_want) for g in fast_got) and runs_of(ff.program("features")) == (1, 1, 2),
          f"phase o: fast features graphed under allow_tf32 != eager without it, or runs "
          f"{runs_of(ff.program('features'))}")
    check(launches["fast features"] == {"noise_scan_f32": 3},
          f"phase o: fast features launched {launches['fast features']}")
    programs[f"fast features, {O_CLIPS} clips"] = ff.program("features")
    del fast_got, fast_want
    lines.append(f"exact features ({O_CLIPS} clips, B1), exact features_from_int16 ({O_LONG_CLIPS} 10 s clips, B6 + "
                 f"B3) and fast features ({O_CLIPS} clips, B5 and cuFFT; graphed with allow_tf32 on, the eager twin "
                 "with it off): eager call, capture, replay each == the eager twin, bitwise")

    # the stream in phase c's 30 s chunks, twice: the full chunks' program
    # and the last chunk's (its own window count)
    flags = StreamFlags(wav="", ground_truth="", target_keyword="alpha", detection_thresholds=[0.5],
                        max_chunk_length_sec=O_CHUNK_S)

    def chunks():
        return [c for c in stream_feature_chunks(wave, SR, flags, frontend=fe)]

    with eager():
        want = chunks()
    got, launches["stream chunks"] = phase_launches(torch, lambda: chunks() + chunks())
    n_chunks, full, last = len(want), want[0].shape[0], want[-1].shape[0]
    check(same(got, want + want), "phase o: stream chunks graphed != eager")
    check(runs_of(fe.program("stream_features", full)) == (1, 1, 2 * n_chunks - 3)
          and runs_of(fe.program("stream_features", last)) == (1, 1, 1),
          f"phase o: stream programs runs {runs_of(fe.program('stream_features', full))}, "
          f"{runs_of(fe.program('stream_features', last))}")
    check(launches["stream chunks"] == {"stream_prefix": 2 * n_chunks, "stream_suffix": 2 * n_chunks},
          f"phase o: stream chunks launched {launches['stream chunks']}")
    programs[f"stream_features, {full} windows"] = fe.program("stream_features", full)
    programs[f"stream_features, {last} windows"] = fe.program("stream_features", last)
    lines.append(f"stream_features on phase c's stream in {O_CHUNK_S} s chunks ({n_chunks - 1} of {full} windows, one "
                 f"of {last}), twice: == the eager twin; the {full}-window program 1 eager call, 1 capture, "
                 f"{2 * n_chunks - 3} replays, the {last}-window one 1, 1, 1")
    del got, want

    # 2. the callers: realtime, featurize_files, file2spec
    m_audio = wave[: M_SECONDS * SR]

    def detect(chunk_ms):
        det = RealtimeDetector("alpha", ft_model, detection_threshold=J_THRESHOLD, frontend=fe, device=dev)
        step = chunk_ms * SR // 1000
        return [(d.time_ms, d.confidence) for i in range(0, len(m_audio), step)
                for d in det.feed(m_audio[i : i + step])]

    rt_captures = {}
    for chunk_ms in M_CHUNKS_MS:
        with eager():
            want = detect(chunk_ms)
        before = fe.program("features").captures
        got, launches[f"realtime {chunk_ms} ms"] = phase_launches(torch, lambda: detect(chunk_ms))
        rt_captures[chunk_ms] = fe.program("features").captures - before
        check(got == want, f"phase o: realtime {chunk_ms} ms: graphed {got} != eager {want}")
        check(rt_captures[chunk_ms] == 1, f"phase o: realtime {chunk_ms} ms: {rt_captures[chunk_ms]} captures")
    lines.append(f"realtime detections on {M_SECONDS} s at {M_CHUNKS_MS} ms feeds (phase e's model) == the eager "
                 f"twin's; the features program's captures by feed size {rt_captures} (one key a window count)")

    files = ft_corpus["train"] + ft_corpus["val"] + ft_corpus["unknown"]
    fe_files = MicroFrontendTorch(device=dev)
    with eager():
        want = featurize_files(files, frontend=fe_files, batch_size=O_FEAT_BATCH)
    got, launches["featurize_files"] = phase_launches(torch, lambda: [
        featurize_files(files, frontend=fe_files, batch_size=O_FEAT_BATCH) for _ in range(2)])
    n_full = len(files) // O_FEAT_BATCH
    check(all(np.array_equal(g, want) for g in got), "phase o: featurize_files graphed != eager")
    check(runs_of(fe_files.program("features")) == (2, 2, 2 * n_full) and len(fe_files.program("features").keys()) == 2,
          f"phase o: featurize_files runs {runs_of(fe_files.program('features'))}")
    programs[f"featurize_files, batches of {O_FEAT_BATCH} and 1"] = fe_files.program("features")
    settings = standard_microspeech_model_settings(3)
    specs = [[file2spec(settings, f, device=dev) for f in files[:3]] for _ in range(3)]
    with eager():
        want_specs = [file2spec(settings, f, device=dev) for f in files[:3]]
    check(all(np.array_equal(a, b) for run in specs for a, b in zip(run, want_specs)), "phase o: file2spec != eager")
    lines.append(f"featurize_files on phase e's {len(files)} clips (batches of {O_FEAT_BATCH}: two keys), twice, "
                 f"and file2spec on 3 clips, three times: == the eager twin")

    # 3. the resident transform: batches and the generator's state
    def resident_ds():
        return AudioDataset(settings, ["alpha"], ft_corpus["bg_dir"], ft_corpus["unknown"], unknown_percentage=50.0,
                            seed=7, device=dev)

    sides = {}
    for graphed in (True, False):
        ds = resident_ds()
        run = lambda ds=ds: list(ds.train_batches_resident(ft_corpus["train"], FT_BATCH, O_RESIDENT))  # noqa: E731
        if graphed:
            batches, launches["resident batches"] = phase_launches(torch, run)
        else:
            with eager():
                batches = run()
        sides[graphed] = (batches, ds)
    (bg, dg), (be, de) = sides[True], sides[False]
    check(all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) for a, b in zip(bg, be)) and len(bg) == O_RESIDENT,
          "phase o: resident batches graphed != eager")
    check(torch.equal(dg.gen.get_state(), de.gen.get_state()), "phase o: the generator moved otherwise than eagerly")
    check(runs_of(dg._resident_program) == (1, 1, O_RESIDENT - 1),
          f"phase o: resident runs {runs_of(dg._resident_program)}")
    check(launches["resident batches"] == {"augment_quantize": O_RESIDENT, "clip_features": O_RESIDENT},
          f"phase o: resident batches launched {launches['resident batches']}")
    programs[f"resident transform, batch {FT_BATCH}"] = dg._resident_program
    lines.append(f"train_batches_resident, {O_RESIDENT} batches of {FT_BATCH}: every batch and label and the "
                 "generator's state after them == the eager twin's")

    # one BN calibration: pretrain(resident_data=True) with two calibration
    # batches through the resident program, under phase i's NCCL group and
    # deterministic cuDNN (its epoch is an EpochGraph on both sides)
    config = pretrain_mod.PretrainConfig(num_labels=PT_WORDS + 1, batch_size=PT_BATCH, num_epochs=1,
                                         steps_per_epoch=N_STEPS, bn_calibration_batches=2, resident_data=True,
                                         device=str(dev))
    base = lecun_init_(make_embedding_model(PT_WORDS + 1, device="cpu"), seed=0)
    twins = {}
    with deterministic_cudnn(torch):
        for graphed in (True, False):
            def run():
                return pretrain_mod.pretrain(pt_corpus["train"], pt_corpus["val"], pt_corpus["words"],
                                             pt_corpus["bg_dir"], config=config, model=copy.deepcopy(base), verbose=0)

            if graphed:
                (model, hist, ds), launches["pretrain calibration"] = phase_launches(torch, run)
                check(runs_of(ds._resident_program) == (1, 1, 1),
                      f"phase o: calibration runs {runs_of(ds._resident_program)}")
                programs["pretrain's calibration batches"] = ds._resident_program
            else:
                with eager():
                    model, hist, ds = run()
            twins[graphed] = (model.state_dict(), hist, ds.gen.get_state())
    (sg, hg, gg), (se, he, ge) = twins[True], twins[False]
    diff = tensor_diffs(torch, sg, se)
    check(not diff and hg == he and torch.equal(gg, ge), f"phase o: pretrain's calibration graphed != eager: {diff}")
    n_val = -(-len(pt_corpus["val"]) // PT_BATCH)
    check(launches["pretrain calibration"] == {"augment_quantize": N_STEPS + 2, "clip_features": N_STEPS + 2 + n_val,
                                               "bn_act": B0_F32_SITES * n_val, "mbconv_middle": B0_BLOCKS * n_val,
                                               "mbconv_middle_split": B0_BLOCKS * n_val},
          f"phase o: pretrain launched {launches['pretrain calibration']}")
    lines.append(f"pretrain(resident_data=True), 1 epoch of {N_STEPS} steps and BN calibration on 2 resident-program "
                 f"batches: the model (BN statistics included), history and generator == the eager twin's")
    del base, model, twins, sg, se

    # 4. profiled replays of each program in a fresh process: every kernel
    # launched by cudaGraphLaunch, at most once a replay, and each replay
    # counted as one launch of each of its wrappers
    replayed = fresh_graph_launchers(ft_corpus, full)
    for name, got in replayed.items():
        for kernel, hosts in got["by"].items():
            check(hosts and all("GraphLaunch" in h for h in hosts) and sum(hosts.values()) <= O_TRACE_REPS,
                  f"phase o: {name}: {kernel} launched by {hosts} in {O_TRACE_REPS} replays")
        want = {k.removesuffix("_kernel"): got["calls"] for k in got["by"]}
        check(got["wrapper_launches"] == want,
              f"phase o: {name}: {got['calls']} replays counted {got['wrapper_launches']}, not {want}")
    lines.append(f"profiled replays in a fresh process ({O_TRACE_REPS} a trace), every kernel launched by "
                 f"cudaGraphLaunch, each replay one launch of each wrapper: "
                 + "; ".join(f"{n} {g['by']}" for n, g in replayed.items()))

    ds_r = dg
    made = ds_r.build_resident_bank(ft_corpus["train"])
    bank = made["bank"]
    idx, _, sil = ds_r._put_batch(next(ds_r.host_train_indices(ft_corpus["train"], FT_BATCH, 1, made)))
    for _ in range(2):  # the new bank's eager call and capture
        ds_r.resident_specs(bank, idx, sil)

    # 5. timings, graphed against eager in turns
    def turns(sides, timed):
        out = {name: [] for name in sides}
        for turn in range(O_TURNS):
            for name in (list(sides) if turn % 2 == 0 else list(sides)[::-1]):
                sync()
                t0 = time.perf_counter()
                timed(sides[name])
                sync()
                out[name].append(time.perf_counter() - t0)
        return out

    feed_ms = {}
    eager_fe = _EagerFeatures(fe)
    for chunk_ms in M_CHUNKS_MS:
        step = chunk_ms * SR // 1000
        feed_ms[chunk_ms] = {"graphed": [], "eager": []}
        for turn in range(O_TURNS):
            for side in (("graphed", "eager") if turn % 2 == 0 else ("eager", "graphed")):
                det = RealtimeDetector("alpha", ft_model, detection_threshold=J_THRESHOLD,
                                       frontend=fe if side == "graphed" else eager_fe, device=dev)
                det.feed(wave[:SR])
                for i in range(M_FEEDS + 2):
                    sync()
                    t0 = time.perf_counter()
                    det.feed(wave[SR + i * step : SR + (i + 1) * step])
                    sync()
                    if i >= 2:
                        feed_ms[chunk_ms][side].append((time.perf_counter() - t0) * 1e3)
    def on_side(run):
        return lambda graphed: run() if graphed else eager_run(run)

    def eager_run(run):
        with eager():
            return run()

    feat_s = turns({"graphed": True, "eager": False}, on_side(
        lambda: featurize_files(files, frontend=fe_files, batch_size=O_FEAT_BATCH)))
    fast_s = turns({"graphed": True, "eager": False}, on_side(lambda: ff.features(audio)))
    res_s = turns({"graphed": True, "eager": False}, on_side(
        lambda: [ds_r.resident_specs(bank, idx, sil) for _ in range(O_RESIDENT_ITERS)]))

    def spread(v, scale=1.0, fmt="{:.3f}"):
        v = np.asarray(v) * scale
        return f"median {fmt.format(np.median(v))} ({fmt.format(v.min())}-{fmt.format(v.max())})"

    for line in lines:
        print(f"phase o: {line}")
    for name, program in programs.items():
        pool = program.pool_bytes()
        print(f"phase o: program {name}: eager calls {program.eager_calls}, captures {program.captures}, replays "
              f"{program.replays}, capture {program.capture_s:.3f} s, pool "
              + (f"{pool / 2**20:.1f} MiB" if pool is not None else "not measured"))
    for chunk_ms, f in feed_ms.items():
        desc = "; ".join(f"{side} p50 {np.percentile(f[side], 50):.3f} p99 {np.percentile(f[side], 99):.3f}"
                         for side in ("graphed", "eager"))
        print(f"phase o: realtime {chunk_ms} ms feeds ({chunk_ms // 20} windows), ms a feed over {O_TURNS} x {M_FEEDS} "
              f"feeds, the predict graphed on both sides, the frontend graphed against eager: {desc}")
    print(f"phase o: featurize_files ({len(files)} clips, batches of {O_FEAT_BATCH}), s over {O_TURNS} turns: graphed "
          f"{spread(feat_s['graphed'], fmt='{:.4f}')}, eager {spread(feat_s['eager'], fmt='{:.4f}')}")
    print(f"phase o: fast features at {O_CLIPS} clips, ms over {O_TURNS} turns: graphed "
          f"{spread(fast_s['graphed'], 1e3)}, eager {spread(fast_s['eager'], 1e3)}")
    print(f"phase o: one resident batch of {FT_BATCH}, ms over {O_TURNS} turns of {O_RESIDENT_ITERS}: graphed "
          f"{spread(res_s['graphed'], 1e3 / O_RESIDENT_ITERS, '{:.4f}')}, eager "
          f"{spread(res_s['eager'], 1e3 / O_RESIDENT_ITERS, '{:.4f}')}")
    print(f"phase o: launches by path {launches}")
    print(f"phase o: {time.perf_counter() - t_phase:.1f} s")
    return launches


# kernels the B0 trunk's inference forward must not launch: cuDNN's
# BatchNorm inference and the layout transposes around its float32 NCHW
# convolutions (the epilogue kernel and the row products replace them)
MODULE_PATH_KERNELS = ("bn_fw_inf", "nchwToNhwc", "nhwcToNchw")
EPILOGUE_BATCH = 8192  # the scan cell's batch
B0_SITES = 49  # the full-width B0's BatchNorm sites: bn_act launches a bfloat16 inference forward
B0_F32_SITES = 18  # bn_act launches a float32 inference forward: the stem, 16 project BNs, the top
B0_BLOCKS = 16  # mbconv_middle launches a float32 inference forward
# float32 sites: |kernel - twin| <= this x the site's largest |twin|, about 8
# float32 ulps: the kernel rounds s, t and one FMA; cuDNN's BatchNorm rounds its
# own formula once a step (measured: 2.35e-7)
EPILOGUE_F32_RTOL = 1e-6
# bfloat16 sites: == the twin. The kernel computes the BatchNorm by the
# formula of PyTorch's channels_last kernel, which the module path runs on
# the card in bfloat16, and rounds where the module path rounds
# the softmax against the module path: the card-vs-CPU softmax tolerance of
# phase c (the row products and cuDNN sum in other orders)
EPILOGUE_SOFTMAX_GAP = 1e-4
MODULE_PATH_CHUNK = 1024  # windows a module-path forward (autograd keeps each chunk's activations)


def module_path_forward(torch, model, x):
    """The model's softmax on x through the B0 trunk's module path (cuDNN's
    convolutions and BatchNorm, F.silu and the add as separate ops), the
    path a forward took before the inference epilogue. The trunk's public
    rule chooses it: an input that requires grad, under ``enable_grad``,
    makes autograd record. Float32 computes in float32, as in
    ``eval_forward``; in chunks of MODULE_PATH_CHUNK windows."""
    from multilingual_kws_tpu_torch import exact_float32

    outs = []
    with torch.enable_grad(), exact_float32():
        for i in range(0, x.shape[0], MODULE_PATH_CHUNK):
            part = x[i:i + MODULE_PATH_CHUNK].clone().requires_grad_()
            check(not model.trunk.inference_path(part), "an input that requires grad took the inference path")
            outs.append(model(part).detach())
    return torch.cat(outs)


def epilogue_sites(torch, model, x, timed: bool = False):
    """The model's inference forward on x (``graphs.eval_forward``) with each
    BatchNorm's output held against its module-path twin on the same input,
    on the card (``cuda_epilogue.bn_act_plain``: cuDNN's BatchNorm, F.silu,
    the add). Returns (a row per site: name, shape, largest |kernel - twin|,
    largest |twin|, values that differ of all, bytes read and written, with
    ``timed`` the twin's ms by CUDA events; the forward's output)."""
    from multilingual_kws_tpu_torch.models.efficientnet import BatchNorm
    from multilingual_kws_tpu_torch.ops import cuda_epilogue
    from multilingual_kws_tpu_torch.train.graphs import eval_forward

    rows = []

    def site(name):
        def hook(bn, args, kwargs, out):
            check(kwargs.get("fused", False), f"{name}: the inference forward took the module path")
            twin_args = (args[0], bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps,
                         kwargs.get("act", False), kwargs.get("residual"))
            twin = cuda_epilogue.bn_act_plain(*twin_args)
            d = (out.float() - twin.float()).abs()
            rows.append({
                "site": name, "shape": tuple(out.shape), "max_err": float(d.max()),
                "max_abs": float(twin.float().abs().max()), "differ": int((d > 0).sum()),
                "values": out.numel(),
                "bytes": out.numel() * out.element_size() * (2 if twin_args[-1] is None else 3),
                "twin_ms": cuda_ms(torch, lambda: cuda_epilogue.bn_act_plain(*twin_args), 3) if timed else None,
            })
        return hook

    handles = [m.register_forward_hook(site(n), with_kwargs=True)
               for n, m in model.named_modules() if isinstance(m, BatchNorm)]
    try:
        out = eval_forward(model, x)
    finally:
        for h in handles:
            h.remove()
    return rows, out


def kernel_names(events):
    return {e["name"] for e in events if e["cat"] == "kernel"}


def epilogue_phase(torch, model, windows, scan_launches: int):
    """Phase p: the B0 trunk's inference epilogue (``ops/cuda_epilogue.bn_act``)
    at the scan's batch of 8192 windows: the kernel against its twin at the
    18 sites of a float32 inference forward (EPILOGUE_F32_RTOL) and the 49
    of a bfloat16 one (==), the model's softmax against the module path, one
    traced forward and one traced replay of the predict program with no
    MODULE_PATH_KERNELS and 18 launches (captured 18 times), the replay ==
    the eager call; the kernel's device time over the 18 sites beside its
    bytes bound and the twin's time. The kernels line gives
    ``scan_launches``, the launches of phase c's timed scan."""
    from multilingual_kws_tpu_torch.ops import cuda_epilogue
    from multilingual_kws_tpu_torch.train import graphs

    x = windows[:EPILOGUE_BATCH, ..., None].contiguous()
    rows, probs = epilogue_sites(torch, model, x, timed=True)
    check(len(rows) == B0_F32_SITES, f"{len(rows)} BatchNorm sites in the inference forward, expected {B0_F32_SITES}")
    worst = max(rows, key=lambda r: r["max_err"] / max(r["max_abs"], 1e-30))
    rtol = worst["max_err"] / max(worst["max_abs"], 1e-30)
    check(rtol <= EPILOGUE_F32_RTOL, f"bn_act vs twin at {worst['site']}: {worst['max_err']} of {worst['max_abs']}")
    rows16, _ = epilogue_sites(torch, bf16_copy(torch, model), x)
    differ16 = {r["site"]: r["differ"] for r in rows16 if r["differ"]}
    check(len(rows16) == B0_SITES and not differ16, f"bfloat16 bn_act != twin, values by site: {differ16}")
    ref = module_path_forward(torch, model, x)
    gap = float((probs - ref).abs().max())
    check(gap <= EPILOGUE_SOFTMAX_GAP, f"softmax of the inference epilogue vs the module path: {gap}")
    before = cuda_epilogue.bn_act.launches
    eager = graphs.eval_forward(model, x)
    launches = cuda_epilogue.bn_act.launches - before
    events, _ = device_trace(torch, lambda: graphs.eval_forward(model, x), expect=("bn_act_kernel", B0_F32_SITES))
    bad = sorted(n for n in kernel_names(events) if any(k in n for k in MODULE_PATH_KERNELS))
    check(not bad and launches == B0_F32_SITES, f"eager forward: {launches} epilogue launches; module-path kernels {bad}")
    k_ms = sum(e["dur"] for e in events if e["cat"] == "kernel" and "bn_act_kernel" in e["name"]) / 1e3
    fwd_ms = sum(e["dur"] for e in events if e["cat"] == "kernel") / 1e3
    predict = graphs.serve(model, graphs.eval_forward)
    captured = cuda_epilogue.bn_act.captured
    for _ in range(2):  # an eager call, then the capture
        predict(x)
    captured = cuda_epilogue.bn_act.captured - captured
    replay = predict(x)
    check(captured == B0_F32_SITES and torch.equal(replay, eager), f"predict program: {captured} captured launches, "
          f"replay vs eager {float((replay - eager).abs().max())}")
    events, _ = device_trace(torch, lambda: predict(x), expect=("bn_act_kernel", B0_F32_SITES))
    bad = sorted(n for n in kernel_names(events) if any(k in n for k in MODULE_PATH_KERNELS))
    check(not bad, f"predict replay launches module-path kernels {bad}")
    twin_ms = sum(r["twin_ms"] for r in rows)
    b_ms = sum(r["bytes"] for r in rows) / PEAK_BYTES_PER_S * 1e3
    print(f"phase p: bn_act at {len(rows)} sites, batch {EPILOGUE_BATCH}: float32 worst |kernel - twin| "
          f"{worst['max_err']:.3g} of {worst['max_abs']:.3g} at {worst['site']}; bfloat16 == twin at every site "
          f"({sum(r['values'] for r in rows16)} values); softmax vs the module path {gap:.3g}; eager forward {fwd_ms:.3f} device "
          f"ms, of which bn_act {k_ms:.3f} ms (bytes bound {b_ms:.3f} ms, {100 * b_ms / k_ms:.1f} %; twin "
          f"{twin_ms:.3f} ms); {B0_F32_SITES} launches a forward, {B0_F32_SITES} captured, replay == eager, no "
          f"{MODULE_PATH_KERNELS} kernel; {scan_launches} launches in phase c's timed scan")
    return [{
        "name": "bn_act", "route": "cuda", "source": f"{PKG}/csrc/epilogue.cu",
        "replaces": "no Pallas kernel: cuDNN BatchNorm inference, F.silu, the residual add",
        "launches": scan_launches, "max_abs_err": worst["max_err"], "ms": k_ms, "plain_ms": twin_ms,
        "bound_ms": b_ms, "bound_by": "bytes", "library_ms": twin_ms,
    }]


MBCONV_BATCHES = (5, 64, EPILOGUE_BATCH)  # the live feed's, the fine-tune's and the scan's batches
# |kernel - twin| <= this x the block's largest |twin|: the taps, the SE mean
# and the SE products sum in other orders than cuDNN's and cuBLAS's
# (measured: 7.2e-6 at block 7a, batch 8192)
MBCONV_RTOL = 3e-5


def mbconv_today(block, x):
    """A block's middle as the inference path ran it before mbconv_middle:
    ``bn_act`` (expand), the pad and cuDNN's depthwise convolution,
    ``bn_act``, the SE mean, the SE row products, silu, sigmoid, the
    multiply (the library yardstick)."""
    import torch
    import torch.nn.functional as F

    if block.args.expand_ratio != 1:
        x = block.expand_bn(x, act=True, fused=True)
    x = block.dw_bn(block.dw_conv(x), act=True, fused=True)
    se = x.mean(dim=(-2, -1), keepdim=True)
    return x * torch.sigmoid(block.se_expand(F.silu(block.se_reduce(se, True)), True))


def mbconv_phase(torch, model, windows, scan_launches: int):
    """Phase q: the middle of each MBConv block (``ops/cuda_mbconv``) at
    MBCONV_BATCHES windows, in the form the launch rule takes at each: the
    kernel against its twin at the 16 blocks (MBCONV_RTOL), the per-sample
    and split forms == each other (same lanes), the form each batch took by
    its counters, 16 captured launches in a predict graph at each batch;
    its device time over the 16 blocks (profiler) beside the bytes bound,
    the twin's and today's ops' times (CUDA events). The kernels line gives
    ``scan_launches``, the launches of phase c's timed scan, and the scan
    batch's numbers."""
    import copy

    from multilingual_kws_tpu_torch import exact_float32
    from multilingual_kws_tpu_torch.models.efficientnet import MBConvBlock
    from multilingual_kws_tpu_torch.ops import cuda_mbconv
    from multilingual_kws_tpu_torch.train import graphs

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = [(n, m) for n, m in model.trunk.named_children() if isinstance(m, MBConvBlock)]
    check(len(blocks) == B0_BLOCKS, f"{len(blocks)} MBConv blocks, expected {B0_BLOCKS}")

    lines, out = [], {}
    for batch in MBCONV_BATCHES:
        x = windows[:batch, ..., None].contiguous()
        inputs, hooks = {}, []
        for name, b in blocks:
            def pre(mod, a, name=name):
                inputs[name] = mod.expand_conv(a[0], True) if mod.args.expand_ratio != 1 else a[0]
            hooks.append(b.register_forward_pre_hook(pre))
        try:
            graphs.eval_forward(model, x)
        finally:
            for h in hooks:
                h.remove()
        calls = [(inputs[n], b.middle_args(), b) for n, b in blocks]
        split_before = cuda_mbconv.mbconv_middle_split.launches
        worst, nbytes, forms = 0.0, 0, set()
        with torch.inference_mode(), exact_float32():
            for name, (xin, a, b) in zip((n for n, _ in blocks), calls):
                got = cuda_mbconv.mbconv_middle(xin, *a)
                twin = cuda_mbconv.mbconv_middle_plain(xin, *a)
                _, e, h, w = xin.shape
                k, s, se = a[1].shape[-1], a[2], a[4].reduce_weight.shape[0]
                _, _, ho, wo = cuda_mbconv.pads(h, w, k, s)
                forms.add("split" if cuda_mbconv.launch_plan(batch, e, se, k, s, h, w, sms).split else "per-sample")
                split = cuda_mbconv.launch_plan(1, e, se, k, s, h, w, sms)  # both forms, one order of sums
                one, two = cuda_mbconv.launch(xin, *a, split._replace(split=False)), cuda_mbconv.launch(xin, *a, split)
                check(torch.equal(one, two), f"batch {batch} {name}: the per-sample and split forms differ by "
                      f"{float((one - two).abs().max())}")
                rel = float((got - twin).abs().max()) / max(float(twin.abs().max()), 1e-30)
                check(rel <= MBCONV_RTOL, f"batch {batch} {name}: mbconv_middle vs twin {rel:.3g} of the largest")
                worst = max(worst, rel)
                nbytes += 4 * batch * e * (h * w + ho * wo)
            split_calls = cuda_mbconv.mbconv_middle_split.launches - split_before
            check(split_calls == (B0_BLOCKS if batch < sms else 0),
                  f"batch {batch}: {split_calls} calls took the split form")

            def kernel():
                for xin, a, _ in calls:
                    cuda_mbconv.mbconv_middle(xin, *a)

            # a forward's launches: one a block, two in the split form; the
            # trace may miss an event at its start, so four forwards are
            # traced and their mean taken over the events it holds
            per_forward = B0_BLOCKS * (2 if batch < sms else 1)
            events, _ = device_trace(torch, kernel, iters=4, expect=("mbconv_", 3 * per_forward))
            durs = [e["dur"] for e in events if e["cat"] == "kernel" and "mbconv_" in e["name"]]
            k_ms = sum(durs) / len(durs) * per_forward / 1e3
            plain_ms = cuda_ms(torch, lambda: [cuda_mbconv.mbconv_middle_plain(xin, *a) for xin, a, _ in calls], 3)
            today_ms = cuda_ms(torch, lambda: [mbconv_today(b, xin) for xin, _, b in calls], 3)
        predict = graphs.serve(copy.deepcopy(model), graphs.eval_forward)
        captured = cuda_mbconv.mbconv_middle.captured
        for _ in range(2):  # an eager call, then the capture
            predict(x)
        captured = cuda_mbconv.mbconv_middle.captured - captured
        check(captured == B0_BLOCKS, f"batch {batch}: {captured} mbconv_middle launches captured, expected {B0_BLOCKS}")
        b_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        out[batch] = {"ms": k_ms, "bound_ms": b_ms, "plain_ms": plain_ms, "library_ms": today_ms, "max_rel": worst}
        lines.append(f"batch {batch} ({'/'.join(sorted(forms))}): {k_ms:.4f} ms over the 16 blocks (bytes bound "
                     f"{b_ms:.4f} ms, {100 * b_ms / k_ms:.1f} %; twin {plain_ms:.4f} ms; today's ops {today_ms:.4f} "
                     f"ms); worst |kernel - twin| {worst:.3g} of the largest; {captured} captured in a predict graph")
    print("phase q: mbconv_middle: " + "; ".join(lines) + f"; {scan_launches} launches in phase c's timed scan")
    scan = out[EPILOGUE_BATCH]
    return [{
        "name": "mbconv_middle", "route": "cuda", "source": f"{PKG}/csrc/mbconv.cu",
        "replaces": "no Pallas kernel: bn_act, the pad, cuDNN's depthwise convolution, bn_act, the SE mean, "
                    "products, silu, sigmoid and multiply",
        "launches": scan_launches, "max_abs_err": scan["max_rel"], "ms": scan["ms"], "plain_ms": scan["plain_ms"],
        "bound_ms": scan["bound_ms"], "bound_by": "bytes", "library_ms": scan["library_ms"],
        "batches": {str(k): v for k, v in out.items()},
    }]


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
    from multilingual_kws_tpu_torch.ops import _build, cuda_epilogue, cuda_fft, cuda_frontend, cuda_mbconv
    from multilingual_kws_tpu_torch.ops.micro_torch import MicroFrontendTorch
    from multilingual_kws_tpu_torch.probes import sass
    from multilingual_kws_tpu_torch.stream.engine import StreamFlags, calculate_streaming_accuracy
    from multilingual_kws_tpu_torch.utils.compilation_cache import enable_compilation_cache
    from multilingual_kws_tpu_torch.utils.wav import write_wav

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # the shared build cache (utils/compilation_cache.py) in a directory of
    # this run: the kernels and host libraries are built there, and the
    # fresh processes of phases h and k (which inherit the variable) load
    # them from there
    cache_dir = tempfile.TemporaryDirectory()
    os.environ["MKWS_COMPILATION_CACHE"] = cache_dir.name
    check(enable_compilation_cache() and _build.BUILD_DIR == Path(cache_dir.name), "the build cache is not on")
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
    n_suffix = suffix_grid(torch, fe, dev)
    print(f"phase a: kernels == plain versions on the card in {n_cmp + 1} comparisons "
          f"({len(cases)} inputs and clip batches); stream_suffix == plain in {n_suffix} more: "
          f"{SUFFIX_WINDOWS} windows at strides {SUFFIX_STRIDES} of 49 frames and one window of 5999 "
          f"frames, default, no-PCAN and no-log frontends, scaled and raw, at {SUFFIX_LAYOUTS} channels a thread")

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
        cuda_epilogue.bn_act.launches = 0
        cuda_mbconv.mbconv_middle.launches = 0
        t1 = time.perf_counter()
        results, inferences = calculate_streaming_accuracy(
            model, [flags], batch_size=BATCH, verbose=False
        )
        torch.cuda.synchronize()
        walls = [time.perf_counter() - t1]
        launches = {
            "stream_prefix": cuda_fft.stream_prefix.launches,
            "stream_suffix": cuda_frontend.stream_suffix.launches,
            "bn_act": cuda_epilogue.bn_act.launches,
            "mbconv_middle": cuda_mbconv.mbconv_middle.launches,
        }
        # four more timed runs: the host's share of the wall varies by run
        for _ in range(4):
            t1 = time.perf_counter()
            calculate_streaming_accuracy(model, [flags], batch_size=BATCH, verbose=False)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
        wall = float(np.median(walls))
    check(inferences.shape == (n_w, 3), f"inferences {inferences.shape}, expected {(n_w, 3)}")
    check(np.isfinite(inferences).all(), "non-finite softmax rows")
    check(np.abs(inferences.sum(1) - 1).max() < 1e-4, "softmax rows do not sum to 1")
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched on the main path")
    # the scan's predict program replays the epilogue's 18 launches and the
    # MBConv middle's 16 a batch
    n_batches = -(-n_w // BATCH)
    check(launches["bn_act"] == B0_F32_SITES * n_batches,
          f"bn_act launched {launches['bn_act']} times on the scan, expected {B0_F32_SITES} x {n_batches} batches")
    check(launches["mbconv_middle"] == B0_BLOCKS * n_batches,
          f"mbconv_middle launched {launches['mbconv_middle']} times on the scan, expected {B0_BLOCKS} x "
          f"{n_batches} batches")
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
        f"phase c: {n_w} windows of a {STREAM_SECONDS} s stream in {wall:.3f} s (median of 5 runs, "
        f"best {min(walls):.4f}: {[round(w, 4) for w in walls]} s): {n_w / wall:.1f} windows/s "
        f"(best {n_w / min(walls):.1f}), real-time factor {STREAM_SECONDS / wall:.1f}; "
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
    for name, f in frontend_variants(fe).items():
        for scaled in (True, False):
            want = cuda_frontend.stream_suffix_plain(base, n_w, 1, 49, f, scaled=scaled)
            for cpt in SUFFIX_LAYOUTS:
                got = cuda_frontend.launch_suffix(base, n_w, 1, 49, f, scaled, cpt)
                check(torch.equal(got, want),
                      f"suffix != plain at the main path's shape: {name}, scaled={scaled}, {cpt} channels a thread")
    del got, want
    k_prefix = kernel_ms(torch, lambda: cuda_fft.stream_prefix(audio, fe), "stream_prefix_kernel")[0]
    h_prefix = cuda_ms(torch, lambda: cuda_fft.stream_prefix(audio, fe), 20) * 1e3
    p_prefix = cuda_ms(torch, lambda: cuda_fft.stream_prefix_plain(audio, fe), 3)
    k_suffix = kernel_ms(torch, lambda: cuda_frontend.stream_suffix(base, n_w, 1, 49, fe),
                         "stream_suffix_kernel")[0]
    h_suffix = cuda_ms(torch, lambda: cuda_frontend.stream_suffix(base, n_w, 1, 49, fe), 20) * 1e3
    p_suffix = cuda_ms(torch, lambda: cuda_frontend.stream_suffix_plain(base, n_w, 1, 49, fe), 3)
    with torch.inference_mode():
        model_ms = cuda_ms(torch, lambda: model(batch), 5)
    # the suffix's layouts (channels a thread) on the stream's first
    # SUFFIX_SWEEP windows and all of them (stride 1), at 64 and 2048
    # one-second clips (stride 49) and on one long window (the stream's
    # 29,999 frames as one clip): where the two cross sets the launch
    # plan's switch point; and each layout's census
    loud = np.random.default_rng(8).uniform(30, 12000, (2048, 1))
    clips = np.clip(np.round(np.random.default_rng(9).normal(0, 1, (2048, SR)) * loud), -32768, 32767)
    clip_base = cuda_fft.stream_prefix(torch.from_numpy(clips.astype(np.int16)).to(dev), fe).reshape(-1, c)
    shapes = {f"{n} windows": (base, n, 1, 49, 20) for n in SUFFIX_SWEEP}
    shapes.update({"stream": (base, n_w, 1, 49, 20), "64 clips": (clip_base, 64, 49, 49, 20),
                   "2048 clips": (clip_base, 2048, 49, 49, 20), "one long window": (base, 1, frames, frames, 5)})
    layouts = {}
    for cpt in SUFFIX_LAYOUTS:
        for what, (b, n, st, nf, it) in shapes.items():
            layouts[what, cpt] = kernel_ms(torch, lambda: cuda_frontend.launch_suffix(
                b, n, st, nf, fe, True, cpt), "stream_suffix_kernel", iters=it)[0]
    del clip_base
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = {what: cuda_frontend.launch_plan(shape[1], c, sms) for what, shape in shapes.items()}
    lib = _build._target("frontend")
    for cpt in SUFFIX_LAYOUTS:
        CENSUS[cpt] = sass.census(lib, f"stream_suffix_kernelILi{cpt}ELb1ELb1ELb1E")
        check(len(CENSUS[cpt]) == 1, f"stream_suffix<{cpt}>: {len(CENSUS[cpt])} storing loops in the census")

    b_prefix = bound(audio.numel() * 2 + frames * c * 4, frames * PREFIX_OPS_PER_FRAME, name="stream_prefix")
    out_elems = n_w * 49 * c
    b_suffix = bound(frames * c * 4 + out_elems * 4, out_elems * SUFFIX_OPS_PER_ELEMENT, name="stream_suffix")
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
    n_batches = -(-n_w // BATCH)
    print(
        f"phase d: kernels == plain versions at the main path's shapes ({frames} frames, "
        f"{n_w} windows); model forward "
        f"{model_ms:.3f} ms per batch of {BATCH} ({n_batches} batches: "
        f"{n_batches * model_ms:.1f} ms); kernel device ms (profiler) stream_prefix {k_prefix:.5f}, "
        f"stream_suffix {k_suffix:.5f} (wrapper loop, host us per call: {h_prefix:.1f}, {h_suffix:.1f})"
    )
    print("phase d: stream_suffix == plain at the stream's shape for the default, no-PCAN and no-log frontends, "
          f"scaled and raw, at {SUFFIX_LAYOUTS} channels a thread; device ms by layout (channels a thread: ms; "
          f"the launch plan's choice in brackets): " + "; ".join(
              f"{what} " + ", ".join(f"{cpt}: {layouts[what, cpt]:.5f}" for cpt in SUFFIX_LAYOUTS) + f" [{plan[what]}]"
              for what in plan))
    for cpt, loops in CENSUS.items():
        loop = {k: v for k, v in loops[0].items() if k != "function"}
        print(f"phase d: SASS census of stream_suffix's loop at {cpt} channels a thread (exact frontend, "
              f"float features): {json.dumps(loop)}")
    del cpu_model, batch, base, audio
    # (p) the B0 trunk's inference epilogue at the scan's batch
    windows = fe.stream_features(torch.from_numpy(i16).to(dev), n_w)
    kernels += epilogue_phase(torch, model, windows, launches["bn_act"])
    # (q) the middle of each MBConv block at the live feed's, the fine-tune's and the scan's batches
    kernels += mbconv_phase(torch, model, windows, launches["mbconv_middle"])
    del windows

    # (e) the fine-tune slice, and (f)'s batch eval and training batches on
    # its fine-tuned model and corpus
    from multilingual_kws_tpu_torch.ops.micro_torch import MicroFrontendTorch as Frontend

    ff = Frontend(device="cuda", mode="fast")
    work = tempfile.TemporaryDirectory()  # phase e's corpus, kept for phase h
    finetune_epoch, fast_eval_res, ft_model, corpus, finetune_kernels = finetune_phase(
        torch, fe, cases, rng, Path(work.name),
        then=lambda predict, corpus: fast_eval(torch, fe, ff, predict, corpus),
    )
    kernels += finetune_kernels

    # (f) the fast frontend mode
    kernels += fast_phase(torch, fe, ff, model, wave, labels, i16, n_w, cases, fast_eval_res,
                          exact={"wall": wall, "found": found})
    # (g) the probes
    kernels += probe_phase(torch, fe, cases)
    # (h) the CLI's train and inference, and the checkpoints
    cli_paths = cli_phase(torch, fe, ft_model, corpus, wave, labels, Path(work.name))
    # (i) pretraining, and bf16 on the stream, the CLI and the fine-tune
    pretrain_epoch, pt_corpus = pretrain_phase(torch, model, ft_model, corpus, finetune_epoch, cli_paths,
                                               Path(work.name))
    # (j) the realtime detector, the TF-free weight mapping and the analysis modules
    analysis_phase(torch, fe, ft_model, corpus, wave, labels, Path(work.name))
    # (k) the DS-CNN, the native host path, profiling, the build cache, wav2vec2
    dscnn_phase(torch, fe, corpus, wave, labels, Path(work.name), smi)
    # (l) the benchmark program, the graft entry points, the tutorial
    phase_l = bench_phase(torch, Path(work.name))
    # (m) the inference programs as CUDA graphs
    phase_m = graph_phase(torch, fe, model, ft_model, wave, Path(work.name))
    # (n) the per-step programs as CUDA graphs
    phase_n = step_program_phase(torch, pt_corpus, corpus, ft_model)
    # (o) the frontend's entry points and the resident transform as CUDA graphs
    phase_o = frontend_program_phase(torch, ft_model, wave, corpus, pt_corpus)
    for k in kernels:
        wrapper = "stream_prefix" if k["name"] == "stream_prefix_clips" else k["name"]
        for phase, by_path in (("l", phase_l), ("m", phase_m), ("n", phase_n), ("o", phase_o)):
            k[f"phase_{phase}_launches"] = {path: counts.get(wrapper, 0) for path, counts in by_path.items()}
    work.cleanup()
    if "--profile" in sys.argv[1:]:
        with tempfile.TemporaryDirectory() as tmp:
            wav, gt = Path(tmp) / "stream.wav", Path(tmp) / "labels.txt"
            write_wav(wav, wave, SR)
            gt.write_text("".join(f"{lab}, {ms}\n" for lab, ms in labels))
            flags = dataclasses.replace(flags, wav=str(wav), ground_truth=str(gt))
            profile_run(
                torch,
                [
                    ("main_path",
                     lambda: calculate_streaming_accuracy(model, [flags], batch_size=BATCH, verbose=False),
                     ("stream_prefix", "stream_suffix", "memcpy", "memset")),
                    ("finetune_epoch", finetune_epoch,
                     ("augment_quantize", "clip_features", "multi_tensor_apply", "wgrad", "memcpy", "memset")),
                    ("pretrain_epoch", pretrain_epoch,
                     ("augment_quantize", "clip_features", "multi_tensor_apply", "wgrad", "dgrad", "nccl",
                      "memcpy", "memset")),
                ],
                ROOT / "chiprun_out",
            )
    torch.distributed.destroy_process_group()
    print(json.dumps({"kernels": kernels}))
    cache_dir.cleanup()
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
