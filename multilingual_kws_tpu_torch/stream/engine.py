"""Streaming KWS evaluation engine.

Counterpart of ``multilingual_kws_tpu/stream/engine.py`` (itself the
equivalent of the reference's batch_streaming_analysis.py): ``StreamFlags``,
``StreamTarget``, ``calculate_streaming_accuracy`` and ``eval_stream_test``.

- The stateless frontend stages run once over the whole stream and the
  windows share them (``MicroFrontendTorch.stream_features``, a program a
  chunk's window count: on a card one CUDA graph); the windows stay on the
  device.
- The model sees one batch shape: the last batch is zero-padded and its pad
  rows' predictions are sliced off. A model is served by its predict
  program: on a card one CUDA graph, replayed for every batch.
- The softmax rows come to the host in one pull (a ``predict_fn`` may
  return tensors or numpy arrays).
- A 16-bit wav goes from the file to the frontend's upload as its own int16
  samples, read in one pass (``_read_stream``); other sample widths are
  decoded to float and quantised as the reference does.
- Audio is processed in chunks of at most ``max_chunk_length_sec``; chunks
  overlap by one clip so no window is lost at a boundary.

Under a profiler a call records its stages as spans
(``utils/profiling.annotate``): the root ``engine.scan``, then
``engine.read_wav`` (counts ``samples`` read and ``pcm16``: 1 when the
stream went to the frontend as the file's int16 samples), ``engine.cast``
(only where a float or non-int16 stream is quantised to int16),
``engine.frontend`` and ``engine.predict`` a chunk (counts ``batches``,
``windows``), ``engine.wait`` (the one pull), and a set of flags'
``engine.detect`` (counts ``hops``, the reliable hops, and ``detections``,
the fires summed over thresholds) and ``engine.score`` (counts ``found``,
the words scored summed over thresholds, and ``ground_truth``, the file's
entries, parsed once for all thresholds).
"""

from __future__ import annotations

import os
import pickle
import wave
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..ops.micro_torch import MicroFrontendTorch, cached_stream_frontend
from ..settings import SILENCE_LABEL, UNKNOWN_WORD_LABEL
from ..train.checkpoints import load_transfer_model
from ..train.graphs import eval_forward, serve
from ..utils.profiling import annotate, spanned
from ..utils.wav import read_wav
from .detector import DetectorParams, detect_all_thresholds
from .stats import StreamingAccuracyStats, read_ground_truth_file


@dataclass(frozen=True)
class StreamFlags:
    """Reference StreamFlags (batch_streaming_analysis.py:27-47)."""

    wav: str
    ground_truth: str
    target_keyword: str
    detection_thresholds: Sequence[float]
    clip_duration_ms: int = 1000
    clip_stride_ms: int = 20
    average_window_duration_ms: int = 100
    suppression_ms: int = 500
    time_tolerance_ms: int = 750
    minimum_count: int = 4
    max_chunk_length_sec: int = 1200

    def labels(self) -> List[str]:
        return [SILENCE_LABEL, UNKNOWN_WORD_LABEL, self.target_keyword]


@dataclass
class StreamTarget:
    """Reference StreamTarget (batch_streaming_analysis.py:187-194)."""

    target_lang: str
    target_word: str
    model_path: Optional[str]
    stream_flags: Sequence[StreamFlags]
    destination_result_pkl: Optional[str] = None
    destination_result_inferences: Optional[str] = None


def _read_stream(path) -> Tuple[np.ndarray, int]:
    """(the wav's first channel, sample rate). 16-bit PCM comes back as the
    file's own int16 samples, read in one pass into a writable array;
    other sample widths as ``read_wav``'s float waveform, which
    ``stream_feature_chunks`` quantises as the reference does."""
    with open(path, "rb") as fh, wave.open(fh, "rb") as w:
        sample_rate, nch, width = w.getframerate(), w.getnchannels(), w.getsampwidth()
        if width == 2:
            # wave.open stops at the data chunk's first byte
            data = np.empty(w.getnframes() * nch, "<i2")
            got = fh.readinto(memoryview(data).cast("B"))
            data = data[: got // (2 * nch) * nch]
    if width != 2:
        return read_wav(path)
    if nch > 1:
        data = np.ascontiguousarray(data.reshape(-1, nch)[:, 0])
    return data.astype(np.int16, copy=False), sample_rate


def _stream_int16(audio: np.ndarray) -> np.ndarray:
    """The stream as the frontend takes it, a writable contiguous int16
    array: int16 audio as it is (copied only if read-only or strided);
    floating audio in [-1, 1] quantised by the reference's clip of
    trunc(x * 32768); other integer audio cast after a check that every
    value lies in the int16 range (values are never wrapped)."""
    if audio.dtype == np.int16:
        return np.require(audio, requirements=("C", "W"))
    with annotate("engine.cast"):
        if np.issubdtype(audio.dtype, np.floating):
            return np.clip(np.trunc(audio * 32768.0), -32768, 32767).astype(np.int16)
        if not np.issubdtype(audio.dtype, np.integer):
            raise TypeError(f"stream audio must be floating or integer, got {audio.dtype}")
        if audio.size and (int(audio.min()) < -32768 or int(audio.max()) > 32767):
            raise ValueError("stream audio values outside the int16 range")
        return audio.astype(np.int16)


def stream_feature_chunks(
    audio: np.ndarray,
    sample_rate: int,
    flags: StreamFlags,
    frontend: Optional[MicroFrontendTorch] = None,
    device="cuda",
):
    """Long waveform -> iterator of (n_w, 49, 40) float32 feature windows on
    the device, chunked by max_chunk_length_sec.

    The windows match the reference: range(0, len(audio) - clip_samples,
    stride_samples). The audio goes to the device once per chunk, as int16,
    into the frontend's ``stream_features`` program of the chunk's window
    count. int16 audio (a 16-bit wav's samples) goes as it is; float audio
    in [-1, 1] is quantised first, as the reference does; other integer
    audio is cast after a range check (``_stream_int16``)."""
    frontend = frontend or cached_stream_frontend(int(sample_rate), str(resolve_device(device)))
    clip_samples = int(flags.clip_duration_ms * sample_rate / 1000)
    stride_samples = int(flags.clip_stride_ms * sample_rate / 1000)
    audio_data_end = audio.shape[0] - clip_samples
    if audio_data_end <= 0:
        return
    num_windows = int(np.ceil(audio_data_end / stride_samples))
    i16 = _stream_int16(audio)

    max_chunk_windows = max(1, int(flags.max_chunk_length_sec * sample_rate) // stride_samples)
    w = 0
    while w < num_windows:
        n_w = min(max_chunk_windows, num_windows - w)
        start = w * stride_samples
        end = start + (n_w - 1) * stride_samples + clip_samples
        with annotate("engine.frontend"):
            features = frontend.stream_features(i16[start:end], n_w)
        yield features
        w += n_w


def featurize_stream(
    audio: np.ndarray,
    sample_rate: int,
    flags: StreamFlags,
    frontend: Optional[MicroFrontendTorch] = None,
    device="cuda",
) -> np.ndarray:
    """Long waveform -> host (num_windows, 49, 40) float32 feature windows."""
    outs = [
        c.cpu().numpy() for c in stream_feature_chunks(audio, sample_rate, flags, frontend, device)
    ]
    if not outs:
        return np.zeros((0, 49, 40), np.float32)
    return np.concatenate(outs, axis=0)


def _predict_batches(predict_fn, windows: torch.Tensor, batch_size: int) -> list:
    """predict_fn over (n, F, C) windows in batches of ONE shape
    (batch_size, F, C, 1): the last batch is zero-padded and the pad rows'
    predictions are sliced off (the model is row-independent in eval mode).
    A predict program copies each batch into its graph's input, so one graph
    serves every offset (the JAX engine's ``_batch_slicer``)."""
    preds = []
    n_w = int(windows.shape[0])
    for i in range(0, n_w, batch_size):
        batch = windows[i : i + batch_size]
        keep = batch.shape[0]
        if keep < batch_size:
            batch = torch.nn.functional.pad(batch, (0, 0, 0, 0, 0, batch_size - keep))
        preds.append(predict_fn(batch[..., None])[:keep])
    return preds


def model_predict_fn(model: torch.nn.Module) -> Callable[[torch.Tensor], torch.Tensor]:
    """(B, 49, 40, 1) -> (B, 3) softmax through an eval-mode model (float32
    computes in float32: ``exact_float32``) through the model's predict
    program (``train/graphs.serve``, one program per model, as the JAX
    package's ``_cached_predict``). On a card each batch shape runs eagerly
    once, then replays one CUDA graph; call the model itself for eager
    calls."""
    return serve(model, eval_forward)


def window_times_ms(audio_data_end: int, stride_samples: int, sample_rate: int) -> np.ndarray:
    """Each window's start in whole ms, the reference's ``int(off * 1000 /
    sample_rate)`` for off in ``range(0, audio_data_end, stride_samples)``,
    in int64 arithmetic: the true quotient lies at least 1/sample_rate
    below the next integer, far more than float64 rounds it by at any
    stream length, so truncating it and flooring the exact quotient
    agree."""
    return np.arange(0, audio_data_end, stride_samples, dtype=np.int64) * 1000 // sample_rate


@spanned("engine.scan")
def calculate_streaming_accuracy(
    predict_fn: Callable,
    flag_list: Sequence[StreamFlags],
    existing_inferences: Optional[np.ndarray] = None,
    frontend: Optional[MicroFrontendTorch] = None,
    batch_size: int = 8192,
    verbose: bool = True,
    device="cuda",
):
    """Reference calculate_streaming_accuracy (:50-179).

    predict_fn: (B, 49, 40, 1) float32 tensor -> (B, 3) softmax (a tensor
    or a numpy array, as the JAX engine's contract allows), or an
    ``nn.Module`` that computes it. Returns (results list [(flags, {thresh:
    (found, found_w_conf)})], inferences)."""
    assert len({f.wav for f in flag_list}) == 1, "can only process one wav"
    assert len({f.clip_duration_ms for f in flag_list}) == 1, "cannot vary"
    assert len({f.clip_stride_ms for f in flag_list}) == 1, "cannot vary"
    if isinstance(predict_fn, torch.nn.Module):
        predict_fn = model_predict_fn(predict_fn)
    f0 = flag_list[0]

    with annotate("engine.read_wav") as span:
        audio, sample_rate = _read_stream(f0.wav)
        span.count(samples=audio.shape[0], pcm16=audio.dtype == np.int16)
    clip_samples = int(f0.clip_duration_ms * sample_rate / 1000)
    stride_samples = int(f0.clip_stride_ms * sample_rate / 1000)
    audio_data_end = audio.shape[0] - clip_samples

    if existing_inferences is not None:
        inferences = np.asarray(existing_inferences)
    else:
        preds = []
        for windows in stream_feature_chunks(audio, sample_rate, f0, frontend, device):
            with annotate("engine.predict") as span:
                batches = _predict_batches(predict_fn, windows, batch_size)
                span.count(batches=len(batches), windows=windows.shape[0])
            preds.extend(batches)
        if preds:
            # one device -> host pull of all softmax rows (numpy rows join
            # as host tensors)
            with annotate("engine.wait"):
                inferences = torch.cat([torch.as_tensor(p) for p in preds], dim=0).float().cpu().numpy()
        else:
            inferences = np.zeros((0, 3), np.float32)

    times_ms = window_times_ms(audio_data_end, stride_samples, sample_rate)
    n = min(len(times_ms), inferences.shape[0])
    times_ms = times_ms[:n]

    results = []
    for flags in flag_list:
        params = DetectorParams(
            average_window_duration_ms=flags.average_window_duration_ms,
            suppression_ms=flags.suppression_ms,
            minimum_count=flags.minimum_count,
            target_id=2,
        )
        with annotate("engine.detect") as span:
            per_thresh = detect_all_thresholds(
                inferences[:n], times_ms, flags.detection_thresholds, params,
                target_name=flags.target_keyword,
            )
            span.count(hops=per_thresh.hops, detections=sum(len(fw) for fw, _ in per_thresh.values()))
        res_thresh = {}
        with annotate("engine.score") as span:
            if flags.detection_thresholds:
                ground_truth = read_ground_truth_file(flags.ground_truth)
                span.count(ground_truth=len(ground_truth))
            for threshold in flags.detection_thresholds:
                found, found_w_conf = per_thresh[float(threshold)]
                stats = StreamingAccuracyStats(target_keyword=flags.target_keyword)
                stats.set_ground_truth(ground_truth)
                stats.calculate_accuracy_stats(found, -1, flags.time_tolerance_ms)
                span.count(found=len(found))
                if verbose:
                    print(f"results for {threshold:0.2f}")
                    stats.print_accuracy_stats()
                res_thresh[threshold] = (found, found_w_conf)
        results.append((flags, res_thresh))
    return results, inferences


def eval_stream_test(
    st: StreamTarget,
    predict_fn: Optional[Callable] = None,
    frontend: Optional[MicroFrontendTorch] = None,
    verbose: bool = True,
    compute_dtype: Optional[str] = None,
    batch_size: int = 8192,
    device="cuda",
):
    """Reference eval_stream_test (:197-241): result/inference memoization +
    streaming accuracy. ``predict_fn`` is a callable or a port model; without
    it the transfer model saved at ``st.model_path`` is loaded on ``device``
    (``train/checkpoints.load_transfer_model``, the trunk sized from its
    metadata) and served in eval mode, its trunk computing in
    ``compute_dtype`` ("bfloat16": convolutions, BN and the embedding head's
    dense layers; the float32 tensors load unchanged and the softmax rows
    stay float32; None or "float32": float32)."""
    if predict_fn is None and st.model_path is None:
        raise ValueError("eval_stream_test needs predict_fn or st.model_path")
    if st.destination_result_pkl is not None and os.path.isfile(st.destination_result_pkl):
        print("results already present", st.destination_result_pkl, flush=True)
        return
    loaded_inferences = None
    if st.destination_result_inferences is not None and os.path.isfile(
        st.destination_result_inferences
    ):
        print("inferences already present", flush=True)
        loaded_inferences = np.load(st.destination_result_inferences)
    if predict_fn is None and loaded_inferences is None:
        predict_fn = model_predict_fn(load_transfer_model(st.model_path, device, compute_dtype)[0])

    results = {}
    results[st.target_word], inferences = calculate_streaming_accuracy(
        predict_fn, st.stream_flags, existing_inferences=loaded_inferences,
        frontend=frontend, batch_size=batch_size, verbose=verbose, device=device,
    )
    if st.destination_result_pkl is not None:
        Path(st.destination_result_pkl).parent.mkdir(parents=True, exist_ok=True)
        with open(st.destination_result_pkl, "wb") as fh:
            pickle.dump(results, fh)
    if loaded_inferences is None and st.destination_result_inferences is not None:
        Path(st.destination_result_inferences).parent.mkdir(parents=True, exist_ok=True)
        np.save(st.destination_result_inferences, inferences)
    return results
