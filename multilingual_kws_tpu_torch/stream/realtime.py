"""Online (real-time) keyword detection over incremental audio.

Counterpart of ``multilingual_kws_tpu/stream/realtime.py``: push audio
chunks of any size as they arrive and get detections back, about one
detector window (100 ms) behind real time.

A host buffer holds the float32 samples that future windows still need.
Every ``clip_stride`` new samples complete one window; the windows a
``feed()`` completes go to the device in one upload, through the frontend's
``features`` program in one call (on a card one CUDA graph of the fused
``clip_features`` kernel a window count) and through the predict function
in one batch, and only their (B, 3) softmax rows come back
to the host, for the reference's averaging and suppression detector
(``stream/detector.SingleTargetRecognizeCommands``). The buffer stays
float32 so that each window takes the same saturating float -> int16 cast
(``MicroFrontendTorch.features``) as the offline engine's whole-stream
cast, and the two give the same features.

The frontend defaults to the port's ``MicroFrontendTorch`` on ``device``
(default ``cuda``; without a card it raises). The JAX module's fallback
from its native host frontend to the JAX one is not carried over: the
frontend is the one asked for, or the error says why not.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Union

import numpy as np
import torch

from .. import resolve_device
from ..ops.micro_torch import MicroFrontendTorch, cached_stream_frontend
from ..settings import SILENCE_LABEL, UNKNOWN_WORD_LABEL
from .detector import SingleTargetRecognizeCommands
from .engine import model_predict_fn


@dataclass
class Detection:
    keyword: str
    time_ms: int
    confidence: float


class RealtimeDetector:
    """Incremental single-target detector session.

    predict_fn: (B, 49, 40, 1) float32 tensor on the frontend's device ->
    (B, 3) softmax (a tensor or an array), e.g.
    ``FinetuneResult.predict_fn()``, or a port model (served through
    ``stream.engine.model_predict_fn``).
    """

    def __init__(
        self,
        target_keyword: str,
        predict_fn: Union[Callable, torch.nn.Module],
        detection_threshold: float = 0.9,
        sample_rate: int = 16000,
        clip_duration_ms: int = 1000,
        clip_stride_ms: int = 20,
        average_window_duration_ms: int = 100,
        suppression_ms: int = 500,
        minimum_count: int = 4,
        frontend: Optional[MicroFrontendTorch] = None,
        device="cuda",
    ):
        self.target_keyword = target_keyword
        if isinstance(predict_fn, torch.nn.Module):
            predict_fn = model_predict_fn(predict_fn)
        self.predict_fn = predict_fn
        self.sample_rate = sample_rate
        self.clip_duration_ms = clip_duration_ms
        self.clip_stride_ms = clip_stride_ms
        self.clip_samples = clip_duration_ms * sample_rate // 1000
        self.stride_samples = clip_stride_ms * sample_rate // 1000
        self.frontend = frontend or cached_stream_frontend(int(sample_rate), str(resolve_device(device)))

        self.recognizer = SingleTargetRecognizeCommands(
            labels=[SILENCE_LABEL, UNKNOWN_WORD_LABEL, target_keyword],
            average_window_duration_ms=average_window_duration_ms,
            detection_threshold=detection_threshold,
            suppression_ms=suppression_ms,
            minimum_count=minimum_count,
            target_id=2,
        )

        self._buffer = np.zeros(0, np.float32)
        self._consumed = 0  # samples dropped from the buffer's front since the stream's start
        self._next_window_start = 0  # absolute sample index of the next window

    @property
    def stream_position_ms(self) -> int:
        return int((self._consumed + self._buffer.shape[0]) * 1000 / self.sample_rate)

    def feed(self, audio_chunk: np.ndarray) -> List[Detection]:
        """Push float waveform samples in [-1, 1]; returns new detections."""
        self._buffer = np.concatenate([self._buffer, np.asarray(audio_chunk, np.float32)])
        first = self._next_window_start - self._consumed
        room = self._buffer.shape[0] - first - self.clip_samples
        n = room // self.stride_samples + 1 if room >= 0 else 0

        detections: List[Detection] = []
        if n:
            span = self._buffer[first : first + (n - 1) * self.stride_samples + self.clip_samples]
            windows = torch.from_numpy(span).to(self.frontend.device).unfold(0, self.clip_samples, self.stride_samples)
            probs = self.predict_fn(self.frontend.features(windows)[..., None])
            probs = probs.float().cpu().numpy() if isinstance(probs, torch.Tensor) else np.asarray(probs)
            for i, p in enumerate(probs):
                t_ms = int((self._next_window_start + i * self.stride_samples) * 1000 / self.sample_rate)
                label, score, is_new = self.recognizer.process_latest_result(p, t_ms)
                if is_new and label == self.target_keyword:
                    detections.append(Detection(self.target_keyword, t_ms, float(score)))
            self._next_window_start += n * self.stride_samples

        # drop samples no longer needed by any future window
        keep_from = self._next_window_start - self._consumed
        if keep_from > 0:
            self._buffer = self._buffer[keep_from:]
            self._consumed += keep_from
        return detections

    def reset(self) -> None:
        """Clear all stream and detector state; every constructor setting
        (including non-default clip_duration_ms / clip_stride_ms) survives."""
        self.__init__(
            self.target_keyword,
            self.predict_fn,
            detection_threshold=self.recognizer._threshold,
            sample_rate=self.sample_rate,
            clip_duration_ms=self.clip_duration_ms,
            clip_stride_ms=self.clip_stride_ms,
            suppression_ms=self.recognizer._suppression,
            average_window_duration_ms=self.recognizer._window,
            minimum_count=self.recognizer._minimum_count,
            frontend=self.frontend,
        )
