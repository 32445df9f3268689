"""Model settings: derived audio-frontend constants.

Reimplements the semantics of the reference's ``prepare_model_settings`` /
``standard_microspeech_model_settings`` (reference:
multilingual_kws/embedding/input_data.py:63-138) as a frozen dataclass with
the same derivation rules (49x40 feature geometry for the standard 16 kHz /
1 s / 30 ms window / 20 ms stride / 40-bin "micro" config).

A ``to_dict()`` view preserves the reference's public ``model_settings`` dict
contract (input_data.py:115-126) for API compatibility.

The port's own copy of ``multilingual_kws_tpu/settings.py`` (numpy only): the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, asdict
from typing import Dict

SILENCE_LABEL = "_silence_"
SILENCE_INDEX = 0
UNKNOWN_WORD_LABEL = "_unknown_"
UNKNOWN_WORD_INDEX = 1


def next_power_of_two(x: int) -> int:
    """Smallest enclosing power of two (reference input_data.py:50-60)."""
    return 1 if x == 0 else 2 ** (int(x) - 1).bit_length()


@dataclass(frozen=True)
class ModelSettings:
    """Frontend + label-geometry constants.

    Field names mirror the reference's ``model_settings`` dict keys exactly.
    """

    desired_samples: int
    window_size_samples: int
    window_stride_samples: int
    spectrogram_length: int
    fingerprint_width: int
    fingerprint_size: int
    label_count: int
    sample_rate: int
    preprocess: str
    average_window_width: int

    def to_dict(self) -> Dict:
        return asdict(self)

    @property
    def feature_shape(self):
        return (self.spectrogram_length, self.fingerprint_width)

    @property
    def window_size_ms(self) -> float:
        return self.window_size_samples * 1000 / self.sample_rate

    @property
    def window_stride_ms(self) -> float:
        return self.window_stride_samples * 1000 / self.sample_rate

    @property
    def fft_size(self) -> int:
        return next_power_of_two(self.window_size_samples)


def prepare_model_settings(
    label_count: int,
    sample_rate: int,
    clip_duration_ms: int,
    window_size_ms: float,
    window_stride_ms: float,
    feature_bin_count: int,
    preprocess: str,
) -> ModelSettings:
    """Same derivation as reference input_data.py:63-126."""
    desired_samples = int(sample_rate * clip_duration_ms / 1000)
    window_size_samples = int(sample_rate * window_size_ms / 1000)
    window_stride_samples = int(sample_rate * window_stride_ms / 1000)
    length_minus_window = desired_samples - window_size_samples
    if length_minus_window < 0:
        spectrogram_length = 0
    else:
        spectrogram_length = 1 + int(length_minus_window / window_stride_samples)
    if preprocess == "average":
        fft_bin_count = 1 + (next_power_of_two(window_size_samples) / 2)
        average_window_width = int(math.floor(fft_bin_count / feature_bin_count))
        fingerprint_width = int(math.ceil(fft_bin_count / average_window_width))
    elif preprocess in ("mfcc", "micro"):
        average_window_width = -1
        fingerprint_width = feature_bin_count
    else:
        raise ValueError(
            'Unknown preprocess mode "%s" (should be "mfcc", "average", or "micro")'
            % preprocess
        )
    fingerprint_size = fingerprint_width * spectrogram_length
    return ModelSettings(
        desired_samples=desired_samples,
        window_size_samples=window_size_samples,
        window_stride_samples=window_stride_samples,
        spectrogram_length=spectrogram_length,
        fingerprint_width=fingerprint_width,
        fingerprint_size=fingerprint_size,
        label_count=label_count,
        sample_rate=sample_rate,
        preprocess=preprocess,
        average_window_width=average_window_width,
    )


def standard_microspeech_model_settings(label_count: int) -> ModelSettings:
    """Standard 49x40 micro config (reference input_data.py:129-138)."""
    return prepare_model_settings(
        label_count=label_count,
        sample_rate=16000,
        clip_duration_ms=1000,
        window_size_ms=30,
        window_stride_ms=20,
        feature_bin_count=40,
        preprocess="micro",
    )
