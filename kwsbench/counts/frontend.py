"""The least device time of the frontend and transform kernels at their
shapes: the larger of their bytes over the memory rate and their operations
over their peak rate (NVIDIA H100 SXM data sheet).

Frozen copies of ``chip_smoke.py``'s bounds: operations counted from the
algorithm, bytes as each input read once and each output written once.

- B2 ``stream_prefix``: per 20 ms frame the window (960), max|x| (960),
  the input shift (480), four radix-4 FFT stages (17,920), the real
  post-stage (5,120), the filterbank (2 x 40 x 28) and Sqrt64 with its
  shift (520) integer operations; int16 audio in, int32 (frames, 40) out.
- B3 ``stream_suffix``: 52 integer operations per output element (noise
  estimate 11, PCAN gain 15, shrink 5, log 19, scale 2); the int32 base
  in, float32 (windows, 49, 40) out.
- B1 ``clip_features``: B2's and B3's work per clip, fused; int16 audio in,
  float32 features out.
- B4 ``augment_quantize``: 17 float operations per sample; per sample the
  int16 foreground, the float32 background crop and the int16 output, per
  clip 21 bytes of draws.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 33.5e12  # half the 67 T/s float32 rate: 64 INT32 lanes an SM
PEAK_FP32_OPS_PER_S = 67e12
PREFIX_OPS_PER_FRAME = 960 + 960 + 480 + 17920 + 5120 + 2 * 40 * 28 + 520
SUFFIX_OPS_PER_ELEMENT = 52
AUGMENT_OPS_PER_SAMPLE = 6 + 11
CHANNELS = 40
SR = 16000
FRAME_STEP = 320
FRAME_SIZE = 480
CLIP_FRAMES = 49


def least_s(nbytes: float, ops: float, ops_per_s: float = PEAK_INT32_OPS_PER_S) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, ops / ops_per_s)


def stream_frames(samples: int) -> int:
    return 1 + (samples - FRAME_SIZE) // FRAME_STEP


def stream_prefix_s(samples: int) -> float:
    frames = stream_frames(samples)
    return least_s(samples * 2 + frames * CHANNELS * 4, frames * PREFIX_OPS_PER_FRAME)


def stream_suffix_s(samples: int, windows: int) -> float:
    out = windows * CLIP_FRAMES * CHANNELS
    return least_s(stream_frames(samples) * CHANNELS * 4 + out * 4, out * SUFFIX_OPS_PER_ELEMENT)


def clip_features_s(clips: int, samples: int = SR) -> float:
    frames = stream_frames(samples)
    return least_s(clips * samples * 2 + clips * frames * CHANNELS * 4,
                   clips * frames * (PREFIX_OPS_PER_FRAME + CHANNELS * SUFFIX_OPS_PER_ELEMENT))


def augment_quantize_s(clips: int, samples: int = SR) -> float:
    return least_s(clips * (samples * (2 + 4 + 2) + 21), clips * samples * AUGMENT_OPS_PER_SAMPLE,
                   PEAK_FP32_OPS_PER_S)
