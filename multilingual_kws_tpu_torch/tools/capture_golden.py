"""Capture golden microfrontend features from the real TFLite op (requires TF).

Produces tests/golden/microfrontend_golden.npz consumed by
tests/test_frontend_exact.py — so the test suite itself never needs TF.

Run: python -m multilingual_kws_tpu_torch.tools.capture_golden

The port's own copy of ``multilingual_kws_tpu/tools/capture_golden.py``, with the same names and
outputs: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np
from pathlib import Path


def make_waveforms() -> dict:
    """Deterministic synthetic waveforms covering the frontend's dynamic range."""
    out = {}
    sr = 16000
    t1 = np.arange(sr) / sr

    rng = np.random.default_rng(12345)
    out["zeros"] = np.zeros(sr)
    out["sine440"] = 0.5 * np.sin(2 * np.pi * 440 * t1)
    out["loud1k"] = 0.999 * np.sin(2 * np.pi * 1000 * t1)
    out["fullscale"] = np.sign(np.sin(2 * np.pi * 100 * t1))  # hits +-1.0 exactly
    out["noise"] = np.clip(rng.normal(0, 0.1, sr), -1, 1)
    out["quiet"] = np.clip(rng.normal(0, 0.001, sr), -1, 1)
    out["chirp"] = 0.3 * np.sin(2 * np.pi * (200 + 3000 * t1) * t1)
    out["impulses"] = np.zeros(sr)
    out["impulses"][::997] = 0.9
    out["speechlike"] = np.clip(
        0.25 * np.sin(2 * np.pi * 180 * t1) * (1 + 0.8 * np.sin(2 * np.pi * 3 * t1))
        + 0.15 * np.sin(2 * np.pi * 2400 * t1) * (np.sin(2 * np.pi * 7 * t1) > 0)
        + rng.normal(0, 0.02, sr),
        -1,
        1,
    )
    out["mix"] = np.clip(
        0.2 * np.sin(2 * np.pi * 300 * t1) + rng.normal(0, 0.05, sr), -1, 1
    )
    # 2-second clip: exercises noise-reduction state over 99 frames
    t2 = np.arange(2 * sr) / sr
    out["long_mix"] = np.clip(
        0.3 * np.sin(2 * np.pi * 500 * t2) * (1 + np.sin(2 * np.pi * 1.5 * t2))
        + rng.normal(0, 0.03, 2 * sr),
        -1,
        1,
    )
    # short clip: single frame
    out["short"] = np.clip(rng.normal(0, 0.2, 480), -1, 1)
    return out


CONFIGS = {
    # name -> op kwargs (reference default config first: input_data.py:25-33)
    "default40": dict(window_size=30, window_step=20, num_channels=40),
    "micro32": dict(window_size=25, window_step=10, num_channels=32),
    "nopcan": dict(window_size=30, window_step=20, num_channels=40, enable_pcan=False),
    "nolog": dict(window_size=30, window_step=20, num_channels=40, enable_log=False),
    "raw": dict(
        window_size=30,
        window_step=20,
        num_channels=40,
        enable_pcan=False,
        enable_log=False,
        min_signal_remaining=1.0,
    ),
}


def main():
    import tensorflow as tf
    from tensorflow.lite.experimental.microfrontend.python.ops import (
        audio_microfrontend_op as frontend_op,
    )

    waveforms = make_waveforms()
    arrays = {}
    for wname, wav in waveforms.items():
        int16_audio = (np.asarray(wav) * 32768.0).astype(np.int64).astype(np.int16)
        arrays[f"audio_{wname}"] = int16_audio
        for cname, kwargs in CONFIGS.items():
            feats = frontend_op.audio_microfrontend(
                tf.constant(int16_audio),
                sample_rate=16000,
                out_scale=1,
                out_type=tf.float32,
                **kwargs,
            ).numpy()
            arrays[f"feat_{cname}_{wname}"] = feats
        # full reference to_micro_spectrogram semantics (float -> int16 cast
        # inside TF, then x 10/256): input_data.py:19-35
        float_audio = tf.constant(wav, dtype=tf.float32)
        int16_input = tf.cast(tf.multiply(float_audio, 32768), tf.int16)
        spec = frontend_op.audio_microfrontend(
            int16_input,
            sample_rate=16000,
            window_size=30,
            window_step=20,
            num_channels=40,
            out_scale=1,
            out_type=tf.float32,
        )
        arrays[f"spec_{wname}"] = (spec * (10.0 / 256.0)).numpy()
        arrays[f"floataudio_{wname}"] = np.asarray(wav, dtype=np.float32)

    dest = Path(__file__).resolve().parents[2] / "tests" / "golden"
    dest.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(dest / "microfrontend_golden.npz", **arrays)
    print(f"wrote {dest/'microfrontend_golden.npz'} with {len(arrays)} arrays")


if __name__ == "__main__":
    main()
