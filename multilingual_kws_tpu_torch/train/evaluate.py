"""Batch clip evaluation: the reference's transfer_learning.py:177-273.

Counterpart of ``multilingual_kws_tpu/train/evaluate.py``.
``evaluate_files_*`` featurize a list of wavs on the device (the fused
``clip_features`` kernel on a card, or a given ``frontend`` of either mode)
and split prediction confidences by argmax against the target id;
``evaluate_fast_*`` sample up to N utterances per word from a data dir. ``predict_fn`` takes (B, 49, 40, 1) float32
features, a tensor on the frontend's device, and returns (B, C) softmax
rows (a tensor or an array): ``FinetuneResult.predict_fn()`` is one.

``featurize_files(backend="native")`` featurizes on the host instead, with
the multithreaded C++ frontend (``native/host_frontend.py``), bit-identical
to the device backend and with no device round trip.
"""

from __future__ import annotations

import glob
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..ops.micro_exact import FrontendConfig
from ..ops.micro_torch import MicroFrontendTorch, cached_stream_frontend
from ..utils.wav import read_wav


def _featurize(files, frontend, desired_samples, batch_size, device) -> torch.Tensor:
    """wav paths -> (N, 49, 40) float32 features on the frontend's device."""
    frontend = frontend or cached_stream_frontend(16000, str(resolve_device(device)))
    out = []
    for i in range(0, len(files), batch_size):
        wavs = np.stack([read_wav(f, desired_samples=desired_samples)[0] for f in files[i : i + batch_size]])
        out.append(frontend.features(torch.from_numpy(wavs).to(frontend.device)))
    if not out:
        return torch.zeros((0, 49, 40), dtype=torch.float32, device=frontend.device)
    return torch.cat(out, dim=0)


def featurize_files(
    files: Sequence[str],
    frontend: Optional[MicroFrontendTorch] = None,
    desired_samples: int = 16000,
    batch_size: int = 256,
    backend: str = "device",
    device="cuda",
) -> np.ndarray:
    """wav paths -> (N, 49, 40) float32 features.

    backend="device": batched on the device (``frontend``'s, else
    ``device``). backend="native": the multithreaded C++ host frontend
    (``frontend``'s configuration, else the default one; ``device`` is not
    used), bit-identical to the device backend."""
    if backend == "native":
        from ..native.host_frontend import NativeMicroFrontend

        native = NativeMicroFrontend(frontend.config if frontend else FrontendConfig())
        files = list(files)
        out = [
            native.features(np.stack([read_wav(f, desired_samples=desired_samples)[0] for f in files[i : i + batch_size]]))
            for i in range(0, len(files), batch_size)
        ]
        return np.concatenate(out, axis=0) if out else np.zeros((0, 49, 40), np.float32)
    if backend != "device":
        raise ValueError(f"unknown backend {backend!r}")
    return _featurize(list(files), frontend, desired_samples, batch_size, device).cpu().numpy()


def _predict(files, predict_fn, frontend, device) -> np.ndarray:
    specs = _featurize(list(files), frontend, 16000, 256, device)
    preds = predict_fn(specs[..., None])
    return preds.cpu().numpy() if isinstance(preds, torch.Tensor) else np.asarray(preds)


def evaluate_files_multiclass(
    files_to_evaluate: Sequence[str],
    target_id: int,
    predict_fn: Callable,
    frontend: Optional[MicroFrontendTorch] = None,
    device="cuda",
) -> Dict[str, List[float]]:
    """Reference evaluate_files_multiclass (:238-261)."""
    preds = _predict(files_to_evaluate, predict_fn, frontend, device)
    cols = np.argmax(preds, axis=1)
    conf = preds[np.arange(len(cols)), cols]
    return dict(
        correct=[float(c) for c, k in zip(conf, cols) if k == target_id],
        incorrect=[float(c) for c, k in zip(conf, cols) if k != target_id],
    )


def evaluate_files_single_target(
    files_to_evaluate: Sequence[str],
    target_id: int,
    predict_fn: Callable,
    frontend: Optional[MicroFrontendTorch] = None,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Reference evaluate_files_single_target (:264-273)."""
    preds = _predict(files_to_evaluate, predict_fn, frontend, device)
    return preds[:, target_id], preds


def _sample_files(words, data_dir, utterances_per_word, rng) -> List[str]:
    files: List[str] = []
    for word in words:
        wavs = glob.glob(os.path.join(data_dir, word, "*.wav"))
        if len(wavs) > utterances_per_word:
            wavs = list(rng.choice(wavs, utterances_per_word, replace=False))
        files.extend(wavs)
    return files


def evaluate_fast_multiclass(
    words_to_evaluate: Sequence[str],
    target_id: int,
    data_dir: str,
    utterances_per_word: int,
    predict_fn: Callable,
    frontend: Optional[MicroFrontendTorch] = None,
    rng: Optional[np.random.Generator] = None,
    device="cuda",
) -> Dict[str, List[float]]:
    """Reference evaluate_fast_multiclass (:177-213)."""
    files = _sample_files(words_to_evaluate, data_dir, utterances_per_word, rng or np.random.default_rng())
    return evaluate_files_multiclass(files, target_id, predict_fn, frontend, device)


def evaluate_fast_single_target(
    words_to_evaluate: Sequence[str],
    target_id: int,
    data_dir: str,
    utterances_per_word: int,
    predict_fn: Callable,
    frontend: Optional[MicroFrontendTorch] = None,
    rng: Optional[np.random.Generator] = None,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Reference evaluate_fast_single_target (:216-235)."""
    files = _sample_files(words_to_evaluate, data_dir, utterances_per_word, rng or np.random.default_rng())
    return evaluate_files_single_target(files, target_id, predict_fn, frontend, device)
