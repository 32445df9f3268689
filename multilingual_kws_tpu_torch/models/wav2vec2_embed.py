"""wav2vec2 embeddings, the dataperf harness's alternative extractor.

Counterpart of ``multilingual_kws_tpu/models/wav2vec2_embed.py`` (the
reference's notebooks/dataperf_wav2vec2.py:43-55): mean-pooled wav2vec2 last
hidden states of 16 kHz waveforms for ``analysis/dataperf.py``. It needs the
``transformers`` package, imported when an embedder is made (the error names
it when it is missing), and a hub id or a local checkpoint directory, or a
model and feature extractor passed in. The model runs on ``device``: the
card by default, and without one it raises unless given ``"cpu"``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import resolve_device


class Wav2Vec2Embedder:
    """Mean-pooled last-hidden-state embeddings of 16 kHz waveforms.

    ``model_name`` is a hub id or a local checkpoint directory; a built
    ``model`` (a ``Wav2Vec2Model``) and ``extractor`` may be passed instead
    (the tests pass a tiny random one)."""

    def __init__(self, model_name: str = "facebook/wav2vec2-base", device="cuda", model=None, extractor=None):
        self.device = resolve_device(device)
        try:
            from transformers import Wav2Vec2FeatureExtractor, Wav2Vec2Model
        except ImportError as e:
            raise ImportError("wav2vec2 embeddings need the 'transformers' package") from e
        self.extractor = extractor if extractor is not None else Wav2Vec2FeatureExtractor.from_pretrained(model_name)
        self.model = (model if model is not None else Wav2Vec2Model.from_pretrained(model_name)).to(self.device).eval()

    def embed(self, waveforms: Sequence[np.ndarray], sample_rate: int = 16000) -> np.ndarray:
        """List of (N,) float waveforms -> (B, hidden) float32 embeddings.

        The mean covers each clip's real frames only: batch padding is left
        out through the feature encoder's length arithmetic. Only a mask the
        extractor itself returns is passed to the model (checkpoints with
        group norm, such as wav2vec2-base, were trained without one)."""
        waveforms = [np.asarray(w, np.float32) for w in waveforms]
        inputs = self.extractor(waveforms, sampling_rate=sample_rate, return_tensors="pt", padding=True)
        mask = getattr(inputs, "attention_mask", None)
        with torch.no_grad():
            out = self.model(
                inputs.input_values.to(self.device),
                attention_mask=mask.to(self.device) if mask is not None else None,
            )
        hidden = out.last_hidden_state  # (B, T, H)
        lengths = self.model._get_feat_extract_output_lengths(torch.tensor([len(w) for w in waveforms]))
        idx = torch.arange(hidden.shape[1], device=hidden.device)[None, :]
        m = (idx < lengths.to(torch.long).to(hidden.device)[:, None]).unsqueeze(-1)
        pooled = (hidden * m).sum(dim=1) / m.sum(dim=1).clamp(min=1)
        return pooled.cpu().numpy().astype(np.float32)

    def embed_files(self, files: Sequence[str]) -> np.ndarray:
        from ..utils.wav import read_wav

        return self.embed([read_wav(f)[0] for f in files])
