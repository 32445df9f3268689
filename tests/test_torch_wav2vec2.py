"""The port's wav2vec2 embedder (models/wav2vec2_embed.py) against the JAX
package's, on a tiny random ``Wav2Vec2Config`` built as
tests/test_wav2vec2.py builds it (no hub weights). The same model and
feature extractor objects go into both embedders, on the CPU, so the
embeddings must be ``==``: both packages run the same torch model on the
same inputs with the same pooling."""

import sys

import numpy as np
import pytest
import torch
from transformers import Wav2Vec2Config, Wav2Vec2FeatureExtractor, Wav2Vec2Model

from multilingual_kws_tpu.models.wav2vec2_embed import Wav2Vec2Embedder as JaxSideEmbedder
from multilingual_kws_tpu_torch.models.wav2vec2_embed import Wav2Vec2Embedder
from multilingual_kws_tpu_torch.utils.wav import write_wav


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs in parallel
    workers that share the cores, and small ops then spend their time in
    thread barriers rather than arithmetic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def embedders():
    torch.manual_seed(0)
    config = Wav2Vec2Config(
        hidden_size=32, num_hidden_layers=1, num_attention_heads=2, intermediate_size=64,
        conv_dim=(16, 16, 16, 16, 16, 16, 16), num_feat_extract_layers=7,
    )
    model, extractor = Wav2Vec2Model(config), Wav2Vec2FeatureExtractor()
    return (Wav2Vec2Embedder(device="cpu", model=model, extractor=extractor),
            JaxSideEmbedder(device="cpu", model=model, extractor=extractor))


def _waves(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 0.1, n).astype(np.float32) for n in lengths]


@pytest.mark.parametrize("lengths", [(16000, 16000, 16000), (8000, 16000), (16000,)],
                         ids=["uniform", "padding_mask", "single"])
def test_embeddings_equal_jax_side(embedders, lengths):
    port, ref = embedders
    waves = _waves(len(lengths), lengths)
    got = port.embed(waves)
    assert got.shape == (len(lengths), 32) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref.embed(waves))


def test_embed_files_equal_jax_side(embedders, tmp_path):
    port, ref = embedders
    files = []
    for i, w in enumerate(_waves(1, (16000, 12000))):
        write_wav(tmp_path / f"{i}.wav", w.clip(-1, 1))
        files.append(str(tmp_path / f"{i}.wav"))
    np.testing.assert_array_equal(port.embed_files(files), ref.embed_files(files))


def test_missing_transformers_is_named(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="'transformers' package"):
        Wav2Vec2Embedder(device="cpu")
